"""Generate Solidity source for the Poseidon permutation (own copy of
``ethsnarks_tpu/poseidon/contract_sol.py``).

A self-contained Solidity library with the round constants C and the
Cauchy MDS matrix M hardcoded (no run-time blake2b) and the three Hades
phases as loops (fully unrolling 65 rounds x t=6 MDS rows would pass the
EIP-170 24KB code-size limit, unlike MiMC's scalar rounds), after the
conventions of ``contracts/MiMC_hash.sol``: a ``library`` with an
``internal pure`` permutation plus a 2-input hash.  The text, its header
line included, is the reference generator's byte for byte.
"""

from ..field import SNARK_SCALAR_FIELD
from .permutation import DefaultParams

P = SNARK_SCALAR_FIELD


def poseidon_contract_solidity(params=None, name='Poseidon_generated'):
    params = params or DefaultParams
    t = params.t
    n_rounds = params.nRoundsF + params.nRoundsP
    half_f = params.nRoundsF // 2
    assert params.e == 5, "sbox emitter is specialized to x^5"

    lines = [
        "// Auto-generated by ethsnarks_tpu.poseidon.contract_sol"
        " - do not edit.",
        "// Poseidon permutation: t=%d, R_F=%d, R_P=%d, e=%d, seed=%r"
        % (t, params.nRoundsF, params.nRoundsP, params.e,
           params.seed.decode('ascii')),
        "pragma solidity ^0.5.0;",
        "",
        "library %s" % name,
        "{",
        "    uint256 constant p = %s;" % hex(P),
        "",
        "    function GetRoundConstants ()",
        "        internal pure returns (uint256[%d] memory C)" % n_rounds,
        "    {",
    ]
    for r, c in enumerate(params.constants_C):
        lines.append("        C[%d] = %s;" % (r, hex(c % P)))
    lines += [
        "    }",
        "",
        "    function GetMatrix ()",
        "        internal pure returns (uint256[%d] memory M)" % (t * t),
        "    {",
    ]
    for i in range(t):
        for j in range(t):
            lines.append("        M[%d] = %s;"
                         % (i * t + j, hex(params.constants_M[i][j] % P)))
    lines += [
        "    }",
        "",
        "    function SBox (uint256 x)",
        "        internal pure returns (uint256)",
        "    {",
        "        uint256 x2 = mulmod(x, x, p);",
        "        uint256 x4 = mulmod(x2, x2, p);",
        "        return mulmod(x4, x, p);",
        "    }",
        "",
        "    function Permute (uint256[%d] memory state)" % t,
        "        internal pure returns (uint256[%d] memory)" % t,
        "    {",
        "        uint256[%d] memory C = GetRoundConstants();" % n_rounds,
        "        uint256[%d] memory M = GetMatrix();" % (t * t),
        "        uint256[%d] memory ns;" % t,
        "        uint256 i;",
        "        uint256 j;",
        "        for (uint256 r = 0; r < %d; r++)" % n_rounds,
        "        {",
        "            // ARK",
        "            for (i = 0; i < %d; i++) {" % t,
        "                state[i] = addmod(state[i], C[r], p);",
        "            }",
        "            // SBOX: full layers outside [%d, %d), single inside"
        % (half_f, half_f + params.nRoundsP),
        "            if (r < %d || r >= %d) {"
        % (half_f, half_f + params.nRoundsP),
        "                for (i = 0; i < %d; i++) {" % t,
        "                    state[i] = SBox(state[i]);",
        "                }",
        "            } else {",
        "                state[0] = SBox(state[0]);",
        "            }",
        "            // MIX",
        "            for (i = 0; i < %d; i++) {" % t,
        "                uint256 acc = 0;",
        "                for (j = 0; j < %d; j++) {" % t,
        "                    acc = addmod(acc,"
        " mulmod(M[i * %d + j], state[j], p), p);" % t,
        "                }",
        "                ns[i] = acc;",
        "            }",
        "            for (i = 0; i < %d; i++) {" % t,
        "                state[i] = ns[i];",
        "            }",
        "        }",
        "        return state;",
        "    }",
        "",
        "    function PoseidonHash (uint256 in_x, uint256 in_y)",
        "        internal pure returns (uint256)",
        "    {",
        "        uint256[%d] memory state;" % t,
        "        state[0] = in_x;",
        "        state[1] = in_y;",
        "        return Permute(state)[0];",
        "    }",
        "}",
    ]
    return "\n".join(lines)


def main():
    print(poseidon_contract_solidity())


if __name__ == '__main__':
    main()

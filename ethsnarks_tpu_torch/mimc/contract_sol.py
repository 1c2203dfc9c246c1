"""Generate the unrolled-Solidity MiMC permutation source (own copy of
``ethsnarks_tpu/mimc/contract_sol.py``): a library with the full round
sequence in inline assembly and hardcoded constants, avoiding run-time
keccak.  The text, its header line included, is the reference
generator's byte for byte.
"""

from ..field import SNARK_SCALAR_FIELD
from .permutation import _constants_list, DEFAULT_SEED, DEFAULT_ROUNDS, \
    DEFAULT_EXPONENT

P = SNARK_SCALAR_FIELD


def mimc_contract_solidity(exponent=DEFAULT_EXPONENT, seed=DEFAULT_SEED,
                           rounds=DEFAULT_ROUNDS, name=None):
    assert exponent in (5, 7)
    name = name or ('MiMCpe%d_generated' % exponent)
    constants = _constants_list(seed, P, rounds)
    lines = [
        "// Auto-generated by ethsnarks_tpu.mimc.contract_sol - do not edit.",
        "pragma solidity ^0.5.0;",
        "",
        "library %s" % name,
        "{",
        "    function MiMCpe%d (uint256 in_x, uint256 in_k)" % exponent,
        "        internal pure returns (uint256 out_x)",
        "    {",
        "        assembly {",
        "            let p := %s" % hex(P),
        "            let x := in_x",
        "            let t := 0",
        "            let a := 0",
    ]
    for c in constants:
        lines.append("            t := addmod(addmod(x, %s, p), in_k, p)"
                     % hex(c % P))
        if exponent == 7:
            lines.append("            a := mulmod(t, t, p)")
            lines.append(
                "            x := mulmod(mulmod(mulmod(a, a, p), a, p), t, p)")
        else:
            lines.append("            a := mulmod(t, t, p)")
            lines.append("            x := mulmod(mulmod(a, a, p), t, p)")
    lines += [
        "            out_x := addmod(x, in_k, p)",
        "        }",
        "    }",
        "}",
    ]
    return "\n".join(lines)


def main():
    import sys
    exponent = int(sys.argv[1]) if len(sys.argv) > 1 else DEFAULT_EXPONENT
    rounds = int(sys.argv[2]) if len(sys.argv) > 2 else \
        (91 if exponent == 7 else 110)
    print(mimc_contract_solidity(exponent, rounds=rounds))


if __name__ == '__main__':
    main()

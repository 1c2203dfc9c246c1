"""Solidity that instantiates a VerifyingKey for Verifier.sol (own copy of
``ethsnarks_tpu/cli/vk2sol.py``).

    python -m ethsnarks_tpu_torch.cli.vk2sol vk.json [func-name]
"""
import json
import sys

from ..verifier import VerifyingKey
from .utils import g2_to_sol, g1_to_sol


def vk_to_sol(vk, name='_getVerifyingKey'):
    indent = "\t\t"
    varname = "vk"
    out = [
        "\tfunction %s (Verifier.VerifyingKey memory %s)" % (name, varname),
        "\t\tinternal pure",
        "\t{",
    ]
    for k in ('beta', 'gamma', 'delta'):
        out.append("%s%s.%s = %s;" % (indent, varname, k,
                                      g2_to_sol(getattr(vk, k))))
    out.append("%s%s.alpha = %s;" % (indent, varname, g1_to_sol(vk.alpha)))
    out.append("%s%s.gammaABC = new Pairing.G1Point[](%d);"
               % (indent, varname, len(vk.gammaABC)))
    for i, v in enumerate(vk.gammaABC):
        out.append("%s%s.gammaABC[%d] = %s;"
                   % (indent, varname, i, g1_to_sol(v)))
    out.append("\t}")
    return '\n'.join(out)


def main(vk_filename, name='_getVerifyingKey'):
    with open(vk_filename, 'r') as handle:
        vk = VerifyingKey.from_dict(json.load(handle))
    print(vk_to_sol(vk, name))


if __name__ == "__main__":
    if len(sys.argv) < 2:
        print("Usage: ethsnarks_tpu_torch.cli.vk2sol <vk.json> [func-name]")
        sys.exit(1)
    sys.exit(main(*sys.argv[1:]))

"""Solidity that instantiates a static proof for Verifier.sol (own copy of
``ethsnarks_tpu/cli/proof2sol.py``).

    python -m ethsnarks_tpu_torch.cli.proof2sol proof.json [func-name]
"""
import json
import sys

from ..verifier import Proof
from .utils import g2_to_sol, g1_to_sol


def proof_to_sol(proof, name='_getStaticProof'):
    out = [
        "\tfunction %s (Verifier.ProofWithInput memory output)" % (name,),
        "\t\tinternal pure",
        "\t{",
        "\t\tVerifier.Proof memory proof = output.proof;",
    ]
    out.append("\t\tproof.B = %s;" % g2_to_sol(proof.B))
    for k in ('A', 'C'):
        out.append("\t\tproof.%s = %s;" % (k, g1_to_sol(getattr(proof, k))))
    out.append("\t\toutput.input = new uint256[](%d);" % (len(proof.input),))
    for i, v in enumerate(proof.input):
        out.append("\t\toutput.input[%d] = %s;" % (i, hex(v)))
    out.append("\t}")
    return '\n'.join(out)


def main(proof_filename, name='_getStaticProof'):
    with open(proof_filename, 'r') as handle:
        proof = Proof.from_dict(json.load(handle))
    print(proof_to_sol(proof, name))


if __name__ == "__main__":
    if len(sys.argv) < 2:
        print("Usage: ethsnarks_tpu_torch.cli.proof2sol <proof.json> "
              "[func-name]")
        sys.exit(1)
    sys.exit(main(*sys.argv[1:]))

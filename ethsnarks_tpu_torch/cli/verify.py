"""Verify a proof.json against a vk.json (own copy of
``ethsnarks_tpu/cli/verify.py``): prints OK and exits 0, or FAIL and 1.

    python -m ethsnarks_tpu_torch.cli.verify vk.json proof.json
"""
import json
import sys

from ..verifier import VerifyingKey, Proof


def main(vk_file, proof_file):
    with open(vk_file, 'r') as vk_handle:
        vk = VerifyingKey.from_dict(json.load(vk_handle))
    with open(proof_file, 'r') as proof_handle:
        proof = Proof.from_dict(json.load(proof_handle))
    if not vk.verify(proof):
        print("FAIL")
        return 1
    print("OK")
    return 0


if __name__ == "__main__":
    if len(sys.argv) < 3:
        print("Usage: ethsnarks_tpu_torch.cli.verify <vk.json> <proof.json>")
        sys.exit(1)
    sys.exit(main(*sys.argv[1:]))

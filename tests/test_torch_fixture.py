"""The committed prove fixture of the PyTorch/CUDA port, regenerated.

``ethsnarks_tpu_torch/fixtures/mimc_chain_10/`` holds a 729-constraint
MiMC-e7 chain (``tools/bench_prove.py:build_circuit(10)``), its constraint
system and witness, a proving key from a seeded host setup in the JAX
package's binary format, the verifying key, and the proof the JAX package's
host prover makes for it.  The port's tests and ``chip_smoke.py`` prove
the fixture and compare with that proof.

Regenerate with::

    JAX_PLATFORMS=cpu python tests/test_torch_fixture.py

The first test below rebuilds the files through the JAX package in a
temporary directory and checks them byte for byte against the committed
ones.  It is marked slow: the host prove takes about a minute.  The second
makes the key through the port's own setup (plain K4 on the CPU) and
checks pk.bin and vk.json byte for byte.
"""
import importlib.util
import json
import os
import random
import sys

import pytest

from torch_port_helpers import torch_threads  # noqa: F401

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
FIXTURE_DIR = os.path.join(ROOT, "ethsnarks_tpu_torch", "fixtures",
                           "mimc_chain_10")
FILES = ("r1cs.json", "witness.json", "pk.bin", "vk.json", "proof.json")
SETUP_SEED = 20261016


def _build_circuit():
    spec = importlib.util.spec_from_file_location(
        "bench_prove", os.path.join(ROOT, "tools", "bench_prove.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.build_circuit(10)


def write_fixture(out_dir):
    from ethsnarks_tpu.field import SNARK_SCALAR_FIELD
    from ethsnarks_tpu.groth16 import generator, ProverContext
    from ethsnarks_tpu.serialization import r1cs_to_dict, write_pk_binary

    cs = _build_circuit()
    seeded = random.Random(SETUP_SEED)
    keypair = generator(cs, rng=lambda: seeded.randrange(
        1, SNARK_SCALAR_FIELD), device_exp=False)
    proof = ProverContext(keypair.pk, cs, use_device_msm=False).prove(
        cs.values)
    assert keypair.vk.verify(proof)
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "r1cs.json"), "w") as fh:
        json.dump(r1cs_to_dict(cs), fh)
    with open(os.path.join(out_dir, "witness.json"), "w") as fh:
        json.dump([str(v) for v in cs.values], fh)
    write_pk_binary(keypair.pk, os.path.join(out_dir, "pk.bin"))
    with open(os.path.join(out_dir, "vk.json"), "w") as fh:
        fh.write(keypair.vk.to_json())
    with open(os.path.join(out_dir, "proof.json"), "w") as fh:
        fh.write(proof.to_json())


@pytest.mark.slow
def test_fixture_regenerates_byte_identical(tmp_path):
    write_fixture(str(tmp_path))
    for name in FILES:
        with open(os.path.join(FIXTURE_DIR, name), "rb") as fh:
            want = fh.read()
        with open(os.path.join(str(tmp_path), name), "rb") as fh:
            assert fh.read() == want, name


def test_port_setup_reproduces_key(tmp_path):
    from ethsnarks_tpu_torch.field import SNARK_SCALAR_FIELD
    from ethsnarks_tpu_torch.groth16 import generator
    from ethsnarks_tpu_torch.serialization import r1cs_from_dict, \
        write_pk_binary
    with open(os.path.join(FIXTURE_DIR, "r1cs.json")) as fh:
        cs = r1cs_from_dict(json.load(fh))
    seeded = random.Random(SETUP_SEED)
    kp = generator(cs, rng=lambda: seeded.randrange(1, SNARK_SCALAR_FIELD),
                   device='cpu')
    write_pk_binary(kp.pk, str(tmp_path / "pk.bin"))
    with open(os.path.join(FIXTURE_DIR, "pk.bin"), "rb") as fh:
        assert (tmp_path / "pk.bin").read_bytes() == fh.read()
    with open(os.path.join(FIXTURE_DIR, "vk.json")) as fh:
        assert kp.vk.to_json() == fh.read()


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    write_fixture(sys.argv[1] if len(sys.argv) > 1 else FIXTURE_DIR)

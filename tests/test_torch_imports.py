"""The PyTorch/CUDA port imports neither JAX nor the JAX package.

Every module of ``ethsnarks_tpu_torch/``, ``chip_smoke.py`` and
``chip_mesh.py`` is parsed (not imported) and each import statement is
checked."""
import ast
import os

import pytest

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
PORT = os.path.join(ROOT, "ethsnarks_tpu_torch")


def _sources():
    out = [os.path.join(ROOT, "chip_smoke.py"),
           os.path.join(ROOT, "chip_mesh.py")]
    for d, _, files in os.walk(PORT):
        out += [os.path.join(d, f) for f in sorted(files) if f.endswith(".py")]
    return sorted(os.path.relpath(p, ROOT) for p in out)


def _forbidden(name):
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "ethsnarks_tpu")


# the Merkle flagship's and the zk form's modules (each also parsed below)
MERKLE_AND_ZK = [
    "ethsnarks_tpu_torch/bench_merkle.py",
    "ethsnarks_tpu_torch/evm_verifier.py",
    "ethsnarks_tpu_torch/evmasm.py",
    "ethsnarks_tpu_torch/gadgets/merkle.py",
    "ethsnarks_tpu_torch/merkletree.py",
    "ethsnarks_tpu_torch/models/__init__.py",
    "ethsnarks_tpu_torch/models/_prove.py",
    "ethsnarks_tpu_torch/models/merkle_batch.py",
    "ethsnarks_tpu_torch/models/merkle_membership.py",
    "ethsnarks_tpu_torch/models/mimc_preimage.py",
    "ethsnarks_tpu_torch/ops/mimc.py",
    "ethsnarks_tpu_torch/poseidon/__init__.py",
    "ethsnarks_tpu_torch/poseidon/permutation.py",
]


# the hash gadgets, their batched traces, models and workloads
HASH_CIRCUITS = [
    "ethsnarks_tpu_torch/bench_workloads.py",
    "ethsnarks_tpu_torch/gadgets/arith.py",
    "ethsnarks_tpu_torch/gadgets/basics.py",
    "ethsnarks_tpu_torch/gadgets/poseidon.py",
    "ethsnarks_tpu_torch/gadgets/sha256.py",
    "ethsnarks_tpu_torch/models/poseidon_batch.py",
    "ethsnarks_tpu_torch/models/sha256_batch.py",
    "ethsnarks_tpu_torch/ops/poseidon_ops.py",
    "ethsnarks_tpu_torch/ops/sha256_ops.py",
]


# the JubJub half of the circuit library: host curve, hashes, signatures,
# gadgets, batched ops and the verify circuit
JUBJUB = [
    "ethsnarks_tpu_torch/eddsa.py",
    "ethsnarks_tpu_torch/field.py",
    "ethsnarks_tpu_torch/gadgets/jubjub.py",
    "ethsnarks_tpu_torch/jubjub.py",
    "ethsnarks_tpu_torch/models/eddsa_verify.py",
    "ethsnarks_tpu_torch/numbertheory.py",
    "ethsnarks_tpu_torch/ops/eddsa_ops.py",
    "ethsnarks_tpu_torch/ops/jubjub_ops.py",
    "ethsnarks_tpu_torch/pedersen.py",
]


# the entry points, the key formats and the verifiers beside vk.verify
ENTRY_POINTS = [
    "ethsnarks_tpu_torch/cli/__init__.py",
    "ethsnarks_tpu_torch/cli/proof2sol.py",
    "ethsnarks_tpu_torch/cli/utils.py",
    "ethsnarks_tpu_torch/cli/verify.py",
    "ethsnarks_tpu_torch/cli/vk2sol.py",
    "ethsnarks_tpu_torch/groth16.py",
    "ethsnarks_tpu_torch/mimc/__main__.py",
    "ethsnarks_tpu_torch/pairing.py",
    "ethsnarks_tpu_torch/pinocchio.py",
    "ethsnarks_tpu_torch/serialization.py",
    "ethsnarks_tpu_torch/shamirspoly.py",
    "ethsnarks_tpu_torch/stubs.py",
    "ethsnarks_tpu_torch/utils/__init__.py",
    "ethsnarks_tpu_torch/utils/profiling.py",
    "ethsnarks_tpu_torch/verifier.py",
]


# the multi-device prover and the host EVM and contract modules
MESH_AND_CONTRACTS = [
    "ethsnarks_tpu_torch/evm_jubjub.py",
    "ethsnarks_tpu_torch/evm_merkle.py",
    "ethsnarks_tpu_torch/evm_snarkutils.py",
    "ethsnarks_tpu_torch/mimc/contract.py",
    "ethsnarks_tpu_torch/mimc/contract_sol.py",
    "ethsnarks_tpu_torch/parallel/__init__.py",
    "ethsnarks_tpu_torch/parallel/mesh.py",
    "ethsnarks_tpu_torch/parallel/msm_red_sharded.py",
    "ethsnarks_tpu_torch/parallel/msm_sharded.py",
    "ethsnarks_tpu_torch/parallel/ntt_sharded.py",
    "ethsnarks_tpu_torch/parallel/qap_sharded.py",
    "ethsnarks_tpu_torch/poseidon/contract.py",
    "ethsnarks_tpu_torch/poseidon/contract_sol.py",
]


def test_port_has_modules():
    assert len(_sources()) >= 15


@pytest.mark.parametrize("relpath", MERKLE_AND_ZK)
def test_merkle_and_zk_modules_present(relpath):
    assert relpath in _sources()


@pytest.mark.parametrize("relpath", HASH_CIRCUITS)
def test_hash_circuit_modules_present(relpath):
    assert relpath in _sources()


@pytest.mark.parametrize("relpath", JUBJUB)
def test_jubjub_modules_present(relpath):
    assert relpath in _sources()


@pytest.mark.parametrize("relpath", ENTRY_POINTS)
def test_entry_point_modules_present(relpath):
    assert relpath in _sources()


@pytest.mark.parametrize("relpath", MESH_AND_CONTRACTS)
def test_mesh_and_contract_modules_present(relpath):
    assert relpath in _sources()


@pytest.mark.parametrize("relpath", _sources())
def test_no_jax_imports(relpath):
    with open(os.path.join(ROOT, relpath)) as fh:
        tree = ast.parse(fh.read(), relpath)
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if node.module and _forbidden(node.module):
                bad.append(node.module)
        elif isinstance(node, ast.Call) and getattr(
                node.func, "id", getattr(node.func, "attr", "")) in (
                    "import_module", "__import__"):
            for arg in node.args:
                if isinstance(arg, ast.Constant) and isinstance(
                        arg.value, str) and _forbidden(arg.value):
                    bad.append(arg.value)
    assert not bad, "%s imports %s" % (relpath, bad)

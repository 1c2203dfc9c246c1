"""The port's batched hash models against the JAX package's on the CPU:
``BatchSha256`` (two 512-bit instances, and one 96-byte message over two
data blocks) and ``BatchPoseidonHash`` (four instances) built and filled
by both packages on the same inputs must have the same constraint triples,
annotations and witness values, and digests equal to hashlib's or the
host Poseidon's.  The port's traces run on the CPU, the reference's
through JAX on the CPU.  Integers, so no tolerance; inputs from numpy
seeds."""
import hashlib

import numpy as np
import pytest

from ethsnarks_tpu.models.poseidon_batch import \
    BatchPoseidonHash as RefBatchPoseidon
from ethsnarks_tpu.models.sha256_batch import BatchSha256 as RefBatchSha256

from ethsnarks_tpu_torch.field import SNARK_SCALAR_FIELD
from ethsnarks_tpu_torch.models import BatchPoseidonHash, BatchSha256
from ethsnarks_tpu_torch.poseidon import poseidon

from torch_port_helpers import rand_ints, same_board, \
    torch_threads  # noqa: F401

P = SNARK_SCALAR_FIELD


def _digest_halves(msg):
    d = hashlib.sha256(msg).digest()
    return int.from_bytes(d[:16], 'big'), int.from_bytes(d[16:], 'big')


@pytest.fixture(scope="module", params=[(2, 64), (1, 96)],
                ids=['2x512', '1x768'])
def sha_models(request):
    n, n_bytes = request.param
    rng = np.random.default_rng(n_bytes)
    msgs = [rng.bytes(n_bytes) for _ in range(n)]
    got = BatchSha256(n, n_bits=8 * n_bytes, device='cpu').set_witness(msgs)
    want = RefBatchSha256(n, n_bits=8 * n_bytes)
    want.set_witness(msgs)
    return got, want, msgs


def test_sha256_model_matches_reference(sha_models):
    got, want, msgs = sha_models
    same_board(got.pb, want.pb)
    assert got.n_blocks == want.n_blocks == 2
    assert got.digests() == [_digest_halves(m) for m in msgs]


def test_sha256_model_satisfied_and_refuses_a_flipped_bit(sha_models):
    got, _, msgs = sha_models
    pb = got.pb
    assert pb.is_satisfied()
    if len(msgs[0]) == 64:
        assert pb.num_constraints == len(msgs) * 60131
    # a carry bit of instance 0's first schedule addition, flipped
    var = got.gadgets[0].comps[0].gadgets[2].carry_bits[0]
    values = list(pb.values)
    values[var.index] ^= 1
    assert not pb.is_satisfied(values=values)


@pytest.fixture(scope="module")
def poseidon_models():
    inputs = [tuple(rand_ints(2, P, seed=60 + i)) for i in range(4)]
    got = BatchPoseidonHash(4, device='cpu').set_witness(inputs)
    want = RefBatchPoseidon(4)
    want.set_witness(inputs)
    return got, want, inputs


def test_poseidon_model_matches_reference(poseidon_models):
    got, want, inputs = poseidon_models
    assert got.pb.num_constraints == 4 * (315 + 1)
    same_board(got.pb, want.pb)
    assert got.digests() == want.digests() == \
        [poseidon(list(r)) for r in inputs]


def test_poseidon_model_satisfied_and_refuses_a_changed_sbox(
        poseidon_models):
    got, _, _ = poseidon_models
    pb = got.pb
    assert pb.is_satisfied()
    values = list(pb.values)
    x4 = got.gadgets[2].sboxes[60].x4.index
    values[x4] = (values[x4] + 1) % P
    assert not pb.is_satisfied(values=values)

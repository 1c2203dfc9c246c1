"""The port's batched hash traces against the JAX package's on the CPU:
``ops.sha256_ops.sha256_witness_trace`` word for word (the final state
and every trace word), ``ops.poseidon_ops.poseidon_witness_device`` value
for value (the final state and every sbox's x^2, x^4, x^5), and the host
conveniences ``poseidon_device`` and ``mimc_hash_device`` against the
host oracles; ``Fr.pow_const`` and ``Fr.sum_axis`` against python ints.
Integers, so no tolerance; inputs from numpy seeds."""
import hashlib

import numpy as np
import pytest
import torch

from ethsnarks_tpu_torch.field import SNARK_SCALAR_FIELD
from ethsnarks_tpu_torch.mimc import mimc_hash
from ethsnarks_tpu_torch.models.sha256_batch import _padded_words
from ethsnarks_tpu_torch.ops.fp import NH, Fr
from ethsnarks_tpu_torch.ops.mimc import mimc_hash_device
from ethsnarks_tpu_torch.ops.poseidon_ops import poseidon_device, \
    poseidon_permutation, poseidon_witness_device
from ethsnarks_tpu_torch.ops.sha256_ops import WORDS_PER_COMP, \
    sha256_witness_trace
from ethsnarks_tpu_torch.poseidon import DefaultParams, poseidon

from torch_port_helpers import rand_ints, torch_threads  # noqa: F401

P = SNARK_SCALAR_FIELD


def test_sha256_trace_matches_reference():
    """Four 96-byte messages (two blocks each): the final state is each
    message's digest and every one of the 2 x 1264 trace words equals the
    reference trace's."""
    import jax.numpy as jnp
    from ethsnarks_tpu.ops.sha256_ops import sha256_witness_trace as ref

    rng = np.random.default_rng(1)
    msgs = [rng.bytes(96) for _ in range(4)]
    blocks = np.moveaxis(np.stack([_padded_words(m, 96 * 8) for m in msgs]),
                         0, 2)                          # (2, 16, 4)
    final, ops = sha256_witness_trace(torch.from_numpy(blocks.copy()))
    want_final, want_ops = ref(jnp.asarray(blocks.astype(np.uint32)))
    assert ops.shape == (2, WORDS_PER_COMP, 4)
    assert ops.dtype == torch.int64
    assert np.array_equal(ops.numpy(), np.asarray(want_ops).astype(np.int64))
    assert np.array_equal(final.numpy(),
                          np.asarray(want_final).astype(np.int64))
    for i, m in enumerate(msgs):
        assert b''.join(int(final[w, i]).to_bytes(4, 'big')
                        for w in range(8)) == hashlib.sha256(m).digest()
    # words below 2^32; a carry word is the whole carry of its addition
    # (t1's five words carry up to 4), not a bit
    assert int(ops.min()) >= 0 and int(ops.max()) < 1 << 32
    assert int(ops[:, 288 + 4:288 + 960:15].max()) >= 2


def _state(values, t, B):
    """t x B ints (column j is state element j) -> (16, t, B)."""
    return Fr.ints_to_h16(values, 'cpu', mont=True).reshape(NH, t, B)


def test_poseidon_witness_matches_reference():
    """Four full-width random states: the final state and the (105, 3)
    sbox values of each lane equal the reference trace's."""
    import jax.numpy as jnp
    from ethsnarks_tpu.ops.fp import Fr as RefFr
    from ethsnarks_tpu.ops.poseidon_ops import _poseidon_witness_jit

    t, B = DefaultParams.t, 4
    vals = rand_ints(t * B, P, seed=2)
    final, aux = poseidon_witness_device(_state(vals, t, B))
    assert aux.shape == (105, 3, NH, B)
    ref_state = np.stack([np.asarray(RefFr.to_mont_jit(RefFr.to_limbs_fast(
        vals[j * B:(j + 1) * B]))) for j in range(t)], axis=1)
    w_final, w_aux = _poseidon_witness_jit(jnp.asarray(ref_state))

    def ref_ints(x, lead):
        flat = jnp.moveaxis(x, lead, 0).reshape(x.shape[lead], -1)
        return [int(v) for v in RefFr.from_limbs_fast(np.asarray(
            RefFr.from_mont_jit(flat)))]

    got_aux = Fr.h16_to_ints(aux.permute(2, 0, 1, 3).reshape(NH, -1),
                             mont=True)
    assert got_aux == ref_ints(w_aux, 2)
    got_final = Fr.h16_to_ints(final.reshape(NH, -1), mont=True)
    assert got_final == ref_ints(w_final, 0)
    lanes = [[vals[j * B + b] for j in range(t)] for b in range(B)]
    assert [got_final[j * B:(j + 1) * B] for j in range(t)] == \
        [[poseidon(s, chained=True)[j] for s in lanes] for j in range(t)]


def test_poseidon_permutation_matches_host():
    t, B = DefaultParams.t, 3
    vals = rand_ints(t * B, P, seed=3)
    out = Fr.h16_to_ints(poseidon_permutation(_state(vals, t, B)).reshape(
        NH, -1), mont=True)
    for b in range(B):
        lane = [vals[j * B + b] for j in range(t)]
        assert [out[j * B + b] for j in range(t)] == \
            poseidon(lane, chained=True)


@pytest.mark.parametrize('width', [1, 2, 5])
def test_poseidon_device_matches_host(width):
    rows = [tuple(rand_ints(width, P, seed=10 * width + i)) for i in range(3)]
    assert poseidon_device(rows, device='cpu') == \
        [poseidon(list(r)) for r in rows]


def test_poseidon_device_chained_matches_host():
    rows = [tuple(rand_ints(6, P, seed=20 + i)) for i in range(2)]
    assert poseidon_device(rows, chained=True, device='cpu') == \
        [poseidon(list(r), chained=True) for r in rows]
    with pytest.raises(ValueError):
        poseidon_device(rows, device='cpu')


@pytest.mark.parametrize('width,k', [(1, 0), (2, 12345)])
def test_mimc_hash_device_matches_host(width, k):
    msgs = [tuple(rand_ints(width, P, seed=30 + i)) for i in range(3)]
    assert mimc_hash_device(msgs, k, device='cpu') == \
        [mimc_hash(list(m), k) for m in msgs]


@pytest.mark.parametrize('e', [1, 2, 5, 7, P - 2])
def test_pow_const_matches_host(e):
    vals = rand_ints(4, P, seed=40) + [0, 1, P - 1]
    got = Fr.pow_const(Fr.ints_to_h16(vals, 'cpu', mont=True), e)
    assert Fr.h16_to_ints(got, mont=True) == [pow(v, e, P) for v in vals]


@pytest.mark.parametrize('k', [1, 2, 6, 9])
def test_sum_axis_matches_host(k):
    vals = rand_ints(3 * k * 2, P, seed=50 + k)
    vals[0:2 * k:2] = [P - 1] * k                # lane (0, 0): the largest sum
    x = Fr.ints_to_h16(vals, 'cpu').reshape(NH, 3, k, 2)
    got = Fr.h16_to_ints(Fr.sum_axis(x, 2).reshape(NH, -1))
    want = [sum(vals[(i * k + j) * 2 + b] for j in range(k)) % P
            for i in range(3) for b in range(2)]
    assert got == want

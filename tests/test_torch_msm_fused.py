"""The port's dense all-windows MSM (ethsnarks_tpu_torch.ops.msm_dense: K1
halving tree, K5 bucket_fold, K3 window Horner, host group Horner, the
fallbacks to the scan MSM; plain path on the CPU) and K5's plain version,
against exact host sums of the JAX package's bn254, and the reference's
capacity plan (pallas_msm._window_ks, _nice_k) against its copy.  The
Pallas fused kernels do not run on the CPU, so the drivers are held to
the host sums, on the cases of tests/test_msm.py and the floods and narrow
top window of tests/test_msm_red.py."""
import json
import os

import numpy as np
import pytest
import torch

from ethsnarks_tpu.bn254 import CURVE_ORDER, multiply, add
from ethsnarks_tpu.ops.pallas_msm import _nice_k, _window_ks

from ethsnarks_tpu_torch.groth16 import ProverContext
from ethsnarks_tpu_torch.ops import curve, fold, kernels, msm, msm_dense
from ethsnarks_tpu_torch.ops.fp import ints_to_words_np
from ethsnarks_tpu_torch.serialization import read_pk_binary, \
    r1cs_from_dict, witness_from_json

from torch_port_helpers import affine, host_points, rand_scalars, \
    torch_threads  # noqa: F401

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                       "ethsnarks_tpu_torch", "fixtures", "mimc_chain_10")


def _host_msm(scalars, points):
    out = None
    for s, p in zip(scalars, points):
        out = add(out, multiply(p, s % CURVE_ORDER) if p else None)
    return out


def _narrow(scalars, c=7, nw=2):
    return torch.tensor([[(s >> (w * c)) & ((1 << c) - 1) for s in scalars]
                         for w in range(nw)], dtype=torch.int64)


def _dense(scalars, points, c, digits=None, g2=False, **kw):
    pts = (curve.g2_to_tensor if g2 else curve.g1_to_tensor)(points, 'cpu')
    if digits is None:
        digits = msm.window_digits(torch.from_numpy(
            ints_to_words_np(scalars)), c)
    kw.setdefault('min_points', 0)
    got, route = msm_dense.msm(pts, digits, c, g2, **kw)
    return affine(got), route


@pytest.mark.parametrize('g2,schedule', [
    (False, None), (False, (32, 2, 2)), (False, (32, 1, 4)),
    (False, (32, 128, 1)), (True, None), (True, (32, 1, 4))],
    ids=['g1', 'g1-2-blocks', 'g1-4-blocks', 'g1-1-thread', 'g2',
         'g2-4-blocks'])
def test_bucket_fold_plain_matches_host(g2, schedule):
    """K5's plain version, in every schedule shape (several threads and
    blocks a window, parts of 1-128 buckets), with empty buckets, against
    the host sum_b b * S_b of each window."""
    c, nw = 7, 2
    pts = host_points(8, g2) + [None]
    rng = np.random.default_rng(7)
    sel = rng.integers(0, len(pts), nw << c)
    B = (curve.g2_to_tensor if g2 else curve.g1_to_tensor)(
        [pts[i] for i in sel], 'cpu')
    got = (curve.tensor_to_g2 if g2 else curve.tensor_to_g1)(
        kernels.bucket_fold(B, nw, c, g2, schedule))
    for w in range(nw):
        want = _host_msm(list(range(1 << c)),
                         [pts[i] for i in sel[w << c:(w + 1) << c]])
        assert affine(got[w]) == affine(want)


def test_fold_schedule_splits_a_window():
    """One wave of blocks on the card, shared by the windows: 16 windows
    of 2^16 buckets on 132 SMs of 2 G1 blocks take 16 blocks a window of
    32 buckets a thread, 2 windows 128 blocks of 4 buckets a thread; at 3
    blocks an SM, 24 blocks of 22 buckets and 171 blocks of 3."""
    assert fold.fold_schedule(16, 16, False, 132, 2) == (128, 32, 16)
    assert fold.fold_schedule(2, 16, False, 132, 2) == (128, 4, 128)
    assert fold.fold_schedule(16, 16, False, 132, 3) == (128, 22, 24)
    assert fold.fold_schedule(2, 16, False, 132, 3) == (128, 3, 171)
    assert fold.fold_schedule(16, 16, True, 132, 4) == (64, 32, 32)
    assert fold.fold_schedule(1, 7, False, 2, 1, 32) == (32, 2, 2)
    assert fold.fold_schedule(1, 8, False, 3, 1, 32) == (32, 3, 3)
    for c in range(0, 25):
        for n_win in (1, 2, 16, 500):
            for g2, sms, blocks in ((False, 132, 3), (True, 132, 4),
                                    (False, 2, 1)):
                T, m, n_blk = fold.fold_schedule(n_win, c, g2, sms, blocks)
                assert fold.check_schedule(c, g2, (T, m, n_blk))
                assert (n_blk - 1) * T * m < 1 << c <= n_blk * T * m
                assert n_win * n_blk <= max(n_win, sms * blocks)
    with pytest.raises(ValueError):
        fold.fold_schedule(1, 6, True, 132, 3, 128)   # G2 blocks: 64
    with pytest.raises(ValueError):
        fold.check_schedule(8, False, (32, 2, 3))      # 192 < 256 buckets


def test_window_ks_and_nice_k_match_reference():
    rng = np.random.default_rng(8)
    for b, c in ((512, 7), (4096, 8), (300, 4)):
        d = rng.integers(0, 1 << c, (6, b))
        d[-1] = rng.integers(0, 3, b)               # narrow top window
        d[2, : b // 2] = 1                          # ones flood
        assert msm_dense.window_ks(b, c, torch.from_numpy(d)) == \
            _window_ks(b, c, d.astype(np.uint32))
    for need in range(0, 300):
        assert msm_dense.nice_k(need) == _nice_k(need)


@pytest.mark.parametrize('g2', [False, True], ids=['g1', 'g2'])
def test_dense_narrow_random(g2):
    n = 128 if g2 else 512
    rng = np.random.default_rng(5)
    s = [int(rng.integers(0, 1 << 14)) for _ in range(n)]
    pts = host_points(16, g2) * (n // 16)
    assert _dense(s, pts, 7, _narrow(s), g2) == \
        (affine(_host_msm(s, pts)), 'dense')


@pytest.mark.parametrize('flood', ['ones', 'equal_value', 'shared_digit'])
def test_dense_floods(flood):
    """Half the digits in one bucket: a window of its own capacity."""
    rng = np.random.default_rng(43)
    s = [int(rng.integers(0, 1 << 14)) for _ in range(256)]
    for i in range(0, 256, 2):
        s[i] = {'ones': 1, 'equal_value': 0x2A3B,
                'shared_digit': (int(rng.integers(0, 128)) << 7) | 5}[flood]
    pts = host_points(16) * 16
    assert _dense(s, pts, 7, _narrow(s)) == (affine(_host_msm(s, pts)),
                                             'dense')


def test_dense_254bit_narrow_top():
    """c = 8: 31 windows in groups and a 6-bit top window."""
    s = rand_scalars(64, 11, CURVE_ORDER)
    pts = host_points(16) * 4
    assert _dense(s, pts, 8) == (affine(_host_msm(s, pts)), 'dense')


@pytest.mark.parametrize('case', ['edge', 'infinity'])
def test_dense_reference_cases(case):
    """tests/test_msm.py: 0, 1, r - 1 and infinity points, narrow windows."""
    if case == 'edge':
        pts = host_points(3) + [host_points(1)[0]]
        s = [0, 1, (1 << 14) - 1, 2]
    else:
        pts = [host_points(1)[0], None, host_points(7)[6]]
        s = [3, 4, 5]
    assert _dense(s, pts, 7, _narrow(s)) == (affine(_host_msm(s, pts)),
                                             'dense')


@pytest.mark.parametrize('why', ['small', 'skew', 'overflow'])
def test_dense_falls_back_to_scan(why):
    rng = np.random.default_rng(6)
    s = [int(rng.integers(0, 1 << 14)) for _ in range(256)]
    for i in range(0, 256, 2):
        s[i] = 1
    pts = host_points(16) * 16
    kw = {'small': dict(min_points=None),
          'skew': dict(max_lanes=1 << 10),
          'overflow': dict(k=16)}[why]
    assert _dense(s, pts, 7, _narrow(s), **kw) == \
        (affine(_host_msm(s, pts)), 'scan:' + why)


def test_dense_all_zero_is_none():
    pts = host_points(16)
    assert _dense([0] * 16, pts, 7, _narrow([0] * 16)) == (None, 'dense')


def test_fused_prover_fixture_proof_matches_stored():
    """ProverContext(msm_impl='fused'): the fixture's proof, byte for byte.
    Its MSMs (548-1024 points) take the scan route, as the reference's
    dense drivers do below 2^13 (G1) and 2^11 (G2) points."""
    with open(os.path.join(FIXTURE, "r1cs.json")) as fh:
        cs = r1cs_from_dict(json.load(fh))
    ctx = ProverContext(read_pk_binary(os.path.join(FIXTURE, "pk.bin"),
                                       'cpu'), cs, device='cpu',
                        msm_impl='fused')
    proof = ctx.prove(witness_from_json(os.path.join(FIXTURE,
                                                     "witness.json")))
    with open(os.path.join(FIXTURE, "proof.json")) as fh:
        assert proof.to_json() == fh.read()
    assert set(ctx.last_routes.values()) == {'scan:small'}


def test_prover_rejects_unknown_msm_impl():
    with pytest.raises(ValueError):
        ProverContext(None, None, device='cpu', msm_impl='pallas')

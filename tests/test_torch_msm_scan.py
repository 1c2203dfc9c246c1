"""The port's scan MSM (ethsnarks_tpu_torch.ops.msm_scan: K6 seg_scan, K5
bucket_fold, the generic MSM's and the fused scan driver's window
combines; plain path on the CPU) against exact host sums of the JAX
package's bn254, on the cases of tests/test_msm.py and the floods of
tests/test_msm_red.py, and the reference's host helpers against their
copies.  The JAX generic MSM itself is not run: its cold CPU compile takes
minutes."""
import json
import os

import numpy as np
import pytest
import torch

from ethsnarks_tpu.bn254 import G1_GEN, G2_GEN, CURVE_ORDER, multiply, add
from ethsnarks_tpu.ops.msm import default_window_bits, window_digits_host_np

from ethsnarks_tpu_torch.groth16 import ProverContext
from ethsnarks_tpu_torch.ops import curve, fold, msm, msm_scan
from ethsnarks_tpu_torch.ops.fp import ints_to_words_np
from ethsnarks_tpu_torch.serialization import read_pk_binary, \
    r1cs_from_dict, witness_from_json

from torch_port_helpers import affine, host_points, rand_scalars, \
    torch_threads  # noqa: F401

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                       "ethsnarks_tpu_torch", "fixtures", "mimc_chain_10")
TILE = (2, 2)        # K6 tiles of 4 threads x 2 elements: 8 elements


def _host_msm(scalars, points):
    out = None
    for s, p in zip(scalars, points):
        out = add(out, multiply(p, s % CURVE_ORDER) if p else None)
    return out


def _scan_msm(scalars, points, c, g2=False, combine='double_add',
              digits=None):
    pts = (curve.g2_to_tensor if g2 else curve.g1_to_tensor)(points, 'cpu')
    if digits is None:
        digits = msm.window_digits(torch.from_numpy(
            ints_to_words_np(scalars)), c)
    res = msm_scan.msm_tensor(pts, digits, c, g2, combine, TILE)
    return None if res is None else affine(
        (curve.tensor_to_g2 if g2 else curve.tensor_to_g1)(res)[0])


@pytest.mark.parametrize('g2', [False, True], ids=['g1', 'g2'])
def test_seg_scan_matches_host_segmented_sums(g2):
    """Runs crossing tiles and levels, never-merging keys -2 and -1, and a
    gather through idx."""
    n = 96 if g2 else 300
    rng = np.random.default_rng(3)
    pts = host_points(8, g2) + [None]
    keys = np.sort(rng.integers(0, 6, n))
    keys[:2], keys[2:4] = -2, -1
    idx = rng.integers(0, len(pts), n)
    P = (curve.g2_to_tensor if g2 else curve.g1_to_tensor)(pts, 'cpu')
    got = (curve.tensor_to_g2 if g2 else curve.tensor_to_g1)(
        msm_scan.seg_scan(P, torch.from_numpy(keys), torch.from_numpy(idx),
                          g2, TILE))
    acc, want = None, []
    for j in range(n):
        merge = j > 0 and keys[j] == keys[j - 1] and keys[j] >= 0
        acc = add(acc, pts[idx[j]]) if merge else pts[idx[j]]
        want.append(affine(acc))
    assert [affine(p) for p in got] == want


def test_seg_scan_one_run_over_every_tile():
    """All keys equal: the carry travels through 64 tiles and two levels."""
    n = 512
    pts = host_points(16)
    P = curve.g1_to_tensor((pts * (n // 16)), 'cpu')
    out = msm_scan.seg_scan(P, torch.zeros(n, dtype=torch.int64), None,
                            False, TILE)
    got = curve.tensor_to_g1(out[[0, 255, 511]])
    total = _host_msm([n // 16] * 16, pts)
    assert affine(got[2]) == affine(total)
    assert affine(got[1]) == affine(_host_msm([16] * 16, pts))
    assert affine(got[0]) == affine(pts[0])


def _edge_scan_inputs(n, run_at, run_len, seed):
    """Sorted keys over n elements: -2, -2, -1, -1 (never merging), runs
    P, -P (P + (-P)), a run of one point repeated (P + P), one run of
    run_len elements from run_at, random short runs after it; and the
    index of each element's point among 8 multiples of the generator, their
    negations and infinity (index 16)."""
    rng = np.random.default_rng(seed)
    keys = np.zeros(n, dtype=np.int64)
    idx = rng.integers(0, 17, n)
    keys[:4] = [-2, -2, -1, -1]
    k, j = 0, 4
    while j < run_at:
        if j + 2 <= run_at and k % 3 < 2:
            keys[j:j + 2] = k
            idx[j], idx[j + 1] = k % 8, 8 + k % 8         # P then -P
            j += 2
        else:
            keys[j] = k
            j += 1
        k += 1
    keys[run_at - 8:run_at] = k                           # P + P
    idx[run_at - 8:run_at] = 3
    keys[run_at:run_at + run_len] = k + 1
    keys[run_at + run_len:] = k + 2 + np.sort(
        rng.integers(0, n // 4, n - run_at - run_len))
    return keys, idx


def _check_scan_by_value(g2, keys, idx, schedule, tile_local):
    """K6's plain version (tile_local: one launch) or the whole scan against
    the JAX package's host sums, and against multiples of the generator
    by the runs' sums of labels."""
    pts = host_points(8, g2)
    gen = G2_GEN if g2 else G1_GEN
    pts = pts + [multiply(p, CURVE_ORDER - 1) for p in pts] + [None]
    label = [j + 1 for j in range(8)] + [-(j + 1) for j in range(8)] + [0]
    P = (curve.g2_to_tensor if g2 else curve.g1_to_tensor)(pts, 'cpu')
    kt, it = torch.from_numpy(keys), torch.from_numpy(idx)
    if tile_local:
        out = fold.seg_scan_tile_plain(P, kt, it, g2, schedule)
        tile = schedule[1] << schedule[0]
    else:
        out = msm_scan.seg_scan(P, kt, it, g2, schedule)
        tile = len(keys)
    got = [affine(p) for p in
           (curve.tensor_to_g2 if g2 else curve.tensor_to_g1)(out)]
    neg = multiply(gen, CURVE_ORDER - 1)
    acc, lab, times = None, 0, {0: None}
    for j in range(len(keys)):
        merge = j % tile > 0 and keys[j] == keys[j - 1] and keys[j] >= 0
        acc = add(acc, pts[idx[j]]) if merge else pts[idx[j]]
        lab = lab + label[idx[j]] if merge else label[idx[j]]
        if lab not in times:
            times[lab] = multiply(gen if lab > 0 else neg, abs(lab))
        assert got[j] == affine(acc), j
        assert got[j] == affine(times[lab]), j


@pytest.mark.parametrize('g2,schedule,n,run_at,run_len,tile_local', [
    (False, (0, 32), 512, 20, 480, False),   # a run over 16 tiles of 32
    (False, (2, 32), 500, 40, 300, True),    # longer than a tile, one launch
    (False, (2, 32), 500, 40, 300, False),
    (False, (6, 2), 400, 30, 300, True),     # across the warps of a tile
    (False, (7, 1), 460, 50, 400, False),    # four warps, every level
    (False, None, 300, 24, 200, True),       # the default tiles, ragged
    (True, (0, 32), 240, 20, 200, False),
    (True, (6, 1), 200, 16, 150, True),
], ids=['g1-16tiles', 'g1-long-one-launch', 'g1-long', 'g1-warps',
        'g1-4warps', 'g1-default', 'g2-7tiles', 'g2-warps'])
def test_seg_scan_schedule_edges(g2, schedule, n, run_at, run_len,
                                 tile_local):
    """K6's schedule (trailing runs, warp shuffles, warps serially, walks
    from the carry) on its edge cases, by value."""
    keys, idx = _edge_scan_inputs(n, run_at, run_len, 21 + n)
    _check_scan_by_value(g2, keys, idx,
                         fold.scan_schedule(g2, *(schedule or (None, None))),
                         tile_local)


def test_window_digits_host_np_matches_reference():
    s = rand_scalars(40, 9, CURVE_ORDER) + [0, 1, CURVE_ORDER - 1]
    for c in (4, 7, 13):
        assert np.array_equal(msm_scan.window_digits_host_np(s, c),
                              window_digits_host_np(s, c))


def test_default_window_bits_matches_reference():
    for n in [1, 16, 32, 33, 100, 1 << 10, 1 << 16, 1 << 20, 1 << 24]:
        assert msm_scan.default_window_bits(n) == default_window_bits(n)


@pytest.mark.parametrize('combine', msm_scan.COMBINES)
def test_g1_random_512(combine):
    rng = np.random.default_rng(5)
    s = [int(rng.integers(0, 1 << 14)) for _ in range(512)]
    pts = (host_points(16) * 32)
    d = torch.tensor([[(x >> (7 * w)) & 127 for x in s] for w in range(2)])
    assert _scan_msm(s, pts, 7, combine=combine, digits=d) == \
        affine(_host_msm(s, pts))


@pytest.mark.parametrize('case', ['edge', 'infinity', 'duplicate'])
def test_g1_reference_cases(case):
    """tests/test_msm.py: 0, 1, r - 1; infinity points; equal scalars."""
    if case == 'edge':
        pts = [G1_GEN, multiply(G1_GEN, 2), multiply(G1_GEN, 3), G1_GEN]
        s = [0, 1, CURVE_ORDER - 1, 2]
    elif case == 'infinity':
        pts = [G1_GEN, None, multiply(G1_GEN, 7)]
        s = [3, 4, 5]
    else:
        pts = [multiply(G1_GEN, i + 1) for i in range(24)]
        s = [42] * 24
    assert _scan_msm(s, pts, 4) == affine(_host_msm(s, pts))


@pytest.mark.parametrize('flood', ['ones', 'equal_value', 'shared_digit'])
def test_g1_floods(flood):
    """tests/test_msm_red.py's floods: half the scalars 1, or one value, or
    distinct values sharing their low digit."""
    s = rand_scalars(64, 23, CURVE_ORDER)
    rng = np.random.default_rng(43)
    for i in range(0, 64, 2):
        if flood == 'ones':
            s[i] = 1
        elif flood == 'equal_value':
            s[i] = 0xABCDEF0123456789FEDCBA
        else:
            s[i] = ((int.from_bytes(rng.bytes(30), 'little') << 7) | 5) \
                % CURVE_ORDER
            s[i] = (s[i] & ~0x7f) | 5
    pts = host_points(16) * 4
    assert _scan_msm(s, pts, 7, combine='horner') == \
        affine(_host_msm(s, pts))


def test_g1_254bit_narrow_top():
    # c = 8: 32 windows, a 6-bit top window
    s = rand_scalars(64, 11, CURVE_ORDER)
    pts = host_points(16) * 4
    assert _scan_msm(s, pts, 8, combine='horner') == \
        affine(_host_msm(s, pts))


def test_g2_254bit():
    s = rand_scalars(16, 16, CURVE_ORDER)
    pts = host_points(16, True)
    assert _scan_msm(s, pts, 5, g2=True) == affine(_host_msm(s, pts))


def test_all_zero_is_none():
    pts = host_points(16)
    assert _scan_msm([0] * 16, pts, 7) is None


def test_g1_host_api_matches_host_sum():
    """tests/test_msm.py's shape: B = 32, c = 4."""
    s = rand_scalars(32, 12, CURVE_ORDER)
    pts = [multiply(G1_GEN, i + 3) for i in range(32)]
    assert affine(msm_scan.msm_g1_host_api(s, pts, c=4, device='cpu')) == \
        affine(_host_msm(s, pts))


def test_chunked_matches_host_sum():
    rng = np.random.default_rng(14)
    s = [int(rng.integers(0, 1 << 14)) for _ in range(256)]
    pts = host_points(16) * 16
    d = torch.from_numpy(window_digits_host_np(s, 7)[:2].astype(np.int64))
    got = msm_scan.msm_g1_chunked(curve.g1_to_tensor(pts, 'cpu'), d, 7,
                                  chunk=128)
    assert affine(got) == affine(_host_msm(s, pts))


def test_g2_host_api_matches_host_sum():
    s = rand_scalars(8, 13, CURVE_ORDER)
    pts = [multiply(G2_GEN, i + 5) for i in range(8)]
    assert affine(msm_scan.msm_g2_host_api(s, pts, c=4, device='cpu')) == \
        affine(_host_msm(s, pts))


def test_host_api_default_device_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        msm_scan.msm_g1_host_api([1], [G1_GEN])


def test_generic_prover_fixture_proof_matches_stored():
    """ProverContext(msm_impl='generic'): the fixture's proof, byte for
    byte (the reference's host prover made proof.json)."""
    with open(os.path.join(FIXTURE, "r1cs.json")) as fh:
        cs = r1cs_from_dict(json.load(fh))
    ctx = ProverContext(read_pk_binary(os.path.join(FIXTURE, "pk.bin"),
                                       'cpu'), cs, device='cpu',
                        msm_impl='generic')
    proof = ctx.prove(witness_from_json(os.path.join(FIXTURE,
                                                     "witness.json")))
    with open(os.path.join(FIXTURE, "proof.json")) as fh:
        assert proof.to_json() == fh.read()
    assert set(ctx.last_routes.values()) == {'scan'}

"""K2 ``point_double`` with n doublings in one call and K3 ``horner`` as
the red pairfold's tail and the scan MSM's window step (the port's plain
path on the CPU), against n single doublings, the loops of calls they
replace, the JAX package's red-core doubling and its bn254 host
arithmetic; K2's choice of path and the latency floor of
``ethsnarks_tpu_torch.cost`` as pure functions.  Exact comparisons
throughout."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ethsnarks_tpu import bn254 as ref
from ethsnarks_tpu.ops import fp_red

from ethsnarks_tpu_torch import bn254 as port, cost
from ethsnarks_tpu_torch.ops import curve, kernels, msm, msm_scan
from ethsnarks_tpu_torch.ops.fp import MONT_R, ints_to_words_np, \
    words_to_ints

from torch_port_helpers import affine, carry_edge_values, \
    torch_threads  # noqa: F401

Q = ref.FIELD_MODULUS


def _curve_points(n, g2, seed):
    """n port tensor points: multiples of the generator and identities."""
    rng = np.random.default_rng(seed)
    gen = port.G2_GEN if g2 else port.G1_GEN
    pts = [None if k % 5 == 0 else port.multiply(gen, int(k))
           for k in rng.integers(0, 1 << 30, n)]
    return (curve.g2_to_tensor if g2 else curve.g1_to_tensor)(pts, 'cpu')


def _carry_edges(n, g2, seed):
    rng = np.random.default_rng(seed)
    vals = carry_edge_values(Q, rng)
    pick = rng.integers(0, len(vals), n * (6 if g2 else 3))
    return torch.from_numpy(ints_to_words_np([vals[i] for i in pick])
                            ).reshape((n,) + curve.point_shape(g2))


def _doubles(P, g2, n):
    for _ in range(n):
        P = kernels.point_double(P, g2)
    return P


@pytest.mark.parametrize('g2', [False, True], ids=['g1', 'g2'])
@pytest.mark.parametrize('n', [1, 3])
def test_point_double_n_is_n_doublings(g2, n):
    """2^n P in one call equals n calls of one doubling word for word, on
    curve points with identities, P + (-P) (the identity in other
    coordinates) and carry-edge coordinates; on the curve points it is the
    JAX package's host 2^n P."""
    P = _curve_points(4, g2, 1)
    x, y, z = curve.unpack(P)
    neg = curve.pack([x, curve._field(g2).sub(torch.zeros_like(y), y), z])
    cases = [P, curve.point_add_plain(P, neg, g2=g2), _carry_edges(3, g2, 2)]
    for pts in cases:
        got = kernels.point_double(pts, g2, n)
        assert torch.equal(got, _doubles(pts, g2, n))
        assert torch.equal(got, curve.point_double_plain(pts, g2, n))
    back = curve.tensor_to_g2 if g2 else curve.tensor_to_g1
    assert [affine(p) for p in back(kernels.point_double(P, g2, n))] == \
        [affine(ref.multiply(h, 1 << n) if h else None) for h in
         _ref_points(back(P), g2)]
    assert all(p is None for p in back(cases[1]))


def _ref_points(pts, g2):
    """Port host points -> the JAX package's host points."""
    out = []
    for p in pts:
        if p is None:
            out.append(None)
        elif g2:
            out.append(tuple(ref.Fq2(list(c.coeffs)) for c in p))
        else:
            out.append((ref.Fq(p[0].n), ref.Fq(p[1].n)))
    return out


def test_point_double_n_matches_red_core():
    """Three plain doublings in one call against three of the JAX
    package's red-core G1 doublings, on carry-edge coordinates."""
    P = _carry_edges(8, False, 3)
    rinv = pow(MONT_R, -1, Q)
    vals = [v * rinv % Q for v in words_to_ints(P)]
    F = fp_red.red_field(Q)
    ops = fp_red.mk_red_ops(F.packed_consts(), engine='xla')
    red = tuple(jnp.asarray(F.to_mont(vals[i::3])) for i in range(3))
    for _ in range(3):
        red = fp_red.g1_double_red(ops, red)
    cols = [[int(v) for v in F.from_mont(np.asarray(x))] for x in red]
    got = [v * rinv % Q for v in words_to_ints(kernels.point_double(P, n=3))]
    assert got == [cols[k][i] for i in range(8) for k in range(3)]


def _old_pairfold_tail(totals, g2):
    """The reference's tail of the pairfold (``msm_red.py:337-376``), call
    by call: acc = 2 acc + t, one K2 and one K1 call a total."""
    acc = totals[0]
    for t in totals[1:]:
        acc = kernels.point_add(kernels.point_double(acc, g2), t, g2=g2)
    return acc


@pytest.mark.parametrize('g2', [False, True], ids=['g1', 'g2'])
def test_pairfold_tail_is_the_loop(g2):
    """msm.pairfold with its K3 tail equals the loop of doublings and adds
    word for word on the same buckets (identities among them), and the
    tail alone is that loop over any totals."""
    nw, c = 3, 4 if g2 else 5
    dense = _curve_points(nw << c, g2, 4)
    totals = [_curve_points(nw, g2, 10 + j) for j in range(c)]
    assert torch.equal(kernels.horner(torch.stack(totals[::-1]), 1, g2),
                       _old_pairfold_tail(totals, g2))
    got = msm.pairfold(dense, nw, c, g2)
    back = curve.tensor_to_g2 if g2 else curve.tensor_to_g1
    B = back(dense)
    want = []
    for w in range(nw):
        acc = None
        for b in range(1, 1 << c):
            if B[(w << c) + b] is not None:
                acc = port.add(acc, port.multiply(B[(w << c) + b], b))
        want.append(affine(acc))
    assert [affine(p) for p in back(got)] == want


@pytest.mark.parametrize('g2', [False, True], ids=['g1', 'g2'])
def test_scan_window_step_is_the_loop(g2):
    """The scan MSM's 'double_add' combine (one K2 call with n = c and one
    K1 call a window) equals c single doublings and an add a window, word
    for word, and the K3 combine by value."""
    nw, c = 3, 5
    wins = _curve_points(nw, g2, 5)
    acc = wins[-1:]
    for w in range(nw - 2, -1, -1):
        acc = kernels.point_add(_doubles(acc, g2, c), wins[w:w + 1], g2=g2)
    got = msm_scan.combine_windows(wins, c, g2, 'double_add')
    assert torch.equal(got, acc)
    back = curve.tensor_to_g2 if g2 else curve.tensor_to_g1
    assert back(got) == back(msm_scan.combine_windows(wins, c, g2, 'horner'))


@pytest.mark.parametrize('g2', [False, True], ids=['g1', 'g2'])
@pytest.mark.parametrize('design', ['red', 'scan'])
def test_msms_match_host_sums(design, g2):
    """The red and scan MSMs on numpy-drawn scalars of two 6-bit windows
    against the port's bn254 host sum and the JAX package's bn254."""
    rng = np.random.default_rng(21 + g2)
    n, c = 64, 6
    scalars = [int(v) for v in rng.integers(0, 1 << (2 * c), n)]
    gen = port.G2_GEN if g2 else port.G1_GEN
    pts = [port.multiply(gen, j + 1) for j in range(n)]
    P = (curve.g2_to_tensor if g2 else curve.g1_to_tensor)(pts, 'cpu')
    d = torch.tensor([[(s >> (c * w)) & ((1 << c) - 1) for s in scalars]
                      for w in range(2)])
    if design == 'red':
        got = (msm.msm_g2 if g2 else msm.msm_g1)(P, d, c)
    else:
        got = (msm_scan.msm_g2 if g2 else msm_scan.msm_g1)(P, d, c)
    host = None
    for s, p in zip(scalars, pts):
        host = port.add(host, port.multiply(p, s))
    oracle = ref.multiply(ref.G2_GEN if g2 else ref.G1_GEN,
                          sum(s * (j + 1) for j, s in enumerate(scalars))
                          % ref.CURVE_ORDER)
    assert affine(got) == affine(host) == affine(oracle)


# (batch, g2, SMs, team path): the teams fill at most one warp a
# scheduler, 4 an SM: 16 G1 points or 4 G2 points an SM
DOUBLE_PATHS = [(1, False, 132, True), (16, False, 132, True),
                (2112, False, 132, True), (2113, False, 132, False),
                (1, True, 132, True), (16, True, 132, True),
                (528, True, 132, True), (529, True, 132, False),
                (1 << 14, False, 132, False), (16, True, 2, False),
                (8, True, 2, True), (32, False, 2, True),
                (33, False, 2, False)]


@pytest.mark.parametrize('batch,g2,sms,team', DOUBLE_PATHS)
def test_double_path_is_a_pure_choice(batch, g2, sms, team):
    assert kernels.double_team(batch, g2, sms) is team
    assert kernels.TEAM_LANES == {False: 8, True: 32}


def test_latency_floor():
    """The window combine of a 2^20 MSM (16 windows, c = 16) is 255 steps,
    its tail (16 windows, c = 1) 30; a G1 step is 2 levels of products, a
    G2 step 3."""
    assert cost.horner_steps(16, 16) == 255
    assert cost.horner_steps(16, 1) == 30
    assert cost.horner_steps(1, 16) == 0
    assert cost.latency_floor_ms(255, False, 5e-4) == pytest.approx(0.255)
    assert cost.latency_floor_ms(255, True, 5e-4) == pytest.approx(0.3825)
    assert cost.latency_floor_ms(16, True, 1e-3) == pytest.approx(0.048)

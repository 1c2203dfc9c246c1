"""The plain twins of the port's point kernels (ethsnarks_tpu_torch
ops.curve) against the JAX package's red-core point bodies (fp_red, eager:
the same RCB15 sequence, so the same projective coordinates) and against
exact affine host arithmetic; the port's proving-key reader against the
reference reader.  Exact comparisons throughout."""
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ethsnarks_tpu import bn254 as ref
from ethsnarks_tpu.ops import fp_red, msm_red
from ethsnarks_tpu import serialization as ref_ser

from ethsnarks_tpu_torch.ops import curve, kernels
from ethsnarks_tpu_torch.ops.fp import MONT_R, ints_to_words_np, \
    words_to_ints
from ethsnarks_tpu_torch.serialization import read_pk_binary

from torch_port_helpers import carry_edge_values, \
    torch_threads  # noqa: F401

Q = ref.FIELD_MODULUS
FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                       "ethsnarks_tpu_torch", "fixtures", "mimc_chain_10")


def _proj(points, lams, g2):
    """Host affine points (None = inf) and scalings -> projective int
    coordinates [(X, Y, Z)], Fq2 coordinates as (c0, c1) pairs."""
    out = []
    for p, lam in zip(points, lams):
        if g2:
            if p is None:
                out.append(((0, 0), (lam, 0), (0, 0)))
            else:
                L = ref.Fq2([lam, 0])
                out.append(tuple(tuple(c.coeffs) for c in
                                 (p[0] * L, p[1] * L, L)))
        else:
            out.append((0, lam, 0) if p is None else
                       (p[0].n * lam % Q, p[1].n * lam % Q, lam))
    return out


def _flat(coords, g2):
    return [v for pt in coords for c in pt for v in (c if g2 else (c,))]


def _to_tensor(coords, g2):
    vals = [v * MONT_R % Q for v in _flat(coords, g2)]
    return torch.from_numpy(ints_to_words_np(vals).reshape(
        (-1,) + curve.point_shape(g2)))


def _from_tensor(t):
    rinv = pow(MONT_R, -1, Q)
    return [v * rinv % Q for v in words_to_ints(t)]


def _red(coords, g2):
    F = fp_red.red_field(Q)
    if g2:
        return tuple(tuple(jnp.asarray(F.to_mont([pt[i][k] for pt in coords]))
                           for k in range(2)) for i in range(3))
    return tuple(jnp.asarray(F.to_mont([pt[i] for pt in coords]))
                 for i in range(3))


def _red_ints(res, g2):
    F = fp_red.red_field(Q)
    leaves = [c for coord in res for c in coord] if g2 else list(res)
    cols = [[int(v) for v in F.from_mont(np.asarray(x))] for x in leaves]
    per = 6 if g2 else 3
    n = len(cols[0])
    return [cols[k][i] for i in range(n) for k in range(per)]


def _cases(g2, seed):
    """P, Q host points covering random pairs, P + P (same and other
    coordinates), P + (-P) and identities, with random Z scalings."""
    rng = np.random.default_rng(seed)
    gen = ref.G2_GEN if g2 else ref.G1_GEN
    base = [ref.multiply(gen, int(k)) for k in rng.integers(1, 1 << 30, 6)]
    P = base[:4] + [base[4], base[4], base[5], None, base[0], None]
    Qs = base[2:6] + [base[4], base[4], ref.neg(base[5]), base[1], None,
                      None]
    lp = [int(v) for v in rng.integers(1, 1 << 62, len(P))]
    lq = [int(v) for v in rng.integers(1, 1 << 62, len(P))]
    lq[4] = lp[4]                      # P + P with identical coordinates
    return P, Qs, _proj(P, lp, g2), _proj(Qs, lq, g2)


def _ops():
    return fp_red.mk_red_ops(fp_red.red_field(Q).packed_consts(),
                             engine='xla')


def _b3():
    b3 = msm_red._g2_b3_red()
    return (b3[:, 0:1], b3[:, 1:2])


@pytest.mark.parametrize('g2', [False, True], ids=['g1', 'g2'])
def test_add_matches_red_core(g2):
    _, _, cp, cq = _cases(g2, 1)
    got = kernels.point_add(_to_tensor(cp, g2), _to_tensor(cq, g2), g2=g2)
    if g2:
        want = fp_red.g2_add_red(_ops(), _b3(), _red(cp, g2), _red(cq, g2))
    else:
        want = fp_red.g1_add_red(_ops(), _red(cp, g2), _red(cq, g2))
    assert _from_tensor(got) == _red_ints(want, g2)


@pytest.mark.parametrize('g2', [False, True], ids=['g1', 'g2'])
def test_double_matches_red_core(g2):
    _, _, cp, _ = _cases(g2, 2)
    got = kernels.point_double(_to_tensor(cp, g2), g2)
    if g2:
        want = fp_red.g2_double_red(_ops(), _b3(), _red(cp, g2))
    else:
        want = fp_red.g1_double_red(_ops(), _red(cp, g2))
    assert _from_tensor(got) == _red_ints(want, g2)


def _carry_edge_coords(n, g2, seed):
    """n raw projective triples, off the curve, whose Montgomery words are
    :func:`carry_edge_values` (chip_smoke.py holds the kernels to these
    same plain results)."""
    rng = np.random.default_rng(seed)
    words = carry_edge_values(Q, rng)
    rinv = pow(MONT_R, -1, Q)
    vals = [words[i] * rinv % Q for i in
            rng.integers(0, len(words), n * (6 if g2 else 3))]
    if g2:
        return [tuple(tuple(vals[6 * i + 2 * c:6 * i + 2 * c + 2])
                      for c in range(3)) for i in range(n)]
    return [tuple(vals[3 * i:3 * i + 3]) for i in range(n)]


@pytest.mark.parametrize('g2', [False, True], ids=['g1', 'g2'])
def test_add_double_match_red_core_on_carry_edges(g2):
    """The RCB15 formulas are polynomials: on raw triples off the curve the
    plain add and double still equal the red core's, word for word."""
    cp, cq = _carry_edge_coords(32, g2, 5), _carry_edge_coords(32, g2, 6)
    got = kernels.point_add(_to_tensor(cp, g2), _to_tensor(cq, g2), g2=g2)
    dbl = kernels.point_double(_to_tensor(cp, g2), g2)
    if g2:
        want = fp_red.g2_add_red(_ops(), _b3(), _red(cp, g2), _red(cq, g2))
        want_dbl = fp_red.g2_double_red(_ops(), _b3(), _red(cp, g2))
    else:
        want = fp_red.g1_add_red(_ops(), _red(cp, g2), _red(cq, g2))
        want_dbl = fp_red.g1_double_red(_ops(), _red(cp, g2))
    assert _from_tensor(got) == _red_ints(want, g2)
    assert _from_tensor(dbl) == _red_ints(want_dbl, g2)


def _affine(pt):
    if pt is None:
        return None
    if hasattr(pt[0], 'coeffs'):
        return tuple(tuple(c.coeffs) for c in pt)
    return (pt[0].n, pt[1].n)


@pytest.mark.parametrize('g2', [False, True], ids=['g1', 'g2'])
def test_add_double_match_host(g2):
    P, Qs, cp, cq = _cases(g2, 3)
    back = curve.tensor_to_g2 if g2 else curve.tensor_to_g1
    tp, tq = _to_tensor(cp, g2), _to_tensor(cq, g2)
    assert [_affine(x) for x in back(kernels.point_add(tp, tq, g2=g2))] == \
        [_affine(ref.add(a, b)) for a, b in zip(P, Qs)]
    assert [_affine(x) for x in back(kernels.point_double(tp, g2))] == \
        [_affine(ref.double(a)) for a in P]


@pytest.mark.parametrize('g2', [False, True], ids=['g1', 'g2'])
def test_indexed_add_and_pass_through(g2):
    P, _, cp, _ = _cases(g2, 4)
    back = curve.tensor_to_g2 if g2 else curve.tensor_to_g1
    t = _to_tensor(cp, g2)
    ia = torch.tensor([3, 0, 7, 5], dtype=torch.int64)
    ib = torch.tensor([1, -1, 2, 5], dtype=torch.int64)
    got = [_affine(x) for x in back(kernels.point_add(t, t, ia, ib, g2))]
    assert got == [_affine(ref.add(P[3], P[1])), _affine(P[0]),
                   _affine(ref.add(P[7], P[2])), _affine(ref.double(P[5]))]


@pytest.mark.parametrize('g2', [False, True], ids=['g1', 'g2'])
def test_host_tensor_roundtrip(g2):
    P, _, _, _ = _cases(g2, 5)
    conv = curve.g2_to_tensor if g2 else curve.g1_to_tensor
    back = curve.tensor_to_g2 if g2 else curve.tensor_to_g1
    assert [_affine(x) for x in back(conv(_port_points(P, g2), 'cpu'))] == \
        [_affine(p) for p in P]


def _port_points(points, g2):
    from ethsnarks_tpu_torch import bn254 as port
    if g2:
        return [None if p is None else
                (port.Fq2(p[0].coeffs), port.Fq2(p[1].coeffs))
                for p in points]
    return [None if p is None else (port.Fq(p[0].n), port.Fq(p[1].n))
            for p in points]


def test_identity_is_zero_one_zero():
    for g2 in (False, True):
        assert _from_tensor(curve.identity(2, g2, 'cpu')) == \
            _flat(_proj([None, None], [1, 1], g2), g2)


@pytest.mark.parametrize('bad', ['dtype', 'shape', 'stride', 'index'])
def test_wrapper_rejects_bad_input(bad):
    t = curve.g1_to_tensor(_port_points(_cases(False, 6)[0], False), 'cpu')
    with pytest.raises(ValueError):
        if bad == 'dtype':
            kernels.point_add(t.to(torch.int64), t)
        elif bad == 'shape':
            kernels.point_double(t.reshape(-1, 4, 6))
        elif bad == 'stride':
            kernels.point_double(t[::2])
        else:
            kernels.point_add(t, t, torch.zeros(3, dtype=torch.int32))


def test_read_pk_binary_matches_reference():
    path = os.path.join(FIXTURE, "pk.bin")
    want = ref_ser.read_pk_binary(path)
    got = read_pk_binary(path, 'cpu')
    assert got.num_inputs == want.num_inputs
    assert _affine(got.alpha_g1) == _affine(want.alpha_g1)
    assert _affine(got.beta_g2) == _affine(want.beta_g2)
    assert _affine(got.delta_g2) == _affine(want.delta_g2)
    assert got.a_idx.tolist() == [i for i, _ in want.a_query]
    assert got.b_idx.tolist() == [i for i, _ in want.b_query]
    for pts, ref_pts, g2 in (
            (got.a_pts, [p for _, p in want.a_query], False),
            (got.b_pts, [p for _, p in want.b_query], True),
            (got.h_pts, want.h_query_bitrev, False),
            (got.l_pts, want.l_query, False)):
        back = curve.tensor_to_g2 if g2 else curve.tensor_to_g1
        assert [_affine(p) for p in back(pts)] == \
            [_affine(p) for p in ref_pts]

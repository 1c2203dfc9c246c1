"""The port's multi-device pieces (ethsnarks_tpu_torch.parallel) on meshes
of CPU devices, with the kernels' plain versions: ``make_mesh``, the
sharded NTT against the port's NttDomain word for word and the reference's
sharded ifft by value, the sharded witness map against the reference's
host witness map and the port's, and the sharded red and scan MSMs
against host sums (the reference's sharded MSM does not import, so it is
no oracle).  ``ProverContext(mesh=...)`` is in
test_torch_parallel_prover.py."""
import json
import os

import numpy as np
import pytest
import torch

from ethsnarks_tpu.bn254 import G1_GEN, G2_GEN, add, multiply
from ethsnarks_tpu.field import SNARK_SCALAR_FIELD as R
from ethsnarks_tpu.qap import QAP as RefQAP
from ethsnarks_tpu.serialization import r1cs_from_dict as ref_r1cs_from_dict
from ethsnarks_tpu.serialization import r1cs_to_dict

from ethsnarks_tpu_torch.field import CURVE_ORDER
from ethsnarks_tpu_torch.ops import curve
from ethsnarks_tpu_torch.ops.fp import Fr, ints_to_words_np, words_to_ints
from ethsnarks_tpu_torch.ops.msm import window_digits
from ethsnarks_tpu_torch.ops.msm_scan import to_host
from ethsnarks_tpu_torch.ops.ntt import NttDomain
from ethsnarks_tpu_torch.parallel import make_mesh, mesh as mesh_mod
from ethsnarks_tpu_torch.parallel.msm_red_sharded import ShardedRedMSM, \
    get_sharded_msm, shard_points
from ethsnarks_tpu_torch.parallel.msm_sharded import make_sharded_msm
from ethsnarks_tpu_torch.parallel.ntt_sharded import ShardedNttDomain
from ethsnarks_tpu_torch.parallel.qap_sharded import ShardedWitnessMap, \
    partition_rows
from ethsnarks_tpu_torch.qap import QAP
from ethsnarks_tpu_torch.serialization import r1cs_from_dict

from torch_port_helpers import affine, rand_ints, \
    torch_threads  # noqa: F401

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                       "ethsnarks_tpu_torch", "fixtures", "mimc_chain_10")


def cpu_mesh(n):
    return make_mesh(devices=['cpu'] * n)


def _ints(h):
    return Fr.h16_to_ints(h, mont=True)


# ---- make_mesh ----

def test_make_mesh_needs_a_card():
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError):
        make_mesh()
    with pytest.raises(RuntimeError):
        make_mesh(devices=['cuda:0'] * 2)


def test_make_mesh_refuses_more_cards_than_present(monkeypatch):
    monkeypatch.setattr(mesh_mod.torch.cuda, 'is_available', lambda: True)
    monkeypatch.setattr(mesh_mod.torch.cuda, 'device_count', lambda: 1)
    with pytest.raises(ValueError):
        make_mesh(2)
    assert make_mesh(1).devices == (torch.device('cuda', 0),)


def test_make_mesh_on_cpu_devices():
    m = cpu_mesh(4)
    assert m.devices == (torch.device('cpu'),) * 4
    assert len(m) == 4 and m.distinct() == [torch.device('cpu')]
    assert m == cpu_mesh(4) and hash(m) == hash(cpu_mesh(4))
    with pytest.raises(ValueError):
        cpu_mesh(3)                       # not a power of two
    with pytest.raises(ValueError):
        make_mesh(2, devices=['cpu'] * 4)


# ---- ShardedNttDomain ----

@pytest.mark.parametrize('n_dev', [1, 2, 4, 8])
def test_sharded_transforms_match_port_domain(n_dev):
    m = 16
    dom = NttDomain(m, 'cpu')
    sd = ShardedNttDomain(m, cpu_mesh(n_dev))
    x = Fr.ints_to_h16(rand_ints(2 * m, R, n_dev), 'cpu', mont=True)
    m_inv = Fr.const_mont(dom.m_inv, 'cpu')
    scale = Fr.mul(dom.coset_scale_m_inv_bitrev, Fr.const_mont(m, 'cpu'))

    def each(f, v):                       # the domain's map, per vector
        return torch.cat([f(v[:, :m]), f(v[:, m:])], dim=1)

    want = {
        'fft_coeffs_bitrev_to_evals_sharded': dom.dit(x, dom.tw_fwd),
        'ifft_evals_to_coeffs_bitrev_sharded':
            Fr.mul(dom.dif(x, dom.tw_inv), m_inv),
        'coset_fft_coeffs_bitrev_to_evals_sharded': dom.dit(
            each(lambda v: Fr.mul(v, scale), x), dom.tw_fwd),
        'icoset_fft_evals_to_coeffs_bitrev_sharded': each(
            lambda v: Fr.mul(v, dom.coset_unscale_m_inv_bitrev),
            dom.dif(x, dom.tw_inv)),
        'divide_by_z_on_coset_sharded': Fr.mul(x, dom.z_coset_inv)}
    for name, w in want.items():
        got = sd.gather(getattr(sd, name)()(sd.shard(x)))
        assert torch.equal(got, w), name
    assert sd.exchange_seconds >= 0


def test_sharded_ifft_matches_reference_sharded_ifft():
    """The reference's ShardedNttDomain(16, make_mesh(4)) ifft (this file's
    one jitted function of the JAX package), by value."""
    import jax
    from ethsnarks_tpu.ops.fp import Fr as RefFr
    from ethsnarks_tpu.parallel.mesh import make_mesh as ref_make_mesh
    from ethsnarks_tpu.parallel.ntt_sharded import \
        ShardedNttDomain as RefSharded
    from jax.sharding import NamedSharding, PartitionSpec
    m = 16
    vals = rand_ints(m, R, 5)
    ref_mesh = ref_make_mesh(4)
    ref = RefSharded(m, ref_mesh)
    limbs = jax.device_put(
        RefFr.to_limbs([v * RefFr.R % R for v in vals]),
        NamedSharding(ref_mesh, PartitionSpec(None, 'shard')))
    out = np.asarray(ref.ifft_evals_to_coeffs_bitrev_sharded()(limbs))
    rinv = pow(RefFr.R, -1, R)
    want = [v * rinv % R for v in RefFr.from_limbs(out)]
    sd = ShardedNttDomain(m, cpu_mesh(4))
    got = sd.gather(sd.ifft_evals_to_coeffs_bitrev_sharded()(
        sd.shard(Fr.ints_to_h16(vals, 'cpu', mont=True))))
    assert _ints(got) == want


# ---- ShardedWitnessMap ----

def test_partition_rows_is_stable():
    rows = np.array([5, 0, 7, 2, 4, 1, 6, 3, 0])
    order, bounds = partition_rows(rows, 2, 4)
    assert bounds.tolist() == [0, 3, 5, 7, 9]
    assert order.tolist() == [1, 5, 8, 3, 7, 0, 4, 2, 6]


def _cubic():
    from test_groth16 import _cubic_circuit
    return _cubic_circuit()


def _check_sharded_witness_map(ref_cs, port_cs, w, n_devs):
    want = RefQAP(ref_cs).witness_map_host(w)
    qap = QAP(port_cs, 'cpu')
    words = torch.from_numpy(ints_to_words_np(w))
    assert words_to_ints(qap.witness_map(words)) == want
    for n_dev in n_devs:
        wm = ShardedWitnessMap(qap, cpu_mesh(n_dev))
        shards = wm(words)
        assert [s.shape[0] for s in shards] == [qap.domain_size // n_dev] \
            * n_dev
        assert words_to_ints(torch.cat(shards)) == want, n_dev


def test_sharded_witness_map_cubic():
    pb = _cubic()
    _check_sharded_witness_map(pb, r1cs_from_dict(r1cs_to_dict(pb)),
                               pb.values, [2, 4])


def test_sharded_witness_map_mimc_chain():
    with open(os.path.join(FIXTURE, "r1cs.json")) as fh:
        d = json.load(fh)
    with open(os.path.join(FIXTURE, "witness.json")) as fh:
        w = [int(v) for v in json.load(fh)]
    _check_sharded_witness_map(ref_r1cs_from_dict(d), r1cs_from_dict(d), w,
                               [8])


# ---- ShardedRedMSM and make_sharded_msm ----

def _host_msm(scalars, points):
    out = None
    for s, p in zip(scalars, points):
        out = add(out, multiply(p, s))
    return out


def _points(n, g2=False, distinct=16):
    gen = G2_GEN if g2 else G1_GEN
    host = [multiply(gen, j + 1) for j in range(distinct)]
    host = (host * (n // distinct + 1))[:n]
    to = curve.g2_to_tensor if g2 else curve.g1_to_tensor
    return host, to(host, 'cpu')


def _digits(scalars, c):
    return window_digits(torch.from_numpy(ints_to_words_np(scalars)), c)


def _full_scalars(n, seed):
    rng = np.random.default_rng(seed)
    return [int.from_bytes(rng.bytes(32), 'little') % CURVE_ORDER
            for _ in range(n)]


MSM_CASES = {
    # tests/test_sharded_prover.py:40-68: full scalars at n = 128 over 4
    # shards; one repeated scalar at n = 256 (the skew that overflowed the
    # reference's static plan)
    'g1_full_128x4': (128, 4, False, 6, lambda n: _full_scalars(n, 3)),
    'g1_repeated_256x4': (256, 4, False, 6, lambda n: [12345] * n),
    'g2_full_12x2': (12, 2, True, 6, lambda n: _full_scalars(n, 9)),
    'g1_uneven_130x4': (130, 4, False, 6, lambda n: _full_scalars(n, 7)),
}


@pytest.mark.parametrize('case', sorted(MSM_CASES))
def test_sharded_red_msm(case):
    n, n_dev, g2, c, scalars = MSM_CASES[case]
    scalars = scalars(n)
    host, pts = _points(n, g2)
    mesh = cpu_mesh(n_dev)
    msm = get_sharded_msm(mesh, n, c, g2)
    assert msm is get_sharded_msm(mesh, n, c, g2)
    shards = msm.shard_points(pts)
    assert [s.shape[0] for s in shards] == \
        [t.shape[0] for t in torch.tensor_split(pts, n_dev)]
    assert affine(msm(shards, _digits(scalars, c))) == \
        affine(_host_msm(scalars, host))


def test_make_sharded_msm():
    """The scan MSM's shards share the splitting and the K1 combine with
    the red one's, so one vector is enough here (the scan MSM alone is
    tested in test_torch_msm_scan.py)."""
    n, n_dev, g2, c, scalars = MSM_CASES['g1_full_128x4']
    scalars = scalars(n)
    host, pts = _points(n, g2)
    mesh = cpu_mesh(n_dev)
    fn = make_sharded_msm(mesh, 'g2' if g2 else 'g1', c)
    got = to_host(fn(shard_points(mesh, pts), _digits(scalars, c)), g2)
    assert affine(got) == affine(_host_msm(scalars, host))


def test_sharded_msm_zero_shards_give_no_partial():
    """Shards whose digits are all zero (and empty shards: 3 points on 4
    devices) add nothing; all-zero digits give None."""
    host, pts = _points(3)
    msm = ShardedRedMSM(cpu_mesh(4), 3, 4)
    assert msm.sizes == [1, 1, 1, 0]
    scalars = [0, 0, 5]
    assert affine(msm(pts, _digits(scalars, 4))) == \
        affine(_host_msm(scalars, host))
    assert msm(pts, _digits([0, 0, 0], 4)) is None

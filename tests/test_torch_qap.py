"""The port's NTT domain and witness map (ethsnarks_tpu_torch ops.ntt, qap)
against a naive O(m^2) transform, the reference NttDomain's constants, and
the reference host witness map QAP.witness_map_host.  Exact."""
import json
import os

import numpy as np
import pytest
import torch

from ethsnarks_tpu.ops.fp import Fr as RefFr
from ethsnarks_tpu.ops.ntt import NttDomain as RefDomain
from ethsnarks_tpu.qap import QAP as RefQAP
from ethsnarks_tpu.serialization import r1cs_from_dict as ref_r1cs_from_dict

from ethsnarks_tpu_torch.field import SNARK_SCALAR_FIELD as R
from ethsnarks_tpu_torch.ops.fp import Fr, ints_to_words_np, words_to_ints
from ethsnarks_tpu_torch.ops.ntt import NttDomain
from ethsnarks_tpu_torch.qap import QAP
from ethsnarks_tpu_torch.serialization import r1cs_from_dict

from torch_port_helpers import torch_threads, rand_ints  # noqa: F401

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                       "ethsnarks_tpu_torch", "fixtures", "mimc_chain_10")


def _ints(h):
    return Fr.h16_to_ints(h, mont=True)


def _ref_ints(limbs):
    rinv = pow(RefFr.R, -1, R)
    return [v * rinv % R for v in RefFr.from_limbs(limbs)]


@pytest.mark.parametrize('m', [16, 64])
def test_domain_constants_match_reference(m):
    got, want = NttDomain(m, 'cpu'), RefDomain(m)
    assert (got.omega, got.omega_inv, got.m_inv, got.coset_gen) == \
        (want.omega, want.omega_inv, want.m_inv, want.coset_gen)
    assert got.bitrev.tolist() == [int(i) for i in want.bitrev]
    for s in range(got.k):
        assert _ints(got.stage_twiddles(got.tw_fwd, s)) == \
            _ref_ints(want.tw_fwd[s])
        assert _ints(got.stage_twiddles(got.tw_inv, s)) == \
            _ref_ints(want.tw_inv[s])
    assert _ints(got.coset_scale_m_inv_bitrev) == \
        _ref_ints(want.coset_scale_m_inv_bitrev)
    assert _ints(got.coset_unscale_m_inv_bitrev) == \
        _ref_ints(want.coset_unscale_m_inv_bitrev)
    assert _ints(got.z_coset_inv) == _ref_ints(want.z_coset_inv_mont)


@pytest.mark.parametrize('m', [16, 64])
def test_transforms_match_naive(m):
    d = NttDomain(m, 'cpu')
    coeffs = rand_ints(2 * m, R, m)              # two stacked vectors
    evals = [[sum(c * pow(d.omega, i * j, R) for i, c in
                  enumerate(coeffs[b * m:(b + 1) * m])) % R
              for j in range(m)] for b in range(2)]
    br = d.bitrev.tolist()
    x = Fr.ints_to_h16([coeffs[b * m + br[p]] for b in range(2)
                        for p in range(m)], 'cpu', mont=True)
    assert _ints(d.dit(x, d.tw_fwd)) == evals[0] + evals[1]
    back = Fr.mul(d.dif(Fr.ints_to_h16(evals[0] + evals[1], 'cpu',
                                       mont=True), d.tw_inv),
                  Fr.const_mont(d.m_inv, 'cpu'))
    assert _ints(back) == [coeffs[b * m + br[p]] for b in range(2)
                           for p in range(m)]


def _cubic():
    from test_groth16 import _cubic_circuit
    return _cubic_circuit()


def _check_witness_map(ref_cs, port_cs, w):
    want = RefQAP(ref_cs).witness_map_host(w)
    qap = QAP(port_cs, 'cpu')
    got = words_to_ints(qap.witness_map(
        torch.from_numpy(ints_to_words_np(w))))
    assert got == want


def test_witness_map_cubic():
    from ethsnarks_tpu.serialization import r1cs_to_dict
    pb = _cubic()
    _check_witness_map(pb, r1cs_from_dict(r1cs_to_dict(pb)), pb.values)


def test_witness_map_mimc_chain():
    """The two-link MiMC-e7 chain of the committed fixture."""
    with open(os.path.join(FIXTURE, "r1cs.json")) as fh:
        d = json.load(fh)
    with open(os.path.join(FIXTURE, "witness.json")) as fh:
        w = [int(v) for v in json.load(fh)]
    _check_witness_map(ref_r1cs_from_dict(d), r1cs_from_dict(d), w)


def test_constraint_system_from_dict():
    pb = _cubic()
    from ethsnarks_tpu.serialization import r1cs_to_dict
    cs = r1cs_from_dict(r1cs_to_dict(pb))
    assert (cs.num_inputs, cs.num_variables, cs.num_constraints) == \
        (pb.num_inputs, pb.num_variables, pb.num_constraints)
    assert cs.is_satisfied(values=pb.values)
    assert not cs.is_satisfied(values=[1, 36] + pb.values[2:])
    want, got = pb.to_coo(), cs.to_coo()
    for name in 'abc':
        assert sorted(zip(*map(list, want[name][:2]), want[name][2])) == \
            sorted(zip(*map(list, got[name][:2]), got[name][2]))

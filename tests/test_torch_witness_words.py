"""The witness map on Fr words (ethsnarks_tpu_torch ops.witness_words and
qap.WordWitnessMap) on the CPU, through the plain versions of K8 and K9:
the stacked CSR matrices against the COO sums, the pass plan, and the
word map against the plain map, bit for bit.  Small tiles give the CPU
maps the several passes and column bits that the card's 2^10 tile gives
a 2^20 domain.  Exact."""
import json
import os

import pytest
import torch

from ethsnarks_tpu_torch.field import SNARK_SCALAR_FIELD as R
from ethsnarks_tpu_torch.ops import kernels, witness_words as ww
from ethsnarks_tpu_torch.ops.fp import ints_to_words_np, words_to_ints
from ethsnarks_tpu_torch.qap import QAP, WordWitnessMap
from ethsnarks_tpu_torch.serialization import r1cs_from_dict

from torch_port_helpers import torch_threads  # noqa: F401
from torch_port_helpers import random_constraint_system

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                       "ethsnarks_tpu_torch", "fixtures", "mimc_chain_10")


def _words(vals):
    return torch.from_numpy(ints_to_words_np(vals))


def _coo_sums(coo, m, n, ni, w):
    """[A w with the input rows; B w; C w] as python ints, from the COO."""
    out = [0] * (3 * m)
    for b, name in enumerate('abc'):
        rows, cols, coeffs = coo[name]
        for r, c, v in zip(rows.tolist(), cols.tolist(), coeffs):
            out[b * m + r] = (out[b * m + r] + v * w[c]) % R
    for j in range(ni + 1):
        out[n + j] = (out[n + j] + w[j]) % R
    return out


def test_csr_layout_matches_coo_sums():
    m, ni = 64, 3
    cs, w = random_constraint_system(m, ni, 20, 11, seed=1)
    coo = cs.to_coo()
    row_ptr, cols, order = ww.csr_layout(coo, m, cs.num_constraints, ni)
    assert row_ptr.shape == (3 * m + 1,) and row_ptr[0] == 0
    assert (row_ptr[1:] >= row_ptr[:-1]).all()
    entries = coo['a'][2] + [1] * (ni + 1) + coo['b'][2] + coo['c'][2]
    assert sorted(order.tolist()) == list(range(len(entries)))
    got = [sum(entries[order[j]] * w[cols[j]]
               for j in range(row_ptr[r], row_ptr[r + 1])) % R
           for r in range(3 * m)]
    assert got == _coo_sums(coo, m, cs.num_constraints, ni, w)
    assert row_ptr[1] - row_ptr[0] == 11       # the longest row stays whole
    with pytest.raises(ValueError, match="outside the domain"):
        ww.csr_layout(coo, 32, cs.num_constraints, ni)


def test_csr_matvec_plain_matches_coo_sums():
    m, ni = 32, 2
    cs, w = random_constraint_system(m, ni, 16, 9, seed=2)
    qap = QAP(cs, 'cpu')
    wm = WordWitnessMap(qap)
    got = kernels.csr_matvec(wm.row_ptr, wm.cols, wm.coeffs, _words(w))
    assert words_to_ints(got) == _coo_sums(cs.to_coo(), m,
                                           cs.num_constraints, ni, w)
    with pytest.raises(ValueError):
        kernels.csr_matvec(wm.row_ptr, wm.cols.long(), wm.coeffs, _words(w))
    with pytest.raises(ValueError, match="16 variables"):
        wm.matvecs(_words(w[:-1]))


@pytest.mark.parametrize('tile_log', [2, 3, 10])
def test_pass_plan_covers_every_stage_once(tile_log):
    for k in range(1, 23):
        ranges = ww.ntt_ranges(k, tile_log)
        assert [lo for lo, _, _ in ranges] == \
            [sum(t for _, t, _ in ranges[:j]) for j in range(len(ranges))]
        assert sum(t for _, t, _ in ranges) == k
        for lo, t, g in ranges:
            assert 1 <= t and t + g <= tile_log and (g <= lo or g == 0)
            assert t + g == min(tile_log, k) or lo + t == k
        plan = ww.pass_plan(k, tile_log)
        assert len(plan) == 3 * len(ranges) - 2
        done = []
        for r, steps in plan:
            for bit, what in ((ww.DIF_IN, 'dif'), (ww.SCALE, 'scale'),
                              (ww.DIT, 'dit'), (ww.COMBINE, 'combine'),
                              (ww.DIF_OUT, 'dif'), (ww.UNSCALE, 'unscale')):
                if steps & bit:
                    done.append((what, r) if what in ('dif', 'dit')
                                else (what,))
        assert done == [('dif', r) for r in ranges[::-1]] + [('scale',)] + \
            [('dit', r) for r in ranges] + [('combine',)] + \
            [('dif', r) for r in ranges[::-1]] + [('unscale',)]


def _fixture():
    with open(os.path.join(FIXTURE, "r1cs.json")) as fh:
        cs = r1cs_from_dict(json.load(fh))
    with open(os.path.join(FIXTURE, "witness.json")) as fh:
        w = [int(v) for v in json.load(fh)]
    return cs, w


@pytest.mark.parametrize('case, tile_log', [
    ('fixture', 10), ('fixture', 4), ('random', 3), ('random', 2)])
def test_word_map_matches_plain_map(case, tile_log):
    """m = 1024 in one pass (the card's tile) and in four; a random system
    at m = 2^7 with a row of 24 terms, 3 inputs, in six passes with column
    bits and in eight."""
    if case == 'fixture':
        cs, w = _fixture()
    else:
        cs, w = random_constraint_system(128, 3, 40, 24, seed=3)
    qap = QAP(cs, 'cpu')
    assert qap.word_map is None            # the CPU takes the plain map
    words = _words(w)
    got = WordWitnessMap(qap, tile_log)(words)
    assert got.dtype == torch.int32 and got.shape == (qap.domain_size, 8)
    assert torch.equal(got, qap.witness_map_plain(words))

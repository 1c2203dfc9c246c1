"""A whole run on the CPU at a tiny size, past the look for a card, with
the timed path broken underneath: ``correct`` has to come out false for
each fault the cells can have, and true with none.

- state unchanged: the batch's ``set_witness`` leaves the assignment as
  the previous request left it; where set-up fills the assignment, the
  witness map returns H as it found it (zeros) instead of computing it;
- half of the batch left out: half of the batch's hashes keep the
  previous request's values; where set-up fills the assignment, the
  prover gets its second half zeroed;
- an answer altered where it is produced: the proof's C plus the G1
  generator.

The exchange between chips does not exist on the one card these cells
use.
"""

import time

import pytest

from port_bench import harness

from .tiny import tiny_cell

CELLS = ['miximus29.prove', 'poseidon1024.batch']


@pytest.fixture(scope='module')
def cache(tmp_path_factory):
    return str(tmp_path_factory.mktemp('keys'))


class _Program(object):
    """The cell's program adapter with ``fill`` replaced."""

    def __init__(self, inner, fill):
        self.build = inner.build
        self.fill = fill


def _state_unchanged(cell, monkeypatch):
    if cell.spec['entry'] == 'fill_prove':
        calls = []
        inner = cell.program

        def fill(model, req):
            calls.append(req)
            return inner.fill(model, req) if len(calls) == 1 else {}
        cell.program = _Program(inner, fill)
    else:
        import torch
        from ethsnarks_tpu_torch.qap import QAP
        monkeypatch.setattr(
            QAP, 'witness_map', lambda self, w: torch.zeros(
                (self.domain_size, 8), dtype=w.dtype, device=w.device))


def _half_left_out(cell, monkeypatch):
    if cell.spec['entry'] == 'fill_prove':
        last = []
        inner = cell.program

        def fill(model, req):
            tuples = req['tuples']
            if last:
                half = len(tuples) // 2
                tuples = tuples[:half] + last[-1][half:]
            last.append(tuples)
            return inner.fill(model, {'tuples': tuples})
        cell.program = _Program(inner, fill)
    else:
        from ethsnarks_tpu_torch.groth16 import ProverContext
        prove = ProverContext.prove

        def halved(self, values, *a, **k):
            keep = self.pk.num_inputs + 1
            half = keep + (len(values) - keep) // 2
            return prove(self, list(values[:half])
                         + [0] * (len(values) - half), *a, **k)
        monkeypatch.setattr(ProverContext, 'prove', halved)


def _answer_altered(cell, monkeypatch):
    from ethsnarks_tpu_torch.bn254 import G1_GEN, add
    from ethsnarks_tpu_torch.groth16 import ProverContext
    from ethsnarks_tpu_torch.verifier import Proof
    prove = ProverContext.prove

    def altered(self, *a, **k):
        p = prove(self, *a, **k)
        return Proof(p.A, p.B, add(p.C, G1_GEN), p.input)
    monkeypatch.setattr(ProverContext, 'prove', altered)


FAULTS = {'none': None, 'state_unchanged': _state_unchanged,
          'half_left_out': _half_left_out,
          'answer_altered': _answer_altered}


@pytest.mark.parametrize('fault', list(FAULTS))
@pytest.mark.parametrize('name', CELLS)
def test_fault_fails_the_run(name, fault, cache, monkeypatch):
    cell = tiny_cell(name)
    if FAULTS[fault]:
        FAULTS[fault](cell, monkeypatch)
    out = harness.run(cell, 2 ** 31 + 101, 0.5, 0, 'cpu',
                      time.perf_counter(), cache=cache)
    assert out['attempted'] >= 1 and out['failed'] == 0
    assert out['correct'] is (fault == 'none'), out['checks']
    assert set(out['metrics']) == {'setup_s', 'prove_s' if
                                   name.startswith('miximus') else
                                   'batch_s'}

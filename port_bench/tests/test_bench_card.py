"""On the card: the command runs a cell end to end and its result line
keeps to the contract.  Skips without a card (decided inside the test).

    python3 -m pytest -p no:cacheprovider -m cuda port_bench/tests/test_bench_card.py
"""

import json
import subprocess
import sys

import pytest

from port_bench import spec


@pytest.mark.cuda
@pytest.mark.parametrize('trace', [0, 1])
def test_cell_runs_on_the_card(trace):
    import torch
    if not torch.cuda.is_available():
        pytest.skip('no CUDA card')
    cell = 'poseidon1024.batch'
    out = subprocess.run(
        [sys.executable, 'port_bench/run.py', '--workload', cell, '--seed',
         str(2 ** 31 + 7), '--seconds', '5', '--trace', str(trace)],
        cwd=spec.ROOT, capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line['correct'] is True
    assert list(line)[-1] == 'checks'
    assert line['device']['platform'] == 'gpu'
    assert line['device']['count'] == 1
    c = spec.Cell(cell)
    want = {m['name'] for m in (c.per_layer if trace else c.end_to_end)}
    assert set(line['metrics']) <= want
    if trace:
        assert line['device']['busy_s'] > 0
        for name, m in line['metrics'].items():
            if m['unit'] == '%':
                assert 0 < m['value'] <= 100, name
    else:
        assert set(line['metrics']) == want

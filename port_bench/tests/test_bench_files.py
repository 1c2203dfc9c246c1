"""The benchmark's files: every entry of BENCHMARK.json has its file, every
name and unit keeps to the allowed characters, every cell reports what
the contract asks, the harness finds a new cell by its name alone, and
nothing the harness loads is JAX or the JAX package."""

import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from port_bench import harness, spec

ROOT = spec.ROOT
BENCH = spec.benchmark()
NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.-]{1,16}$')
TEXT = re.compile(r'^[^\n\t]{1,200}$')
CELLS = [w['name'] for w in BENCH['workloads']]
METRICS = BENCH['end_to_end'] + BENCH['per_layer']


def test_top_level_keys():
    assert set(BENCH) == {'command', 'paths', 'run_seconds', 'configs',
                          'workloads', 'end_to_end', 'per_layer'}
    assert BENCH['command'] == ['python3', 'port_bench/run.py']
    assert BENCH['paths'] == ['port_bench']
    assert 1 <= BENCH['run_seconds'] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize('entry', BENCH['configs'],
                         ids=lambda c: c['name'])
def test_config_file(entry):
    assert set(entry) == {'name', 'source', 'file', 'reduced', 'why'}
    assert entry['file'] == 'port_bench/configs/%s.json' % entry['name']
    with open(os.path.join(ROOT, entry['file'])) as fh:
        cfg = json.load(fh)
    assert cfg['name'] == entry['name']
    assert cfg['source'] == entry['source']
    assert cfg['reduced'] == entry['reduced']
    assert cfg['mode'] in ('nozk', 'zk')
    assert TEXT.match(entry['source']) and TEXT.match(entry['why'])
    assert any(w['config'] == entry['name'] for w in BENCH['workloads'])


@pytest.mark.parametrize('name', CELLS)
def test_cell_loads_and_reports(name):
    cell = spec.Cell(name)
    e2e = {m['name'] for m in cell.end_to_end}
    assert 'setup_s' in e2e and len(e2e) >= 2
    assert cell.per_layer
    for m in cell.per_layer:
        assert m['moves'] in e2e, (m['name'], m['moves'])
        assert callable(cell.reader(m))
    assert cell.entry['chips'] in (1, 4)
    assert TEXT.match(cell.entry['why'])
    assert cell.spec['entry'] in ('prove', 'fill_prove')


@pytest.mark.parametrize('metric', METRICS, ids=lambda m: m['name'])
def test_metric_entry(metric):
    keys = {'name', 'unit', 'better', 'source'}
    if metric in BENCH['end_to_end']:
        keys |= {'bound'}
        assert metric['source'] in ('host_clock', 'device_trace')
        assert 0.01 <= metric['bound'] <= 0.25
    else:
        keys |= {'layer', 'moves'}
        assert TEXT.match(metric['layer'])
        assert metric['source'] in ('device_trace', 'program_span',
                                    'program_counter', 'host_clock')
    assert set(metric) - {'workloads'} == keys
    assert NAME.match(metric['name']) and UNIT.match(metric['unit'])
    assert metric['better'] in ('lower', 'higher')
    for cell in metric.get('workloads', []):
        assert cell in CELLS
    assert os.path.exists(os.path.join(spec.HERE, 'metrics',
                                       metric['name'] + '.py'))


def test_names_unique_and_allowed():
    for group in ('configs', 'workloads', 'end_to_end', 'per_layer'):
        names = [x['name'] for x in BENCH[group]]
        assert len(names) == len(set(names))
        assert all(NAME.match(n) for n in names)
    for w in BENCH['workloads']:
        assert NAME.match(w['config']) and NAME.match(w['traffic'])
    pairs = [(w['config'], w['traffic']) for w in BENCH['workloads']]
    assert len(pairs) == len(set(pairs))
    layers = {}
    for m in BENCH['per_layer']:
        layers.setdefault(m['name'].split('.')[0], set()).add(m['layer'])
    assert all(len(v) == 1 for v in layers.values())


def test_dummy_cell_found_by_name(tmp_path):
    """A cell added as files and an entry, no line of the harness
    changed, is found by its name."""
    shutil.copytree(spec.HERE, tmp_path / 'port_bench',
                    ignore=shutil.ignore_patterns('.cache', '__pycache__'))
    bench = json.loads(json.dumps(BENCH))
    bench['workloads'].append(dict(bench['workloads'][0],
                                   name='miximus29.dummy',
                                   traffic='members48_dummy'))
    (tmp_path / 'BENCHMARK.json').write_text(json.dumps(bench))
    src = tmp_path / 'port_bench'
    (src / 'traffic' / 'members48_dummy.json').write_text(json.dumps(
        {'kind': 'merkle_statements', 'leaves': 8, 'statements': 2}))
    (src / 'workloads' / 'miximus29.dummy.json').write_text(json.dumps(
        {'config': 'miximus29', 'entry': 'prove', 'why': 'a test'}))
    code = ("from port_bench import spec; c = spec.Cell('miximus29.dummy'); "
            "print(c.traffic['leaves'], c.spec['why'], "
            "sorted(m['name'] for m in c.per_layer)[:1])")
    out = subprocess.run([sys.executable, '-c', code], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split()[:3] == ['8', 'a', 'test']


def test_forbidden_names_compared_whole():
    saved = dict(sys.modules)
    try:
        sys.modules['ethsnarks_tpu_torch_probe_name'] = sys
        assert 'ethsnarks_tpu_torch_probe_name' not in \
            harness.forbidden_modules()
        sys.modules['ethsnarks_tpu.probe_name'] = sys
        assert 'ethsnarks_tpu.probe_name' in harness.forbidden_modules()
    finally:
        sys.modules.clear()
        sys.modules.update(saved)


def test_harness_loads_no_jax():
    """Every module of the harness and of the program's paths it drives,
    loaded in a fresh process: none has the top-level name jax, jaxlib,
    flax or ethsnarks_tpu, and none comes from benchmarks/."""
    code = """
import sys, glob, os
from port_bench import harness, spec, compare, devtrace, record, cost
from port_bench.traffic import generate
for name in [w['name'] for w in spec.benchmark()['workloads']]:
    cell = spec.Cell(name)
    for m in cell.end_to_end + cell.per_layer:
        cell.reader(m)
    cell.program.build  # the program's modules load on first build
import ethsnarks_tpu_torch.models, ethsnarks_tpu_torch.groth16
import ethsnarks_tpu_torch.serialization, ethsnarks_tpu_torch.merkletree
import ethsnarks_tpu_torch.ops.kernels
bad = harness.forbidden_modules()
bad += [n for n, m in sys.modules.items() if n.split('.')[0] == 'benchmarks']
print(' '.join(bad) or 'clean')
"""
    env = dict(os.environ)
    env.pop('JAX_PLATFORMS', None)
    out = subprocess.run([sys.executable, '-c', code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == 'clean'


def test_sources_import_no_jax():
    pat = re.compile(r'^\s*(from|import)\s+(jax|jaxlib|flax|ethsnarks_tpu|'
                     r'benchmarks)(\s|\.|$)', re.M)
    for dirpath, _, files in os.walk(spec.HERE):
        for f in files:
            if f.endswith('.py'):
                with open(os.path.join(dirpath, f)) as fh:
                    assert not pat.search(fh.read()), f


def test_run_refuses_without_card(tmp_path):
    """On a machine with no card the command exits non-zero and prints no
    result."""
    code = "import torch; print(torch.cuda.is_available())"
    has = subprocess.run([sys.executable, '-c', code], capture_output=True,
                         text=True, timeout=120).stdout.strip()
    if has == 'True':
        pytest.skip('a card is present')
    out = subprocess.run(
        [sys.executable, 'port_bench/run.py', '--workload',
         CELLS[0], '--seed', '1', '--seconds', '1', '--trace', '0'],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 2
    assert out.stdout.strip() == ''


def test_run_refuses_outside_a_checkout(tmp_path):
    """In a folder holding only BENCHMARK.json and port_bench/ the program
    is missing: non-zero exit, no result."""
    shutil.copytree(spec.HERE, tmp_path / 'port_bench',
                    ignore=shutil.ignore_patterns('.cache', '__pycache__'))
    shutil.copy(os.path.join(ROOT, 'BENCHMARK.json'), tmp_path)
    out = subprocess.run(
        [sys.executable, 'port_bench/run.py', '--workload', CELLS[0],
         '--seed', '1', '--seconds', '1', '--trace', '0'],
        cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ''

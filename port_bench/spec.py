"""The benchmark's files, found by name.

``BENCHMARK.json`` at the checkout's root lists the configurations, the
cells and the metrics.  Everything that belongs to one of them sits in a
file of its own under ``port_bench/``:

- ``configs/<config>.json``: the circuit, its arguments, the key seed,
  the mode and the deployment it stands for;
- ``workloads/<cell>.json``: the configuration, the traffic mix, the
  entry the window drives and how many requests the check samples;
- ``traffic/<traffic>.json``: the traffic mix's parameters, read by
  :mod:`.traffic.generate`;
- ``circuits/<circuit>.py``: how the program builds the circuit and
  fills its assignment from a request;
- ``reference/<circuit>.py``: the plain reference of the same circuit;
- ``metrics/<metric>.py``: one reader a metric.

A new configuration, cell or metric adds files and entries; no line here
changes.
"""

import importlib
import importlib.util
import json
import os
import re

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')


def _load_json(*parts):
    with open(os.path.join(*parts)) as fh:
        return json.load(fh)


def benchmark(root=ROOT):
    return _load_json(root, 'BENCHMARK.json')


def _checked(name):
    if not NAME.match(name):
        raise ValueError("not a name: %r" % (name,))
    return name


def _module(kind, name):
    """port_bench/<kind>/<name>.py as a module, loaded from its file (a
    name may hold dots, so not through the import system's dotted
    names)."""
    path = os.path.join(HERE, kind, _checked(name) + '.py')
    spec = importlib.util.spec_from_file_location(
        'port_bench.%s.%s' % (kind, name.replace('.', '_')), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell(object):
    """One cell with everything it names, loaded from its files."""

    def __init__(self, name, bench=None):
        bench = bench if bench is not None else benchmark()
        entries = {w['name']: w for w in bench['workloads']}
        if name not in entries:
            raise KeyError("no cell %r in BENCHMARK.json" % (name,))
        self.name = name
        self.entry = entries[name]
        self.spec = _load_json(HERE, 'workloads', _checked(name) + '.json')
        if self.spec['config'] != self.entry['config']:
            raise ValueError("cell %s: config %r in its file, %r in "
                             "BENCHMARK.json" % (name, self.spec['config'],
                                                 self.entry['config']))
        self.config = _load_json(HERE, 'configs',
                                 _checked(self.spec['config']) + '.json')
        self.traffic = _load_json(HERE, 'traffic',
                                  _checked(self.entry['traffic']) + '.json')
        self.chips = int(self.entry['chips'])
        circuit = _checked(self.config['circuit'])
        self.program = importlib.import_module(
            'port_bench.circuits.' + circuit)
        self.reference = importlib.import_module(
            'port_bench.reference.' + circuit)
        self.end_to_end = _metrics(bench['end_to_end'], name)
        self.per_layer = _metrics(bench['per_layer'], name,
                                  self.end_to_end)

    def reader(self, metric):
        """The reader of ``metric``: metrics/<metric>.py's ``read``."""
        return _module('metrics', metric['name']).read


def _metrics(entries, cell, reported=None):
    """The metrics a cell reports: those that list it, and those without a
    list whose end-to-end metric the cell reports."""
    names = None if reported is None else {m['name'] for m in reported}
    out = []
    for m in entries:
        if 'workloads' in m:
            if cell in m['workloads']:
                out.append(m)
        elif names is None or m['moves'] in names:
            out.append(m)
    return out

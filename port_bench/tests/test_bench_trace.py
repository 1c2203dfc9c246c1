"""The trace's reading on synthetic events: busy time is the union of the
device's activity inside the window (the window's own span mirrored on
the device is none of it), idle gaps are labelled by the host's phase."""

import pytest

from port_bench import devtrace
from port_bench.devtrace import WINDOW


def test_summarise_busy_gaps_and_labels():
    events = [
        (WINDOW, False, 100.0, 110.0),
        (WINDOW, True, 100.0, 110.0),     # the profiler's mirror
        ('k1', True, 99.0, 101.0),        # clipped to the window
        ('k2', True, 100.5, 102.0),       # overlaps k1
        ('copy', True, 104.0, 105.0),
        ('k1', True, 108.0, 112.0),       # clipped
        ('cpu_op', False, 101.0, 109.0),
    ]
    # host clock 1000 s behind the profiler's
    phases = [('fill', 0.0 - 900, 0.0 - 900)] + [
        ('prove.witness_upload', -898.0, -896.0),
        ('prove.witness_map', -896.0, -893.0)]
    out = devtrace.summarise(events, -900.0, phases)
    assert out['window_s'] == pytest.approx(10.0)
    assert out['busy_s'] == pytest.approx(2.0 + 1.0 + 2.0)
    ops = dict((n, s) for n, s in out['device_ops'])
    assert ops == pytest.approx({'k1': 1.0 + 2.0, 'k2': 1.5, 'copy': 1.0})
    gaps = dict((n, s) for n, s in out['idle_gaps'])
    # phases at 102-104 (upload) and 104-107 (map) on the profiler's
    # clock; gaps 102-104 (upload) and 105-108 (map 105-107, none 107-108)
    assert gaps == pytest.approx({'prove.witness_upload': 2.0,
                                  'prove.witness_map': 2.0, 'other': 1.0})


def test_no_device_activity():
    out = devtrace.summarise([(WINDOW, False, 0.0, 5.0)], 0.0, [])
    assert out['busy_s'] == 0.0
    assert dict(out['idle_gaps']) == pytest.approx({'other': 5.0})

"""The traced window: ``torch.profiler`` over the window, and what the
per-layer metrics and the ``breakdown`` read from it.

Device activity is every CUDA kernel, copy and memset event of the
profiler's trace.  The window is the span of a ``record_function`` the
harness opens around its loop, which also ties the profiler's clock to
the host's ``time.perf_counter``, so that each idle gap on the device is
labelled by the phase the host was in: the harness's own spans and the
program's ``last_profile`` phases, placed back in time from each call's
end.
"""

import time
import warnings
from contextlib import contextmanager

import torch

WINDOW = 'port_bench.window'
CUDA = torch.autograd.DeviceType.CUDA
NAME_CHARS = 160


class Trace(object):
    """The profiler around a window; :meth:`summary` after it."""

    def __init__(self):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts)
        self.host_start = None

    @contextmanager
    def window(self):
        warnings.filterwarnings('ignore', message='.*Profiler clears events')
        with self.prof:
            with torch.profiler.record_function(WINDOW):
                self.host_start = time.perf_counter()
                yield

    def _events(self):
        """(name, on the device, start_s, end_s) of every device event and
        of the host events of a second or more (the window's span among
        them), in the profiler's clock.  Host events are most of the
        trace and none else is read, so only their durations are."""
        out = []
        for e in self.prof.profiler.kineto_results.events():
            dev = e.device_type() == CUDA
            dur = e.duration_ns()
            if dev or dur >= 10 ** 9:
                start = e.start_ns()
                out.append((e.name(), dev, start * 1e-9,
                            (start + dur) * 1e-9))
        return out

    def summary(self, phases):
        """phases: (label, host_start, host_end) in perf_counter seconds ->
        :func:`summarise` of the trace."""
        return summarise(self._events(), self.host_start, phases)


def summarise(events, host_start, phases):
    """events: (name, on the device, start, end) in the profiler's clock,
    with the window's span among them; phases: (label, start, end) in
    perf_counter seconds, host_start the window's start there -> {busy_s,
    window_s, device_ops, idle_gaps}; busy_s 0 when the trace holds no
    device activity.  The window's span also shows on the device (the
    profiler mirrors a ``record_function`` there), and is no activity."""
    win = [e for e in events if e[0] == WINDOW and not e[1]]
    if not win:
        raise RuntimeError("the profiler lost the window's span")
    w0, w1 = win[0][2], win[0][3]
    offset = w0 - host_start
    dev = [(n, max(s, w0), min(e, w1)) for n, d, s, e in events
           if d and n != WINDOW and e > w0 and s < w1]
    by_name = {}
    for n, s, e in dev:
        by_name[n] = by_name.get(n, 0.0) + (e - s)
    dev = sorted((s, e) for _, s, e in dev)
    busy, gaps, cur_s, cur_e = 0.0, [], None, w0
    for s, e in dev:
        if cur_s is None or s > cur_e:
            if cur_s is not None:
                busy += cur_e - cur_s
            if s > cur_e:
                gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_s is not None:
        busy += cur_e - cur_s
    if cur_e < w1:
        gaps.append((cur_e, w1))
    idle = _label(gaps, [(label, a + offset, b + offset)
                         for label, a, b in phases])
    top = lambda d: sorted(([k[:NAME_CHARS], v] for k, v in d.items()),
                           key=lambda kv: -kv[1])[:10]
    return {'busy_s': busy, 'window_s': w1 - w0,
            'device_ops': top(by_name), 'idle_gaps': top(idle)}


def _label(gaps, phases):
    """Idle seconds by the phase they overlap ('other' where none): both
    lists sorted by start, phases disjoint."""
    phases = sorted(phases, key=lambda p: p[1])
    out = {}
    i = 0
    for g0, g1 in gaps:
        covered = 0.0
        while i < len(phases) and phases[i][2] <= g0:
            i += 1
        j = i
        while j < len(phases) and phases[j][1] < g1:
            label, p0, p1 = phases[j]
            ov = min(g1, p1) - max(g0, p0)
            if ov > 0:
                out[label] = out.get(label, 0.0) + ov
                covered += ov
            j += 1
        if g1 - g0 - covered > 0:
            out['other'] = out.get('other', 0.0) + (g1 - g0 - covered)
    return out

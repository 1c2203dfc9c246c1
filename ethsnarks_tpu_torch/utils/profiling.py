"""Block profiler with libff's enter_block / leave_block bracketing (own
copy of ``ethsnarks_tpu/utils/profiling.py``).

``leave_block(name, value)`` with a tensor ``value`` on a CUDA device
synchronises that device first, so the block's seconds include the work
queued on it.  ``inhibit_profiling_info`` turns every call into a no-op.

    from ethsnarks_tpu_torch.utils.profiling import block
    with block("FFT", sync_value=h):
        ...
"""

import time
from contextlib import contextmanager

import torch

inhibit_profiling_info = False

_stack = []
_records = []  # (depth, name, seconds)


def start_profiling():
    global _records
    _records = []


def enter_block(name, indent=True):
    if inhibit_profiling_info:
        return
    _stack.append((name, time.perf_counter()))
    print("%s(enter) %s" % ('  ' * (len(_stack) - 1), name))


def leave_block(name, value=None):
    """Close the innermost block, which must be ``name``; a CUDA tensor
    ``value`` has its device synchronised first."""
    if inhibit_profiling_info:
        return
    if isinstance(value, torch.Tensor) and value.device.type == 'cuda':
        torch.cuda.synchronize(value.device)
    if not _stack or _stack[-1][0] != name:
        print("(leave) %s [unmatched]" % name)
        return
    _, t0 = _stack.pop()
    dt = time.perf_counter() - t0
    _records.append((len(_stack), name, dt))
    print("%s(leave) %s [%.4fs]" % ('  ' * len(_stack), name, dt))


@contextmanager
def block(name, sync_value=None):
    enter_block(name)
    try:
        yield
    finally:
        leave_block(name, sync_value)


def print_summary():
    if inhibit_profiling_info:
        return
    print("-- profiling summary --")
    for depth, name, dt in _records:
        print("%s%-50s %.4fs" % ('  ' * depth, name, dt))


def print_mem(label=""):
    """The card's allocated bytes and its used / total memory; nothing
    without CUDA."""
    if not torch.cuda.is_available():
        return
    free, total = torch.cuda.mem_get_info()
    print("(mem) %s %d MiB allocated, %d MiB used / %d MiB" % (
        label, torch.cuda.memory_allocated() >> 20, (total - free) >> 20,
        total >> 20))

"""The benchmark's command: one run of one cell of ``BENCHMARK.json``.

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout.  The last line of standard output is
one JSON object (``correct``, ``attempted``, ``failed``, ``metrics``,
``device``, with ``--trace 1`` ``breakdown``, and ``checks`` last); the
numbers compared and their limits are also the last lines of standard
error.  Exits 2 without a result where no CUDA card is found (there is no
fallback to the CPU), 3 where the process loaded JAX or the JAX package,
1 on any other failure.  See :mod:`port_bench.harness`.
"""

import time

T0 = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# the checkout's root, not this folder, is where imports start
sys.path[:] = [ROOT] + [p for p in sys.path
                        if os.path.abspath(p or '.') != HERE]
# every build and kernel cache inside the checkout, at fixed paths
os.environ['TORCH_EXTENSIONS_DIR'] = os.path.join(ROOT, 'build',
                                                  'torch_extensions')
os.environ['TRITON_CACHE_DIR'] = os.path.join(ROOT, 'build', 'triton')

if __name__ == '__main__':
    from port_bench import harness
    sys.exit(harness.main(sys.argv[1:], T0))

"""The control: the plain reference put in the program's place with one
guarantee of the configuration broken, held to the same comparison as a
run.

    python3 port_bench/control.py --workload <cell> --seeds 1,2,3

The configurations state no precision; they state that each proof is the
deterministic nozk proof of its assignment.  The control breaks that as a
later change would be tempted to: its proof leaves the quotient H(t) Z(t)
out of C, as a prover that skipped the witness map would.  For each seed
it makes the cell's requests, takes as many as a run checks, and prints
the comparison's numbers; ``proof_mismatch`` above its limit is the
control failing, as it must.  It needs no card.
"""

import argparse
import json
import os
import sys
import time

if __name__ == '__main__':
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))

from port_bench import compare, spec  # noqa: E402
from port_bench.traffic import generate  # noqa: E402


def control_numbers(cell, seed):
    """The comparison's numbers with the control in the program's
    place, over the requests a run of ``cell`` checks."""
    pool = generate.make(cell.traffic, seed)['pool']
    k = 1 if cell.spec['entry'] == 'prove' else cell.spec['check_sample']
    answers = [(req, None, None) for req in pool[:k]]
    return compare.check(cell, answers, seed, control=True)


def main(argv):
    ap = argparse.ArgumentParser(prog='port_bench/control.py')
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seeds', required=True)
    a = ap.parse_args(argv)
    cell = spec.Cell(a.workload)
    for seed in [int(s) for s in a.seeds.split(',')]:
        t = time.perf_counter()
        numbers, info = control_numbers(cell, seed)
        print(json.dumps({'workload': a.workload, 'seed': seed,
                          'numbers': numbers, 'limits': compare.LIMITS,
                          'info': info,
                          'seconds': time.perf_counter() - t}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main(sys.argv[1:]))

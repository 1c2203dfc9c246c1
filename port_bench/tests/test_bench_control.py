"""The control fails the comparison, and the reference alone passes it,
at a size a test run can hold.  (The same control at each cell's own size
is ``python3 port_bench/control.py``.)"""

import pytest

from port_bench import compare, control
from port_bench.traffic import generate

from .tiny import tiny_cell


@pytest.mark.parametrize('name', ['miximus29.prove', 'poseidon1024.batch'])
@pytest.mark.parametrize('seed', [1, 2 ** 31 + 3, 77])
def test_control_fails_reference_passes(name, seed):
    cell = tiny_cell(name)
    numbers, _ = control.control_numbers(cell, seed)
    assert numbers['proof_mismatch'] > compare.LIMITS['proof_mismatch']
    assert numbers['reference_unsatisfied'] == 0
    # the reference's own proof in the program's place passes
    pool = generate.make(cell.traffic, seed)['pool']
    from port_bench.reference import groth16
    ref = cell.reference
    answers = []
    for req in pool[:2]:
        st = ref.Statement(cell.config['args'], req)
        shape = ref.shape(cell.config['args'])
        m = groth16.domain_size(shape['constraints'], shape['inputs'])
        sec = groth16.Secrets(cell.config['key_seed'], m)
        sums = groth16.RowSums(groth16.lagrange_at(sec.t, m))
        st.rows(sums)
        answers.append((req, groth16.expected_proof(sec, sums, st.inputs()),
                        st.values))
    numbers, _ = compare.check(cell, answers, seed)
    assert numbers == dict.fromkeys(compare.LIMITS, 0)

"""The comparison that decides ``correct``.

The program's answers are its proofs and, where the window fills the
assignment, the assignment it proved.  Once the window has closed, a
sample of the requests, drawn from the seed, is held to the plain
reference (:mod:`.reference`): the reference rebuilds the statement from
the request alone, works out the assignment in the circuit's variable
order and the expected nozk proof from the setup's secrets, and each
number below counts what differs.  All are exact comparisons, with the
limit 0:

- ``proof_mismatch``: checked proofs whose A, B, C or public inputs differ
  from the reference's;
- ``witness_mismatch``: values of the checked assignments that differ from
  the reference's;
- ``reference_unsatisfied``: rows of the reference's own assignment where
  a b != c (a broken reference or traffic, never the program).
"""

import random

from .reference import groth16

LIMITS = {'proof_mismatch': 0, 'witness_mismatch': 0,
          'reference_unsatisfied': 0}


def proof_ints(proof):
    """The program's Proof -> the reference's form, through the program's
    own JSON form (hex strings, G2 coordinates as [c1, c0])."""
    d = proof.to_dict()
    h = lambda v: int(v, 16)
    g2 = lambda p: (h(p[1]), h(p[0]))
    return {'A': (h(d['A'][0]), h(d['A'][1])),
            'B': (g2(d['B'][0]), g2(d['B'][1])),
            'C': (h(d['C'][0]), h(d['C'][1])),
            'input': [h(v) for v in d['input']]}


def sample(n, k, seed):
    """k of the n request indices, drawn from the seed; the last one
    always among them."""
    if n <= k:
        return list(range(n))
    rest = random.Random(seed).sample(range(n - 1), k - 1)
    return sorted(rest) + [n - 1]


def check(cell, answers, seed, control=False):
    """answers: [(request, proof as :func:`proof_ints`, assignment or
    None)] of the requests sampled -> ({number: value}, {info}).
    ``control`` puts the reference's own proof with its quotient left out
    in the program's place."""
    ref, args = cell.reference, cell.config['args']
    shape = ref.shape(args)
    m = groth16.domain_size(shape['constraints'], shape['inputs'])
    secrets = groth16.Secrets(cell.config['key_seed'], m)
    lagrange = groth16.lagrange_at(secrets.t, m)
    out = dict.fromkeys(LIMITS, 0)
    memo = {}
    for request, proof, values in answers:
        key = id(request)
        if key not in memo:
            st = ref.Statement(args, request)
            sums = groth16.RowSums(lagrange)
            st.rows(sums)
            out['reference_unsatisfied'] += sums.unsatisfied
            memo[key] = (st, groth16.expected_proof(secrets, sums,
                                                    st.inputs()), sums)
        st, expected, sums = memo[key]
        if control:
            proof = groth16.expected_proof(secrets, sums, st.inputs(),
                                           drop_quotient=True)
        if proof != expected:
            out['proof_mismatch'] += 1
        if values is not None:
            if len(values) != len(st.values):
                out['witness_mismatch'] += max(len(values), len(st.values))
            else:
                out['witness_mismatch'] += sum(
                    1 for a, b in zip(values, st.values) if a != b)
    return out, {'proofs_checked': len(answers),
                 'statements_checked': len(memo), 'domain': m}

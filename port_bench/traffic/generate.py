"""The one traffic generator: a traffic file's parameters and a seed ->
the requests of a run.  The same seed gives the same requests.

Kinds (the ``kind`` key of ``traffic/<traffic>.json``):

- ``merkle_statements``: ``leaves`` leaves uniform in [1, r) and
  ``statements`` distinct leaf indices; one request, proved again and
  again (derived from ``ethsnarks_tpu_torch/bench_merkle.py``'s
  ``build_tree`` and ``proof_indices``, whose leaves and indices are
  fixed; here both come from the seed);
- ``field_tuples``: a warm-up batch and a pool of ``pool`` batches, each
  ``batch`` tuples of ``arity`` values uniform in [0, r) (the draw of
  ``chip_smoke.py``'s ``poseidon_inputs``: 32 bytes from numpy's
  ``default_rng(seed)``, shifted right by 2, rejected at r or above).

:func:`key_rng` is the setup's draw of its secrets from a key seed
(``bench_merkle.seeded_rng``).
"""

import random

import numpy as np

R = 21888242871839275222246405745257275088548364400416034343698204186575808495617


def key_rng(seed):
    rng = random.Random(seed)
    return lambda: rng.randrange(1, R)


def field_values(rng, n):
    """n values uniform in [0, r) from a numpy Generator."""
    out = []
    while len(out) < n:
        raw = rng.bytes(32 * (n - len(out)) * 5 // 4 + 32)
        for i in range(0, len(raw) - 31, 32):
            v = int.from_bytes(raw[i:i + 32], 'little') >> 2
            if v < R:
                out.append(v)
                if len(out) == n:
                    break
    return out


def merkle_statements(params, seed):
    rng = random.Random(seed)
    n_leaves, n = params['leaves'], params['statements']
    leaves = [rng.randrange(1, R) for _ in range(n_leaves)]
    indices = sorted(rng.sample(range(n_leaves), n))
    request = {'leaves': leaves, 'indices': indices}
    return {'warmup': request, 'pool': [request]}


def field_tuples(params, seed):
    rng = np.random.default_rng(seed)
    k, b = params['arity'], params['batch']

    def batch():
        vals = field_values(rng, k * b)
        return {'tuples': [tuple(vals[k * i:k * i + k]) for i in range(b)]}
    warmup = batch()
    return {'warmup': warmup, 'pool': [batch() for _ in range(params['pool'])]}


KINDS = {'merkle_statements': merkle_statements,
         'field_tuples': field_tuples}


def make(params, seed):
    """-> {'warmup': request, 'pool': [request, ...]}: request i of the
    window is pool[i % len(pool)]."""
    return KINDS[params['kind']](params, seed)

"""Batched Poseidon permutation and its witness trace on tensors
(counterpart of ``ethsnarks_tpu/ops/poseidon_ops.py:23-181``).

Values are the port's Fr in Montgomery form, h16 layout (:mod:`.fp`:
int64 ``(16, *batch)``, limb axis first); a state is ``(16, t, B)``.  The
rounds run one after another on the state's device, each on the whole
batch (the reference's three ``lax.scan`` phases: the first full rounds,
the partial rounds, the last full rounds).  The MDS mix is one broadcast
Fr product over ``(16, t, t, B)`` and a modular sum over the input axis.
The round constants and the matrix are the host oracle's
(:mod:`..poseidon.permutation`), converted once and cached per (params,
device).
"""

import torch

from .. import resolve_device
from ..poseidon.permutation import DefaultParams
from .fp import NH, Fr

_PARAMS = {}


def params_device(params, device):
    """(C (16, nRounds), M (16, t, t, 1)) Montgomery h16 on ``device``.
    Keyed by the params object's id; the cache holds the object, so the id
    is not reused while the entry lives."""
    key = (id(params), str(device))
    hit = _PARAMS.get(key)
    if hit is None:
        t = params.t
        C = Fr.ints_to_h16(params.constants_C, device, mont=True)
        M = Fr.ints_to_h16([v for row in params.constants_M for v in row],
                           device, mont=True).reshape(NH, t, t, 1)
        hit = _PARAMS[key] = (params, C, M)
    return hit[1], hit[2]


def _mix(state, M):
    """MDS product: out[i] = sum_j M[i][j] state[j]; state (16, t, B)."""
    return Fr.sum_axis(Fr.mul(M, state[:, None, :, :]), axis=2)


def poseidon_permutation(state, params=None):
    """The Poseidon permutation of a (16, t, B) Montgomery state."""
    params = params or DefaultParams
    C, M = params_device(params, state.device)
    half_F = params.nRoundsF // 2
    for i in range(C.shape[1]):
        s = Fr.add(state, C[:, i, None, None])
        if i < half_F or i >= half_F + params.nRoundsP:
            s = Fr.pow_const(s, params.e)
        else:
            s = torch.cat([Fr.pow_const(s[:, :1], params.e), s[:, 1:]],
                          dim=1)
        state = _mix(s, M)
    return state


def poseidon_witness_device(state, params=None):
    """The permutation with every sbox's (x^2, x^4, x^5): (final (16, t,
    B), aux (n_sboxes, 3, 16, B)), the sboxes in circuit order (the first
    full rounds by (round, j), then the partial rounds, then the last full
    rounds), the values :class:`..gadgets.poseidon._FifthPower`
    allocates.  One trace fills the witness of every instance of a
    batch."""
    params = params or DefaultParams
    if params.e != 5:
        raise ValueError("the witness trace is for the x^5 sbox, not x^%d"
                         % params.e)
    C, M = params_device(params, state.device)
    half_F = params.nRoundsF // 2
    aux = []
    for i in range(C.shape[1]):
        s = Fr.add(state, C[:, i, None, None])
        full = i < half_F or i >= half_F + params.nRoundsP
        x = s if full else s[:, :1]
        x2 = Fr.mul(x, x)
        x4 = Fr.mul(x2, x2)
        x5 = Fr.mul(x4, x)
        # (16, n, B) x 3 -> (n, 3, 16, B): sbox j of the round first
        aux.append(torch.stack([x2, x4, x5]).permute(2, 0, 1, 3))
        state = _mix(x5 if full else torch.cat([x5, s[:, 1:]], dim=1), M)
    return state, torch.cat(aux)


def poseidon_device(inputs_batch, params=None, chained=False, device=None):
    """A batch of input tuples (ints, each of one length, below t unless
    ``chained``) through one batched permutation on ``device`` (None: the
    card) -> each tuple's state[0], or its whole state if ``chained``."""
    params = params or DefaultParams
    dev = resolve_device(device)
    t = params.t
    width = len(inputs_batch[0])
    if width > t or (width == t and not chained):
        raise ValueError("%d inputs exceed the rate of t = %d" % (width, t))
    n = len(inputs_batch)
    cols = [[row[j] for row in inputs_batch] if j < width else [0] * n
            for j in range(t)]
    state = Fr.ints_to_h16([v for col in cols for v in col], dev,
                           mont=True).reshape(NH, t, n)
    out = Fr.h16_to_ints(poseidon_permutation(state, params).reshape(NH, -1),
                         mont=True)
    if chained:
        return [[out[j * n + b] for j in range(t)] for b in range(n)]
    return out[:n]

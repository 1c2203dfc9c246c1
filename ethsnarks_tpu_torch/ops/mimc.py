"""Batched MiMC permutation, Miyaguchi-Preneel hash and witness trace on
tensors (counterpart of ``ethsnarks_tpu/ops/mimc.py:27-151``).

Values are the port's Fr in Montgomery form, h16 layout
(:mod:`.fp`: int64 ``(16, *batch)``, limb axis first).  A round is
x <- (x + k + c_i)^e by Fr products; the rounds run one after another on
the tensors' device, each on the whole batch (the reference's
``lax.scan``).  The round constants are the host oracle's Keccak chain
(:mod:`..mimc.permutation`), made on the host once and cached per device.
"""

import torch

from .. import resolve_device
from ..field import SNARK_SCALAR_FIELD
from ..mimc.permutation import constants_list, DEFAULT_EXPONENT, \
    DEFAULT_ROUNDS, DEFAULT_SEED
from .fp import NH, Fr

_constants = {}


def round_constants_mont(seed=DEFAULT_SEED, R=DEFAULT_ROUNDS, device='cpu'):
    """(16, R) h16 Montgomery round constants on ``device``."""
    key = (seed, R, str(device))
    if key not in _constants:
        _constants[key] = Fr.ints_to_h16(
            constants_list(seed, SNARK_SCALAR_FIELD, R), device, mont=True)
    return _constants[key]


def _round(x, k, c, e):
    """One round on h16 (16, B): the gadget's variables [t2, t4, (t6,)]
    and the round output (t^e)."""
    t = Fr.add(Fr.add(x, k), c)
    t2 = Fr.mul(t, t)
    t4 = Fr.mul(t2, t2)
    if e == 7:
        t6 = Fr.mul(t2, t4)
        return [t2, t4, t6], Fr.mul(t6, t)
    if e == 5:
        return [t2, t4], Fr.mul(t4, t)
    raise ValueError("MiMC exponent %r: 5 or 7" % (e,))


def mimc_permutation(x, k, constants, e=DEFAULT_EXPONENT):
    """E_k(x) on h16 Montgomery (16, B); constants (16, R)."""
    for r in range(constants.shape[1]):
        _, x = _round(x, k, constants[:, r:r + 1], e)
    return Fr.add(x, k)


def mimc_hash_batch(xs, k, seed=DEFAULT_SEED, e=DEFAULT_EXPONENT,
                    R=DEFAULT_ROUNDS):
    """Miyaguchi-Preneel over message columns: xs (16, n_msgs, B), k the
    initial key (16, B) -> (16, B)."""
    constants = round_constants_mont(seed, R, xs.device)
    for j in range(xs.shape[1]):
        x = xs[:, j]
        k = Fr.add(Fr.add(k, x), mimc_permutation(x, k, constants, e))
    return k


def mimc_permutation_trace(x, k, constants, e=DEFAULT_EXPONENT):
    """E_k(x) with every variable the cipher gadget allocates: (final,
    trace) with trace (16, R, n_aux, B), n_aux = 4 for e = 7 (t2, t4, t6,
    out) or 3 for e = 5 (t2, t4, out); the last round's out includes the
    + k, as the gadget's last round does."""
    R = constants.shape[1]
    rows = []
    for r in range(R):
        aux, x = _round(x, k, constants[:, r:r + 1], e)
        if r == R - 1:
            x = Fr.add(x, k)
        rows.append(torch.stack(aux + [x], dim=1))
    return x, torch.stack(rows, dim=1)


def mimc_mp_witness_device(left, right, iv, seed=DEFAULT_SEED,
                           R=DEFAULT_ROUNDS):
    """Witness of one MiMC-e7 Miyaguchi-Preneel node hash H(left, right)
    for a batch: left, right (16, B) h16 Montgomery; iv an int or a (16, B)
    tensor.  Returns (out (16, B), aux (16, 8R + 2, B)): both ciphers'
    traces and the two chaining values, exactly the variables
    :class:`..gadgets.mimc.MiyaguchiPreneel_OWF` allocates, in allocation
    order."""
    constants = round_constants_mont(seed, R, left.device)
    k0 = Fr.const_mont(iv, left.device) if isinstance(iv, int) else iv
    c1, tr1 = mimc_permutation_trace(left, k0, constants)
    mp1 = Fr.add(Fr.add(k0, left), c1)
    c2, tr2 = mimc_permutation_trace(right, mp1, constants)
    out = Fr.add(Fr.add(mp1, right), c2)
    shape = (tr1.shape[0], 4 * R, tr1.shape[-1])
    aux = torch.cat([tr1.reshape(shape), mp1[:, None],
                     tr2.reshape(shape), out[:, None]], dim=1)
    return out, aux


def mimc_hash_device(msgs, k=0, device=None):
    """Miyaguchi-Preneel hashes of a batch of messages (tuples of ints, each
    of one length) under one int key, by :func:`mimc_hash_batch` on
    ``device`` (None: the card) -> a list of ints."""
    dev = resolve_device(device)
    n, width = len(msgs), len(msgs[0])
    xs = Fr.ints_to_h16([m[j] for j in range(width) for m in msgs], dev,
                        mont=True).reshape(NH, width, n)
    return Fr.h16_to_ints(mimc_hash_batch(xs, Fr.const_mont(k, dev)),
                          mont=True)

"""Batched PureEdDSA verification on tensors (counterpart of
``ethsnarks_tpu/ops/eddsa_ops.py:23-74``; the ``eddsa16k`` row of
:mod:`..bench_workloads` times it at 16,384 signatures).

Per signature: lhs = s B (fixed base, 2-bit windows); t = the x of the
Pedersen hash ('EdDSA_Verify.RAM') of BITS(R.x) || BITS(A.x) || M, three
batched Fermat inversions in all (R.x, A.x, the hash's x); rhs = R + t A
(variable base).  The accept mask compares lhs and rhs projectively.
The host oracle is :class:`..eddsa.PureEdDSA`.
"""

import numpy as np
import torch

from .. import resolve_device
from ..eddsa import PureEdDSA
from .fp import ints_to_words_np
from . import jubjub_ops as jj

RAM_P13N = b'EdDSA_Verify.RAM'
S_BITS = 254


def _msg_bits(msgs, device):
    """Equal-length byte strings -> (8 len, B) int64 bits, MSB first in
    each byte (the host ``to_bits`` order)."""
    arr = np.frombuffer(b''.join(msgs), dtype=np.uint8).reshape(
        len(msgs), -1)
    bits = np.unpackbits(arr, axis=1).T.astype(np.int64)
    return torch.from_numpy(np.ascontiguousarray(bits)).to(device)


def _scalar_bits(values, device, nbits=S_BITS):
    """Ints below 2^256 -> (nbits, B) int64 bits, LSB first."""
    words = ints_to_words_np(values).view(np.uint8)
    bits = np.unpackbits(words, axis=1, bitorder='little')[:, :nbits]
    return torch.from_numpy(np.ascontiguousarray(bits.T.astype(
        np.int64))).to(device)


def prepare(As, sigs, msgs, device):
    """The host's part: keys A (affine Points), signatures (R, s) and
    byte messages of one length -> the tensors of
    :func:`eddsa_verify_device` on ``device``."""
    a = jj.point_to_device(As, device)
    r = jj.point_to_device([sig[0] for sig in sigs], device)
    s_bits = _scalar_bits([int(sig[1]) for sig in sigs], device)
    return a, r, s_bits, _msg_bits(msgs, device)


def eddsa_verify_parts(a, r, s_bits, msg_bits):
    """-> (lhs = s B, the Pedersen hash point, rhs = R + t A), ETEC."""
    lhs = jj.fixed_base_mult_device(PureEdDSA.B(), s_bits)
    rx_bits = jj.mont_to_bits(jj.etec_to_affine_x(r))
    ax_bits = jj.mont_to_bits(jj.etec_to_affine_x(a))
    all_bits = torch.cat([rx_bits, ax_bits, msg_bits])
    pad = (-all_bits.shape[0]) % 3
    if pad:
        all_bits = torch.cat([all_bits, torch.zeros_like(all_bits[:pad])])
    hash_pt = jj.pedersen_hash_bits_device(RAM_P13N, all_bits)
    t_bits = jj.mont_to_bits(jj.etec_to_affine_x(hash_pt))
    rhs = jj.etec_add(r, jj.scalar_mult_bits(a, t_bits))
    return lhs, hash_pt, rhs


def eddsa_verify_device(a, r, s_bits, msg_bits):
    """The accept mask (B,) bool, on the tensors' device."""
    lhs, _, rhs = eddsa_verify_parts(a, r, s_bits, msg_bits)
    return jj.etec_equal(lhs, rhs)


def eddsa_verify_batch(As, sigs, msgs, device=None):
    """Keys A, signatures (R, s) and byte messages of one length -> a
    list of bools.  ``device=None`` is the card."""
    dev = resolve_device(device)
    ok = eddsa_verify_device(*prepare(As, sigs, msgs, dev))
    return [bool(v) for v in ok.cpu().tolist()]

"""Batched SHA-256 witness trace on tensors (counterpart of
``ethsnarks_tpu/ops/sha256_ops.py:37-127``).

One trace computes every value the circuit gadgets of
:mod:`..gadgets.sha256` allocate, for a whole batch of messages at once:
the xor chains' aux words, Ch and Maj, the modular additions' outputs
and carries.  The words of one compression come in the order of the
compression's ``gadgets`` list (:mod:`..models.sha256_batch` pairs each
variable with a word and a bit):

  schedule t = 16..63:  [s0_pair, s0_out, s1_pair, s1_out, w_out, w_carry]
  rounds   t = 0..63:   [S1_pair, S1_out, ch, t1_out, t1_carry,
                         S0_pair, S0_out, maj_ab, maj_out, t2_out, t2_carry,
                         e_out, e_carry, a_out, a_carry]
  feed-forward i = 0..7: [h_out, h_carry]

48 x 6 + 64 x 15 + 8 x 2 = 1264 words a compression, each a (B,) lane
vector.  A pair word is the first input word xor the second (the aux
``t`` wire of a three-wire ``_XorWords`` bit); a carry word is the whole
carry of a ``_ModAdd`` (bit j is carry wire j).

Lanes are int64 holding 32-bit words: torch's uint32 has no shifts, adds
or complement on every device.  A sum of up to five words stays far
below 2^63, so the carry is ``sum >> 32``.
"""

import torch

from ..gadgets.sha256 import SHA256_IV, SHA256_K

WORDS_PER_COMP = 48 * 6 + 64 * 15 + 8 * 2   # 1264

M32 = 0xFFFFFFFF


def _rotr(x, n):
    return ((x >> n) | (x << (32 - n))) & M32


def _modadd(words):
    """(sum mod 2^32, carry = sum >> 32) of lane vectors."""
    s = words[0]
    for w in words[1:]:
        s = s + w
    return s & M32, s >> 32


def _compression_trace(state, block):
    """One compression: state a list of 8 (B,) words, block (16, B) ->
    (the new state, ops (WORDS_PER_COMP, B)) in the module's word
    order."""
    ops = []
    w = list(block)
    for _ in range(48):
        a15, a2 = w[-15], w[-2]
        p0 = _rotr(a15, 7) ^ _rotr(a15, 18)
        x0 = p0 ^ (a15 >> 3)
        p1 = _rotr(a2, 17) ^ _rotr(a2, 19)
        x1 = p1 ^ (a2 >> 10)
        out, carry = _modadd([w[-16], x0, w[-7], x1])
        ops += [p0, x0, p1, x1, out, carry]
        w.append(out)
    a, b, c, d, e, f, g, h = state
    for t in range(64):
        pS1 = _rotr(e, 6) ^ _rotr(e, 11)
        S1 = pS1 ^ _rotr(e, 25)
        ch = (e & f) ^ ((e ^ M32) & g)
        t1, c1 = _modadd([h, S1, ch, SHA256_K[t], w[t]])
        pS0 = _rotr(a, 2) ^ _rotr(a, 13)
        S0 = pS0 ^ _rotr(a, 22)
        mt = a & b
        maj = mt ^ (a & c) ^ (b & c)
        t2, c2 = _modadd([S0, maj])
        ne, ce = _modadd([d, t1])
        na, ca = _modadd([t1, t2])
        ops += [pS1, S1, ch, t1, c1, pS0, S0, mt, maj, t2, c2, ne, ce, na,
                ca]
        a, b, c, d, e, f, g, h = na, a, b, c, ne, e, f, g
    new_state = []
    for old, word in zip(state, (a, b, c, d, e, f, g, h)):
        out, carry = _modadd([old, word])
        ops += [out, carry]
        new_state.append(out)
    return new_state, torch.stack(ops)


def sha256_witness_trace(blocks):
    """blocks: (n_blocks, 16, B) integer tensor of the padded message's
    32-bit words (big-endian within the message, the padding included).
    Returns (final state (8, B), ops (n_blocks, WORDS_PER_COMP, B)), int64
    on the blocks' device."""
    blocks = blocks.to(torch.int64) & M32
    B = blocks.shape[2]
    state = [torch.full((B,), iv, dtype=torch.int64, device=blocks.device)
             for iv in SHA256_IV]
    ops = []
    for block in blocks:
        state, comp_ops = _compression_trace(state, block)
        ops.append(comp_ops)
    return torch.stack(state), torch.stack(ops)

"""N SHA-256 preimage proofs in one circuit, with the witness made by the
batched SHA-256 trace (counterpart of
``ethsnarks_tpu/models/sha256_batch.py:25-186``).

The gadgets (:class:`..gadgets.sha256.sha256_many`) stamp each instance's
rows; the witness of all N instances is computed by one call of
:func:`..ops.sha256_ops.sha256_witness_trace` on the model's device, and
each bit variable takes its bit of its trace word, by index.  One 512-bit
message is 60,131 constraints on the domain 2^16, every witness value a
bit but the two public digest halves.
"""

import hashlib

import numpy as np
import torch

from .. import resolve_device
from ..gadgets.sha256 import _Ch, _Maj, _ModAdd, _XorWords, \
    bits2blocks_padded, sha256_compression, sha256_many
from ..ops.sha256_ops import WORDS_PER_COMP, sha256_witness_trace
from ..r1cs import ConstraintSystem


def _build_assignment(comp, word_base):
    """Walk one compression's gadgets in construction order and pair each
    allocated wire with its (word offset, bit position) in the trace's
    word stream (:mod:`..ops.sha256_ops`).  Returns parallel lists
    (var_idx, op_idx, bit_pos)."""
    var_idx, op_idx, bit_pos = [], [], []
    cur = word_base
    for g in comp.gadgets:
        if isinstance(g, _XorWords):
            pair, out = cur, cur + 1
            cur += 2
            for step in g.steps:
                if step is None:
                    continue
                wires, const, o, i, t = step
                var_idx.append(o.index)
                op_idx.append(out)
                bit_pos.append(i)
                if t is not None:
                    # the aux t wire: first ^ second input word's bit
                    var_idx.append(t.index)
                    op_idx.append(pair)
                    bit_pos.append(i)
        elif isinstance(g, _Ch):
            for i, vb in enumerate(g.out_bits):
                var_idx.append(vb.index)
                op_idx.append(cur)
                bit_pos.append(i)
            cur += 1
        elif isinstance(g, _Maj):
            for arr, off in ((g.t_bits, 0), (g.out_bits, 1)):
                for i, vb in enumerate(arr):
                    var_idx.append(vb.index)
                    op_idx.append(cur + off)
                    bit_pos.append(i)
            cur += 2
        elif isinstance(g, _ModAdd):
            for i, vb in enumerate(g.out_bits):
                var_idx.append(vb.index)
                op_idx.append(cur)
                bit_pos.append(i)
            for j, vb in enumerate(g.carry_bits):
                var_idx.append(vb.index)
                op_idx.append(cur + 1)
                bit_pos.append(j)
            cur += 2
        else:
            raise TypeError("unknown sha256 sub-gadget %r" % type(g))
    assert cur - word_base == WORDS_PER_COMP, (cur - word_base)
    return var_idx, op_idx, bit_pos


def _padded_words(message, n_bits):
    """The SHA-256 padded message as (n_blocks, 16) big-endian 32-bit
    words, int64."""
    assert len(message) * 8 == n_bits
    n_blocks = bits2blocks_padded(n_bits)
    buf = bytearray(message)
    buf.append(0x80)
    while len(buf) % 64 != 56:
        buf.append(0)
    buf += int(n_bits).to_bytes(8, 'big')
    assert len(buf) == n_blocks * 64
    return np.frombuffer(bytes(buf), dtype='>u4').reshape(
        n_blocks, 16).astype(np.int64)


class BatchSha256(object):
    """N independent SHA-256 hashes of byte-aligned ``n_bits``-bit private
    messages, each digest packed into two public field elements (high and
    low 128 bits).  ``device`` (None: the card) is where
    :meth:`set_witness` runs the trace."""

    def __init__(self, n_instances, n_bits=512, device=None):
        assert n_bits % 8 == 0, "byte-aligned messages only"
        self.n_instances = n_instances
        self.n_bits = n_bits
        self.n_blocks = bits2blocks_padded(n_bits)
        self.device = resolve_device(device)
        pb = ConstraintSystem()
        self.digest_vs = []
        for i in range(n_instances):
            self.digest_vs.append(
                (pb.allocate('digest_hi_%d' % i),
                 pb.allocate('digest_lo_%d' % i)))
        pb.set_input_sizes(2 * n_instances)

        self.input_vs = []
        self.gadgets = []
        self._assign = []       # per instance: (var_idx, op_idx, bit_pos)
        for i in range(n_instances):
            in_bits = pb.allocate_array(n_bits, 'msg_%d' % i)
            g = sha256_many(pb, in_bits, 'sha_%d' % i)
            g.generate_r1cs_constraints()
            res = g.result()    # 256 bits, MSB first
            lc_hi = sum(b * (1 << (127 - k)) for k, b in enumerate(res[:128]))
            lc_lo = sum(b * (1 << (127 - k)) for k, b in enumerate(res[128:]))
            d_hi, d_lo = self.digest_vs[i]
            pb.add_constraint(lc_hi, 1, d_hi + 0, 'pack_hi_%d' % i)
            pb.add_constraint(lc_lo, 1, d_lo + 0, 'pack_lo_%d' % i)
            self.input_vs.append(in_bits)
            self.gadgets.append(g)
            vi, oi, bp = [], [], []
            for blk, comp in enumerate(g.comps):
                assert isinstance(comp, sha256_compression)
                a, b, c = _build_assignment(comp, blk * WORDS_PER_COMP)
                vi += a
                oi += b
                bp += c
            self._assign.append((vi, np.asarray(oi, np.int64),
                                 np.asarray(bp, np.int64)))
        self.pb = pb
        # every instance has the same structure: one op/bit map for all
        self._op_idx = self._assign[0][1]
        self._bit_pos = self._assign[0][2]
        for vi, oi, bp in self._assign[1:]:
            assert np.array_equal(oi, self._op_idx)
            assert np.array_equal(bp, self._bit_pos)

    def set_witness(self, messages):
        """messages: n_instances byte strings of n_bits // 8 bytes.  One
        batched trace on the model's device fills every xor, Ch, Maj and
        addition wire; each digest must equal hashlib's."""
        assert len(messages) == self.n_instances
        pb = self.pb
        B = self.n_instances
        values = pb.values

        # the input bit wires, MSB first within the byte stream
        for i, msg in enumerate(messages):
            bits = np.unpackbits(np.frombuffer(msg, dtype=np.uint8)).tolist()
            for v, bit in zip(self.input_vs[i], bits):
                values[v.index] = bit

        blocks = np.stack([_padded_words(m, self.n_bits)
                           for m in messages])           # (B, n_blocks, 16)
        blocks = torch.from_numpy(np.moveaxis(blocks, 0, 2).copy()).to(
            self.device)                                 # (n_blocks, 16, B)
        final, ops = sha256_witness_trace(blocks)
        W = ops.reshape(self.n_blocks * WORDS_PER_COMP, B).cpu().numpy()
        bits = (W[self._op_idx] >> self._bit_pos[:, None]) & 1   # (A, B)
        for i in range(B):
            for vi, bit in zip(self._assign[i][0], bits[:, i].tolist()):
                values[vi] = bit

        final = final.cpu().numpy()                      # (8, B)
        for i, msg in enumerate(messages):
            digest = b''.join(int(final[w, i]).to_bytes(4, 'big')
                              for w in range(8))
            assert digest == hashlib.sha256(msg).digest()
            d_hi, d_lo = self.digest_vs[i]
            pb.setval(d_hi, int.from_bytes(digest[:16], 'big'))
            pb.setval(d_lo, int.from_bytes(digest[16:], 'big'))
        return self

    def digests(self):
        return [(self.pb.val(h), self.pb.val(lo))
                for h, lo in self.digest_vs]

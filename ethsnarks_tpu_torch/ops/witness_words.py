"""The QAP witness map on 8 x 32-bit Fr words, as the card runs it
(:class:`..qap.WordWitnessMap`): the stacked CSR form of the matrices, the
plan of the transform passes, and the plain versions of K8 and K9
(``csrc/witness_kernels.cu``; :mod:`.kernels` runs them for CPU tensors).

Values are plain residues mod r.  The constants are Montgomery forms (the
matrices' coefficients, the twiddles, the coset planes), so a Montgomery
product of a value by a constant is plain again and the witness and H need
no conversion.  A B on the coset comes out as A B / R and C is taken to
C / R (a product with the plain 1); the unscale plane carries R / Z on the
coset, so H leaves the last pass plain and canonical, bit-reversed, equal
word for word to :meth:`..qap.QAP.witness_map_plain`'s.

The transforms follow ``ops/ntt.py``'s conventions (DIF natural ->
bit-reversed, DIT bit-reversed -> natural, no permutation, bit-reversed
planes).  The index bits of m = 2^k are cut into ranges of at most
``tile_log`` bits (:func:`ntt_ranges`), and each pass runs one range's
stages on tiles in shared memory; :func:`pass_plan` fuses the pointwise
steps into the passes where two transforms meet.
"""

import numpy as np
import torch

from .fp import Fr, NH, h16_to_words, words_to_h16
from .ntt import dif_stage, dit_stage

# csrc/witness_kernels.cu kTileLog: the most elements of a vector a K9
# block holds is 2^TILE_LOG
TILE_LOG = 10
# K9's steps (csrc/witness_kernels.cu NttStep), run in this order
DIF_IN, SCALE, DIT, COMBINE, DIF_OUT, UNSCALE = 1, 2, 4, 8, 16, 32


def csr_layout(coo, m, num_constraints, num_inputs):
    """The stacked CSR matrices [A; B; C] of 3m rows, A with the input rows
    n + j -> w_j (j = 0 .. num_inputs, coefficient 1) that pin the inputs.

    coo: {'a'|'b'|'c': (rows, cols, coeffs)} -> (row_ptr int64 (3m + 1,),
    cols int64 (nnz,), order int64 (nnz,)): entry j of the CSR form is
    entry order[j] of the concatenation [A's entries, the input rows, B's,
    C's], a row's entries in their COO order."""
    extra = np.arange(num_inputs + 1, dtype=np.int64)
    rows, cols = [], []
    for b, name in enumerate('abc'):
        r, c = (np.asarray(v, dtype=np.int64) for v in coo[name][:2])
        if name == 'a':
            r = np.concatenate([r, num_constraints + extra])
            c = np.concatenate([c, extra])
        if r.size and (r.min() < 0 or r.max() >= m):
            raise ValueError("COO row outside the domain of %d" % m)
        rows.append(r + b * m)
        cols.append(c)
    rows, cols = np.concatenate(rows), np.concatenate(cols)
    order = np.argsort(rows, kind='stable')
    row_ptr = np.zeros(3 * m + 1, dtype=np.int64)
    np.cumsum(np.bincount(rows, minlength=3 * m), out=row_ptr[1:])
    return row_ptr, cols[order], order


def ntt_ranges(k, tile_log=TILE_LOG):
    """(lo, t, g) of each pass over m = 2^k, lowest first: index bits [lo,
    lo + t), and g column bits that fill the tile to 2^(t + g) elements
    ([0, g) for lo > 0, so a tile reads runs of 2^g neighbours)."""
    t0 = min(k, tile_log)
    out = [(0, t0, 0)]
    rest = k - t0
    n = -(-rest // tile_log)
    lo = t0
    for j in range(n):
        t = rest // n + (j < rest % n)
        out.append((lo, t, min(tile_log - t, lo)))
        lo += t
    return out


def pass_plan(k, tile_log=TILE_LOG):
    """[(range, steps)] of one witness map: DIF of A, B, C from the top
    range down, the coset scale, their DIT from the bottom range up,
    (A B - C) / Z, the DIF of that from the top range down and the
    unscale.  The pointwise steps sit in the passes of the bottom range
    (scale, unscale) and the top one ((A B - C) / Z), where two transforms
    meet in one pass, so a map of n ranges is 3n - 2 passes."""
    ranges = ntt_ranges(k, tile_log)
    bottom, top, mid = ranges[0], ranges[-1], ranges[1:-1]
    if len(ranges) == 1:
        return [(bottom, DIF_IN | SCALE | DIT | COMBINE | DIF_OUT | UNSCALE)]
    plan = [(r, DIF_IN) for r in [top] + mid[::-1]]
    plan.append((bottom, DIF_IN | SCALE | DIT))
    plan += [(r, DIT) for r in mid]
    plan.append((top, DIT | COMBINE | DIF_OUT))
    plan += [(r, DIF_IN) for r in mid[::-1]]
    plan.append((bottom, DIF_IN | UNSCALE))
    return plan


def matvec_work(n_rows, nnz, n_vars):
    """(bytes, Fr products) of K8: the row pointers, columns, coefficients
    and witness read once, the rows written once, a product a term."""
    return (n_rows + 1) * 8 + nnz * 36 + n_vars * 32 + n_rows * 32, nnz


def pass_work(k, lo, t, steps, n_in):
    """(bytes, Fr products) of one K9 pass on n_in stacked vectors of 2^k:
    each element read and written once, each plane and each twiddle the
    stages use (2^(lo + t - 1) of a series) read once; a product a
    butterfly and a pointwise product."""
    m = 1 << k
    n_out = 1 if steps & COMBINE else n_in
    stages = t * (m // 2)
    tw = 32 << (lo + t - 1)
    n_bytes, prods = 32 * m * (n_in + n_out), 0
    if steps & (DIF_IN | DIF_OUT):
        n_bytes += tw
    if steps & DIT:
        n_bytes += tw
    for bit, n in ((DIF_IN, n_in * stages), (SCALE, n_in * m),
                   (DIT, n_in * stages), (COMBINE, 2 * m),
                   (DIF_OUT, stages), (UNSCALE, n_out * m)):
        if steps & bit:
            prods += n
            n_bytes += 32 * m if bit in (SCALE, UNSCALE) else 0
    return n_bytes, prods


# ---- plain versions of the kernels (CPU tensors) ----

def csr_matvec_plain(row_ptr, cols, coeffs, w):
    """K8's plain version: row r of (len(row_ptr) - 1, 8) canonical words
    is the sum over its entries j of the Montgomery products coeffs[j]
    w[cols[j]], added term by term as the kernel adds them."""
    n_rows = row_ptr.shape[0] - 1
    counts = row_ptr[1:] - row_ptr[:-1]
    c16, w16 = words_to_h16(coeffs), words_to_h16(w)
    acc = torch.zeros((NH, n_rows), dtype=torch.int64, device=w.device)
    for j in range(int(counts.max()) if n_rows else 0):
        live = counts > j
        idx = row_ptr[:-1][live] + j
        acc[:, live] = Fr.add(acc[:, live],
                              Fr.mul(c16[:, idx], w16[:, cols[idx].long()]))
    return h16_to_words(acc)


def _stages(x, series, k, lo, t, dif):
    """The DIF (top bit down) or DIT (bottom bit up) stages of index bits
    [lo, lo + t) on h16 ``x`` (16, B*m): ops/ntt.py's stage bodies."""
    bits = range(lo + t - 1, lo - 1, -1) if dif else range(lo, lo + t)
    for b in bits:
        s = k - 1 - b
        tw = series[:, ::1 << s][:, :1 << b]
        x = (dif_stage if dif else dit_stage)(x, tw, 2 << b)
    return x


def ntt_pass_plain(x, tw_inv, tw_fwd, scale, unscale, k, lo, t, steps):
    """K9's plain version on (B*m, 8) words, B = 3 with COMBINE."""
    m = 1 << k
    h = words_to_h16(x)

    def times(h, plane):
        return Fr.mul(h.reshape(NH, -1, m),
                      words_to_h16(plane)[:, None, :]).reshape(NH, -1)

    if steps & DIF_IN:
        h = _stages(h, words_to_h16(tw_inv), k, lo, t, True)
    if steps & SCALE:
        h = times(h, scale)
    if steps & DIT:
        h = _stages(h, words_to_h16(tw_fwd), k, lo, t, False)
    if steps & COMBINE:
        e = h.reshape(NH, 3, m)
        h = Fr.sub(Fr.mul(e[:, 0], e[:, 1]),
                   Fr.mul(e[:, 2], Fr.const(1, h.device)))
    if steps & DIF_OUT:
        h = _stages(h, words_to_h16(tw_inv), k, lo, t, True)
    if steps & UNSCALE:
        h = times(h, unscale)
    return h16_to_words(h)

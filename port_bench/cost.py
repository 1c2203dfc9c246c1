"""The yardstick's counts: the least work a proof's witness map and MSMs
need, and the card's peaks that turn work into a least time.

Peaks of one NVIDIA H100 SXM at its full 700 W power limit: 3.35 TB/s of
HBM (data sheet) and 32-bit integer multiply-adds at 64 lanes an SM a
clock x 132 SMs x 1.98 GHz = 16.7e12 IMAD/s (derived from the
architecture; half the 128 float32 lanes behind the data sheet's 67
TFLOP/s).  A 256-bit Fr or Fq Montgomery product is 264 IMADs: 64 wide
operand products and 64 wide products by the modulus at 2 IMADs each, and
8 low products for the quotient digits.

The counts read the work itself, whatever implements it:

- the witness map: three sparse mat-vecs at one product a nonzero, 7
  transforms of size m at (m/2) log2 m butterflies of one product, 4m
  products of coset scaling (three vectors in, one out) and m for the
  pointwise (A B - C) / Z; its bytes are the witness and the matrices read
  once (32 B a value, 32 + 4 B a nonzero, 4 B a row) and H written once;
- an MSM: Pippenger's bucket additions, one a nonzero window digit of
  its scalars, plus 2 * 2^c additions for each window that holds a
  nonzero digit, at the window width c that gives the fewest (for the
  witness's scalars, searched within 3 of the best width for uniform
  scalars as many as its nonzero ones); each
  addition at the fewest Fq products any known formula needs, 6 in G1
  (batch-affine with a shared inversion) and 18 in G2 (the same over Fq2,
  3 Fq products an Fq2 product); its bytes are the points (affine, 64 B
  in G1, 128 B in G2) and the scalars (32 B) read once.

These are frozen: a later change to the program changes its times, never
this yardstick.
"""

import numpy as np

HBM_BYTES_PER_S = 3.35e12
IMAD_PER_S = 64 * 132 * 1.98e9
PRODUCT_IMAD = 2 * 64 + 8 + 2 * 64
ADD_PRODUCTS = {False: 6, True: 18}
POINT_BYTES = {False: 64, True: 128}
SCALAR_BYTES = 32
SCALAR_BITS = 254
WINDOWS = range(1, 25)


def least_seconds(n_bytes, n_products):
    """The larger of the bytes over the HBM rate and the products' IMADs
    over the IMAD rate."""
    return max(n_bytes / HBM_BYTES_PER_S,
               n_products * PRODUCT_IMAD / IMAD_PER_S)


def witness_map_work(m, nnz, n_vars, n_rows):
    """(bytes, products) of one witness map over a domain of size m, the
    matrices' ``nnz`` nonzeros in all and ``n_rows`` rows each."""
    log_m = m.bit_length() - 1
    products = nnz + 7 * (m // 2) * log_m + 4 * m + m
    n_bytes = n_vars * 32 + nnz * 36 + 3 * n_rows * 4 + m * 32
    return n_bytes, products


def scalar_words(values):
    """Python ints below 2^256 -> (n, 4) uint64 little-endian words."""
    raw = b''.join(int(v).to_bytes(32, 'little') for v in values)
    return np.frombuffer(raw, dtype='<u8').reshape(-1, 4)


def nonzero_digits(words, c):
    """(nonzero c-bit window digits in all, windows holding one or
    more)."""
    total, windows = 0, 0
    mask = np.uint64((1 << c) - 1)
    for o in range(0, SCALAR_BITS, c):
        w, s = divmod(o, 64)
        d = words[:, w] >> np.uint64(s)
        if s + c > 64 and w + 1 < 4:
            d = d | (words[:, w + 1] << np.uint64(64 - s))
        n = int(np.count_nonzero(d & mask))
        total += n
        windows += n > 0
    return total, windows


def _uniform_additions(n, c):
    n_win = -(-SCALAR_BITS // c)
    return n * n_win * (1 - 2.0 ** -c) + n_win * 2 * (1 << c)


def msm_additions(words=None, uniform=0):
    """The fewest bucket additions over the window widths, for ``uniform``
    scalars uniform below r (each c-bit window nonzero with chance 1 -
    2^-c; every width tried), or for the scalars ``words``: their digits
    counted at each width within 3 of the best width for as many nonzero
    uniform scalars (an exact scan of every width costs seconds a query,
    and the best width lies there)."""
    if uniform:
        return min(_uniform_additions(uniform, c) for c in WINDOWS)
    n_nz = int(np.count_nonzero(words.any(axis=1)))
    if n_nz == 0:
        return 0
    c0 = min(WINDOWS, key=lambda c: _uniform_additions(n_nz, c))
    best = None
    for c in range(max(1, c0 - 3), c0 + 4):
        digits, windows = nonzero_digits(words, c)
        adds = digits + windows * 2 * (1 << c)
        best = adds if best is None else min(best, adds)
    return best


def msm_work(n_points, adds, g2):
    """(bytes, products) of an MSM of n_points points with ``adds``
    additions."""
    return (n_points * (POINT_BYTES[g2] + SCALAR_BYTES),
            adds * ADD_PRODUCTS[g2])

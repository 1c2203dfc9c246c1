"""Readers of the reference's on-disk formats (counterparts in
``ethsnarks_tpu/serialization.py``).

- :func:`read_pk_binary`: the binary Montgomery-form proving key written by
  the reference's ``write_pk_binary`` (:208-345), read straight into point
  tensors on the device.  The key stores field elements as 8 little-endian
  32-bit words of x * 2^256 mod q, the port's own layout, so the query
  points load without arithmetic.
- :func:`r1cs_from_dict`: the ``r1cs_to_dict`` layout (:13-26).
- witness JSON: a flat list of decimal strings.
"""

import json

import numpy as np
import torch

from . import resolve_device
from .bn254 import Fq, Fq2
from .field import FIELD_MODULUS
from .ops.fp import MONT_R, ints_to_words_np
from .r1cs import ConstraintSystem

_PK_MAGIC = b"ETSNARKS-TPU-PK\x01"
_ONE_WORDS = ints_to_words_np([MONT_R % FIELD_MODULUS])[0].view(np.uint32)


def r1cs_from_dict(d):
    return ConstraintSystem(
        int(d["nPubInputs"]), int(d["nVars"]),
        [[{int(k): int(v) for k, v in lc.items()} for lc in row]
         for row in d["constraints"]])


def witness_from_json(path):
    with open(path) as fh:
        return [int(v) for v in json.load(fh)]


def _unmont(words):
    """(n, 8k) uint32 words -> list of n lists of k python ints."""
    rinv = pow(MONT_R, -1, FIELD_MODULUS)
    raw = np.ascontiguousarray(words, dtype='<u4').tobytes()
    k = words.shape[1] // 8
    vals = [int.from_bytes(raw[32 * i:32 * i + 32], 'little') * rinv
            % FIELD_MODULUS for i in range(words.shape[0] * k)]
    return [vals[k * j:k * j + k] for j in range(words.shape[0])]


def _g1_points(words, inf):
    """(n, 16) affine Montgomery words + infinity flags -> (n, 3, 8)."""
    n = words.shape[0]
    pts = np.zeros((n, 3, 8), dtype=np.uint32)
    pts[:, 0] = words[:, :8]
    pts[:, 1] = words[:, 8:]
    pts[:, 2] = _ONE_WORDS
    inf = inf.astype(bool)
    pts[inf] = 0
    pts[inf, 1] = _ONE_WORDS
    return pts


def _g2_points(words, inf):
    """(n, 32) affine Montgomery words -> (n, 3, 2, 8), z = (1, 0)."""
    n = words.shape[0]
    pts = np.zeros((n, 3, 2, 8), dtype=np.uint32)
    pts[:, :2] = words.reshape(n, 2, 2, 8)
    pts[:, 2, 0] = _ONE_WORDS
    inf = inf.astype(bool)
    pts[inf] = 0
    pts[inf, 1, 0] = _ONE_WORDS
    return pts


def read_pk_binary(path, device=None):
    """Binary Montgomery-form key -> :class:`groth16.ProvingKey` with its
    query points on ``device`` (None = the CUDA card)."""
    from .groth16 import ProvingKey
    dev = resolve_device(device)
    with open(path, "rb") as fh:
        if fh.read(len(_PK_MAGIC)) != _PK_MAGIC:
            raise ValueError("not a binary ethsnarks-tpu proving key")
        hlen = int.from_bytes(fh.read(4), "little")
        hdr = json.loads(fh.read(hlen).decode("ascii"))
        buf = fh.read()
    n_a, n_b, n_h, n_l = hdr["n_a"], hdr["n_b"], hdr["n_h"], hdr["n_l"]
    off = 0

    def take(dtype, shape):
        nonlocal off
        arr = np.frombuffer(buf, dtype=dtype, offset=off,
                            count=int(np.prod(shape))).reshape(shape)
        off += arr.nbytes
        return arr

    hdr_w = take('<u4', (1, 16))
    bet_w = take('<u4', (2, 32))
    a_idx = take('<u4', (n_a,))
    a_w = take('<u4', (n_a, 16))
    a_inf = take(np.uint8, (n_a,))
    b_idx = take('<u4', (n_b,))
    b_w = take('<u4', (n_b, 32))
    b_inf = take(np.uint8, (n_b,))
    h_w = take('<u4', (n_h, 16))
    h_inf = take(np.uint8, (n_h,))
    l_w = take('<u4', (n_l, 16))
    l_inf = take(np.uint8, (n_l,))
    if off != len(buf):
        raise ValueError("proving key length mismatch: %d of %d bytes used"
                         % (off, len(buf)))

    def tensor(pts):
        return torch.from_numpy(pts.view(np.int32)).to(dev)

    (ax, ay), = _unmont(hdr_w)
    g2 = [(Fq2(v[0:2]), Fq2(v[2:4])) for v in _unmont(bet_w)]
    return ProvingKey(
        alpha_g1=(Fq(ax), Fq(ay)), beta_g2=g2[0], delta_g2=g2[1],
        a_idx=torch.from_numpy(a_idx.astype(np.int64)).to(dev),
        a_pts=tensor(_g1_points(a_w, a_inf)),
        b_idx=torch.from_numpy(b_idx.astype(np.int64)).to(dev),
        b_pts=tensor(_g2_points(b_w, b_inf)),
        h_pts=tensor(_g1_points(h_w, h_inf)),
        l_pts=tensor(_g1_points(l_w, l_inf)),
        num_inputs=int(hdr["num_inputs"]))

"""The reference's on-disk formats (counterparts in
``ethsnarks_tpu/serialization.py``).

- :func:`read_pk_binary` / :func:`write_pk_binary`: the binary
  Montgomery-form proving key of the reference (:208-345).  The key stores
  field elements as 8 little-endian 32-bit words of x * 2^256 mod q, the
  port's own layout, so the query points load into device tensors without
  arithmetic; writing normalises the projective query points to affine
  with one batch inversion per query.  Each reads what the other writes.
- :func:`r1cs_from_dict`: the ``r1cs_to_dict`` layout (:13-26).
- witness JSON: a flat list of decimal strings.
"""

import json

import numpy as np
import torch

from . import resolve_device
from .bn254 import Fq, Fq2
from .field import FIELD_MODULUS
from .ops import curve
from .ops.fp import MONT_R, ints_to_words_np
from .r1cs import ConstraintSystem, LinearCombination

_PK_MAGIC = b"ETSNARKS-TPU-PK\x01"
_ONE_WORDS = ints_to_words_np([MONT_R % FIELD_MODULUS])[0].view(np.uint32)


def r1cs_from_dict(d):
    """A ConstraintSystem with the constraints of ``d`` (no witness)."""
    cs = ConstraintSystem()
    for _ in range(int(d["nVars"]) - 1):
        cs.allocate()
    cs.set_input_sizes(int(d["nPubInputs"]))
    for row in d["constraints"]:
        cs.add_constraint(*[LinearCombination(
            {int(k): int(v) for k, v in lc.items()}) for lc in row])
    return cs


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


def _mont_words(coords):
    """Lists of plain coordinate ints (one list per column) -> (n, 8 *
    columns) uint32 Montgomery words."""
    flat = [c for row in zip(*coords) for c in row]
    return curve.mont_words(flat).view(np.uint32).reshape(
        len(coords[0]), 8 * len(coords))


def _g1_block(pts):
    """Projective G1 point tensor -> affine words (n, 16), infinity flags."""
    xs, ys, inf = curve.affine_ints(pts)
    return _mont_words([xs, ys]), np.array(inf, dtype=np.uint8)


def _g2_block(pts):
    xs, ys, inf = curve.affine_ints(pts, g2=True)
    return (_mont_words([[x[0] for x in xs], [x[1] for x in xs],
                         [y[0] for y in ys], [y[1] for y in ys]]),
            np.array(inf, dtype=np.uint8))


def write_pk_binary(pk, path):
    """:class:`groth16.ProvingKey` -> the reference's binary stream, byte
    for byte what the reference writes for the same key.  Projective query
    points are normalised to affine (Z = 0 is written as infinity: zero
    words, flag 1)."""
    a_idx = pk.a_idx.cpu().numpy().astype(np.uint32)
    b_idx = pk.b_idx.cpu().numpy().astype(np.uint32)
    a_w, a_inf = _g1_block(pk.a_pts)
    b_w, b_inf = _g2_block(pk.b_pts)
    h_w, h_inf = _g1_block(pk.h_pts)
    l_w, l_inf = _g1_block(pk.l_pts)
    al = pk.alpha_g1
    hdr_w = _mont_words([[al[0].n], [al[1].n]])
    bet_w = _mont_words([[p[k].coeffs[j] for p in (pk.beta_g2, pk.delta_g2)]
                         for k in range(2) for j in range(2)])
    header = json.dumps({
        "v": 1, "num_inputs": pk.num_inputs,
        "n_a": len(a_idx), "n_b": len(b_idx),
        "n_h": int(pk.h_pts.shape[0]), "n_l": int(pk.l_pts.shape[0]),
    }).encode("ascii")
    with open(path, "wb") as fh:
        fh.write(_PK_MAGIC)
        fh.write(len(header).to_bytes(4, "little"))
        fh.write(header)
        for arr in (hdr_w, bet_w, a_idx, a_w, a_inf, b_idx, b_w, b_inf,
                    h_w, h_inf, l_w, l_inf):
            fh.write(np.ascontiguousarray(arr).tobytes())

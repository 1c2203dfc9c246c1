"""The reference's on-disk formats (counterparts in
``ethsnarks_tpu/serialization.py``).

- R1CS and witness JSON (:13-75): :func:`r1cs_to_dict` / :func:`r1cs2json`
  write the snarkjs-style layout (nPubInputs, nVars, nConstraints, one
  ``{variable: coefficient}`` map per A, B, C row), :func:`r1cs_from_dict`
  reads it back; :func:`witness2json` / :func:`witness_from_json`, a
  flat list of decimal strings; :func:`vk2json_file` and
  :func:`proof_to_json`, the verifier's JSON.
- The bellman / snarkjs proving key (:78-210): :func:`pk_to_bellman_dict`
  reads the key's query tensors back to host points in the dense bellman
  layout, :func:`pk_from_bellman_dict` builds a key on a device from one,
  and :func:`pk_bellman2ethsnarks` converts a bellman file into the
  binary key.
- :func:`read_pk_binary` / :func:`write_pk_binary`: the binary
  Montgomery-form proving key of the reference (:208-345).  The key stores
  field elements as 8 little-endian 32-bit words of x * 2^256 mod q, the
  port's own layout, so the query points load into device tensors without
  arithmetic; writing normalises the projective query points to affine
  on their device, in Montgomery form, with one batch inversion per query
  (Montgomery's trick down 2^16 lanes).  Each reads what the other
  writes.
"""

import json

import numpy as np
import torch

from . import resolve_device
from .bn254 import Fq, Fq2
from .field import FIELD_MODULUS
from .ops import curve, fp2
from .ops.fp import MONT_R, NH, h16_to_words, ints_to_words_np
from .ops.fp import Fq as FqOps
from .ops.ntt import bitrev_indices
from .r1cs import ConstraintSystem, LinearCombination

_PK_MAGIC = b"ETSNARKS-TPU-PK\x01"
_INV_LANES = 1 << 16     # lanes of the key writer's batch inversion
_ONE_WORDS = ints_to_words_np([MONT_R % FIELD_MODULUS])[0].view(np.uint32)


def r1cs_to_dict(cs):
    constraints = []
    for cons in cs.constraints:
        constraints.append([
            {str(k): str(v) for k, v in sorted(lc.terms.items())}
            for lc in (cons.a, cons.b, cons.c)])
    return {
        "nPubInputs": cs.num_inputs,
        "nOutputs": 0,
        "nVars": cs.num_variables,
        "nConstraints": cs.num_constraints,
        "constraints": constraints,
    }


def r1cs2json(cs, path):
    with open(path, 'w') as fh:
        json.dump(r1cs_to_dict(cs), fh)
    return True


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


def witness2json(cs, path):
    with open(path, 'w') as fh:
        json.dump([str(v) for v in cs.values], fh)
    return True


def witness_from_json(path):
    with open(path) as fh:
        return [int(v) for v in json.load(fh)]


def vk2json_file(vk, path):
    with open(path, 'w') as fh:
        fh.write(vk.to_json())


def proof_to_json(proof):
    return proof.to_json()


# ---------------- bellman / snarkjs proving-key interop ----------------
#
# Keys "A", "B1", "B2", "C" (the aux variables from index 2), "hExps",
# "vk_alfa_1", "vk_beta_2", "vk_delta_2", "nPublic"; points as arrays of
# decimal-string coordinates, infinity as the projective [0, 1, 0].

def _bell_g1(pt):
    vals = [int(c) for c in pt]
    if len(vals) >= 3 and vals[2] == 0:
        return None
    if all(v == 0 for v in vals[:2]):
        return None
    if len(vals) >= 3 and vals[2] != 1:
        zi = pow(vals[2], -1, FIELD_MODULUS)
        return (Fq(vals[0] * zi), Fq(vals[1] * zi))
    return (Fq(vals[0]), Fq(vals[1]))


def _bell_g2(pt):
    x = [int(c) for c in pt[0]]
    y = [int(c) for c in pt[1]]
    if len(pt) >= 3:
        z = [int(c) for c in pt[2]]
        if z == [0, 0]:
            return None
        if z != [1, 0]:
            zi = Fq2(z).inv()
            return (Fq2(x) * zi, Fq2(y) * zi)
    return (Fq2(x), Fq2(y))


def _bell_dump_g1(pt):
    if pt is None:
        return ["0", "1", "0"]
    return [str(pt[0].n), str(pt[1].n), "1"]


def _bell_dump_g2(pt):
    if pt is None:
        return [["0", "0"], ["1", "0"], ["0", "0"]]
    return [[str(pt[0].coeffs[0]), str(pt[0].coeffs[1])],
            [str(pt[1].coeffs[0]), str(pt[1].coeffs[1])],
            ["1", "0"]]


def pk_to_bellman_dict(pk, num_variables, domain_bitrev):
    """A nozk :class:`groth16.ProvingKey` in the bellman layout: dense A
    and B2 over ``num_variables``, B1 all infinity (a nozk key has no B
    query in G1), C = two pads then the L query, hExps in natural order
    (``domain_bitrev``: the domain's bit-reversal permutation, a list or
    tensor).  The query points are read back from their tensors."""
    a_dense = [None] * num_variables
    for i, pt in zip(pk.a_idx.tolist(), curve.tensor_to_g1(pk.a_pts)):
        a_dense[i] = pt
    b2_dense = [None] * num_variables
    for i, pt in zip(pk.b_idx.tolist(), curve.tensor_to_g2(pk.b_pts)):
        b2_dense[i] = pt
    c_list = [None, None] + curve.tensor_to_g1(pk.l_pts)
    bitrev = [int(i) for i in (domain_bitrev.tolist() if hasattr(
        domain_bitrev, 'tolist') else domain_bitrev)]
    h_bitrev = curve.tensor_to_g1(pk.h_pts)
    h_natural = [None] * len(h_bitrev)
    for p, pt in enumerate(h_bitrev):
        h_natural[bitrev[p]] = pt
    return {
        "A": [_bell_dump_g1(p) for p in a_dense],
        "B1": [_bell_dump_g1(None)] * num_variables,
        "B2": [_bell_dump_g2(p) for p in b2_dense],
        "C": [_bell_dump_g1(p) for p in c_list],
        "hExps": [_bell_dump_g1(p) for p in h_natural],
        "vk_alfa_1": _bell_dump_g1(pk.alpha_g1),
        "vk_beta_2": _bell_dump_g2(pk.beta_g2),
        "vk_delta_2": _bell_dump_g2(pk.delta_g2),
        "nPublic": pk.num_inputs,
    }


def pk_from_bellman_dict(d, num_inputs=None, device=None):
    """A bellman / snarkjs key dict -> a nozk :class:`groth16.ProvingKey`
    on ``device`` (None = the CUDA card): the A and B2 queries sparse
    (infinity dropped), H padded to a power of two and permuted into the
    domain's bit-reversed order."""
    from .groth16 import ProvingKey
    dev = resolve_device(device)
    a = [(i, g) for i, g in enumerate(map(_bell_g1, d["A"])) if g is not None]
    b = [(i, g) for i, g in enumerate(map(_bell_g2, d["B2"]))
         if g is not None]
    l_query = [_bell_g1(p) for p in d["C"][2:]]
    h_natural = [_bell_g1(p) for p in d["hExps"]]
    m = 1
    while m < len(h_natural):
        m *= 2
    h_natural += [None] * (m - len(h_natural))
    h_bitrev = [h_natural[j] for j in bitrev_indices(m, 'cpu').tolist()]
    if num_inputs is None:
        num_inputs = int(d.get("nPublic", 0))

    def idx(query):
        return torch.tensor([i for i, _ in query], dtype=torch.int64,
                            device=dev)
    return ProvingKey(
        alpha_g1=_bell_g1(d["vk_alfa_1"]),
        beta_g2=_bell_g2(d["vk_beta_2"]),
        delta_g2=_bell_g2(d["vk_delta_2"]),
        a_idx=idx(a), a_pts=curve.g1_to_tensor([p for _, p in a], dev),
        b_idx=idx(b), b_pts=curve.g2_to_tensor([p for _, p in b], dev),
        h_pts=curve.g1_to_tensor(h_bitrev, dev),
        l_pts=curve.g1_to_tensor(l_query, dev),
        num_inputs=num_inputs)


def pk_bellman2ethsnarks(bellman_pk_file, pk_file, num_inputs=None,
                         device=None):
    """A bellman key file -> the binary Montgomery-form key file, through
    :func:`pk_from_bellman_dict` on ``device`` (None = the CUDA card)."""
    with open(bellman_pk_file) as fh:
        d = json.load(fh)
    write_pk_binary(pk_from_bellman_dict(d, num_inputs, device), pk_file)
    return True


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


def _inverse_mont(z):
    """Montgomery inverses of canonical Montgomery h16 values ``z`` (16,
    n) on their device, zeros staying zero: Montgomery's trick down the
    rows of a (rows, k) grid of the values (k = min(n, _INV_LANES) lanes
    a product), then one Fermat power of the k row-end products."""
    n = z.shape[1]
    k = min(n, _INV_LANES)
    rows = -(-n // k)
    one = FqOps.const_mont(1, z.device)
    zero = (z == 0).all(0)
    v = torch.where(zero[None], one, z)
    v = torch.cat([v, one.expand(NH, rows * k - n)], 1).reshape(NH, rows, k)
    prefix = torch.empty_like(v)
    acc = one.expand(NH, k)
    for r in range(rows):
        prefix[:, r] = acc
        acc = FqOps.mul(acc, v[:, r])
    inv = FqOps.pow_const(acc, FIELD_MODULUS - 2)
    out = torch.empty_like(v)
    for r in range(rows - 1, -1, -1):
        out[:, r] = FqOps.mul(inv, prefix[:, r])
        inv = FqOps.mul(inv, v[:, r])
    out = out.reshape(NH, rows * k)[:, :n]
    return torch.where(zero[None], torch.zeros_like(out), out)


def _g1_block(pts):
    """Projective G1 point tensor -> affine Montgomery words (n, 16) and
    infinity flags, normalised on the tensor's device (Z = 0: zero words,
    flag 1)."""
    if pts.shape[0] == 0:
        return np.zeros((0, 16), np.uint32), np.zeros(0, np.uint8)
    X, Y, Z = curve.unpack(pts)
    zi = _inverse_mont(Z)
    xy = h16_to_words(torch.stack([FqOps.mul(X, zi), FqOps.mul(Y, zi)], 2))
    return (xy.reshape(-1, 16).cpu().numpy().view(np.uint32),
            (Z == 0).all(0).cpu().numpy().astype(np.uint8))


def _g2_block(pts):
    """The same on G2: 1 / z = conj(z) / (z0^2 + z1^2)."""
    if pts.shape[0] == 0:
        return np.zeros((0, 32), np.uint32), np.zeros(0, np.uint8)
    X, Y, Z = curve.unpack(pts)
    z0, z1 = Z[..., 0], Z[..., 1]
    ni = _inverse_mont(FqOps.add(FqOps.mul(z0, z0), FqOps.mul(z1, z1)))
    zi = torch.stack([FqOps.mul(z0, ni), FqOps.neg(FqOps.mul(z1, ni))], -1)
    xy = h16_to_words(torch.stack([fp2.mul(X, zi), fp2.mul(Y, zi)], 2))
    return (xy.reshape(-1, 32).cpu().numpy().view(np.uint32),
            (Z == 0).all(0).all(-1).cpu().numpy().astype(np.uint8))


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

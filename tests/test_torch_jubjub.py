"""The port's host JubJub modules (``field.FQ``/``FR``, ``numbertheory``,
``jubjub``, ``pedersen``, ``eddsa``) against the JAX package's on the same
seeded inputs.  Values are integers, so every comparison is exact."""
import numpy as np
import pytest

from ethsnarks_tpu import eddsa as ref_eddsa
from ethsnarks_tpu import field as ref_field
from ethsnarks_tpu import jubjub as ref_jubjub
from ethsnarks_tpu import numbertheory as ref_nt
from ethsnarks_tpu import pedersen as ref_pedersen

from ethsnarks_tpu_torch import eddsa, field, jubjub, numbertheory, pedersen
from ethsnarks_tpu_torch.field import FQ, FR, FR_ORDER, SNARK_SCALAR_FIELD

from torch_port_helpers import ints_of, port_jubjub, rand_ints

P = SNARK_SCALAR_FIELD
L = jubjub.JUBJUB_L


def _pairs(mods, modulus, seed, n=6):
    """n (a, b) pairs of the module's FQ, from seeded ints below 2^320."""
    vals = rand_ints(2 * n, 1 << 320, seed)
    return [(mods.FQ(vals[2 * i], modulus), mods.FQ(vals[2 * i + 1], modulus))
            for i in range(n)]


def _fq_results(mods, modulus, seed):
    out = []
    for a, b in _pairs(mods, modulus, seed):
        out += [a + b, a - b, a * b, -a, a + 5, 7 - a, 3 * b, a.exp(12345),
                a ** 3, a == b, a == a, a != b, int(a), a.bits(),
                a.to_bytes(), a.to_bytes('little'), b.bits()]
        if b.n and (modulus == P or b.n % 2):
            out += [a / b, 9 / b, b.inv()]
    return [x.n if isinstance(x, mods.FQ) else x for x in out]


@pytest.mark.parametrize('modulus', [P, FR_ORDER])
def test_fq_arithmetic_matches_reference(modulus):
    assert _fq_results(field, modulus, 1) == \
        _fq_results(ref_field, modulus, 1)
    assert FR(-1).n == ref_field.FR(-1).n == FR_ORDER - 1
    assert (FQ.zero(modulus).n, FQ.one(modulus).n) == (0, 1)
    assert FQ.random(modulus).m == modulus
    assert len(FQ(5).bits()) == len(ref_field.FQ(5).bits()) == 254


def test_fq_sqrt_and_counts_match_reference():
    squares = [v * v % P for v in rand_ints(6, P, 2)]
    assert [FQ(s).sqrt().n for s in squares] == \
        [ref_field.FQ(s).sqrt().n for s in squares]
    logs = []
    for mods in (field, ref_field):
        mods.FQ._reset_counts()
        a, b = mods.FQ(3), mods.FQ(5)
        _ = (a + b, a * b, a / b, -a, a.inv(), (a * a).sqrt())
        logs.append(mods.FQ._COUNTS.report())
        mods.FQ._disable_counting()
    assert logs[0] == logs[1]
    assert logs[0].splitlines() == ['add  = 1', 'inv  = 2', 'mul  = 2',
                                    'sqrt = 1', 'sub  = 1']
    with pytest.raises(RuntimeError):
        FQ(3) + FQ(3, 7)


PRIMES = [P, 10007, 1000003, 13]       # p % 8 == 1, 7, 3, 5


@pytest.mark.parametrize('p', PRIMES)
def test_numbertheory_matches_reference(p):
    vals = rand_ints(12, p, 3)
    assert [numbertheory.jacobi(v, p) for v in vals] == \
        [ref_nt.jacobi(v, p) for v in vals]
    nz = [v for v in vals if v]
    assert [numbertheory.inverse_mod(v, p) for v in nz] == \
        [ref_nt.inverse_mod(v, p) for v in nz]
    squares = [v * v % p for v in vals]
    assert [numbertheory.square_root_mod_prime(s, p) for s in squares] == \
        [ref_nt.square_root_mod_prime(s, p) for s in squares]
    non = next(v for v in range(2, p) if ref_nt.jacobi(v, p) == -1)
    with pytest.raises(numbertheory.SquareRootError):
        numbertheory.square_root_mod_prime(non, p)


def _scalars(seed, n=3):
    return rand_ints(n, L, seed)


COORDS = ['Point', 'ProjPoint', 'EtecPoint', 'MontPoint']


def _curve_results(mods, coords, seed):
    """Add, double, neg, mult and every conversion of seeded multiples of
    the generator, in the ``coords`` system, as ints."""
    g = mods.Point.generator()
    ks = _scalars(seed)
    pts = [getattr(g * k, 'as_' + {'Point': 'point', 'ProjPoint': 'proj',
                                    'EtecPoint': 'etec',
                                    'MontPoint': 'mont'}[coords])()
           for k in ks]
    out = []
    for p, q, k in zip(pts, pts[1:] + pts[:1], ks):
        for r in (p + q, p.double(), -p, p - q, p * 29, p * k,
                  p.mult_wnaf(k), p.mult_wnaf(k, 4)):
            out.append(ints_of(r))
        out += [ints_of(p.as_point()), ints_of(p.as_proj()),
                ints_of(p.as_etec()), ints_of(p.as_mont()), p.valid(),
                p.sign(), p.compress()]
    return out


@pytest.mark.parametrize('coords', COORDS)
def test_curve_matches_reference(coords):
    assert _curve_results(jubjub, coords, 4) == \
        _curve_results(ref_jubjub, coords, 4)


def test_points_convert_from_the_reference():
    g = ref_jubjub.Point.generator() * 12345
    for p in (g, g.as_proj(), g.as_etec(), g.as_mont()):
        q = port_jubjub(p)
        assert type(q).__name__ == type(p).__name__
        assert ints_of(q) == ints_of(p)
        assert ints_of(q * 77) == ints_of(p * 77)


def test_from_hash_wnaf_and_torsion_match_reference():
    rng = np.random.default_rng(5)
    for n in (1, 10, 32):
        entropy = rng.bytes(n)
        p = jubjub.Point.from_hash(entropy)
        assert ints_of(p) == ints_of(ref_jubjub.Point.from_hash(entropy))
        assert ints_of(jubjub.Point.decompress(p.compress())) == ints_of(p)
        assert ints_of(jubjub.ProjPoint.decompress(p.compress())) == \
            ints_of(ref_jubjub.ProjPoint.decompress(p.compress()))
    g, rg = jubjub.Point.generator(), ref_jubjub.Point.generator()
    for k in _scalars(6) + [0, 1, 2, 3]:
        for w in (2, 3, 5):
            assert jubjub.wNAF(k, w) == ref_jubjub.wNAF(k, w)
            assert ints_of(jubjub.mult_naf_lut(g, k, w)) == \
                ints_of(ref_jubjub.mult_naf_lut(rg, k, w))
        assert ints_of(jubjub.mult_naf(g, k)) == \
            ints_of(ref_jubjub.mult_naf(rg, k))
    assert [ints_of(p) for p in jubjub.Point.all_loworder_points()] == \
        [ints_of(p) for p in ref_jubjub.Point.all_loworder_points()]
    assert (jubjub.MONT_A, jubjub.MONT_B, jubjub.JUBJUB_E, jubjub.JUBJUB_L) \
        == (ref_jubjub.MONT_A, ref_jubjub.MONT_B, ref_jubjub.JUBJUB_E,
            ref_jubjub.JUBJUB_L)


def test_pedersen_matches_reference():
    rng = np.random.default_rng(7)
    for name, seq in (('test', 0), (b'EdDSA_Verify.RAM', 3), ('x' * 28, 65535)):
        assert pedersen._p13n_string(name, seq) == \
            ref_pedersen._p13n_string(name, seq)
        assert ints_of(pedersen.pedersen_hash_basepoint(name, seq)) == \
            ints_of(ref_pedersen.pedersen_hash_basepoint(name, seq))
    for bad in (('y' * 29, 0), ('test', 1 << 16), (3, 0)):
        with pytest.raises((ValueError, TypeError)):
            pedersen._p13n_string(*bad)
    for nbits in (3, 30, 190):
        bits = ''.join(str(b) for b in rng.integers(0, 2, nbits))
        assert ints_of(pedersen.pedersen_hash_bits('test', bits)) == \
            ints_of(ref_pedersen.pedersen_hash_bits('test', bits))
    data = rng.bytes(24)
    assert ints_of(pedersen.pedersen_hash_bytes(b'test', data)) == \
        ints_of(ref_pedersen.pedersen_hash_bytes(b'test', data))
    scalars = rand_ints(2, P, 8)
    assert ints_of(pedersen.pedersen_hash_scalars(b'test', *scalars)) == \
        ints_of(ref_pedersen.pedersen_hash_scalars(b'test', *scalars))


SCHEMES = ['PureEdDSA', 'EdDSA', 'MiMCEdDSA']


@pytest.mark.parametrize('scheme', SCHEMES)
def test_sign_verify_matches_reference(scheme):
    """One seeded key and message: the port's signature equals the
    reference's; each package accepts the other's and refuses s + 1."""
    rng = np.random.default_rng(9)
    k = rand_ints(1, L - 1, 10)[0] + 1
    msg = [1, 2, 3] if scheme == 'MiMCEdDSA' else rng.bytes(32)
    port, ref = getattr(eddsa, scheme), getattr(ref_eddsa, scheme)
    sm = port.sign(msg, FQ(k))
    want = ref.sign(msg, ref_field.FQ(k))
    assert ints_of(sm.A) == ints_of(want.A)
    assert ints_of(sm.sig) == ints_of(want.sig)
    assert port.verify(port_jubjub(want.A), port_jubjub(want.sig), msg)
    assert ref.verify(*want)
    bad = eddsa.Signature(sm.sig.R, sm.sig.s.n + 1)
    assert not port.verify(sm.A, bad, msg)
    assert not ref.verify(want.A, ref_eddsa.Signature(
        want.sig.R, want.sig.s.n + 1), msg)
    assert list(eddsa.as_scalar(sm.A, [1, FQ(2)])) == \
        list(ref_eddsa.as_scalar(want.A, [1, ref_field.FQ(2)]))
    assert port.hash_secret(FQ(k), msg) == ref.hash_secret(
        ref_field.FQ(k), msg)
    with pytest.raises(RuntimeError):
        port.sign(msg, FQ(0))

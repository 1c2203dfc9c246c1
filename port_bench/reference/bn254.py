"""BN254 (alt_bn128) in plain Python: the scalar field r, the base field q,
Fq2 = Fq[i] / (i^2 + 1), and scalar multiples of the G1 and G2
generators, with affine points as tuples of ints.

Written for the benchmark's reference alone: it needs only ``k * G1`` and
``k * G2``, so there is no general point type, no pairing and no infinity
other than ``None``.
"""

R = 21888242871839275222246405745257275088548364400416034343698204186575808495617
Q = 21888242871839275222246405745257275088696311157297823662689037894645226208583

G1 = (1, 2)
# x = x0 + x1 i, y = y0 + y1 i
G2 = ((10857046999023057135944570762232829481370756359578518086990519993285655852781,
       11559732032986387107991004021392285783925812861821192530917403151452391805634),
      (8495653923123431417604973247489272438418190587263600148770280649306958101930,
       4082367875863433681332203403145435568316851327593401208105741076214120093531))


class _Fq(object):
    """Base-field operations on ints."""
    zero, one = 0, 1

    @staticmethod
    def add(a, b):
        return (a + b) % Q

    @staticmethod
    def sub(a, b):
        return (a - b) % Q

    @staticmethod
    def mul(a, b):
        return a * b % Q

    @staticmethod
    def inv(a):
        return pow(a, -1, Q)


class _Fq2(object):
    """Fq2 operations on (c0, c1) pairs, i^2 = -1."""
    zero, one = (0, 0), (1, 0)

    @staticmethod
    def add(a, b):
        return ((a[0] + b[0]) % Q, (a[1] + b[1]) % Q)

    @staticmethod
    def sub(a, b):
        return ((a[0] - b[0]) % Q, (a[1] - b[1]) % Q)

    @staticmethod
    def mul(a, b):
        return ((a[0] * b[0] - a[1] * b[1]) % Q,
                (a[0] * b[1] + a[1] * b[0]) % Q)

    @staticmethod
    def inv(a):
        n = pow((a[0] * a[0] + a[1] * a[1]) % Q, -1, Q)
        return (a[0] * n % Q, -a[1] * n % Q)


def _double(F, p):
    """Jacobian doubling on y^2 = x^3 + b (a = 0)."""
    X, Y, Z = p
    if Z == F.zero:
        return p
    A = F.mul(X, X)
    B = F.mul(Y, Y)
    C = F.mul(B, B)
    t = F.add(X, B)
    D = F.sub(F.sub(F.mul(t, t), A), C)
    D = F.add(D, D)
    E = F.add(F.add(A, A), A)
    X3 = F.sub(F.mul(E, E), F.add(D, D))
    C8 = F.add(C, C)
    C8 = F.add(C8, C8)
    C8 = F.add(C8, C8)
    Y3 = F.sub(F.mul(E, F.sub(D, X3)), C8)
    Z3 = F.mul(Y, Z)
    return X3, Y3, F.add(Z3, Z3)


def _add_affine(F, p, a):
    """Jacobian p plus affine a (mixed addition)."""
    X1, Y1, Z1 = p
    if Z1 == F.zero:
        return a[0], a[1], F.one
    Z1Z1 = F.mul(Z1, Z1)
    U2 = F.mul(a[0], Z1Z1)
    S2 = F.mul(F.mul(a[1], Z1), Z1Z1)
    H = F.sub(U2, X1)
    r = F.sub(S2, Y1)
    if H == F.zero:
        return _double(F, p) if r == F.zero else (F.one, F.one, F.zero)
    HH = F.mul(H, H)
    HHH = F.mul(H, HH)
    V = F.mul(X1, HH)
    X3 = F.sub(F.sub(F.mul(r, r), HHH), F.add(V, V))
    Y3 = F.sub(F.mul(r, F.sub(V, X3)), F.mul(Y1, HHH))
    return X3, Y3, F.mul(Z1, H)


def _multiply(F, base, k):
    k %= R
    acc = (F.one, F.one, F.zero)
    for bit in bin(k)[2:] if k else '':
        acc = _double(F, acc)
        if bit == '1':
            acc = _add_affine(F, acc, base)
    X, Y, Z = acc
    if Z == F.zero:
        return None
    zi = F.inv(Z)
    zi2 = F.mul(zi, zi)
    return F.mul(X, zi2), F.mul(Y, F.mul(zi2, zi))


def g1_mul(k):
    """k * G1 as (x, y), None for the point at infinity."""
    return _multiply(_Fq, G1, k)


def g2_mul(k):
    """k * G2 as ((x0, x1), (y0, y1)), None for the point at infinity."""
    return _multiply(_Fq2, G2, k)


def g1_on_curve(p):
    x, y = p
    return (y * y - x * x * x - 3) % Q == 0

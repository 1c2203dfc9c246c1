"""Keccak-256 with Ethereum's padding (0x01 ... 0x80), in plain Python: the
MiMC round constants are its iterated digests."""

_RC = [
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A,
    0x8000000080008000, 0x000000000000808B, 0x0000000080000001,
    0x8000000080008081, 0x8000000000008009, 0x000000000000008A,
    0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089,
    0x8000000000008003, 0x8000000000008002, 0x8000000000000080,
    0x000000000000800A, 0x800000008000000A, 0x8000000080008081,
    0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
]
# rotation of lane (x, y), at index x + 5 y
_ROT = [0, 1, 62, 28, 27, 36, 44, 6, 55, 20, 3, 10, 43, 25, 39,
        41, 45, 15, 21, 8, 18, 2, 61, 56, 14]
_M = (1 << 64) - 1
_RATE = 136


def _rotl(v, s):
    return ((v << s) | (v >> (64 - s))) & _M if s else v


def _f(a):
    for rc in _RC:
        c = [a[x] ^ a[x + 5] ^ a[x + 10] ^ a[x + 15] ^ a[x + 20]
             for x in range(5)]
        d = [c[(x - 1) % 5] ^ _rotl(c[(x + 1) % 5], 1) for x in range(5)]
        a = [a[i] ^ d[i % 5] for i in range(25)]
        b = [0] * 25
        for x in range(5):
            for y in range(5):
                b[y + 5 * ((2 * x + 3 * y) % 5)] = _rotl(a[x + 5 * y],
                                                         _ROT[x + 5 * y])
        a = [b[i] ^ (~b[(i + 1) % 5 + 5 * (i // 5)] & _M
                     & b[(i + 2) % 5 + 5 * (i // 5)]) for i in range(25)]
        a[0] ^= rc
    return a


def keccak256(data):
    pad = bytearray(_RATE - len(data) % _RATE)
    pad[0] |= 0x01
    pad[-1] |= 0x80
    msg = bytes(data) + bytes(pad)
    state = [0] * 25
    for off in range(0, len(msg), _RATE):
        for i in range(_RATE // 8):
            state[i] ^= int.from_bytes(msg[off + 8 * i:off + 8 * i + 8],
                                       'little')
        state = _f(state)
    return b''.join(state[i].to_bytes(8, 'little') for i in range(4))

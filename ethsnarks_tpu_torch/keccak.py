"""Pure-Python Keccak-256 with Ethereum's pre-NIST padding (own copy of
``ethsnarks_tpu/keccak.py``).

Only the 256-bit digest / rate-1088 instance, which is what the MiMC
round-constant chain needs.

Keccak-f[1600] with 24 rounds; multi-rate padding 0x01 .. 0x80 (NOT the SHA-3
0x06 domain separator).
"""

_ROUND_CONSTANTS = [
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A,
    0x8000000080008000, 0x000000000000808B, 0x0000000080000001,
    0x8000000080008081, 0x8000000000008009, 0x000000000000008A,
    0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089,
    0x8000000000008003, 0x8000000000008002, 0x8000000000000080,
    0x000000000000800A, 0x800000008000000A, 0x8000000080008081,
    0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
]

# Rotation offsets r[x][y], indexed [x + 5*y] below.
_ROTATIONS = [
    0, 1, 62, 28, 27,
    36, 44, 6, 55, 20,
    3, 10, 43, 25, 39,
    41, 45, 15, 21, 8,
    18, 2, 61, 56, 14,
]

_MASK = (1 << 64) - 1


def _rotl(value, shift):
    return ((value << shift) | (value >> (64 - shift))) & _MASK


def _keccak_f(state):
    """Keccak-f[1600] permutation over a 25-lane state (list of 64-bit ints)."""
    for rc in _ROUND_CONSTANTS:
        # theta
        c = [state[x] ^ state[x + 5] ^ state[x + 10] ^ state[x + 15] ^ state[x + 20]
             for x in range(5)]
        d = [c[(x - 1) % 5] ^ _rotl(c[(x + 1) % 5], 1) for x in range(5)]
        state = [state[i] ^ d[i % 5] for i in range(25)]
        # rho + pi
        b = [0] * 25
        for x in range(5):
            for y in range(5):
                # B[y, 2x+3y] = rot(A[x, y])
                b[y + 5 * ((2 * x + 3 * y) % 5)] = _rotl(
                    state[x + 5 * y], _ROTATIONS[x + 5 * y])
        # chi
        state = [b[i] ^ ((~b[(i + 1) % 5 + 5 * (i // 5)]) & b[(i + 2) % 5 + 5 * (i // 5)])
                 for i in range(25)]
        # iota
        state[0] ^= rc
    return state


class keccak_256(object):
    """Minimal hashlib-style interface: keccak_256(data).digest()/hexdigest()."""

    digest_size = 32
    block_size = 136  # rate in bytes for capacity 512

    def __init__(self, data=b''):
        self._buffer = b''
        self._state = [0] * 25
        if data:
            self.update(data)

    def update(self, data):
        if not isinstance(data, (bytes, bytearray)):
            raise TypeError("keccak_256 requires bytes")
        self._buffer += bytes(data)
        while len(self._buffer) >= self.block_size:
            block, self._buffer = (self._buffer[:self.block_size],
                                   self._buffer[self.block_size:])
            self._absorb(block)
        return self

    def _absorb(self, block):
        for i in range(self.block_size // 8):
            lane = int.from_bytes(block[8 * i:8 * i + 8], 'little')
            self._state[i] ^= lane
        self._state = _keccak_f(self._state)

    def digest(self):
        # Multi-rate padding: 0x01, zeros, final bit 0x80 (may coincide).
        padlen = self.block_size - (len(self._buffer) % self.block_size)
        pad = bytearray(padlen)
        pad[0] |= 0x01
        pad[-1] |= 0x80
        final = self._buffer + bytes(pad)
        state = list(self._state)
        for off in range(0, len(final), self.block_size):
            block = final[off:off + self.block_size]
            tmp = list(state)
            for i in range(self.block_size // 8):
                tmp[i] ^= int.from_bytes(block[8 * i:8 * i + 8], 'little')
            state = _keccak_f(tmp)
        out = b''.join(state[i].to_bytes(8, 'little') for i in range(4))
        return out

    def hexdigest(self):
        return self.digest().hex()

"""The windowed Pedersen hash of ZCash Sapling, host oracle (own copy of
``ethsnarks_tpu/pedersen.py:16-90``).

3-bit signed windows, 62 windows a personalised basepoint (ZCash spec
theorem 5.4.1), basepoints ``HashToPoint(b"%-28s%04X" % (name, seq))``
kept in a cache.  Bit sequences are '0'/'1' strings, read 3 characters a
window and reversed (the first character is the window's low bit).  The
batched version on tensors is :func:`.ops.jubjub_ops.pedersen_hash_bits_device`.
"""

from math import floor, log2

from .jubjub import Point, EtecPoint, JUBJUB_L

MAX_SEGMENT_BITS = floor(log2(JUBJUB_L))
MAX_SEGMENT_BYTES = MAX_SEGMENT_BITS // 8

N_WINDOWS_PER_BASEPOINT = 62

_basepoint_cache = {}


def _p13n_string(name, seq):
    """32-byte personalisation string b"%-28s%04X": the name padded to 28
    characters, then the segment's sequence number in 4 hex digits (the
    basepoints, and so every Pedersen hash, depend on this layout)."""
    if isinstance(name, str):
        name = name.encode('ascii')
    elif not isinstance(name, bytes):
        raise TypeError(
            "personalization name must be str or bytes, got %s"
            % type(name).__name__)
    if len(name) > 28:
        raise ValueError("personalization name exceeds the 28-byte field")
    if not 0 <= seq <= 0xFFFF:
        raise ValueError(
            "basepoint sequence %r outside the 4-hex-digit field" % (seq,))
    return b"%-28s%04X" % (name, seq)


def pedersen_hash_basepoint(name, i):
    """Personalized basepoint: HashToPoint over the 32-byte p13n string."""
    key = (bytes(name) if isinstance(name, (bytes, bytearray))
           else name, i)
    if key not in _basepoint_cache:
        _basepoint_cache[key] = Point.from_hash(
            _p13n_string(name, i)).as_etec()
    return _basepoint_cache[key]


def pedersen_hash_windows(name, windows):
    """Accumulate sum of per-window table entries: entry = +-(m+1) * 16^j * B."""
    result = EtecPoint.infinity()
    current = None
    for j, window in enumerate(windows):
        if j % N_WINDOWS_PER_BASEPOINT == 0:
            current = pedersen_hash_basepoint(name, j // N_WINDOWS_PER_BASEPOINT)
        else:
            # Multiply by 16 = advance one 4-bit row of the lookup table.
            current = current.double().double().double().double()
        segment = current * ((window & 0b11) + 1)
        if window > 0b11:
            segment = segment.neg()
        result += segment
    return result.as_point()


def pedersen_hash_bits(name, bits):
    """bits: '0'/'1' string; chopped into 3-bit windows, each reversed."""
    windows = [int(bits[i:i + 3][::-1], 2) for i in range(0, len(bits), 3)]
    assert len(windows) > 0
    return pedersen_hash_windows(name, windows)


def pedersen_hash_bytes(name, data):
    assert isinstance(data, bytes)
    assert len(data) > 0
    bits = ''.join(bin(b)[2:].rjust(8, '0') for b in data)
    return pedersen_hash_bits(name, bits)


def pedersen_hash_scalars(name, *scalars):
    """Hash scalars by splitting each into 3-bit little-endian windows."""
    windows = []
    for s in scalars:
        s = int(s)
        windows += [(s >> i) & 0b111 for i in range(0, s.bit_length(), 3)]
    return pedersen_hash_windows(name, windows)

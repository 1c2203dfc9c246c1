"""Groth16 verifier as EVM bytecode, run on the in-process mini-EVM (own
copy of ``ethsnarks_tpu/evm_verifier.py:28-230``).

The bytecode twin of ``contracts/Verifier.sol``: the same vk, gammaABC,
proof and input word layouts, the same scalar-field range check on the
inputs, the same NegateY and one 4-pair EIP-197 pairing call, so a proof
accepted here is encoded as the contract expects.  ``groth16_verifier_code``
is byte for byte the reference's.

Calldata layout (flat 32-byte words, no ABI heads):

    word 0            n  (number of public inputs)
    words 1..14       vk  = [alpha.x, alpha.y, beta.x.c1, beta.x.c0,
                             beta.y.c1, beta.y.c0, gamma(4), delta(4)]
    words 15..22      proof = [A.x, A.y, B.x.c1, B.x.c0, B.y.c1, B.y.c0,
                               C.x, C.y]
    words 23..22+n    inputs
    words 23+n ..     gammaABC (2*(n+1) words: x,y pairs)

Returns one word: 1 (accept) / 0 (the pairing says no); REVERTs on a bad
encoding, an input >= r, or a precompile failure.
"""

from .evmasm import Assembler, execute

SNARK_SCALAR_FIELD = 21888242871839275222246405745257275088548364400416034343698204186575808495617
PRIME_Q = 21888242871839275222246405745257275088696311157297823662689037894645226208583

# memory map
_M_ECIN = 0x00        # 4-word scratch for ecmul/ecadd inputs
_M_ECMUL_OUT = 0x80   # 2-word ecmul result
_M_VKX = 0xC0         # 2-word accumulator vk_x
_M_N32 = 0x100        # 32 * n
_M_I32 = 0x120        # loop counter (scaled by 32)
_M_PAIR = 0x140       # 24-word pairing-precompile input
_M_OUT = 0x440        # pairing result / return word

_W_VK = 1             # calldata word indexes
_W_PROOF = 15
_W_INPUTS = 23


def _cd_word(a, idx):
    """Push calldata word at static index idx."""
    a.push(32 * idx).emit('CALLDATALOAD')


def _mstore(a, off):
    """Store stack top at static memory offset."""
    a.push(off).emit('MSTORE')


def _mload(a, off):
    a.push(off).emit('MLOAD')


def _neg_y(a):
    """Replace stack top y with PRIME_Q - (y % PRIME_Q)."""
    a.push(PRIME_Q).emit('SWAP1').emit('MOD')     # y % Q
    a.push(PRIME_Q).emit('SUB')                   # Q - (y % Q)


def _require(a, label='fail'):
    """Consume stack top; revert when it is zero."""
    a.emit('ISZERO').push_label(label).emit('JUMPI')


def groth16_verifier_code():
    """Assemble the runtime bytecode of the Verify routine."""
    a = Assembler()

    # n32 = 32 * calldata[0]
    _cd_word(a, 0)
    a.push(32).emit('MUL')
    _mstore(a, _M_N32)

    # vk_x = gammaABC[0..1]  (gammaABC word j is at 32*(23+n) + 32*j)
    for coord in (0, 1):
        _mload(a, _M_N32)
        a.push(32 * (_W_INPUTS + coord)).emit('ADD').emit('CALLDATALOAD')
        _mstore(a, _M_VKX + 32 * coord)

    # i32 = 0
    a.push(0)
    _mstore(a, _M_I32)

    a.label('loop')
    # while i32 < n32
    _mload(a, _M_N32)
    _mload(a, _M_I32)
    a.emit('LT')                                  # i32 < n32
    a.emit('ISZERO').push_label('endloop').emit('JUMPI')

    # input_i = calldata[32*23 + i32]; require input_i < r
    _mload(a, _M_I32)
    a.push(32 * _W_INPUTS).emit('ADD').emit('CALLDATALOAD')
    a.emit('DUP1')
    a.push(SNARK_SCALAR_FIELD).emit('SWAP1').emit('LT')   # input < r
    _require(a)
    _mstore(a, _M_ECIN + 0x40)                    # ecmul scalar slot

    # gammaABC[2 + 2i] / [3 + 2i]  at 32*(23+n) + 64 + 2*i32 (+32)
    for coord in (0, 1):
        _mload(a, _M_I32)
        a.push(2).emit('MUL')
        _mload(a, _M_N32)
        a.emit('ADD')
        a.push(32 * _W_INPUTS + 64 + 32 * coord).emit('ADD')
        a.emit('CALLDATALOAD')
        _mstore(a, _M_ECIN + 32 * coord)

    # term = ecmul(point, scalar)
    a.push(0x40).push(_M_ECMUL_OUT).push(0x60).push(_M_ECIN)
    a.push(7).emit('GAS').emit('STATICCALL')
    _require(a)

    # vk_x = ecadd(vk_x, term)
    for src, dst in ((_M_VKX, _M_ECIN), (_M_VKX + 32, _M_ECIN + 32),
                     (_M_ECMUL_OUT, _M_ECIN + 64),
                     (_M_ECMUL_OUT + 32, _M_ECIN + 96)):
        _mload(a, src)
        _mstore(a, dst)
    a.push(0x40).push(_M_VKX).push(0x80).push(_M_ECIN)
    a.push(6).emit('GAS').emit('STATICCALL')
    _require(a)

    # i32 += 32
    _mload(a, _M_I32)
    a.push(32).emit('ADD')
    _mstore(a, _M_I32)
    a.push_label('loop').emit('JUMP')

    a.label('endloop')
    # pairing input: (A, B) (-alpha, beta) (-vk_x, gamma) (-C, delta)
    slot = 0

    def put_cd(idx, negate=False):
        nonlocal slot
        _cd_word(a, idx)
        if negate:
            _neg_y(a)
        _mstore(a, _M_PAIR + 32 * slot)
        slot += 1

    for w in range(6):                            # A, B
        put_cd(_W_PROOF + w)
    put_cd(_W_VK + 0)                             # alpha.x
    put_cd(_W_VK + 1, negate=True)                # -alpha.y
    for w in range(2, 6):                         # beta
        put_cd(_W_VK + w)
    _mload(a, _M_VKX)                             # vk_x.x
    _mstore(a, _M_PAIR + 32 * slot)
    slot += 1
    _mload(a, _M_VKX + 32)                        # -vk_x.y
    _neg_y(a)
    _mstore(a, _M_PAIR + 32 * slot)
    slot += 1
    for w in range(6, 10):                        # gamma
        put_cd(_W_VK + w)
    put_cd(_W_PROOF + 6)                          # C.x
    put_cd(_W_PROOF + 7, negate=True)             # -C.y
    for w in range(10, 14):                       # delta
        put_cd(_W_VK + w)
    assert slot == 24

    a.push(0x20).push(_M_OUT).push(768).push(_M_PAIR)
    a.push(8).emit('GAS').emit('STATICCALL')
    _require(a)

    # return pairing verdict as a clean 0/1 word
    _mload(a, _M_OUT)
    a.emit('ISZERO').emit('ISZERO')
    _mstore(a, _M_OUT)
    a.push(0x20).push(_M_OUT).emit('RETURN')

    a.label('fail')
    a.emit('REVERT')
    return a.assemble()


# ---------------- host-side encode + run ----------------

def _g1_words(pt):
    """Host affine G1 (Fq, Fq) or [x, y] ints -> 2 words."""
    if hasattr(pt[0], 'n'):
        return [pt[0].n, pt[1].n]
    return [int(pt[0]), int(pt[1])]


def _g2_words(pt):
    """Host G2 (Fq2, Fq2) -> 4 words, imaginary coefficient first
    (EIP-197 / Verifier.sol layout: x.c1, x.c0, y.c1, y.c0).
    Fq2.coeffs entries are plain ints (bn254.FQP)."""
    x, y = pt
    return [int(x.coeffs[1]), int(x.coeffs[0]),
            int(y.coeffs[1]), int(y.coeffs[0])]


def vk_words(vk):
    """14-word vk layout from a :class:`.verifier.VerifyingKey`."""
    return _g1_words(vk.alpha) + _g2_words(vk.beta) + \
        _g2_words(vk.gamma) + _g2_words(vk.delta)


def proof_words(proof):
    """8-word proof layout from a :class:`.verifier.Proof`."""
    return _g1_words(proof.A) + _g2_words(proof.B) + _g1_words(proof.C)


def encode_calldata(vk, proof, inputs=None):
    """Flat calldata for the bytecode verifier.  ``inputs`` defaults to the
    proof's embedded public inputs."""
    inputs = proof.input if inputs is None else inputs
    words = [len(inputs)]
    words += vk_words(vk)
    words += proof_words(proof)
    words += [int(x) for x in inputs]
    for pt in vk.gammaABC:
        words += _g1_words(pt)
    return b''.join(w.to_bytes(32, 'big') for w in words)


def evm_verify(vk, proof, inputs=None):
    """Run the bytecode verifier; True/False, EvmError on malformed data."""
    out = execute(groth16_verifier_code(), encode_calldata(vk, proof, inputs))
    return bool(int.from_bytes(out, 'big'))

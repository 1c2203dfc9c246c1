"""SnarkUtils.PackWords / ReverseBits as executable EVM bytecode (own copy
of ``ethsnarks_tpu/evm_snarkutils.py``).

Bytecode twins of ``contracts/SnarkUtils.sol`` (word -> 253-bit field-
element packing, as libff's pack_int_vector_into_field_element_vector,
plus the 256-bit parallel bit reversal), run by :func:`.evmasm.execute`.
The host oracle is :func:`.utils.bytes_to_field_elements` (MSB-first bits
per byte, each 253-bit chunk reversed).

Both programs keep the contract's own arithmetic: shifts are ``EXP``/
``DIV``/``MUL`` as in the Solidity (``x / 2**i``, ``x * 2**i``), and the
reversal uses the same mask recurrence (``mask ^= mask << s``) rather than
host-precomputed lookup tables.
"""

from .evmasm import Assembler, execute

_U256 = (1 << 256) - 1

# memory map (32-byte words)
M_I = 0x00         # source word index i
M_SRC = 0x20       # current (bit-reversed) source word
M_SOFF = 0x40      # source_offset
M_O = 0x60         # output word index o
M_DST = 0x80       # dest accumulator
M_DOFF = 0xA0      # dest_offset
M_NWORDS = 0xC0    # number of input words
M_OLEN = 0xE0      # number of output words
M_RB = 0x100       # reverse-bits subroutine argument/result
OUT = 0x140        # output array base


def _ml(asm, off):
    asm.push(off).emit('MLOAD')


def _ms(asm, off):
    asm.push(off).emit('MSTORE')


def _reverse_bits_ops(asm):
    """mem[M_RB] <- bit-reversed mem[M_RB] (straight-line; the contract's
    ``while ((s >>= 1) > 0)`` loop unrolled with the same mask recurrence
    mask ^= mask << s starting from ~0)."""
    mask = _U256
    s = 256
    while (s := s >> 1) > 0:
        mask ^= (mask << s) & _U256
        # v = ((v / 2^s) & mask) | ((v * 2^s) & ~mask)
        asm.push(mask)
        asm.push(s)
        asm.push(2)
        asm.emit('EXP')                      # [mask, 2^s]
        _ml(asm, M_RB)
        asm.emit('DUP2')                     # [mask, 2^s, v, 2^s]
        asm.emit('SWAP1')                    # [mask, 2^s, 2^s, v]
        asm.emit('DIV')                      # [mask, 2^s, v/2^s]
        asm.emit('SWAP1')                    # [mask, v/2^s, 2^s]
        _ml(asm, M_RB)
        asm.emit('MUL')                      # [mask, v/2^s, v*2^s]
        asm.push(mask ^ _U256)
        asm.emit('AND')                      # [mask, v/2^s, lo]
        asm.emit('SWAP2')                    # [lo, v/2^s, mask]
        asm.emit('AND')                      # [lo, hi]
        asm.emit('OR')
        _ms(asm, M_RB)


def _reverse_bits_subroutine(asm):
    """Stack [ret] -> []; mem[M_RB] reversed in place."""
    asm.label('rb')
    _reverse_bits_ops(asm)
    asm.emit('JUMP')


def reverse_bits_code():
    """Runtime bytecode: calldata [v] -> 32 bytes [ReverseBits(v)]."""
    asm = Assembler()
    asm.push(0).emit('CALLDATALOAD')
    _ms(asm, M_RB)
    _reverse_bits_ops(asm)
    asm.push(32).push(M_RB).emit('RETURN')
    return asm.assemble()


def _load_source(asm, tag):
    """mem[M_SRC] <- ReverseBits(calldata[32*i]); mem[M_SOFF] <- 0."""
    ret = 'ls_back_%s' % tag
    asm.push(32)
    _ml(asm, M_I)
    asm.emit('MUL').emit('CALLDATALOAD')
    _ms(asm, M_RB)
    asm.push_label(ret)
    asm.push_label('rb').emit('JUMP')
    asm.label(ret)
    _ml(asm, M_RB)
    _ms(asm, M_SRC)
    asm.push(0)
    _ms(asm, M_SOFF)


def pack_words_code():
    """Runtime bytecode of SnarkUtils.PackWords: calldata = N 256-bit
    words; returns ceil(256*N/253) packed 253-bit field elements.

    Mirrors the contract's nested loop: for each output word, pull
    min(needed, available) bits from the current bit-reversed source word
    at source_offset and OR them in at dest_offset."""
    asm = Assembler()
    # n_words = calldatasize / 32; out_len = (256*n + 252) / 253
    asm.push(32).emit('CALLDATASIZE').emit('DIV')
    asm.emit('DUP1')
    _ms(asm, M_NWORDS)
    asm.push(256).emit('MUL').push(252).emit('ADD')
    asm.push(253).emit('SWAP1').emit('DIV')
    _ms(asm, M_OLEN)
    # i = 0; source = RB(word 0); source_offset = 0; o = 0
    asm.push(0)
    _ms(asm, M_I)
    asm.push(0)
    _ms(asm, M_O)
    _load_source(asm, 'init')

    asm.label('outer')                       # for (o < out_len)
    _ml(asm, M_OLEN)
    _ml(asm, M_O)
    asm.emit('LT').emit('ISZERO')
    asm.push_label('finish').emit('JUMPI')
    asm.push(0)
    _ms(asm, M_DST)
    asm.push(0)
    _ms(asm, M_DOFF)

    asm.label('inner')                       # while (dest_offset < 253)
    asm.push(253)
    _ml(asm, M_DOFF)
    asm.emit('LT').emit('ISZERO')
    asm.push_label('store_out').emit('JUMPI')
    # needed = 253 - dest_offset; avail = 256 - source_offset
    _ml(asm, M_DOFF)
    asm.push(253).emit('SUB')                # [needed]
    _ml(asm, M_SOFF)
    asm.push(256).emit('SUB')                # [needed, avail]
    # n = min(needed, avail)
    asm.emit('DUP2').emit('DUP2')            # [needed, avail, needed, avail]
    asm.emit('LT')                           # [needed, avail, avail<needed]
    asm.push_label('use_avail').emit('JUMPI')
    asm.emit('POP')                          # n = needed
    asm.push_label('have_n').emit('JUMP')
    asm.label('use_avail')
    asm.emit('SWAP1').emit('POP')            # n = avail
    asm.label('have_n')                      # [n]
    # dest |= ((source / 2^source_offset) & (2^n - 1)) * 2^dest_offset
    asm.emit('DUP1')                         # [n, n]
    asm.push(2).emit('EXP').push(1)
    asm.emit('SWAP1').emit('SUB')            # [n, 2^n - 1]
    _ml(asm, M_SOFF)
    asm.push(2).emit('EXP')                  # [n, 2^n-1, 2^soff]
    _ml(asm, M_SRC)
    asm.emit('DIV')                          # [n, 2^n-1, src>>soff]
    asm.emit('AND')                          # [n, bits]
    _ml(asm, M_DOFF)
    asm.push(2).emit('EXP').emit('MUL')      # [n, bits<<doff]
    _ml(asm, M_DST)
    asm.emit('OR')
    _ms(asm, M_DST)                          # [n]
    # source_offset += n; dest_offset += n
    asm.emit('DUP1')
    _ml(asm, M_SOFF)
    asm.emit('ADD')
    _ms(asm, M_SOFF)
    _ml(asm, M_DOFF)
    asm.emit('ADD')
    _ms(asm, M_DOFF)                         # []
    # if (source_offset >= 256) advance source word
    asm.push(256)
    _ml(asm, M_SOFF)
    asm.emit('LT')
    asm.push_label('inner').emit('JUMPI')
    _ml(asm, M_I)
    asm.push(1).emit('ADD')
    asm.emit('DUP1')
    _ms(asm, M_I)                            # [i+1]
    _ml(asm, M_NWORDS)
    asm.emit('GT').emit('ISZERO')            # n_words > i+1 ? continue
    asm.push_label('store_out').emit('JUMPI')  # exhausted input: break
    _load_source(asm, 'adv')
    asm.push_label('inner').emit('JUMP')

    asm.label('store_out')                   # out[o] = dest
    _ml(asm, M_DST)
    asm.push(32)
    _ml(asm, M_O)
    asm.emit('MUL').push(OUT).emit('ADD')
    asm.emit('MSTORE')
    _ml(asm, M_O)
    asm.push(1).emit('ADD')
    _ms(asm, M_O)
    asm.push_label('outer').emit('JUMP')

    asm.label('finish')
    asm.push(32)
    _ml(asm, M_OLEN)
    asm.emit('MUL').push(OUT).emit('RETURN')
    _reverse_bits_subroutine(asm)
    return asm.assemble()


def reverse_bits_evm(v):
    out = execute(reverse_bits_code(), int(v).to_bytes(32, 'big'))
    return int.from_bytes(out, 'big')


def pack_words_evm(words):
    """words: list of 256-bit ints -> list of 253-bit field elements."""
    data = b''.join(int(w).to_bytes(32, 'big') for w in words)
    out = execute(pack_words_code(), data, gas_limit=50_000_000)
    return [int.from_bytes(out[i:i + 32], 'big')
            for i in range(0, len(out), 32)]

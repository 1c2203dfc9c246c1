"""Baby-JubJub scalar multiplication and EdDSA verify as EVM bytecode (own
copy of ``ethsnarks_tpu/evm_jubjub.py``).

Bytecode twins of ``contracts/JubJub.sol`` (ETEC add/double per
add-2008-hwcd / dbl-2008-hwcd, binary double-and-add scalarMult, the
modexp precompile's inverse for the ETEC -> affine conversion),
``contracts/wNAF.sol`` (scalarMultNAF5) and ``contracts/EdDSA.sol``
(sha256-precompile HashToInt with the 2^250-1 mask, s*B == t*A check),
run by :func:`.evmasm.execute`; the host oracle is :mod:`.jubjub`.

Subroutine convention: return address on the stack, points in fixed
memory regions (ACC = accumulator, PT = base point, both ETEC
[x, y, t, z]); etec_add folds PT into ACC, etec_dbl doubles PT in place,
smul consumes a scalar from the stack, to_affine converts ACC via the
EIP-198 modexp precompile.
"""

from .evmasm import Assembler, execute

# Baby-JubJub lives over the SNARK SCALAR field (contracts/JubJub.sol:15)
Q = 21888242871839275222246405745257275088548364400416034343698204186575808495617
A_COEFF = 168700
D_COEFF = 168696
GEN = (16540640123574156134436876038791482806971768689494387082833631921987005038935,
       20819045374670962167435360035096875258406992893633759881276124905556507972311)
MASK_250 = (1 << 250) - 1

# memory map (32-byte words)
ACC = 0x000        # 4 words: accumulator point (ETEC)
PT = 0x080         # 4 words: base point (ETEC)
SCR = 0x100        # 8 words: add/double temporaries
MODIN = 0x200      # 6 words: modexp precompile input
MODOUT = 0x2C0     # 1 word:  modexp output
AFF = 0x300        # 2 words: affine conversion output
LHS = 0x340        # 2 words: EdDSA lhs
SHABUF = 0x380     # 5 words: sha256 input


def _ml(asm, off):
    asm.push(off).emit('MLOAD')


def _ms(asm, off):
    asm.push(off).emit('MSTORE')


def _mulmod_mem(asm, out, a, b):
    """mem[out] = mem[a] * mem[b] mod Q."""
    asm.push(Q)
    _ml(asm, b)
    _ml(asm, a)
    asm.emit('MULMOD')
    _ms(asm, out)


def _mulmod_const(asm, out, c, a):
    asm.push(Q)
    _ml(asm, a)
    asm.push(c)
    asm.emit('MULMOD')
    _ms(asm, out)


def _addmod_mem(asm, out, a, b):
    asm.push(Q)
    _ml(asm, b)
    _ml(asm, a)
    asm.emit('ADDMOD')
    _ms(asm, out)


def _submod_mem(asm, out, a, b):
    """mem[out] = mem[a] + (Q - mem[b]) mod Q (inputs < Q)."""
    asm.push(Q)
    _ml(asm, b)
    asm.push(Q)
    asm.emit('SUB')          # Q - b
    _ml(asm, a)
    asm.emit('ADDMOD')
    _ms(asm, out)


def _etec_add_subroutine(asm):
    """ACC <- ACC + PT (add-2008-hwcd, a = A_COEFF).  Stack: [ret] -> []."""
    x1, y1, t1, z1 = ACC, ACC + 32, ACC + 64, ACC + 96
    x2, y2, t2, z2 = PT, PT + 32, PT + 64, PT + 96
    s0, s1, s2, s3 = SCR, SCR + 32, SCR + 64, SCR + 96
    s4, s5, s6, s7 = SCR + 128, SCR + 160, SCR + 192, SCR + 224
    asm.label('etec_add')
    _mulmod_mem(asm, s0, x1, x2)             # x1x2
    _mulmod_mem(asm, s1, y1, y2)             # y1y2
    _mulmod_mem(asm, s2, t1, t2)
    _mulmod_const(asm, s2, D_COEFF, s2)      # dtt = d*t1*t2
    _mulmod_mem(asm, s3, z1, z2)             # z1z2
    # e = (x1+y1)*(x2+y2) - x1x2 - y1y2
    _addmod_mem(asm, s4, x1, y1)
    _addmod_mem(asm, s5, x2, y2)
    _mulmod_mem(asm, s4, s4, s5)
    _addmod_mem(asm, s5, s0, s1)
    _submod_mem(asm, s4, s4, s5)             # e
    _submod_mem(asm, s5, s3, s2)             # f = z1z2 - dtt
    _addmod_mem(asm, s6, s3, s2)             # g = z1z2 + dtt
    _mulmod_const(asm, s7, A_COEFF, s0)
    _submod_mem(asm, s7, s1, s7)             # h = y1y2 - a*x1x2
    _mulmod_mem(asm, x1, s4, s5)             # x3 = e*f
    _mulmod_mem(asm, y1, s6, s7)             # y3 = g*h
    _mulmod_mem(asm, t1, s4, s7)             # t3 = e*h
    _mulmod_mem(asm, z1, s5, s6)             # z3 = f*g
    asm.emit('JUMP')


def _etec_dbl_subroutine(asm):
    """PT <- 2*PT (dbl-2008-hwcd).  Stack: [ret] -> []."""
    x, y, t, z = PT, PT + 32, PT + 64, PT + 96
    s0, s1, s2, s3 = SCR, SCR + 32, SCR + 64, SCR + 96
    s4, s5, s6, s7 = SCR + 128, SCR + 160, SCR + 192, SCR + 224
    asm.label('etec_dbl')
    _mulmod_mem(asm, s0, x, x)               # a_ = x^2
    _mulmod_mem(asm, s1, y, y)               # b_ = y^2
    _mulmod_mem(asm, s2, z, z)
    _mulmod_const(asm, s2, 2, s2)            # c_ = 2z^2
    _mulmod_const(asm, s3, A_COEFF, s0)      # d_ = a*a_
    _addmod_mem(asm, s4, x, y)
    _mulmod_mem(asm, s4, s4, s4)
    _addmod_mem(asm, s5, s0, s1)
    _submod_mem(asm, s4, s4, s5)             # e = (x+y)^2 - a_ - b_
    _addmod_mem(asm, s6, s3, s1)             # g = d_ + b_
    _submod_mem(asm, s5, s6, s2)             # f = g - c_
    _submod_mem(asm, s7, s3, s1)             # h = d_ - b_
    _mulmod_mem(asm, x, s4, s5)              # x3 = e*f
    _mulmod_mem(asm, y, s6, s7)              # y3 = g*h
    _mulmod_mem(asm, t, s4, s7)              # t3 = e*h
    _mulmod_mem(asm, z, s5, s6)              # z3 = f*g
    asm.emit('JUMP')


def _smul_subroutine(asm):
    """ACC <- scalar * PT (binary double-and-add; clobbers PT).

    Entry stack: [ret, scalar]; exit: [] (result in ACC, identity if
    scalar is 0).  ACC is (re)initialized to the ETEC identity here."""
    asm.label('smul')                        # [ret, s]
    asm.push(0)
    _ms(asm, ACC)
    asm.push(1)
    _ms(asm, ACC + 32)
    asm.push(0)
    _ms(asm, ACC + 64)
    asm.push(1)
    _ms(asm, ACC + 96)
    asm.label('smul_loop')                   # [ret, s]
    asm.emit('DUP1').emit('ISZERO')
    asm.push_label('smul_end').emit('JUMPI')
    asm.emit('DUP1').push(1).emit('AND').emit('ISZERO')
    asm.push_label('smul_skip').emit('JUMPI')
    asm.push_label('smul_back1')
    asm.push_label('etec_add').emit('JUMP')
    asm.label('smul_back1')
    asm.label('smul_skip')
    asm.push_label('smul_back2')
    asm.push_label('etec_dbl').emit('JUMP')
    asm.label('smul_back2')
    asm.push(2).emit('SWAP1').emit('DIV')    # s >>= 1
    asm.push_label('smul_loop').emit('JUMP')
    asm.label('smul_end')                    # [ret, 0]
    asm.emit('POP')
    asm.emit('JUMP')


def _to_affine_subroutine(asm):
    """AFF <- affine(ACC) via modexp-precompile inverse of z.
    Stack: [ret] -> []."""
    asm.label('to_affine')
    for off, val in ((MODIN, 32), (MODIN + 32, 32), (MODIN + 64, 32)):
        asm.push(val)
        _ms(asm, off)
    _ml(asm, ACC + 96)
    _ms(asm, MODIN + 96)                     # base = z
    asm.push(Q - 2)
    _ms(asm, MODIN + 128)                    # exponent
    asm.push(Q)
    _ms(asm, MODIN + 160)                    # modulus
    asm.push(32).push(MODOUT).push(0xC0).push(MODIN)
    asm.push(0x05).push(100000).emit('STATICCALL')
    asm.emit('ISZERO')
    asm.push_label('fail').emit('JUMPI')
    _mulmod_mem(asm, AFF, ACC, MODOUT)       # x/z
    _mulmod_mem(asm, AFF + 32, ACC + 32, MODOUT)  # y/z
    asm.emit('JUMP')


def _load_point_etec(asm, x_word, y_word):
    """PT <- ETEC(calldata[x_word], calldata[y_word])."""
    asm.push(32 * x_word).emit('CALLDATALOAD')
    asm.emit('DUP1')
    _ms(asm, PT)
    asm.push(32 * y_word).emit('CALLDATALOAD')
    asm.emit('DUP1')
    _ms(asm, PT + 32)
    # t = x*y mod Q  (stack currently [x, y])
    asm.push(Q).emit('SWAP2').emit('MULMOD')
    _ms(asm, PT + 64)
    asm.push(1)
    _ms(asm, PT + 96)


def scalar_mult_code():
    """Runtime bytecode: calldata [x, y, scalar] -> 64 bytes [rx, ry]."""
    asm = Assembler()
    _load_point_etec(asm, 0, 1)
    asm.push_label('done_mul')
    asm.push(64).emit('CALLDATALOAD')        # [ret, s]
    asm.push_label('smul').emit('JUMP')
    asm.label('done_mul')
    asm.push_label('done_aff')
    asm.push_label('to_affine').emit('JUMP')
    asm.label('done_aff')
    asm.push(64).push(AFF).emit('RETURN')
    asm.label('fail')
    asm.push(0).push(0).emit('REVERT')
    _smul_subroutine(asm)
    _etec_add_subroutine(asm)
    _etec_dbl_subroutine(asm)
    _to_affine_subroutine(asm)
    return asm.assemble()


def eddsa_verify_code():
    """Runtime bytecode of EdDSA.Verify: calldata
    [A.x, A.y, hashed_msg, R.x, R.y, s] -> 32 bytes (1 accept / 0).

    Same protocol as contracts/EdDSA.sol: t = HashToInt(pack(R, A, M)),
    accept iff s*B == t*A."""
    asm = Assembler()
    # lhs = s * B
    asm.push(GEN[0])
    asm.emit('DUP1')
    _ms(asm, PT)
    asm.push(GEN[1])
    asm.emit('DUP1')
    _ms(asm, PT + 32)
    asm.push(Q).emit('SWAP2').emit('MULMOD')
    _ms(asm, PT + 64)
    asm.push(1)
    _ms(asm, PT + 96)
    asm.push_label('lhs_done')
    asm.push(32 * 5).emit('CALLDATALOAD')    # [ret, s]
    asm.push_label('smul').emit('JUMP')
    asm.label('lhs_done')
    asm.push_label('lhs_aff')
    asm.push_label('to_affine').emit('JUMP')
    asm.label('lhs_aff')
    _ml(asm, AFF)
    _ms(asm, LHS)
    _ml(asm, AFF + 32)
    _ms(asm, LHS + 32)
    # t = sha256(R.x || R.y || A.x || A.y || M) & (2^250 - 1)
    for i, word in enumerate((3, 4, 0, 1, 2)):
        asm.push(32 * word).emit('CALLDATALOAD')
        _ms(asm, SHABUF + 32 * i)
    asm.push(32).push(MODOUT).push(160).push(SHABUF)
    asm.push(0x02).push(100000).emit('STATICCALL')
    asm.emit('ISZERO')
    asm.push_label('fail').emit('JUMPI')
    # rhs = t * A
    _load_point_etec(asm, 0, 1)
    asm.push_label('rhs_done')
    asm.push(MASK_250)
    _ml(asm, MODOUT)
    asm.emit('AND')                          # [ret, t]
    asm.push_label('smul').emit('JUMP')
    asm.label('rhs_done')
    asm.push_label('rhs_aff')
    asm.push_label('to_affine').emit('JUMP')
    asm.label('rhs_aff')
    # compare
    _ml(asm, LHS)
    _ml(asm, AFF)
    asm.emit('EQ')
    _ml(asm, LHS + 32)
    _ml(asm, AFF + 32)
    asm.emit('EQ')
    asm.emit('AND')
    _ms(asm, MODOUT)
    asm.push(32).push(MODOUT).emit('RETURN')
    asm.label('fail')
    asm.push(0).push(0).emit('REVERT')
    _smul_subroutine(asm)
    _etec_add_subroutine(asm)
    _etec_dbl_subroutine(asm)
    _to_affine_subroutine(asm)
    return asm.assemble()


# wNAF twin memory map (above the shared regions)
WNAF_W = 0x400     # 8 window points x 4 ETEC words (odd multiples of P)
WNAF_DIG = 0x800   # up to 256 digit slots (c in [0, 31]; 0 = skip)


def _copy_words(asm, dst, src, n):
    for w in range(n):
        _ml(asm, src + 32 * w)
        _ms(asm, dst + 32 * w)


def _wnaf_build_window(asm):
    """W[i] <- (2i+1) * P for i in 0..7 (contracts/wNAF.sol buildWindow):
    W[0] = P, PT <- 2P, then W[i] = W[i-1] + 2P via the shared adder."""
    _copy_words(asm, WNAF_W, PT, 4)
    asm.push_label('ww_dbl_back')
    asm.push_label('etec_dbl').emit('JUMP')  # PT <- 2P
    asm.label('ww_dbl_back')
    for i in range(1, 8):
        _copy_words(asm, ACC, WNAF_W + 128 * (i - 1), 4)
        asm.push_label('ww_add_back_%d' % i)
        asm.push_label('etec_add').emit('JUMP')
        asm.label('ww_add_back_%d' % i)
        _copy_words(asm, WNAF_W + 128 * i, ACC, 4)


def scalar_mult_naf5_code():
    """Runtime bytecode of wNAF.scalarMultNAF5 (contracts/wNAF.sol:41-83):
    calldata [x, y, scalar] -> 64 bytes [rx, ry].

    Same structure as the contract: build the odd-multiple window
    {1,3,..,15}P, emit width-5 wNAF digits LSB-first into memory (digit
    slot stores the raw c = k mod 32; c > 16 encodes the negative digit of
    magnitude 32 - c), then the MSB-first double-and-add over the digits
    with on-the-fly window negation (x,t sign flip)."""
    asm = Assembler()
    _load_point_etec(asm, 0, 1)
    _wnaf_build_window(asm)

    # ---- digit pass: k -> digits[0..n) ----
    asm.push(64).emit('CALLDATALOAD')        # [k]
    asm.push(0)                              # [k, n]
    asm.label('dig_loop')                    # [k, n]
    asm.emit('DUP2').emit('ISZERO')
    asm.push_label('dig_done').emit('JUMPI')
    asm.push(0)                              # [k, n, d=0]
    asm.emit('DUP3').push(1).emit('AND').emit('ISZERO')
    asm.push_label('dig_store').emit('JUMPI')
    asm.emit('POP')                          # odd: drop d=0
    asm.emit('DUP2').push(31).emit('AND')    # [k, n, c] (k mod 32)
    asm.emit('DUP1').push(16).emit('LT')     # [k, n, c, 16<c]
    asm.push_label('dig_neg').emit('JUMPI')
    # positive digit: k -= c
    asm.emit('DUP1')                         # [k, n, c, c]
    asm.emit('SWAP3')                        # [c, n, c, k]
    asm.emit('SUB')                          # [c, n, k-c]  (a=k, b=c)
    asm.emit('SWAP2')                        # [k-c, n, c]
    asm.push_label('dig_store').emit('JUMP')
    asm.label('dig_neg')                     # [k, n, c]: k += 32 - c
    asm.emit('DUP1').push(32).emit('SUB')    # [k, n, c, 32-c]
    asm.emit('DUP4').emit('ADD')             # [k, n, c, k+32-c]
    asm.emit('SWAP3').emit('POP')            # [k', n, c]
    asm.label('dig_store')                   # [k, n, d]
    asm.emit('DUP2').push(32).emit('MUL')
    asm.push(WNAF_DIG).emit('ADD')           # [k, n, d, addr]
    asm.emit('MSTORE')                       # [k, n]
    asm.push(1).emit('ADD')                  # n += 1  (a=1, b=n)
    asm.emit('SWAP1').push(2).emit('SWAP1')
    asm.emit('DIV').emit('SWAP1')            # k /= 2
    asm.push_label('dig_loop').emit('JUMP')
    asm.label('dig_done')                    # [k=0, n]
    asm.emit('SWAP1').emit('POP')            # [n]

    # ---- ACC <- identity ----
    asm.push(0)
    _ms(asm, ACC)
    asm.push(1)
    _ms(asm, ACC + 32)
    asm.push(0)
    _ms(asm, ACC + 64)
    asm.push(1)
    _ms(asm, ACC + 96)

    # ---- main loop: for (i = n; i > 0; i--) ----
    asm.label('mul_loop')                    # [i]
    asm.emit('DUP1').emit('ISZERO')
    asm.push_label('mul_done').emit('JUMPI')
    # ACC <- 2*ACC (copy through PT; the shared doubler works on PT)
    _copy_words(asm, PT, ACC, 4)
    asm.push_label('ml_dbl_back')
    asm.push_label('etec_dbl').emit('JUMP')
    asm.label('ml_dbl_back')
    _copy_words(asm, ACC, PT, 4)
    # d = digits[i-1]
    asm.emit('DUP1').push(1).emit('SWAP1').emit('SUB')   # [i, i-1]
    asm.push(32).emit('MUL').push(WNAF_DIG).emit('ADD')
    asm.emit('MLOAD')                        # [i, d]
    asm.emit('DUP1').emit('ISZERO')
    asm.push_label('mul_skip').emit('JUMPI')
    asm.emit('DUP1').push(16).emit('LT')     # [i, d, 16<d]
    asm.push_label('mul_neg').emit('JUMPI')
    # PT <- W[(d-1)/2]
    asm.push(1).emit('SWAP1').emit('SUB')    # [i, d-1]
    asm.push(2).emit('SWAP1').emit('DIV')
    asm.push(128).emit('MUL').push(WNAF_W).emit('ADD')   # [i, waddr]
    asm.emit('DUP1')
    for w in range(4):
        asm.emit('DUP1')
        asm.push(32 * w).emit('ADD').emit('MLOAD')
        _ms(asm, PT + 32 * w)
    asm.emit('POP').emit('POP')              # [i]
    asm.push_label('ml_add').emit('JUMP')
    asm.label('mul_neg')                     # [i, d]: PT <- -W[(31-d)/2]
    asm.push(31).emit('SUB')                 # [i, 31-d]  (a=31? check)
    asm.push(2).emit('SWAP1').emit('DIV')
    asm.push(128).emit('MUL').push(WNAF_W).emit('ADD')   # [i, waddr]
    for w in range(4):
        asm.emit('DUP1')
        asm.push(32 * w).emit('ADD').emit('MLOAD')
        _ms(asm, PT + 32 * w)
    asm.emit('POP')                          # [i]
    # negate x and t (y, z unchanged): v <- Q - (v % Q)
    for off in (PT, PT + 64):
        asm.push(Q)
        _ml(asm, off)
        asm.push(Q).emit('SWAP1').emit('MOD')            # v % Q
        asm.emit('SWAP1').emit('SUB')                    # Q - (v % Q)
        asm.push(Q).emit('SWAP1').emit('MOD')            # mod Q (v==0 case)
        _ms(asm, off)
    asm.label('ml_add')                      # [i]
    asm.push_label('ml_add_back')
    asm.push_label('etec_add').emit('JUMP')
    asm.label('ml_add_back')                 # [i]
    asm.push_label('mul_next').emit('JUMP')
    asm.label('mul_skip')                    # [i, 0] (the skipped digit)
    asm.emit('POP')
    asm.label('mul_next')                    # [i]
    asm.push(1).emit('SWAP1').emit('SUB')    # i -= 1
    asm.push_label('mul_loop').emit('JUMP')
    asm.label('mul_done')                    # [0]
    asm.emit('POP')
    asm.push_label('naf_aff_back')
    asm.push_label('to_affine').emit('JUMP')
    asm.label('naf_aff_back')
    asm.push(64).push(AFF).emit('RETURN')
    asm.label('fail')
    asm.push(0).push(0).emit('REVERT')
    _etec_add_subroutine(asm)
    _etec_dbl_subroutine(asm)
    _to_affine_subroutine(asm)
    return asm.assemble()


def scalar_mult_naf5_evm(x, y, scalar):
    """Execute the wNAF width-5 scalarMult twin; returns (rx, ry)."""
    calldata = b''.join(int(v).to_bytes(32, 'big')
                        for v in (x % Q, y % Q, scalar))
    out = execute(scalar_mult_naf5_code(), calldata, gas_limit=10_000_000)
    return (int.from_bytes(out[:32], 'big'),
            int.from_bytes(out[32:], 'big'))


def scalar_mult_evm(x, y, scalar):
    """Execute the scalarMult twin; returns (rx, ry)."""
    calldata = b''.join(int(v).to_bytes(32, 'big')
                        for v in (x % Q, y % Q, scalar))
    out = execute(scalar_mult_code(), calldata, gas_limit=5_000_000)
    return (int.from_bytes(out[:32], 'big'),
            int.from_bytes(out[32:], 'big'))


def eddsa_verify_evm(pubkey, hashed_msg, R, s):
    """Execute the EdDSA.Verify twin; returns bool."""
    calldata = b''.join(int(v).to_bytes(32, 'big') for v in
                        (pubkey[0] % Q, pubkey[1] % Q, hashed_msg,
                         R[0] % Q, R[1] % Q, s))
    out = execute(eddsa_verify_code(), calldata, gas_limit=20_000_000)
    return int.from_bytes(out, 'big') == 1

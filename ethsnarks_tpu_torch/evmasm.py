"""EVM assembler and a small interpreter of the EVM's arithmetic subset
(own copy of ``ethsnarks_tpu/evmasm.py:12-491``).

The assembler emits bytecode (PUSH sizes, labels, a constructor header);
:func:`execute` runs it with the EIP-196/197/198 precompiles and SHA-256
on the host (backed by this package's :mod:`.bn254`, :mod:`.pairing` and
:mod:`.keccak`), metering gas by the Istanbul schedule.  It is what runs
the bytecode twin of Verifier.sol (:mod:`.evm_verifier`) in-process.
"""


class _Op(object):
    __slots__ = ('name', 'code', 'imm')

    def __init__(self, name, code, imm=0):
        self.name = name
        self.code = code
        self.imm = imm


_OPCODES = {}


def _define(name, code, imm=0):
    _OPCODES[name] = _Op(name, code, imm)


for _n, _c in [
        ('STOP', 0x00), ('ADD', 0x01), ('MUL', 0x02), ('SUB', 0x03),
        ('DIV', 0x04), ('MOD', 0x06), ('ADDMOD', 0x08), ('MULMOD', 0x09),
        ('EXP', 0x0a), ('LT', 0x10), ('GT', 0x11), ('EQ', 0x14),
        ('ISZERO', 0x15), ('AND', 0x16), ('OR', 0x17), ('XOR', 0x18),
        ('NOT', 0x19), ('SHA3', 0x20), ('CALLDATALOAD', 0x35),
        ('CALLDATASIZE', 0x36), ('CALLDATACOPY', 0x37),
        ('RETURNDATASIZE', 0x3d), ('RETURNDATACOPY', 0x3e),
        ('POP', 0x50), ('MLOAD', 0x51),
        ('MSTORE', 0x52), ('JUMP', 0x56), ('JUMPI', 0x57), ('PC', 0x58),
        ('MSIZE', 0x59), ('GAS', 0x5a),
        ('JUMPDEST', 0x5b), ('STATICCALL', 0xfa),
        ('RETURN', 0xf3), ('REVERT', 0xfd)]:
    _define(_n, _c)
for _i in range(1, 33):
    _define('PUSH%d' % _i, 0x5f + _i, imm=_i)
for _i in range(1, 17):
    _define('DUP%d' % _i, 0x7f + _i)
    _define('SWAP%d' % _i, 0x8f + _i)


class Assembler(object):
    """Tiny two-pass assembler: ops are (name,) or (name, value) tuples;
    labels via ('LABEL', name) and ('PUSHLABEL', name)."""

    def __init__(self):
        self.items = []

    def emit(self, name, value=None):
        self.items.append((name, value))
        return self

    def push(self, value):
        value = int(value)
        assert value >= 0
        nbytes = max(1, (value.bit_length() + 7) // 8)
        assert nbytes <= 32
        self.emit('PUSH%d' % nbytes, value)
        return self

    def label(self, name):
        self.items.append(('LABEL', name))
        return self

    def push_label(self, name):
        self.items.append(('PUSHLABEL', name))
        return self

    def assemble(self):
        # pass 1: offsets (PUSHLABEL always 3 bytes: PUSH2 imm16)
        offsets = {}
        pc = 0
        for name, value in self.items:
            if name == 'LABEL':
                offsets[value] = pc
                pc += 1  # JUMPDEST byte
            elif name == 'PUSHLABEL':
                pc += 3
            else:
                op = _OPCODES[name]
                pc += 1 + op.imm
        # pass 2: emit
        out = bytearray()
        for name, value in self.items:
            if name == 'LABEL':
                out.append(_OPCODES['JUMPDEST'].code)
            elif name == 'PUSHLABEL':
                out.append(_OPCODES['PUSH2'].code)
                out += offsets[value].to_bytes(2, 'big')
            else:
                op = _OPCODES[name]
                out.append(op.code)
                if op.imm:
                    out += int(value).to_bytes(op.imm, 'big')
        return bytes(out)


def deployable(runtime_code):
    """Wrap runtime bytecode in a minimal constructor that returns it
    (PUSH len, PUSH offset, PUSH 0, CODECOPY, PUSH len, PUSH 0, RETURN)."""
    n = len(runtime_code)
    head = Assembler()
    head.push(n)
    # CODECOPY(destOffset=0, offset=<after header>, length=n)
    # header length is computed after assembling with a placeholder.
    for hdr_len in range(8, 64):
        head = Assembler()
        head.push(n).push(hdr_len).push(0)
        head.items.append(('CODECOPY', None))
        head.push(n).push(0)
        head.emit('RETURN')
        code = bytearray()
        for name, value in head.items:
            if name == 'CODECOPY':
                code.append(0x39)
            else:
                op = _OPCODES[name]
                code.append(op.code)
                if op.imm:
                    code += int(value).to_bytes(op.imm, 'big')
        if len(code) == hdr_len:
            return bytes(code) + runtime_code
    raise RuntimeError("constructor header did not converge")


_U256 = (1 << 256) - 1


class EvmError(Exception):
    pass


# ---------------- EIP-196/197/198 precompiles (host-backed) ----------------

def _words(data, n):
    """First n 32-byte big-endian words of data, zero-extended (EVM call
    inputs are implicitly right-padded)."""
    data = bytes(data).ljust(32 * n, b'\x00')
    return [int.from_bytes(data[32 * i:32 * i + 32], 'big') for i in range(n)]


def _decode_g1(x, y):
    from .bn254 import Fq, FIELD_MODULUS, is_on_curve, B1
    if x >= FIELD_MODULUS or y >= FIELD_MODULUS:
        raise EvmError("G1 coordinate >= field modulus")
    if x == 0 and y == 0:
        return None
    pt = (Fq(x), Fq(y))
    if not is_on_curve(pt, B1):
        raise EvmError("G1 point not on curve")
    return pt


def _encode_g1(pt):
    if pt is None:
        return b'\x00' * 64
    return pt[0].n.to_bytes(32, 'big') + pt[1].n.to_bytes(32, 'big')


def _decode_g2(x_c1, x_c0, y_c1, y_c0):
    """EIP-197 G2 encoding: each Fq2 element a*i + b arrives as (a, b) -
    imaginary coefficient first.  Requires on-curve AND correct-subgroup."""
    from .bn254 import (
        Fq2, FIELD_MODULUS, CURVE_ORDER, is_on_curve, multiply, B2)
    for v in (x_c1, x_c0, y_c1, y_c0):
        if v >= FIELD_MODULUS:
            raise EvmError("G2 coordinate >= field modulus")
    if x_c1 == x_c0 == y_c1 == y_c0 == 0:
        return None
    pt = (Fq2([x_c0, x_c1]), Fq2([y_c0, y_c1]))
    if not is_on_curve(pt, B2):
        raise EvmError("G2 point not on curve")
    if multiply(pt, CURVE_ORDER) is not None:
        raise EvmError("G2 point not in the r-order subgroup")
    return pt


def _pre_ecadd(data):
    from .bn254 import add
    x1, y1, x2, y2 = _words(data, 4)
    return _encode_g1(add(_decode_g1(x1, y1), _decode_g1(x2, y2)))


def _pre_ecmul(data):
    from .bn254 import multiply
    x, y, s = _words(data, 3)
    pt = _decode_g1(x, y)
    return _encode_g1(multiply(pt, s) if pt is not None else None)


def _pre_pairing(data):
    from .pairing import pairing_product_is_one
    if len(data) % 192 != 0:
        raise EvmError("pairing input not a multiple of 192 bytes")
    pairs = []
    for k in range(len(data) // 192):
        w = _words(data[192 * k:192 * (k + 1)], 6)
        p = _decode_g1(w[0], w[1])
        q = _decode_g2(w[2], w[3], w[4], w[5])
        if p is not None and q is not None:
            pairs.append((p, q))
    ok = pairing_product_is_one(pairs) if pairs else True
    return int(ok).to_bytes(32, 'big')


def _pre_modexp(data):
    """EIP-198 big-int modular exponentiation."""
    bl, el, ml = _words(data, 3)
    body = bytes(data[96:]).ljust(bl + el + ml, b'\x00')
    b = int.from_bytes(body[:bl], 'big')
    e = int.from_bytes(body[bl:bl + el], 'big')
    m = int.from_bytes(body[bl + el:bl + el + ml], 'big')
    r = 0 if m == 0 else pow(b, e, m)
    return r.to_bytes(ml, 'big')


def _pre_sha256(data):
    import hashlib
    return hashlib.sha256(bytes(data)).digest()


_PRECOMPILES = {
    0x02: _pre_sha256,
    0x05: _pre_modexp,
    0x06: _pre_ecadd,
    0x07: _pre_ecmul,
    0x08: _pre_pairing,
}


def call_precompile(address, data):
    """(success, returndata) for a call to a precompile address."""
    fn = _PRECOMPILES.get(address)
    if fn is None:
        return False, b''
    try:
        return True, fn(data)
    except EvmError:
        return False, b''


# ---------------- gas schedule (Istanbul) ----------------
# Per-opcode constant costs; dynamic components (EXP exponent bytes, SHA3 /
# copy words, memory expansion, precompiles) are charged in execute().
# Mirrors the fee schedule the reference measures via eth-gas-reporter /
# estimateGas (truffle.js:22-27, test/TestMiMC.js:18-19).

_GAS_BASE = 2        # POP, PC, MSIZE, GAS, CALLDATASIZE, RETURNDATASIZE
_GAS_VERYLOW = 3     # arith/logic/push/dup/swap/mload/mstore/calldataload
_GAS_LOW = 5         # MUL DIV MOD
_GAS_MID = 8         # ADDMOD MULMOD JUMP
_GAS_HIGH = 10       # JUMPI

_GAS_CONST = {
    0x00: 0,                       # STOP
    0x01: _GAS_VERYLOW, 0x02: _GAS_LOW, 0x03: _GAS_VERYLOW,
    0x04: _GAS_LOW, 0x06: _GAS_LOW, 0x08: _GAS_MID, 0x09: _GAS_MID,
    0x0a: 10,                      # EXP (plus 50/exponent byte)
    0x10: _GAS_VERYLOW, 0x11: _GAS_VERYLOW, 0x14: _GAS_VERYLOW,
    0x15: _GAS_VERYLOW, 0x16: _GAS_VERYLOW, 0x17: _GAS_VERYLOW,
    0x18: _GAS_VERYLOW, 0x19: _GAS_VERYLOW,
    0x20: 30,                      # SHA3 (plus 6/word)
    0x35: _GAS_VERYLOW, 0x36: _GAS_BASE,
    0x37: _GAS_VERYLOW,            # CALLDATACOPY (plus 3/word)
    0x3d: _GAS_BASE,
    0x3e: _GAS_VERYLOW,            # RETURNDATACOPY (plus 3/word)
    0x50: _GAS_BASE, 0x51: _GAS_VERYLOW, 0x52: _GAS_VERYLOW,
    0x56: _GAS_MID, 0x57: _GAS_HIGH, 0x58: _GAS_BASE, 0x59: _GAS_BASE,
    0x5a: _GAS_BASE, 0x5b: 1,
    0xfa: 700,                     # STATICCALL (plus precompile cost)
    0xf3: 0, 0xfd: 0,
}


def _precompile_gas(address, data):
    """Istanbul gas for the supported precompiles (EIP-1108 / EIP-2565-
    style modexp)."""
    n = len(data)
    if address == 0x02:                      # sha256
        return 60 + 12 * ((n + 31) // 32)
    if address == 0x05:                      # modexp
        bl, el, ml = _words(data, 3)
        body = bytes(data[96:]).ljust(bl + el + ml, b'\x00')
        e_head = int.from_bytes(body[bl:bl + min(el, 32)], 'big')
        if el <= 32:
            iter_count = max(e_head.bit_length() - 1, 0)
        else:
            iter_count = 8 * (el - 32) + max(e_head.bit_length() - 1, 0)
        words = (max(bl, ml) + 7) // 8
        return max(200, words * words * max(iter_count, 1) // 3)
    if address == 0x06:                      # ecadd
        return 150
    if address == 0x07:                      # ecmul
        return 6000
    if address == 0x08:                      # pairing
        return 45000 + 34000 * (n // 192)
    return 0


def _mem_words_cost(n_words):
    return 3 * n_words + n_words * n_words // 512


def execute(code, calldata=b'', gas_limit=10_000_000, with_gas=False):
    """Interpret the arithmetic EVM subset; returns the RETURN data
    (or (data, gas_used) when ``with_gas``).

    Supports the opcodes the generated hash contracts use (stack ops,
    modular arithmetic, memory, keccak via SHA3, jumps).  Gas is metered
    per the Istanbul schedule (constant costs + EXP/SHA3/copy dynamics,
    quadratic memory expansion, EIP-1108 precompile prices) so the EVM
    twins report the same figure the reference logs via estimateGas."""
    from .keccak import keccak_256

    stack = []
    memory = bytearray()
    returndata = b''
    pc = 0
    steps = 0
    gas = [0]

    def finish(ret):
        return (ret, gas[0]) if with_gas else ret

    def mem_ensure(end):
        if len(memory) < end:
            old_w = (len(memory) + 31) // 32
            new_w = (end + 31) // 32
            gas[0] += _mem_words_cost(new_w) - _mem_words_cost(old_w)
            memory.extend(b'\x00' * (new_w * 32 - len(memory)))

    while pc < len(code):
        steps += 1
        if steps > gas_limit:
            raise EvmError("out of gas (interpreter step limit)")
        op = code[pc]
        if 0x60 <= op <= 0x7f:  # PUSH1..32
            n = op - 0x5f
            gas[0] += _GAS_VERYLOW
            stack.append(int.from_bytes(code[pc + 1:pc + 1 + n], 'big'))
            pc += 1 + n
            continue
        if 0x80 <= op <= 0x8f:  # DUP1..16
            gas[0] += _GAS_VERYLOW
            stack.append(stack[-(op - 0x7f)])
            pc += 1
            continue
        if 0x90 <= op <= 0x9f:  # SWAP1..16
            gas[0] += _GAS_VERYLOW
            n = op - 0x8f
            stack[-1], stack[-1 - n] = stack[-1 - n], stack[-1]
            pc += 1
            continue
        gas[0] += _GAS_CONST.get(op, _GAS_VERYLOW)
        if op == 0x0a and len(stack) >= 2:       # EXP: 50/exponent byte
            gas[0] += 50 * ((stack[-2].bit_length() + 7) // 8)
        elif op == 0x20 and len(stack) >= 2:     # SHA3: 6/word
            gas[0] += 6 * ((stack[-2] + 31) // 32)
        elif op in (0x37, 0x3e) and len(stack) >= 3:  # copies: 3/word
            gas[0] += 3 * ((stack[-3] + 31) // 32)
        pc += 1
        if op == 0x00:  # STOP
            return finish(b'')
        elif op == 0x01:
            a, b = stack.pop(), stack.pop()
            stack.append((a + b) & _U256)
        elif op == 0x02:
            a, b = stack.pop(), stack.pop()
            stack.append((a * b) & _U256)
        elif op == 0x03:
            a, b = stack.pop(), stack.pop()
            stack.append((a - b) & _U256)
        elif op == 0x04:
            a, b = stack.pop(), stack.pop()
            stack.append(0 if b == 0 else a // b)
        elif op == 0x06:
            a, b = stack.pop(), stack.pop()
            stack.append(0 if b == 0 else a % b)
        elif op == 0x08:
            a, b, n = stack.pop(), stack.pop(), stack.pop()
            stack.append(0 if n == 0 else (a + b) % n)
        elif op == 0x09:
            a, b, n = stack.pop(), stack.pop(), stack.pop()
            stack.append(0 if n == 0 else (a * b) % n)
        elif op == 0x0a:
            a, b = stack.pop(), stack.pop()
            stack.append(pow(a, b, 1 << 256))
        elif op == 0x10:
            a, b = stack.pop(), stack.pop()
            stack.append(1 if a < b else 0)
        elif op == 0x11:
            a, b = stack.pop(), stack.pop()
            stack.append(1 if a > b else 0)
        elif op == 0x14:
            a, b = stack.pop(), stack.pop()
            stack.append(1 if a == b else 0)
        elif op == 0x15:
            stack.append(1 if stack.pop() == 0 else 0)
        elif op == 0x16:
            a, b = stack.pop(), stack.pop()
            stack.append(a & b)
        elif op == 0x17:
            a, b = stack.pop(), stack.pop()
            stack.append(a | b)
        elif op == 0x18:
            a, b = stack.pop(), stack.pop()
            stack.append(a ^ b)
        elif op == 0x19:
            stack.append(stack.pop() ^ _U256)
        elif op == 0x20:  # SHA3
            off, size = stack.pop(), stack.pop()
            mem_ensure(off + size)
            stack.append(int.from_bytes(
                keccak_256(bytes(memory[off:off + size])).digest(), 'big'))
        elif op == 0x35:  # CALLDATALOAD
            off = stack.pop()
            chunk = calldata[off:off + 32]
            stack.append(int.from_bytes(chunk.ljust(32, b'\x00'), 'big'))
        elif op == 0x36:
            stack.append(len(calldata))
        elif op == 0x37:  # CALLDATACOPY
            dst, off, size = stack.pop(), stack.pop(), stack.pop()
            mem_ensure(dst + size)
            chunk = calldata[off:off + size]
            memory[dst:dst + size] = chunk.ljust(size, b'\x00')
        elif op == 0x3d:  # RETURNDATASIZE
            stack.append(len(returndata))
        elif op == 0x3e:  # RETURNDATACOPY
            dst, off, size = stack.pop(), stack.pop(), stack.pop()
            if off + size > len(returndata):
                raise EvmError("returndatacopy out of bounds")
            mem_ensure(dst + size)
            memory[dst:dst + size] = returndata[off:off + size]
        elif op == 0x50:
            stack.pop()
        elif op == 0x51:
            off = stack.pop()
            mem_ensure(off + 32)
            stack.append(int.from_bytes(memory[off:off + 32], 'big'))
        elif op == 0x52:
            off, val = stack.pop(), stack.pop()
            mem_ensure(off + 32)
            memory[off:off + 32] = val.to_bytes(32, 'big')
        elif op == 0x56:  # JUMP
            dest = stack.pop()
            if dest >= len(code) or code[dest] != 0x5b:
                raise EvmError("bad jump destination")
            pc = dest
        elif op == 0x57:  # JUMPI
            dest, cond = stack.pop(), stack.pop()
            if cond:
                if dest >= len(code) or code[dest] != 0x5b:
                    raise EvmError("bad jump destination")
                pc = dest
        elif op == 0x58:
            stack.append(pc - 1)
        elif op == 0x59:  # MSIZE
            stack.append((len(memory) + 31) // 32 * 32)
        elif op == 0x5a:  # GAS (interpreter: remaining step budget)
            stack.append(gas_limit - steps)
        elif op == 0x5b:  # JUMPDEST
            pass
        elif op == 0xfa:  # STATICCALL (precompiles only)
            _gas, addr, in_off, in_size, out_off, out_size = (
                stack.pop(), stack.pop(), stack.pop(), stack.pop(),
                stack.pop(), stack.pop())
            mem_ensure(in_off + in_size)
            data_in = bytes(memory[in_off:in_off + in_size])
            gas[0] += _precompile_gas(addr, data_in)
            ok, returndata = call_precompile(addr, data_in)
            if ok and out_size:
                mem_ensure(out_off + out_size)
                n = min(out_size, len(returndata))
                memory[out_off:out_off + n] = returndata[:n]
            stack.append(1 if ok else 0)
        elif op == 0xf3:  # RETURN
            off, size = stack.pop(), stack.pop()
            mem_ensure(off + size)
            return finish(bytes(memory[off:off + size]))
        elif op == 0xfd:  # REVERT
            raise EvmError("revert")
        else:
            raise EvmError("unsupported opcode 0x%02x" % op)
    return finish(b'')

"""Generated EVM bytecode for the Poseidon permutation (own copy of
``ethsnarks_tpu/poseidon/contract.py``).

The round constants C and the MDS matrix M are stored to memory once, the
state lives in memory, and the three round phases run as bytecode loops
(an order of magnitude smaller than fully unrolled stack code for the same
permutation).

Call convention: calldata = inputs (32 bytes each, fewer than t) ->
returns state[0] (32 bytes).  :func:`..evmasm.execute` runs it against the
host :func:`.permutation.poseidon`.
"""

from ..field import SNARK_SCALAR_FIELD
from ..evmasm import Assembler, deployable
from .permutation import DefaultParams

P = SNARK_SCALAR_FIELD

_WORD = 32


def poseidon_contract_opcodes(params=None, n_inputs=2):
    params = params or DefaultParams
    t = params.t
    assert 0 < n_inputs < t
    half_f = params.nRoundsF // 2
    n_p = params.nRoundsP
    n_rounds = params.nRoundsF + n_p

    m_base = 0x40
    c_base = m_base + t * t * _WORD
    s_base = c_base + n_rounds * _WORD
    ns_base = s_base + t * _WORD

    asm = Assembler()

    # 1. constants into memory
    for i in range(t):
        for j in range(t):
            asm.push(params.constants_M[i][j])
            asm.push(m_base + (i * t + j) * _WORD)
            asm.emit('MSTORE')
    for r, c in enumerate(params.constants_C):
        asm.push(c % P)
        asm.push(c_base + r * _WORD)
        asm.emit('MSTORE')

    # 2. state init from calldata (missing inputs are zero by MSTORE of 0)
    for j in range(t):
        if j < n_inputs:
            asm.push(j * _WORD)
            asm.emit('CALLDATALOAD')
        else:
            asm.push(0)
        asm.push(s_base + j * _WORD)
        asm.emit('MSTORE')

    def emit_sbox(j):
        # state[j] = state[j]^5 mod p
        addr = s_base + j * _WORD
        # x
        asm.push(addr)
        asm.emit('MLOAD')          # [x]
        # x2 = mulmod(x, x, p)
        asm.push(P)                # [x, p]
        asm.emit('DUP2')           # [x, p, x]
        asm.emit('DUP1')           # [x, p, x, x]
        asm.emit('MULMOD')         # [x, x2]
        # x4 = mulmod(x2, x2, p)
        asm.push(P)                # [x, x2, p]
        asm.emit('SWAP1')          # [x, p, x2]
        asm.emit('DUP1')           # [x, p, x2, x2]
        asm.emit('MULMOD')         # [x, x4]
        # x5 = mulmod(x4, x, p)
        asm.push(P)                # [x, x4, p]
        asm.emit('SWAP2')          # [p, x4, x]
        asm.emit('MULMOD')         # [x5]
        asm.push(addr)
        asm.emit('MSTORE')

    def emit_ark_all():
        # c_r address = c_base + r*32; r is on stack top entering the round
        # body; we keep [r] and compute per-element.
        for j in range(t):
            addr = s_base + j * _WORD
            asm.push(P)            # [r, p]
            asm.emit('DUP2')       # [r, p, r]
            asm.push(_WORD)
            asm.emit('MUL')        # [r, p, r*32]
            asm.push(c_base)
            asm.emit('ADD')        # [r, p, addr_c]
            asm.emit('MLOAD')      # [r, p, C_r]
            asm.push(addr)
            asm.emit('MLOAD')      # [r, p, C_r, s_j]
            asm.emit('ADDMOD')     # [r, (s_j + C_r) % p]
            asm.push(addr)
            asm.emit('MSTORE')     # [r]

    def emit_mix():
        for i in range(t):
            # acc = sum_j mulmod(M[i][j], s[j], p)
            asm.push(0)            # [r, acc]
            for j in range(t):
                asm.push(P)        # [r, acc, p]
                asm.emit('SWAP1')  # [r, p, acc]
                asm.push(P)        # [r, p, acc, p]
                asm.push(m_base + (i * t + j) * _WORD)
                asm.emit('MLOAD')  # [r, p, acc, p, M]
                asm.push(s_base + j * _WORD)
                asm.emit('MLOAD')  # [r, p, acc, p, M, s_j]
                asm.emit('MULMOD')  # [r, p, acc, prod]
                asm.emit('ADDMOD')  # [r, acc']
            asm.push(ns_base + i * _WORD)
            asm.emit('MSTORE')     # [r]
        # copy ns -> s
        for i in range(t):
            asm.push(ns_base + i * _WORD)
            asm.emit('MLOAD')
            asm.push(s_base + i * _WORD)
            asm.emit('MSTORE')

    def emit_phase(label, start, end, full):
        """Loop rounds [start, end) with full or partial sbox layer."""
        asm.push(start)            # [r]
        asm.label(label)
        emit_ark_all()
        if full:
            for j in range(t):
                emit_sbox(j)
        else:
            emit_sbox(0)
        emit_mix()
        # r += 1; if r < end goto label
        asm.push(1)
        asm.emit('ADD')            # [r+1]
        asm.emit('DUP1')           # [r+1, r+1]
        asm.push(end)
        asm.emit('SWAP1')          # [r+1, r+1... wait: [r+1, end, r+1]
        asm.emit('LT')             # [r+1, (r+1 < end)]
        asm.push_label(label)
        asm.emit('JUMPI')          # [r+1]
        asm.emit('POP')

    emit_phase('full1', 0, half_f, True)
    emit_phase('partial', half_f, half_f + n_p, False)
    emit_phase('full2', half_f + n_p, n_rounds, True)

    asm.push(s_base)
    asm.emit('MLOAD')
    asm.push(0)
    asm.emit('MSTORE')
    asm.push(32)
    asm.push(0)
    asm.emit('RETURN')
    return asm


def poseidon_contract(params=None, n_inputs=2):
    return poseidon_contract_opcodes(params, n_inputs).assemble()


def poseidon_contract_deployable(params=None, n_inputs=2):
    return deployable(poseidon_contract(params, n_inputs))

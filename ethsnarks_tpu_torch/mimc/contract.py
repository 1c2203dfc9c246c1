"""Generated EVM bytecode for the MiMC permutation (own copy of
``ethsnarks_tpu/mimc/contract.py``).

Fully unrolled stack-machine bytecode with hardcoded round constants (no
keccak at run time).  Call convention of the generated runtime code:

  calldata = x (32 bytes) || k (32 bytes)  ->  returns E_k(x) (32 bytes)

:func:`..evmasm.execute` runs it against the host :func:`.permutation.mimc`.
"""

from ..field import SNARK_SCALAR_FIELD
from ..evmasm import Assembler, deployable
from .permutation import _constants_list, DEFAULT_SEED, DEFAULT_ROUNDS, \
    DEFAULT_EXPONENT

P = SNARK_SCALAR_FIELD


def mimc_contract_opcodes(exponent=DEFAULT_EXPONENT, seed=DEFAULT_SEED,
                          rounds=DEFAULT_ROUNDS):
    """Assembler program for the unrolled permutation.

    Stack invariant between rounds: [k, x] (x on top); all values < p."""
    assert exponent in (5, 7)
    constants = _constants_list(seed, P, rounds)
    asm = Assembler()
    asm.push(32)
    asm.emit('CALLDATALOAD')       # [k]
    asm.push(0)
    asm.emit('CALLDATALOAD')       # [k, x]
    for c_i in constants:
        # t = addmod(addmod(x, c, p), k, p)
        asm.push(P)                # [k, x, p]
        asm.emit('SWAP1')          # [k, p, x]
        asm.push(c_i % P)          # [k, p, x, c]
        asm.emit('SWAP1')          # [k, p, c, x]
        asm.emit('ADDMOD')         # [k, (x+c)%p]
        asm.push(P)                # [k, xc, p]
        asm.emit('SWAP1')          # [k, p, xc]
        asm.emit('DUP3')           # [k, p, xc, k]
        asm.emit('ADDMOD')         # [k, t]
        # t2 = mulmod(t, t, p)
        asm.push(P)                # [k, t, p]
        asm.emit('DUP2')           # [k, t, p, t]
        asm.emit('DUP1')           # [k, t, p, t, t]
        asm.emit('MULMOD')         # [k, t, t2]
        if exponent == 7:
            asm.push(P)            # [k, t, t2, p]
            asm.emit('DUP2')       # [k, t, t2, p, t2]
            asm.emit('DUP1')       # [k, t, t2, p, t2, t2]
            asm.emit('MULMOD')     # [k, t, t2, t4]
            asm.push(P)            # [k, t, t2, t4, p]
            asm.emit('SWAP2')      # [k, t, p, t4, t2]
            asm.emit('MULMOD')     # [k, t, t6]
            asm.push(P)            # [k, t, t6, p]
            asm.emit('SWAP2')      # [k, p, t6, t]
            asm.emit('MULMOD')     # [k, x']
        else:
            asm.push(P)            # [k, t, t2, p]
            asm.emit('SWAP1')      # [k, t, p, t2]
            asm.emit('DUP1')       # [k, t, p, t2, t2]
            asm.emit('MULMOD')     # [k, t, t4]
            asm.push(P)            # [k, t, t4, p]
            asm.emit('SWAP2')      # [k, p, t4, t]
            asm.emit('MULMOD')     # [k, x']
    # out = addmod(x, k, p)
    asm.push(P)                    # [k, x, p]
    asm.emit('SWAP2')              # [p, x, k]
    asm.emit('ADDMOD')             # [out]
    asm.push(0)
    asm.emit('MSTORE')
    asm.push(32)
    asm.push(0)
    asm.emit('RETURN')
    return asm


def mimc_contract(exponent=DEFAULT_EXPONENT, seed=DEFAULT_SEED,
                  rounds=DEFAULT_ROUNDS):
    """Runtime bytecode for the unrolled permutation."""
    return mimc_contract_opcodes(exponent, seed, rounds).assemble()


def mimc_contract_deployable(exponent=DEFAULT_EXPONENT, seed=DEFAULT_SEED,
                             rounds=DEFAULT_ROUNDS):
    return deployable(mimc_contract(exponent, seed, rounds))

"""MerkleTree.VerifyPath as EVM bytecode (own copy of
``ethsnarks_tpu/evm_merkle.py``).

Bytecode twin of ``contracts/MerkleTree.sol:129-147``: walk the
authentication path from the leaf, at each depth hashing (left, right)
with the Miyaguchi-Preneel MiMCpe7 construction keyed by that depth's IV
- the IV chain of :class:`.merkletree.MerkleHasher_MiMC` (a running
sha256), which the contract hardcodes.  The MiMC permutation is one shared
bytecode subroutine (return address on the stack) rather than 58 inlined
copies.

Call convention of the runtime code (flat 32-byte calldata words):

    word 0                leaf
    words 1..depth        path (sibling node per level, leaf level first)
    words depth+1..2*depth address bits (1 = current node is the RIGHT
                          child, i.e. hash(path[d], current); 0 = left)

Returns one 32-byte word: the recomputed merkle root.  A proof is valid
iff it equals the tree root (the contract's caller-side comparison).
:func:`verify_path_evm` runs it in :func:`.evmasm.execute`.
"""

from .field import SNARK_SCALAR_FIELD
from .evmasm import Assembler
from .mimc.permutation import _constants_list, DEFAULT_SEED, DEFAULT_ROUNDS

P = SNARK_SCALAR_FIELD


def _perm_subroutine(asm, label):
    """MiMCpe7 permutation as a subroutine.

    Entry (via JUMP to `label`): stack [..., ret, k, x].
    Exit  (JUMP to ret):         stack [..., E_k(x)] = x_final + k mod p.
    Round body is the unrolled sequence of mimc.contract, which only
    touches the top 3 stack slots ([k, x] frame + scratch), so the return
    address below is untouched."""
    constants = _constants_list(DEFAULT_SEED, P, DEFAULT_ROUNDS)
    asm.label(label)                   # [ret, k, x]
    for c_i in constants:
        asm.push(P).emit('SWAP1')      # [ret, k, p, x]
        asm.push(c_i % P).emit('SWAP1')
        asm.emit('ADDMOD')             # [ret, k, (x+c)%p]
        asm.push(P).emit('SWAP1')
        asm.emit('DUP3')               # k
        asm.emit('ADDMOD')             # [ret, k, t]
        asm.push(P).emit('DUP2').emit('DUP1').emit('MULMOD')  # t2
        asm.push(P).emit('DUP2').emit('DUP1').emit('MULMOD')  # t4
        asm.push(P).emit('SWAP2').emit('MULMOD')              # t6
        asm.push(P).emit('SWAP2').emit('MULMOD')              # x' = t7
    # out = addmod(x', k, p); return
    asm.push(P).emit('SWAP2').emit('ADDMOD')   # [ret, out]
    asm.emit('SWAP1').emit('JUMP')


def merkle_verify_path_code(depth=29):
    """Runtime bytecode for VerifyPath at the given tree depth."""
    from .merkletree import MerkleHasher_MiMC
    ivs = MerkleHasher_MiMC(depth)._IVs
    asm = Assembler()
    asm.push(0).emit('CALLDATALOAD')           # [m]
    for d in range(depth):
        iv = int(ivs[d])
        # ---- load bit and sibling ----
        asm.push(32 * (depth + 1 + d)).emit('CALLDATALOAD')
        asm.push(1).emit('AND')                # [m, bit]
        asm.push(32 * (1 + d)).emit('CALLDATALOAD')   # [m, bit, pd]
        # ---- branch-free (l, r) select: l = m + bit*(pd - m) mod p ----
        asm.emit('DUP3').push(P).emit('SUB')   # [m, bit, pd, P-m]
        asm.push(P).emit('SWAP1')              # [m, bit, pd, P, P-m]
        asm.emit('DUP3')                       # + pd
        asm.emit('ADDMOD')                     # [m, bit, pd, diff]
        asm.push(P).emit('SWAP1')              # [m, bit, pd, P, diff]
        asm.emit('DUP4')                       # bit
        asm.emit('MULMOD')                     # [m, bit, pd, sel]
        asm.push(P).emit('SWAP1')              # [m, bit, pd, P, sel]
        asm.emit('DUP5')                       # m
        asm.emit('ADDMOD')                     # [m, bit, pd, l]
        # r = (m + pd - l) mod p
        asm.push(P).emit('DUP3')               # [m, bit, pd, l, P, pd]
        asm.emit('DUP6')                       # m
        asm.emit('ADDMOD')                     # [m, bit, pd, l, s]
        asm.emit('DUP2').push(P).emit('SUB')   # [.., l, s, P-l]
        asm.push(P).emit('SWAP2')              # [.., l, P, P-l, s]
        asm.emit('ADDMOD')                     # [m, bit, pd, l, r]
        # ---- drop m, bit, pd; keep [r, l] (l on top) ----
        asm.emit('SWAP4').emit('POP')          # [r, bit, pd, l]
        asm.emit('SWAP2').emit('POP')          # [r, l, pd]
        asm.emit('POP')                        # [r, l]
        # ---- MP step: k1 = IV + l + E_IV(l); m' = k1 + r + E_k1(r) ----
        ret1 = 'ret1_%d' % d
        asm.push_label(ret1)                   # [r, l, ret1]
        asm.push(iv)                           # [r, l, ret1, IV]
        asm.emit('DUP3')                       # x = l
        asm.push_label('mimc_perm').emit('JUMP')
        asm.label(ret1)                        # [r, l, E1]
        asm.push(P).emit('SWAP1')              # [r, l, P, E1]
        asm.emit('DUP3').emit('ADDMOD')        # [r, l, (E1+l)%p]
        asm.push(P).emit('SWAP1')
        asm.push(iv).emit('ADDMOD')            # [r, l, k1]
        asm.emit('SWAP1').emit('POP')          # [r, k1]
        ret2 = 'ret2_%d' % d
        asm.push_label(ret2)                   # [r, k1, ret2]
        asm.emit('DUP2')                       # k1
        asm.emit('DUP4')                       # x = r
        asm.push_label('mimc_perm').emit('JUMP')
        asm.label(ret2)                        # [r, k1, E2]
        asm.push(P).emit('SWAP1')              # [r, k1, P, E2]
        asm.emit('DUP4').emit('ADDMOD')        # [r, k1, (E2+r)%p]
        asm.push(P).emit('SWAP1')
        asm.emit('DUP3').emit('ADDMOD')        # [r, k1, m']
        asm.emit('SWAP2').emit('POP').emit('POP')   # [m']
    asm.push(0).emit('MSTORE')
    asm.push(32).push(0).emit('RETURN')
    _perm_subroutine(asm, 'mimc_perm')
    return asm.assemble()


def verify_path_evm(leaf, path, address_bits, depth=None):
    """Execute the bytecode twin; returns the recomputed root (int)."""
    from .evmasm import execute
    depth = depth if depth is not None else len(path)
    assert len(path) == depth and len(address_bits) == depth
    code = merkle_verify_path_code(depth)
    words = [int(leaf) % P]
    words += [int(x) % P for x in path]
    words += [1 if b else 0 for b in address_bits]
    calldata = b''.join(w.to_bytes(32, 'big') for w in words)
    out = execute(code, calldata, gas_limit=50_000_000)
    return int.from_bytes(out, 'big')

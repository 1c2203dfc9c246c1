"""The CUDA field core's inline PTX (ethsnarks_tpu_torch/csrc/field.cuh),
run on the CPU by a small interpreter of the PTX it uses, against Python
integers and the JAX package's BN254 moduli: the blocks' Fq instantiation
(q) and their Fr instantiation (r).

The C preprocessor expands the header's PTX macros; each block is then
executed instruction by instruction with the carry flag of the PTX ISA
(add.cc / addc, sub.cc / subc as borrow, mad.lo.cc / madc.{lo,hi}[.cc]).
The interpreter fails on a carry read before it is set, on an input read
after an output was written (outputs may share registers with inputs),
and, in the product, on a carry dropped by an instruction without .cc.
Inputs are the values that reach rare carries: 0, 1, p - 1, p, 2p - 1,
p - 2^32, 2^255 mod p, values with all-ones low words, and random ones,
all below 2p (the lazy-reduction range), for p = q and p = r."""
import ast
import os
import re
import shutil
import subprocess

import numpy as np
import pytest

from ethsnarks_tpu.bn254 import FIELD_MODULUS as Q, CURVE_ORDER as RMOD

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                    "ethsnarks_tpu_torch", "csrc")
M32 = (1 << 32) - 1
R = 1 << 256
BLOCKS = {"MUL": "ESN_FQ_MUL_PTX", "ADD": "ESN_FQ_ADD_PTX",
          "SUB": "ESN_FQ_SUB_PTX", "CANON": "ESN_FQ_CANON_PTX",
          "FR_MUL": "ESN_FR_MUL_PTX", "FR_ADD": "ESN_FR_ADD_PTX",
          "FR_SUB": "ESN_FR_SUB_PTX", "FR_CANON": "ESN_FR_CANON_PTX"}


@pytest.fixture(scope="module")
def ptx():
    """{block: PTX text} from the preprocessed header."""
    cpp = shutil.which("cpp")
    assert cpp, "the C preprocessor expands field.cuh's PTX macros"
    src = '#include "field.cuh"\n' + "".join(
        "@@%s %s\n" % (k, v) for k, v in BLOCKS.items())
    out = subprocess.run([cpp, "-P", "-I", CSRC], input=src, text=True,
                         capture_output=True, check=True).stdout
    blocks = {}
    for line in out.splitlines():
        m = re.match(r"@@(\w+) (.*)$", line)
        if m:
            blocks[m.group(1)] = ast.literal_eval(m.group(2))
    assert set(blocks) == set(BLOCKS)
    return blocks


def run(body, inputs, strict):
    """Executes one PTX block: %0-%7 outputs, %8.. the inputs' words."""
    regs, outs = {}, set()
    cf = None

    def val(tok):
        if tok.startswith("%"):
            k = int(tok[1:])
            assert k >= 8, "reads output operand " + tok
            assert not outs, "reads input %s after an output was written" \
                % tok
            return inputs[k - 8]
        if re.match(r"^(0x[0-9a-fA-F]+|\d+)$", tok):
            return int(tok, 0) & M32
        return regs[tok]

    def put(tok, v):
        if tok.startswith("%"):
            outs.add(int(tok[1:]))
        regs[tok] = v & M32

    for stmt in re.split(r"[;{}]", body):
        stmt = stmt.strip()
        if not stmt or stmt.startswith(".reg"):
            continue
        op, rest = stmt.split(None, 1)
        args = [a.strip() for a in rest.split(",")]
        base, parts = op.split(".")[0], op.split(".")
        cc = "cc" in parts
        if base in ("madc", "addc", "subc"):
            assert cf is not None, "carry read before it is set: " + stmt
        if base == "mov":
            put(args[0], val(args[1]))
        elif base in ("mul", "mad", "madc"):
            p = val(args[1]) * val(args[2])
            part = p & M32 if parts[1] == "lo" else p >> 32
            if base == "mul":
                put(args[0], part)
                continue
            t = part + val(args[3]) + (cf if base == "madc" else 0)
            put(args[0], t)
            if cc:
                cf = t >> 32
            else:
                assert not (strict and t >> 32), "drops a carry: " + stmt
        elif base in ("add", "addc"):
            t = val(args[1]) + val(args[2]) + (cf if base == "addc" else 0)
            put(args[0], t)
            if cc:
                cf = t >> 32
            else:
                assert not (strict and t >> 32), "drops a carry: " + stmt
        elif base in ("sub", "subc"):
            t = val(args[1]) - val(args[2]) - (cf if base == "subc" else 0)
            put(args[0], t)
            if cc:
                cf = int(t < 0)
        elif base == "and":
            put(args[0], val(args[1]) & val(args[2]))
        elif base == "setp":
            assert parts[1] == "ne"
            regs[args[0]] = val(args[1]) != val(args[2])
        elif base == "selp":
            put(args[0], val(args[1]) if regs[args[3]] else val(args[2]))
        else:
            raise AssertionError("unknown PTX op " + stmt)
    return sum(regs["%%%d" % k] << (32 * k) for k in range(8))


def _words(x):
    return [(x >> (32 * i)) & M32 for i in range(8)]


def _values(seed, n_random, p=Q):
    rng = np.random.default_rng(seed)

    def rand():
        return int.from_bytes(rng.bytes(32), "little")

    vals = [0, 1, 2, p - 1, p - 2, p, p + 1, 2 * p - 1, 2 * p - 2,
            p - (1 << 32), (1 << 255) % p, (1 << 254) - 1, 1 << 253,
            2 * p - (1 << 32)]
    for k in range(1, 8):
        vals.append((rand() | ((1 << (32 * k)) - 1)) % (2 * p))
    vals += [rand() % (2 * p) for _ in range(n_random)]
    return vals


def test_product_is_montgomery_below_2q(ptx):
    rinv = pow(R, -1, Q)
    vals = _values(1, 8)
    for a in vals:
        for b in vals:
            r = run(ptx["MUL"], _words(a) + _words(b), strict=True)
            assert r < 2 * Q and r % Q == a * b * rinv % Q, (hex(a), hex(b))
    # the largest inputs, where the no-carry bound is tightest
    for a in range(2 * Q - 8, 2 * Q):
        r = run(ptx["MUL"], _words(a) + _words(2 * Q - 1), strict=True)
        assert r < 2 * Q and r % Q == a * (2 * Q - 1) * rinv % Q


@pytest.mark.parametrize("block", ["ADD", "SUB"])
def test_sum_and_difference_below_2q(ptx, block):
    vals = _values(2, 8)
    for a in vals:
        for b in vals:
            r = run(ptx[block], _words(a) + _words(b), strict=block == "ADD")
            want = (a + b) % Q if block == "ADD" else (a - b) % Q
            assert r < 2 * Q and r % Q == want, (hex(a), hex(b))


def test_canonical_reduction(ptx):
    for a in _values(3, 64):
        assert run(ptx["CANON"], _words(a), strict=True) == a % Q


def test_fr_product_is_montgomery_below_2r(ptx):
    """The Fr instantiation on r's edge values, and at the lazy bound."""
    assert RMOD < 1 << 254 and 4 * RMOD < R
    rinv = pow(R, -1, RMOD)
    vals = _values(4, 6, RMOD)
    for a in vals:
        for b in vals:
            r = run(ptx["FR_MUL"], _words(a) + _words(b), strict=True)
            assert r < 2 * RMOD and r % RMOD == a * b * rinv % RMOD, \
                (hex(a), hex(b))
    for a in range(2 * RMOD - 8, 2 * RMOD):
        r = run(ptx["FR_MUL"], _words(a) + _words(2 * RMOD - 1), strict=True)
        assert r < 2 * RMOD and r % RMOD == a * (2 * RMOD - 1) * rinv % RMOD


@pytest.mark.parametrize("block", ["FR_ADD", "FR_SUB"])
def test_fr_sum_and_difference_below_2r(ptx, block):
    vals = _values(5, 6, RMOD)
    for a in vals:
        for b in vals:
            r = run(ptx[block], _words(a) + _words(b),
                    strict=block == "FR_ADD")
            want = (a + b) % RMOD if block == "FR_ADD" else (a - b) % RMOD
            assert r < 2 * RMOD and r % RMOD == want, (hex(a), hex(b))


def test_fr_canonical_reduction(ptx):
    for a in _values(6, 64, RMOD):
        assert run(ptx["FR_CANON"], _words(a), strict=True) == a % RMOD

"""The port's throughput probe (K7's plain version in
ethsnarks_tpu_torch.ops.int_probe, the entry point ethsnarks_tpu_torch.probe)
against the ops of the reference's tools/probe_vpu.py, applied by JAX on
the CPU to the same inputs; and the bench entry point
(ethsnarks_tpu_torch.bench) on the CPU at a small size.  The reference's
Pallas probe kernel needs a TPU; its ops are what it chains."""
import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ethsnarks_tpu_torch import bench, probe
from ethsnarks_tpu_torch.field import FIELD_MODULUS
from ethsnarks_tpu_torch.ops import int_probe, kernels
from ethsnarks_tpu_torch.ops.fp import MONT_R, words_to_ints

from torch_port_helpers import torch_threads  # noqa: F401

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
REFERENCE_OPS = ['u32_mul', 'u32_add', 'u32_mul_add', 'u32_shr13_and',
                 'u32_cmp_sel', 'i32_mul', 'f32_fma']


@pytest.fixture(scope="module")
def reference_ops():
    """tools/probe_vpu.py's OPS: {name: (op, jnp dtype)}."""
    spec = importlib.util.spec_from_file_location(
        "probe_vpu", os.path.join(ROOT, "tools", "probe_vpu.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.OPS


def test_ops_are_the_reference_ops_and_the_wide_product(reference_ops):
    assert list(reference_ops) == REFERENCE_OPS
    assert list(int_probe.OPS) == REFERENCE_OPS + ['u32_mul_wide']


@pytest.mark.parametrize('op', REFERENCE_OPS)
def test_plain_matches_reference_op(op, reference_ops):
    """Two chains of 16 steps on the probe's inputs: integer ops bit for
    bit, f32_fma within int_probe.F32_RTOL (the reference rounds a * b and
    + b separately, the card's fma.rn once)."""
    fn, dtype = reference_ops[op]
    x, y = probe.inputs(op, 512, 'cpu', seed=3)
    iters = 2
    got = kernels.int_probe(op, x, y, iters).numpy()
    npt = np.dtype(dtype)
    a, b = jnp.asarray(x.numpy().view(npt)), jnp.asarray(y.numpy().view(npt))
    for _ in range(iters * int_probe.CHAIN):
        a = fn(a, b)
    want = np.asarray(a)
    if op == 'f32_fma':
        g = got.view(np.float32)
        assert np.all(np.abs(g - want) <= int_probe.F32_RTOL * np.abs(want))
    else:
        assert np.array_equal(got, want.view(np.int32))


def test_u32_mul_wide_plain_matches_python_ints():
    x, y = probe.inputs('u32_mul_wide', 256, 'cpu', seed=4)
    x[:4] = torch.tensor([-1, -1, 0, 1 << 30], dtype=torch.int32)
    y[:4] = torch.tensor([-1, 7, -1, -1], dtype=torch.int32)
    got = kernels.int_probe('u32_mul_wide', x, y, 1)
    a = [int(v) & 0xFFFFFFFF for v in x]
    b = [int(v) & 0xFFFFFFFF for v in y]
    for _ in range(int_probe.CHAIN):
        a = [(p * q & 0xFFFFFFFF) ^ (p * q >> 32) for p, q in zip(a, b)]
    assert [int(v) & 0xFFFFFFFF for v in got] == a


def test_int_probe_checks_its_inputs():
    x, y = probe.inputs('u32_add', 16, 'cpu')
    with pytest.raises(ValueError):
        kernels.int_probe('u64_add', x, y, 1)
    with pytest.raises(ValueError):
        kernels.int_probe('u32_add', x.long(), y, 1)
    with pytest.raises(ValueError):
        kernels.int_probe('u32_add', x, y[:8], 1)


def test_fq_chain_plain_matches_python_ints():
    """K7b's plain version: x y^k R^-k mod q, k Montgomery products each
    on the one before; canonical words; bad inputs raise."""
    x, y = probe.fq_inputs(16, 'cpu', seed=6)
    got = words_to_ints(kernels.fq_chain(x, y, 5))
    q = FIELD_MODULUS
    rinv = pow(MONT_R, -1, q)
    assert got == [a * pow(b * rinv, 5, q) % q for a, b in
                   zip(words_to_ints(x), words_to_ints(y))]
    assert torch.equal(kernels.fq_chain(x, y, 0), x)
    with pytest.raises(ValueError):
        kernels.fq_chain(x[:, :4].contiguous(), y[:, :4].contiguous(), 1)
    with pytest.raises(ValueError):
        kernels.fq_chain(x, y[:8], 1)
    with pytest.raises(ValueError):
        kernels.fq_chain(x, y, -1)


def test_probe_and_bench_need_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        probe.run()
    with pytest.raises(RuntimeError):
        bench.run(log_n=4)
    with pytest.raises(RuntimeError):
        probe.run(device='cpu')          # the probe measures the card only
    with pytest.raises(RuntimeError):
        probe.t_fq_ms(device='cpu')


@pytest.mark.parametrize('mode', bench.MODES)
def test_bench_modes_correct_on_cpu(mode):
    """bench.run on the CPU (plain versions): 2^4 points of the
    reference's draw, exact against the class-sum oracle; the record starts
    with the reference's keys."""
    out = bench.run(log_n=4, c=8, reps=1, mode=mode, device="cpu")
    assert list(out)[:3] == ["metric", "value", "unit"]
    assert out["correct"] and "correct=True" in out["unit"]
    with pytest.raises(ValueError):
        bench.run(log_n=4, mode='auto', device='cpu')

"""The port's entry points (``ethsnarks_tpu_torch.stubs``, the
``ProverContext`` call forms of the reference, ``groth16.prove``) against
the JAX package's, on ``tests/test_stubs.py``'s two-constraint circuit
with the same seeded rng: the key files and the proof JSON byte for byte.
Everything runs on the CPU, asked for with ``device='cpu'`` or
``use_device_msm=False``."""
import os
import pickle
import random

import pytest
import torch

from ethsnarks_tpu import stubs as ref_stubs
from ethsnarks_tpu.r1cs import ConstraintSystem as RefConstraintSystem

from ethsnarks_tpu_torch import groth16, stubs
from ethsnarks_tpu_torch.field import SNARK_SCALAR_FIELD
from ethsnarks_tpu_torch.groth16 import ProverContext
from ethsnarks_tpu_torch.parallel import make_mesh
from ethsnarks_tpu_torch.r1cs import ConstraintSystem

from torch_port_helpers import torch_threads  # noqa: F401

P = SNARK_SCALAR_FIELD
RNG_SEED = 9009


def _circuit(cs_cls):
    """tests/test_stubs.py's circuit: out = x * x + x, x = 6."""
    pb = cs_cls()
    out = pb.allocate('out')
    pb.set_input_sizes(1)
    x = pb.allocate('x')
    sq = pb.allocate('sq')
    pb.add_constraint(x, x, sq, 'x*x')
    pb.add_constraint(sq + x, 1, out, 'sum')
    pb.setval(x, 6)
    pb.setval(sq, 36)
    pb.setval(out, 42)
    assert pb.is_satisfied()
    return pb


def _seeded():
    rng = random.Random(RNG_SEED)
    return lambda: rng.randrange(1, P)


def _read(path, mode='r'):
    with open(path, mode) as fh:
        return fh.read()


@pytest.fixture(scope="module")
def cycle(tmp_path_factory):
    """Both packages' genkeys -> load -> prove through the stubs, the port
    on the CPU, the reference on its host prover."""
    d = tmp_path_factory.mktemp("stubs")
    out = {}
    for tag, mod, cs_cls, kw in (
            ('ref', ref_stubs, RefConstraintSystem, {}),
            ('port', stubs, ConstraintSystem, {'device': 'cpu'})):
        pb = _circuit(cs_cls)
        pk_file, vk_file = str(d / (tag + '_pk.raw')), str(d / (tag + '_vk.json'))
        mod.stub_genkeys_from_pb(pb, pk_file, vk_file, rng=_seeded(), **kw)
        pk = mod.load_proving_key(pk_file, **kw)
        ctx = mod.make_prover_context(pk, pb, use_device_msm=False)
        out[tag] = dict(pb=pb, pk_file=pk_file, vk_json=_read(vk_file),
                        pk_bytes=_read(pk_file, 'rb'), ctx=ctx,
                        proof_json=mod.prove(ctx, pb))
    return out


def test_stub_keys_equal_reference(cycle):
    assert cycle['port']['vk_json'] == cycle['ref']['vk_json']
    assert cycle['port']['pk_bytes'] == cycle['ref']['pk_bytes']


def test_stub_proof_equals_reference_and_verifies(cycle):
    port = cycle['port']
    assert port['ctx'].device.type == 'cpu'
    assert port['proof_json'] == cycle['ref']['proof_json']
    assert stubs.stub_verify(port['vk_json'], port['proof_json'])
    bad = port['proof_json'].replace('"0x2a"', '"0x2b"')
    assert bad != port['proof_json']
    assert not stubs.stub_verify(port['vk_json'], bad)
    assert not ref_stubs.stub_verify(port['vk_json'], bad)


def test_prove_from_pb_equals_reference(cycle):
    port = cycle['port']
    assert stubs.prove_from_pb(port['pb'], port['pk_file'],
                               use_device_msm=False) == \
        cycle['ref']['proof_json']


def test_groth16_prove_helper():
    """groth16.prove hands the witness to the context's prove."""
    class Context(object):
        def prove(self, values):
            return ('proved', values)
    assert groth16.prove(Context(), [1, 2]) == ('proved', [1, 2])


def test_stub_genkeys(tmp_path):
    """A gadget on a fresh protoboard through stub_genkeys: the keys load
    and fit the board."""
    from ethsnarks_tpu_torch.gadgets import lookup_2bit_gadget
    from ethsnarks_tpu_torch.r1cs import Variable

    class Table(lookup_2bit_gadget):
        def __init__(self, pb, consts):
            out = pb.allocate('out')
            pb.set_input_sizes(1)
            b0, b1 = pb.allocate('b0'), pb.allocate('b1')
            super().__init__(pb, consts, b0, b1, 'table')
            self.out = out

        def generate_r1cs_constraints(self):
            super().generate_r1cs_constraints()
            self.pb.add_constraint(self.result(), 1, self.out, 'bind')
    pk_file, vk_file = str(tmp_path / 'pk'), str(tmp_path / 'vk.json')
    pb, gadget = stubs.stub_genkeys(Table, pk_file, vk_file, [3, 5, 7, 9],
                                    rng=_seeded(), device='cpu')
    assert isinstance(gadget, Table) and isinstance(gadget.out, Variable)
    vk = stubs.VerifyingKey.from_json(_read(vk_file))
    assert len(vk.gammaABC) == pb.num_inputs + 1 == 2
    pk = stubs.load_proving_key(pk_file, device='cpu')
    assert pk.num_inputs == 1
    assert pk.h_pts.shape[0] >= pb.num_constraints + 2


def test_stub_main_verify(cycle, tmp_path, capsys):
    port = cycle['port']
    vk, good, bad = (tmp_path / n for n in ('vk.json', 'good', 'bad'))
    vk.write_text(port['vk_json'])
    good.write_text(port['proof_json'])
    bad.write_text(port['proof_json'].replace('"0x2a"', '"0x2b"'))
    assert stubs.stub_main_verify('v', [str(vk), str(good)]) == 0
    assert stubs.stub_main_verify('v', [str(vk), str(bad)]) == 1
    assert stubs.stub_main_verify('v', [str(vk)]) == 1
    got = capsys.readouterr().out
    assert ref_stubs.stub_main_verify('v', [str(vk), str(good)]) == 0
    assert ref_stubs.stub_main_verify('v', [str(vk), str(bad)]) == 1
    assert ref_stubs.stub_main_verify('v', [str(vk)]) == 1
    assert got == capsys.readouterr().out == \
        "OK\nFAIL\nUsage: v <vk.json> <proof.json>\n"


def test_context_call_forms(cycle):
    """The reference's positional and keyword forms; device and qap are
    keyword-only."""
    port = cycle['port']
    pk = stubs.load_proving_key(port['pk_file'], device='cpu')
    pb = port['pb']
    assert ProverContext(pk, pb, False).device.type == 'cpu'
    ctx = ProverContext(pk, pb, False, groth16.Config(multi_exp_c=5),
                        'generic', None)
    assert (ctx.device.type, ctx.msm_impl, ctx.c['h']) == ('cpu', 'generic', 5)
    assert ProverContext(pk, pb, device='cpu', qap=ctx.qap).qap is ctx.qap
    with pytest.raises(ValueError):
        ProverContext(pk, pb, use_device_msm=False, device='cuda')
    # the sixth positional argument is the mesh: a parallel.mesh.Mesh
    mesh = make_mesh(devices=['cpu'] * 2)
    ctx = ProverContext(pk, pb, False, None, 'auto', mesh)
    assert ctx.mesh is mesh and ctx.device.type == 'cpu'
    with pytest.raises(TypeError):
        ProverContext(pk, pb, use_device_msm=False, mesh=object())
    with pytest.raises(TypeError):
        ProverContext(pk, pb, 'cpu')
    if not torch.cuda.is_available():
        # the card is the default: no silent fall back to the CPU
        with pytest.raises(RuntimeError):
            ProverContext(pk, pb)
        with pytest.raises(RuntimeError):
            stubs.load_proving_key(port['pk_file'])


def test_load_proving_key_formats(cycle, tmp_path):
    """The binary key, a pickle of the port's own key; a pickle naming the
    JAX package's classes and other bytes raise ValueError."""
    port = cycle['port']
    pk = stubs.load_proving_key(port['pk_file'], device='cpu')
    own = tmp_path / 'pk.pickle'
    own.write_bytes(pickle.dumps(pk))
    again = stubs.load_proving_key(str(own), device='cpu')
    assert isinstance(again, groth16.ProvingKey)
    assert torch.equal(again.h_pts, pk.h_pts)
    assert torch.equal(again.b_pts, pk.b_pts)
    ref = tmp_path / 'ref.pickle'
    ref.write_bytes(b"cethsnarks_tpu.groth16\nProvingKey\n)\x81.")
    with pytest.raises(ValueError, match='ethsnarks_tpu.groth16'):
        stubs.load_proving_key(str(ref), device='cpu')
    junk = tmp_path / 'junk'
    junk.write_bytes(b"not a key at all")
    with pytest.raises(ValueError, match='neither'):
        stubs.load_proving_key(str(junk), device='cpu')
    other = tmp_path / 'dict.pickle'
    other.write_bytes(pickle.dumps({'a': 1}))
    with pytest.raises(ValueError, match='dict'):
        stubs.load_proving_key(str(other), device='cpu')

"""Groth16 setup and prover on the card (counterparts of
``ethsnarks_tpu/groth16.py`` ``Config``, :67-103, ``generator``, :176-291,
and of the device branch of ``ProverContext.prove``, :636-790).

Setup: the QAP, the seeded draws of t, alpha, beta, gamma and delta, the
host instance map, then every query as one fixed-base batch
multiplication (:mod:`.ops.batch_exp`, K4 on the card); the query points
stay on the device in projective form and feed the prover directly.

One proof: one witness upload, the witness map (:mod:`.qap`), window digits
of H and of the witness columns of the A, B and L queries, four Pippenger
MSMs (H, A and L in G1, B in G2) on the hand-written kernels, by the MSM
design that ``msm_impl`` names (:class:`ProverContext`), and host
finalisation (alpha + A, beta + B, H + L).  With a mesh (the counterpart
of ``_prepare_mesh_keys`` and of the mesh branch of ``prove``, :313-398,
:660-680) every query is split over the mesh's devices, the witness map
runs on row chunks (:mod:`.parallel.qap_sharded`) and each MSM on the
shards with a K1 combine (:mod:`.parallel.msm_red_sharded`).  nozk proofs
carry no blinding and are deterministic: the same witness gives the
reference host prover's exact proof, whatever the MSM design or mesh.

The zk form: ``generator(zk=True)`` also keeps delta and beta in G1 and
the B query in G1 (one more K4 G1 batch), and ``prove(blind=True)`` adds
the Groth16 r/s blinding on the host, with B in G1 from a fifth MSM (G1,
over the B query's digits) on the card.
"""

import secrets
import time

import torch

from . import resolve_device
from .bn254 import G1_GEN, G2_GEN, add, multiply, neg
from .field import SNARK_SCALAR_FIELD
from .ops import curve, msm_dense, msm_scan
from .ops.batch_exp import BatchExp
from .ops.fp import ints_to_words_np
from .ops.msm import best_c, msm_g1, msm_g2, window_digits
from .parallel.mesh import Mesh, normalise, on
from .parallel.msm_red_sharded import get_sharded_msm
from .parallel.qap_sharded import ShardedWitnessMap
from .qap import QAP
from .verifier import Proof, VerifyingKey

P = SNARK_SCALAR_FIELD


class Config(object):
    """Prover tuning, with the reference's knobs (``ethsnarks_tpu/
    groth16.py:67-103``, libsnark's prover_config.hpp).

    - multi_exp_c: the window bits of every MSM (None: ``best_c`` of each
      MSM's size).
    - msm_max_lanes, msm_static_plan: the TPU red pipeline's lane budget
      and digit planning; accepted, no effect here (the port's MSMs plan
      on the card from the digits themselves).
    - fft ('dif_dit'; 'basic_radix2' and 'recursive' accepted as aliases),
      swapAB, num_threads, smt, radixes, multi_exp_prefetch_locality,
      prefetch_stride, multi_exp_look_ahead: CPU-only knobs of the
      reference, accepted, no effect.
    """

    def __init__(self, multi_exp_c=None, fft='dif_dit', swapAB=False,
                 num_threads=0, smt=False, radixes=(),
                 multi_exp_prefetch_locality=3, prefetch_stride=0,
                 multi_exp_look_ahead=1, msm_max_lanes=None,
                 msm_static_plan='auto'):
        self.multi_exp_c = multi_exp_c
        self.fft = fft
        self.swapAB = swapAB
        self.num_threads = num_threads
        self.smt = smt
        self.radixes = tuple(radixes)
        self.multi_exp_prefetch_locality = multi_exp_prefetch_locality
        self.prefetch_stride = prefetch_stride
        self.multi_exp_look_ahead = multi_exp_look_ahead
        self.msm_max_lanes = msm_max_lanes
        if msm_static_plan not in ('auto', True, False):
            raise ValueError("msm_static_plan %r: 'auto', True or False"
                             % (msm_static_plan,))
        self.msm_static_plan = msm_static_plan


class ProvingKey(object):
    """Proving key.  Header points are host affine; the queries are point
    tensors (Montgomery words, infinity = (0, 1, 0)): sparse A (G1) and B
    (G2) with their variable indices, the dense H query in bit-reversed
    order, and the L query over the aux variables.

    The zk extras (None on a nozk key): delta_g1 and beta_g1 (host affine)
    and ``b1_pts``, the B query in G1 over the same ``b_idx``."""

    def __init__(self, alpha_g1, beta_g2, delta_g2, a_idx, a_pts, b_idx,
                 b_pts, h_pts, l_pts, num_inputs, delta_g1=None,
                 beta_g1=None, b1_pts=None):
        self.alpha_g1 = alpha_g1
        self.beta_g2 = beta_g2
        self.delta_g2 = delta_g2
        self.a_idx, self.a_pts = a_idx, a_pts
        self.b_idx, self.b_pts = b_idx, b_pts
        self.h_pts = h_pts
        self.l_pts = l_pts
        self.num_inputs = num_inputs
        self.delta_g1 = delta_g1
        self.beta_g1 = beta_g1
        self.b1_pts = b1_pts

    @property
    def has_zk_extras(self):
        return (self.delta_g1 is not None and self.beta_g1 is not None
                and self.b1_pts is not None)

    def to(self, device):
        """The same key with every query tensor on ``device``."""
        return ProvingKey(
            self.alpha_g1, self.beta_g2, self.delta_g2,
            self.a_idx.to(device), self.a_pts.to(device),
            self.b_idx.to(device), self.b_pts.to(device),
            self.h_pts.to(device), self.l_pts.to(device), self.num_inputs,
            self.delta_g1, self.beta_g1,
            None if self.b1_pts is None else self.b1_pts.to(device))


class Keypair(object):
    """A proving and a verifying key.  ``profile`` holds the setup's phase
    seconds and ``qap`` the compiled QAP it built, which a
    :class:`ProverContext` of the same circuit may reuse."""

    def __init__(self, pk, vk, profile=None, qap=None):
        self.pk = pk
        self.vk = vk
        self.profile = profile
        self.qap = qap


def _marker(*devices):
    """mark(name) appends (name, time), synchronising the cards first."""
    marks = []

    def mark(name):
        for device in devices:
            if device.type == 'cuda':
                torch.cuda.synchronize(device)
        marks.append((name, time.perf_counter()))
    return marks, mark


def _spans(marks):
    return {name: t - marks[i][1] for i, (name, t) in enumerate(marks[1:])}


def generator(cs, rng=None, device=None, zk=False):
    """Trusted setup of a keypair for a finished constraint system.

    rng: callable returning random field elements; the same rng gives the
    reference ``generator(device_exp=False, zk=zk)``'s keypair, point for
    point (default: rejection-sampled ``secrets.randbelow``).  Every query
    is one K4 launch; the header points are host multiples.  zk: also keep
    delta_g1, beta_g1 and the B query in G1 (one more K4 G1 launch), which
    ``prove(blind=True)`` needs; the draws are the same either way.  The
    phase seconds, synchronised at each mark and named as the reference's
    marks, are left in the keypair's ``profile``."""
    dev = resolve_device(device)
    marks, mark = _marker(dev)
    mark('start')
    rng = rng or (lambda: secrets.randbelow(P - 1) + 1)
    qap = QAP(cs, dev)
    mark('qap_build')
    while True:
        t = rng()
        if pow(t, qap.domain_size, P) != 1:
            break
    alpha, beta, gamma, delta = rng(), rng(), rng(), rng()
    gamma_inv = pow(gamma, -1, P)
    delta_inv = pow(delta, -1, P)
    At, Bt, Ct, Zt = qap.instance_map(t)
    mark('instance_map')
    nv, ni, m = qap.num_variables, qap.num_inputs, qap.domain_size

    g1 = BatchExp(G1_GEN, False, device=dev)
    g2 = BatchExp(G2_GEN, True, device=dev)
    # sparse queries: zero entries dropped (the nozk key conversion)
    a_idx = [i for i in range(nv) if At[i]]
    a_pts = g1.mul_many([At[i] for i in a_idx])
    mark('a_query')
    b_idx = [i for i in range(nv) if Bt[i]]
    b_pts = g2.mul_many([Bt[i] for i in b_idx])
    mark('b_query_g2')
    # H query: t^i Z(t) / delta, stored bit-reversed
    h_scalar = [0] * m
    acc = Zt * delta_inv % P
    for i in range(m):
        h_scalar[i] = acc
        acc = acc * t % P
    h_pts = g1.mul_many([h_scalar[j] for j in qap.domain.bitrev.tolist()])
    mark('h_query')
    # L query over the aux variables: (beta A_i + alpha B_i + C_i) / delta
    l_pts = g1.mul_many([(beta * At[i] + alpha * Bt[i] + Ct[i]) % P
                         * delta_inv % P for i in range(ni + 1, nv)])
    mark('l_query')
    gamma_abc = curve.tensor_to_g1(g1.mul_many(
        [(beta * At[i] + alpha * Bt[i] + Ct[i]) % P * gamma_inv % P
         for i in range(ni + 1)]))
    mark('gamma_abc')
    if any(p is None for p in gamma_abc):
        raise ValueError("zero gammaABC entry; input variable unused")
    alpha_g1, beta_g2 = g1.mul(alpha), g2.mul(beta)
    delta_g2 = g2.mul(delta)
    vk = VerifyingKey(alpha=alpha_g1, beta=beta_g2, gamma=g2.mul(gamma),
                      delta=delta_g2, gammaABC=gamma_abc)
    zk_extras = {}
    if zk:
        zk_extras = dict(delta_g1=g1.mul(delta), beta_g1=g1.mul(beta),
                         b1_pts=g1.mul_many([Bt[i] for i in b_idx]))
        mark('b_query_g1')
    pk = ProvingKey(
        alpha_g1=alpha_g1, beta_g2=beta_g2, delta_g2=delta_g2,
        a_idx=torch.tensor(a_idx, dtype=torch.int64, device=dev),
        a_pts=a_pts,
        b_idx=torch.tensor(b_idx, dtype=torch.int64, device=dev),
        b_pts=b_pts, h_pts=h_pts, l_pts=l_pts, num_inputs=ni, **zk_extras)
    mark('vk_pk')
    return Keypair(pk, vk, _spans(marks), qap)


MSM_IMPLS = ('auto', 'red', 'fused', 'generic')


class ProverContext(object):
    """Per-circuit proving state: the key's query points stay on the device
    across proofs, with the QAP's COO matrices and NTT constants (``qap``:
    one already compiled for ``cs`` on this device, else built here).

    msm_impl (``ethsnarks_tpu/groth16.py:300-310``): 'auto' and 'red', the
    sort + segmented-sum MSM of :mod:`.ops.msm`; 'fused', the dense
    all-windows MSM of :mod:`.ops.msm_dense` (with its fallbacks to the scan
    MSM); 'generic', the scan MSM of :mod:`.ops.msm_scan` with the generic
    window step.  All give the same proof.  config: a :class:`Config`;
    its ``multi_exp_c`` sets every MSM's window bits.

    The call forms are the reference's (``ethsnarks_tpu/groth16.py:303``).
    use_device_msm: True runs on ``device`` (None: the CUDA card, which
    raises without one); False is the caller asking for the CPU, the
    reference's host oracle: the plain versions of the kernels run there,
    and a CUDA ``device`` with it raises ValueError.

    mesh: a :class:`.parallel.mesh.Mesh` (``parallel.make_mesh``) proves
    on its devices: the A, B, L and H queries (and the zk key's B query in
    G1) are split over them with one red MSM of shards each
    (:class:`.parallel.msm_red_sharded.ShardedRedMSM`, window bits
    ``config.multi_exp_c`` or ``best_c`` of a shard's points), and the
    witness map is a :class:`.parallel.qap_sharded.ShardedWitnessMap` (a
    ``qap`` given must lie on the mesh's first device).  ``device=`` must
    then be None, msm_impl 'auto' or 'red', and ``use_device_msm=False``
    takes a mesh of CPU devices only (ValueError otherwise); a mesh of CPU
    devices is how the tests ask for the CPU."""

    def __init__(self, pk, cs, use_device_msm=True, config=None,
                 msm_impl='auto', mesh=None, *, device=None, qap=None):
        if msm_impl not in MSM_IMPLS:
            raise ValueError("msm_impl %r: one of %s"
                             % (msm_impl, ", ".join(MSM_IMPLS)))
        if isinstance(use_device_msm, (str, torch.device)):
            raise TypeError("use_device_msm is a bool; pass the device as "
                            "device=%r" % (use_device_msm,))
        if mesh is not None:
            if not isinstance(mesh, Mesh):
                raise TypeError("mesh: a parallel.mesh.Mesh (make_mesh), "
                                "not %r" % (mesh,))
            if device is not None:
                raise ValueError("with a mesh the devices are the mesh's; "
                                 "device=%r" % (device,))
            if msm_impl not in ('auto', 'red'):
                raise ValueError("the mesh prover runs the red MSM; "
                                 "msm_impl=%r" % (msm_impl,))
            if not use_device_msm and any(d.type != 'cpu' for d in mesh):
                raise ValueError("use_device_msm=False asks for the CPU, "
                                 "but the mesh is %r" % (mesh,))
            device = mesh.devices[0]
        elif not use_device_msm:
            if device is None:
                device = 'cpu'
            elif torch.device(device).type != 'cpu':
                raise ValueError("use_device_msm=False asks for the CPU, "
                                 "but device=%r" % (device,))
        self.msm_impl = msm_impl
        self.config = config or Config()
        self.mesh = mesh
        self.device = resolve_device(device)
        # a mesh splits the key's queries from wherever they lie
        self.pk = pk if mesh is not None else pk.to(self.device)
        if qap is not None and normalise(qap.device) != normalise(
                self.device):
            raise ValueError("QAP compiled for %s, context on %s"
                             % (qap.device, self.device))
        self.qap = qap if qap is not None else QAP(cs, self.device)
        if self.pk.h_pts.shape[0] != self.qap.domain_size:
            raise ValueError("H query of %d points for a domain of %d"
                             % (self.pk.h_pts.shape[0], self.qap.domain_size))
        ni, nv = pk.num_inputs, self.qap.num_variables
        self.l_idx = torch.arange(ni + 1, nv, device=self.device)
        shards = 1 if mesh is None else len(mesh)
        pick = (lambda n: self.config.multi_exp_c) \
            if self.config.multi_exp_c else \
            (lambda n: best_c(-(-n // shards)))
        self.c = dict(h=pick(self.qap.domain_size),
                      a=pick(self.pk.a_idx.shape[0]),
                      b=pick(self.pk.b_idx.shape[0]),
                      l=pick(nv - ni - 1))
        self.last_profile = None
        self.last_routes = None
        if mesh is not None:
            self._prepare_mesh()

    def _prepare_mesh(self):
        """The queries' shards, one sharded red MSM a query, the column
        indices of A, B and L split the same way, the sharded witness
        map."""
        pk, mesh = self.pk, self.mesh
        self._mesh_msm = {}
        for name, pts, g2, _ in self._queries(pk.b1_pts is not None):
            msm_ = get_sharded_msm(mesh, pts.shape[0], self.c[name[0]], g2)
            self._mesh_msm[name] = (msm_, msm_.shard_points(pts))
        self._mesh_idx = {
            name: [i.to(dev) for i, dev in zip(
                torch.tensor_split(idx, len(mesh)), mesh)]
            for name, idx in (('a', pk.a_idx), ('b', pk.b_idx),
                              ('l', self.l_idx))}
        self._wm = ShardedWitnessMap(self.qap, mesh)
        if [h.shape[0] for h in self._mesh_msm['h'][1]] != \
                [self._wm.chunk] * len(mesh):
            raise ValueError("H query shards do not match the domain's")

    def _msm(self, points, digits, c, g2):
        """One MSM by ``msm_impl`` -> (host affine point, route)."""
        if self.msm_impl == 'fused':
            return msm_dense.msm(points, digits, c, g2)
        if self.msm_impl == 'generic':
            return (msm_scan.msm_g2 if g2 else msm_scan.msm_g1)(
                points, digits, c), 'scan'
        return (msm_g2 if g2 else msm_g1)(points, digits, c), 'red'

    def prove(self, witness_values, primary_input=None, blind=False,
              rng=None):
        """witness_values: the full assignment [1, inputs.., aux..] as ints
        (``primary_input`` is accepted as the reference accepts it, and
        unused: the inputs are read from the assignment).  Returns a
        :class:`Proof`; per-phase wall seconds are left in
        ``self.last_profile`` and each MSM's route in ``self.last_routes``.

        blind: the Groth16 r/s blinding (``ethsnarks_tpu/groth16.py
        :777-790``): r, then s, drawn from ``rng`` (default: rejection-
        sampled ``secrets.randbelow``); A += r delta, B += s delta, C += s A
        + r B1 - r s delta, with B1 = beta + the B query in G1 (a fifth
        MSM).  Needs a key from ``generator(zk=True)``: ValueError on a
        nozk key."""
        pk = self.pk
        if blind and not pk.has_zk_extras:
            raise ValueError(
                "blind=True needs a zk-form key: generate with "
                "generator(zk=True); nozk keys drop delta_g1/beta_g1/"
                "B1-query")
        ni = pk.num_inputs
        w = [int(v) % P for v in witness_values]
        if len(w) != self.qap.num_variables or w[0] != 1:
            raise ValueError("witness must hold %d values starting with 1"
                             % self.qap.num_variables)
        devices = [self.device] if self.mesh is None else \
            self.mesh.distinct()
        marks, mark = _marker(*devices)
        mark('start')
        run = self._evals if self.mesh is None else self._evals_mesh
        evals, routes, extra = run(w, blind, mark)
        g_a = add(pk.alpha_g1, evals['a'])
        g_b = add(pk.beta_g2, evals['b'])
        g_c = add(evals['h'], evals['l'])
        if blind:
            rng = rng or (lambda: secrets.randbelow(P - 1) + 1)
            r, s = rng(), rng()
            g_b1 = add(add(pk.beta_g1, evals['b1']),
                       multiply(pk.delta_g1, s))
            g_a = add(g_a, multiply(pk.delta_g1, r))
            g_b = add(g_b, multiply(pk.delta_g2, s))
            g_c = add(g_c, add(multiply(g_a, s), add(
                multiply(g_b1, r), neg(multiply(pk.delta_g1, r * s % P)))))
        proof = Proof(A=g_a, B=g_b, C=g_c, input=w[1:1 + ni])
        mark('finalise')
        self.last_profile = dict(_spans(marks), **extra)
        self.last_routes = routes
        return proof

    def _evals(self, w, blind, mark):
        """One device: the upload, the witness map, the digits and the
        MSMs -> ({query: host point}, routes, {})."""
        pk, c = self.pk, self.c
        w_words = torch.from_numpy(ints_to_words_np(w)).to(self.device)
        mark('witness_upload')
        h = self.qap.witness_map(w_words)
        mark('witness_map')
        digits = dict(h=window_digits(h, c['h']),
                      a=window_digits(w_words[pk.a_idx], c['a']),
                      b=window_digits(w_words[pk.b_idx], c['b']),
                      l=window_digits(w_words[self.l_idx], c['l']))
        mark('digits')
        evals, routes = {}, {}
        for name, pts, g2, span in self._queries(blind):
            evals[name], routes[name] = self._msm(
                pts, digits[name[0]], c[name[0]], g2)
            mark(span)
        return evals, routes, {}

    def _evals_mesh(self, w, blind, mark):
        """The mesh branch: one witness upload a device, the sharded
        witness map, every shard's digits on its device (H from its own H
        shard, never gathered), the sharded MSMs -> (points, routes,
        {'exchange': seconds in the NTT's cross stages})."""
        mesh, c = self.mesh, self.c
        w_np = ints_to_words_np(w)
        w_dev = {dev: torch.from_numpy(w_np).to(dev)
                 for dev in mesh.distinct()}
        mark('witness_upload')
        before = self._wm.dom.exchange_seconds
        h = self._wm(w_dev)
        mark('witness_map')
        exchange = self._wm.dom.exchange_seconds - before
        digits = {'h': [], 'a': [], 'b': [], 'l': []}
        for d, dev in enumerate(mesh):
            with on(dev):
                digits['h'].append(window_digits(h[d], c['h']))
                for name in 'abl':
                    digits[name].append(window_digits(
                        w_dev[dev][self._mesh_idx[name][d]], c[name]))
        mark('digits')
        evals = {}
        for name, _, _, span in self._queries(blind):
            msm_, shards = self._mesh_msm[name]
            evals[name] = msm_(shards, digits[name[0]])
            mark(span)
        return evals, {name: 'mesh' for name in evals}, \
            {'exchange': exchange}

    def _queries(self, blind):
        """(name, points, g2, span) of each MSM of a proof, in order."""
        pk = self.pk
        out = [('h', pk.h_pts, False, 'h_msm'), ('a', pk.a_pts, False,
                                                 'a_msm'),
               ('b', pk.b_pts, True, 'b_msm_g2'),
               ('l', pk.l_pts, False, 'l_msm')]
        if blind:
            out.append(('b1', pk.b1_pts, False, 'b1_msm'))
        return out


def prove(context, witness_values):
    """One-call helper (``ethsnarks_tpu/groth16.py:793``)."""
    return context.prove(witness_values)

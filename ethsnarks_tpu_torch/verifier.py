"""Groth16 verifying key, proof and pairing verification with the
reference's JSON layout (counterpart of ``ethsnarks_tpu/verifier.py:1-143``).

G1 points as ``["0x..", "0x.."]``, G2 points as ``[[X.c1, X.c0], [Y.c1,
Y.c0]]`` (EVM order), inputs as hex strings: ``to_json`` is byte-identical
to the reference's, so its verifiers and Verifier.sol accept the proofs.
The check is the 4-product of Verifier.sol:

    e(A, B) * e(-vk_x, gamma) * e(-C, delta) * e(-alpha, beta) == 1

Beside it (``ethsnarks_tpu/verifier.py:145-267``): the processed key
(:meth:`VerifyingKey.process`: e(alpha, beta) once and the line
coefficients of gamma and delta, then three Miller loops a proof),
:func:`affine_verify_weak_IC`, and the repo's C++ verifier
(``native/``) through ``ctypes``: :class:`NativeVerifier` and
:class:`NativeProcessedVK`, with :func:`native_library` building it by
``make -C native`` at first use.
"""

import ctypes
import fcntl
import json
import os
import subprocess
from collections import namedtuple

from .bn254 import Fq, Fq2, add, multiply, neg, is_on_curve, B1, B2
from .pairing import (G2Precomp, cast_g1_to_fq12, final_exponentiate,
                      miller_loop, miller_loop_precomp,
                      pairing_product_is_one, twist)
from .utils import native_lib_path

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NATIVE_DIR = os.path.join(_ROOT, "native")
NATIVE_BUILD = os.path.join(_ROOT, "build", "ethsnarks_tpu_torch", "native")


def _parse_int(x):
    """Int, 0x-hex or decimal string -> int."""
    if isinstance(x, int):
        return x
    x = x.strip()
    if x.startswith('0x') or x.startswith('0X'):
        return int(x, 16)
    return int(x)


def _load_g1_point(point):
    if len(point) < 2:
        raise RuntimeError("Invalid G1 point", point)
    out = (Fq(_parse_int(point[0])), Fq(_parse_int(point[1])))
    if not is_on_curve(out, B1):
        raise ValueError("Invalid G1 point - not on curve", point)
    return out


def _load_g2_point(point):
    x, y = point
    if len(x) != 2 or len(y) != 2:
        raise RuntimeError("Invalid G2 point", point)
    # JSON order is [c1, c0] (EVM); internally [c0, c1]
    out = (Fq2([_parse_int(x[1]), _parse_int(x[0])]),
           Fq2([_parse_int(y[1]), _parse_int(y[0])]))
    if not is_on_curve(out, B2):
        raise ValueError("Invalid G2 point - not on curve", point)
    return out


def _dump_g1(pt):
    return [hex(pt[0].n), hex(pt[1].n)]


def _dump_g2(pt):
    x, y = pt
    return [[hex(x.coeffs[1]), hex(x.coeffs[0])],
            [hex(y.coeffs[1]), hex(y.coeffs[0])]]


class Proof(namedtuple('_ProofStruct', ('A', 'B', 'C', 'input'))):
    def to_dict(self):
        return {
            'A': _dump_g1(self.A),
            'B': _dump_g2(self.B),
            'C': _dump_g1(self.C),
            'input': [hex(_) for _ in self.input],
        }

    def to_json(self):
        return json.dumps(self.to_dict())

    @classmethod
    def from_dict(cls, d):
        return cls(A=_load_g1_point(d['A'][:2]), B=_load_g2_point(d['B']),
                   C=_load_g1_point(d['C'][:2]),
                   input=[_parse_int(_) for _ in d['input']])

    @classmethod
    def from_json(cls, json_data):
        return cls.from_dict(json.loads(json_data))


class VerifyingKey(namedtuple('_VerifyingKeyStruct',
                              ('alpha', 'beta', 'gamma', 'delta',
                               'gammaABC'))):
    def to_dict(self):
        return {
            'alpha': _dump_g1(self.alpha),
            'beta': _dump_g2(self.beta),
            'gamma': _dump_g2(self.gamma),
            'delta': _dump_g2(self.delta),
            'gammaABC': [_dump_g1(p) for p in self.gammaABC],
        }

    def to_json(self):
        return json.dumps(self.to_dict())

    @classmethod
    def from_dict(cls, d):
        return cls(alpha=_load_g1_point(d['alpha']),
                   beta=_load_g2_point(d['beta']),
                   gamma=_load_g2_point(d['gamma']),
                   delta=_load_g2_point(d['delta']),
                   gammaABC=[_load_g1_point(p) for p in d['gammaABC']])

    @classmethod
    def from_json(cls, json_data):
        return cls.from_dict(json.loads(json_data))

    @classmethod
    def from_file(cls, filename):
        with open(filename, 'r') as handle:
            return cls.from_dict(json.load(handle))

    def verify(self, proof):
        """Strong input consistency: exactly one gammaABC entry per input
        plus one."""
        if not isinstance(proof, Proof):
            raise TypeError("Invalid proof type")
        if len(proof.input) + 1 != len(self.gammaABC):
            return False
        return self.verify_weak_IC(proof)

    def verify_weak_IC(self, proof):
        """Weak input consistency: accepts |input| + 1 <= |gammaABC|."""
        if len(proof.input) + 1 > len(self.gammaABC):
            return False
        vk_x = _accumulate(self.gammaABC, proof.input)
        return pairing_product_is_one([
            (proof.A, proof.B),
            (neg(vk_x), self.gamma),
            (neg(proof.C), self.delta),
            (neg(self.alpha), self.beta)])

    def process(self):
        """The processed key of the reference's online verifier."""
        return ProcessedVerifyingKey(self)


def _accumulate(gamma_abc, inputs):
    vk_x = gamma_abc[0]
    for i, x in enumerate(inputs):
        vk_x = add(vk_x, multiply(gamma_abc[i + 1], x))
    return vk_x


class ProcessedVerifyingKey(object):
    """e(alpha, beta) evaluated once and the Miller-loop line coefficients
    of gamma and delta precomputed, so that a proof costs three Miller
    loops and one final exponentiation."""

    def __init__(self, vk):
        self.gammaABC = list(vk.gammaABC)
        self.alpha_beta = final_exponentiate(miller_loop(
            twist(vk.beta), cast_g1_to_fq12(vk.alpha)))
        self.gamma_precomp = G2Precomp(vk.gamma)
        self.delta_precomp = G2Precomp(vk.delta)

    def online_verify_weak_IC(self, proof):
        """e(A, B) == e(alpha, beta) e(vk_x, gamma) e(C, delta), after the
        check that A, B and C lie on their curves; accepts |input| + 1 <=
        |gammaABC|."""
        if not isinstance(proof, Proof):
            raise TypeError("Invalid proof type")
        if len(proof.input) + 1 > len(self.gammaABC):
            return False
        if not (is_on_curve(proof.A, B1) and is_on_curve(proof.B, B2)
                and is_on_curve(proof.C, B1)):
            return False
        vk_x = _accumulate(self.gammaABC, proof.input)
        acc = miller_loop(twist(proof.B), cast_g1_to_fq12(proof.A))
        acc = acc * miller_loop_precomp(self.gamma_precomp, neg(vk_x))
        acc = acc * miller_loop_precomp(self.delta_precomp, neg(proof.C))
        return final_exponentiate(acc) == self.alpha_beta

    def online_verify_strong_IC(self, proof):
        """As the weak check, with exactly |gammaABC| - 1 inputs."""
        if len(proof.input) + 1 != len(self.gammaABC):
            return False
        return self.online_verify_weak_IC(proof)


def affine_verify_weak_IC(vk, proof):
    """The reference's affine-ate entry point: the host Miller loop is
    affine already, so this is the weak check on a freshly processed
    key."""
    return ProcessedVerifyingKey(vk).online_verify_weak_IC(proof)


def native_library():
    """The path of the repo's C++ verifier library, built from
    ``native/`` by ``make -C native`` into ``build/ethsnarks_tpu_torch/
    native/`` (git-ignored); make rebuilds it only when a source is
    newer.  A failed build raises RuntimeError with make's output."""
    lib = os.path.join(NATIVE_BUILD, native_lib_path("libethsnarks_verify"))
    os.makedirs(NATIVE_BUILD, exist_ok=True)
    with open(os.path.join(NATIVE_BUILD, ".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        out = subprocess.run(["make", "-C", NATIVE_DIR,
                              "BUILD=" + NATIVE_BUILD, lib],
                             capture_output=True, text=True)
    if out.returncode != 0:
        raise RuntimeError("building the native verifier failed:\n%s%s"
                           % (out.stdout, out.stderr))
    return lib


def _load(native_library_path):
    return ctypes.cdll.LoadLibrary(native_library_path or native_library())


class NativeVerifier(VerifyingKey):
    """The verifying key checked by the C++ verifier library
    (``ethsnarks_verify``) through ``ctypes``; ``native_library_path``
    None means :func:`native_library`."""

    def verify(self, proof, native_library_path=None):
        if not isinstance(proof, Proof):
            raise TypeError("Invalid proof type")
        lib = _load(native_library_path)
        lib.ethsnarks_verify.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
        lib.ethsnarks_verify.restype = ctypes.c_bool
        return lib.ethsnarks_verify(self.to_json().encode('ascii'),
                                    proof.to_json().encode('ascii'))

    def process_native(self, native_library_path=None):
        """A processed key on the native side: process once, verify
        many."""
        return NativeProcessedVK(self, native_library_path)


class NativeProcessedVK(object):
    """An opaque native processed-key handle (the G2 line coefficients and
    e(alpha, beta) precomputed in C++), verifying with weak or strong
    input consistency."""

    _handle = None

    def __init__(self, vk, native_library_path=None):
        lib = _load(native_library_path)
        lib.ethsnarks_process_vk.argtypes = [ctypes.c_char_p]
        lib.ethsnarks_process_vk.restype = ctypes.c_void_p
        for name in ("ethsnarks_verify_prepared",
                     "ethsnarks_verify_prepared_strong"):
            getattr(lib, name).argtypes = [ctypes.c_void_p, ctypes.c_char_p]
            getattr(lib, name).restype = ctypes.c_bool
        lib.ethsnarks_release_vk.argtypes = [ctypes.c_void_p]
        self._lib = lib
        self._handle = lib.ethsnarks_process_vk(
            vk.to_json().encode('ascii'))
        if not self._handle:
            raise ValueError("native process_vk failed")

    def verify(self, proof, strong_ic=True):
        if not isinstance(proof, Proof):
            raise TypeError("Invalid proof type")
        fn = (self._lib.ethsnarks_verify_prepared_strong if strong_ic
              else self._lib.ethsnarks_verify_prepared)
        return fn(self._handle, proof.to_json().encode('ascii'))

    def close(self):
        if self._handle:
            self._lib.ethsnarks_release_vk(self._handle)
            self._handle = None

    def __del__(self):
        self.close()

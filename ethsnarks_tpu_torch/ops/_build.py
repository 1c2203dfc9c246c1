"""Build and load the CUDA kernels (``csrc/msm_kernels.cu``, which includes
``csrc/setup_kernels.cu``) on first use.

The source is compiled by ``nvcc`` into a shared library with a plain C
interface under ``build/ethsnarks_tpu_torch/`` at the repo root
(git-ignored), named by a hash of the sources so an edited kernel rebuilds,
and loaded with ``ctypes``.  ``torch.utils.cpp_extension.load`` is not
used: a source that includes PyTorch's headers takes minutes to compile, a
plain one seconds.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
SOURCE = "msm_kernels"
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "ethsnarks_tpu_torch")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# name -> argtypes of every C entry point
_VOID = ctypes.c_void_p
_INT = ctypes.c_int
ENTRY_POINTS = {
    "esn_point_add_g1": [_VOID, _VOID, _VOID, _VOID, _VOID, _INT, _VOID],
    "esn_point_add_g2": [_VOID, _VOID, _VOID, _VOID, _VOID, _INT, _VOID],
    "esn_point_double_g1": [_VOID, _VOID, _INT, _VOID],
    "esn_point_double_g2": [_VOID, _VOID, _INT, _VOID],
    "esn_horner_g1": [_VOID, _VOID, _INT, _INT, _INT, _VOID],
    "esn_horner_g2": [_VOID, _VOID, _INT, _INT, _INT, _VOID],
    "esn_fixed_base_mul_g1": [_VOID, _VOID, _VOID, _INT, _INT, _INT, _VOID],
    "esn_fixed_base_mul_g2": [_VOID, _VOID, _VOID, _INT, _INT, _INT, _VOID],
}

_lib = None


def _nvcc():
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def _stem():
    """build/ethsnarks_tpu_torch/msm_kernels-<hash of flags and sources>."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in sorted(os.listdir(CSRC)):
        with open(os.path.join(CSRC, name), "rb") as fh:
            h.update(name.encode() + fh.read())
    return os.path.join(BUILD_DIR, "%s-%s" % (SOURCE, h.hexdigest()[:16]))


def _compile(out):
    """One nvcc run into ``out``.  The compiler's report (registers and
    spills per kernel) is kept beside it as a .log."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = out + ".tmp%d" % os.getpid()
    proc = subprocess.run(
        [_nvcc()] + NVCC_FLAGS + ["-o", tmp,
                                  os.path.join(CSRC, SOURCE + ".cu")],
        capture_output=True, text=True)
    with open(out[:-3] + ".log", "w") as fh:
        fh.write(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError("nvcc failed for %s.cu:\n%s%s"
                           % (SOURCE, proc.stdout, proc.stderr))
    os.replace(tmp, out)


def build():
    """Compile the kernels unless already built, load them; returns the
    ctypes library."""
    global _lib
    if _lib is None:
        out = _stem() + ".so"
        if not os.path.exists(out):
            _compile(out)
        lib = ctypes.CDLL(out)
        for fn, argtypes in ENTRY_POINTS.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        _lib = lib
    return _lib


def build_log():
    """The compiler's report (after build)."""
    with open(_stem() + ".log") as fh:
        return fh.read()


def function(name):
    return getattr(build(), name)

"""Build and load the CUDA kernels on first use.

Three libraries, each one ``nvcc`` run, started together when they are
missing:

- ``msm_kernels`` from ``csrc/msm_kernels.cu``, which includes
  ``csrc/setup_kernels.cu`` and ``csrc/msm_fused_kernels.cu``: every point
  kernel (K1-K6);
- ``probe_kernels`` from ``csrc/probe_kernels.cu``: the throughput probe
  (K7) and the Fq product's latency chain (K7b);
- ``witness_kernels`` from ``csrc/witness_kernels.cu``: the witness map's
  CSR mat-vec (K8) and transform pass (K9).

Each source is compiled into a shared library with a plain C interface
under ``build/ethsnarks_tpu_torch/`` at the repo root (git-ignored), named
by a hash of the flags and sources so an edited kernel rebuilds, and
loaded with ``ctypes``.  ``torch.utils.cpp_extension.load`` is not used: a
source that includes PyTorch's headers takes minutes to compile, a plain
one seconds.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "ethsnarks_tpu_torch")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# library -> {C entry point: argtypes}
_VOID = ctypes.c_void_p
_INT = ctypes.c_int
LIBRARIES = {
    "msm_kernels": {
        "esn_point_add_g1": [_VOID, _VOID, _VOID, _VOID, _VOID, _INT, _VOID],
        "esn_point_add_g2": [_VOID, _VOID, _VOID, _VOID, _VOID, _INT, _VOID],
        "esn_point_double_g1": [_VOID, _VOID, _INT, _INT, _INT, _VOID],
        "esn_point_double_g2": [_VOID, _VOID, _INT, _INT, _INT, _VOID],
        "esn_horner_g1": [_VOID, _VOID, _INT, _INT, _INT, _VOID],
        "esn_horner_g2": [_VOID, _VOID, _INT, _INT, _INT, _VOID],
        "esn_fixed_base_mul_g1": [_VOID, _VOID, _VOID, _INT, _INT, _INT,
                                  _VOID],
        "esn_fixed_base_mul_g2": [_VOID, _VOID, _VOID, _INT, _INT, _INT,
                                  _VOID],
        "esn_bucket_fold_g1": [_VOID, _VOID, _VOID, _INT, _INT, _INT, _INT,
                               _INT, _INT, _VOID],
        "esn_bucket_fold_g2": [_VOID, _VOID, _VOID, _INT, _INT, _INT, _INT,
                               _INT, _INT, _VOID],
        "esn_bucket_fold_blocks_g1": [_INT],
        "esn_bucket_fold_blocks_g2": [_INT],
        "esn_seg_scan_g1": [_VOID, _VOID, _VOID, _VOID, _INT, _INT, _INT,
                            _VOID],
        "esn_seg_scan_g2": [_VOID, _VOID, _VOID, _VOID, _INT, _INT, _INT,
                            _VOID],
    },
    "probe_kernels": {
        "esn_int_probe": [_INT, _VOID, _VOID, _VOID, _INT, _INT, _VOID],
        "esn_fq_chain": [_VOID, _VOID, _VOID, _INT, _INT, _VOID],
    },
    "witness_kernels": {
        "esn_csr_matvec_fr": [_VOID, _VOID, _VOID, _VOID, _VOID, _INT, _VOID],
        "esn_ntt_pass_fr": [_VOID, _VOID, _VOID, _VOID, _VOID, _VOID, _INT,
                            _INT, _INT, _INT, _INT, _INT, _VOID],
    },
}

_libs = {}


def _nvcc():
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def _stem(lib):
    """build/ethsnarks_tpu_torch/<lib>-<hash of flags and sources>."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in sorted(os.listdir(CSRC)):
        with open(os.path.join(CSRC, name), "rb") as fh:
            h.update(name.encode() + fh.read())
    return os.path.join(BUILD_DIR, "%s-%s" % (lib, h.hexdigest()[:16]))


def _compile(libs):
    """One nvcc run per library, all started together.  Each compiler's
    report (registers and spills per kernel) is kept beside its library
    as a .log."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    runs = []
    for lib in libs:
        out = _stem(lib) + ".so"
        tmp = out + ".tmp%d" % os.getpid()
        proc = subprocess.Popen(
            [nvcc] + NVCC_FLAGS + ["-o", tmp, os.path.join(CSRC, lib + ".cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        runs.append((lib, out, tmp, proc))
    failed = []
    for lib, out, tmp, proc in runs:
        report = proc.communicate()[0]
        with open(out[:-3] + ".log", "w") as fh:
            fh.write(report)
        if proc.returncode != 0:
            failed.append("nvcc failed for %s.cu:\n%s" % (lib, report))
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))


def build():
    """Compile the libraries not built yet and load them all; returns
    {library: ctypes library}."""
    if len(_libs) < len(LIBRARIES):
        _compile([lib for lib in LIBRARIES
                  if not os.path.exists(_stem(lib) + ".so")])
        for lib, entry_points in LIBRARIES.items():
            handle = ctypes.CDLL(_stem(lib) + ".so")
            for fn, argtypes in entry_points.items():
                getattr(handle, fn).argtypes = argtypes
                getattr(handle, fn).restype = ctypes.c_int
            _libs[lib] = handle
    return _libs


def build_log():
    """The compilers' reports (after build)."""
    out = []
    for lib in LIBRARIES:
        with open(_stem(lib) + ".log") as fh:
            out.append(fh.read())
    return "".join(out)


def function(name):
    for lib, entry_points in LIBRARIES.items():
        if name in entry_points:
            return getattr(build()[lib], name)
    raise KeyError("no CUDA entry point %r" % name)

"""Build the hand-written Hopper kernels and bind them with ctypes.

The CUDA sources under ``easevoice_trainer_tpu_torch/csrc/`` have a plain C
interface.  At first use each ``.cu`` is compiled with ``nvcc`` for
``sm_90a`` in its own process, all at once, and the objects are linked into
one shared library under ``build/torch_kernels/<hash>/`` at the repository
root (git-ignored); the hash covers the sources, the headers and the flags,
so an edited source rebuilds and an unchanged one loads the library already
built.

Every entry point takes ``c_void_p`` pointers (tensor ``data_ptr()``) and the
current CUDA stream, launches, and returns ``cudaGetLastError()``;
:func:`check` raises on a non-zero code.
"""
from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import time
from typing import Optional

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_ROOT = os.path.join(os.path.dirname(_PKG), "build", "torch_kernels")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_F = ctypes.c_float
SIGNATURES = {
    "ev_prefill_attention_f32": [_P] * 5 + [_LL] * 6
    + [_P, _P, _I, _I, _I, _I, _F, _P],
    "ev_encoder_attention_f32": [_P] * 4 + [_LL] * 6
    + [_P, _I, _I, _I, _I, _F, _P],
    "ev_prefill_attention_bwd_f32": [_P] * 10 + [_LL] * 4
    + [_P, _P, _I, _I, _I, _I, _F, _P],
    "ev_decode_attention_f32": [_P] * 7 + [_LL] * 3 + [_I] * 5 + [_F, _P],
    "ev_mrf_conv_f32": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _P],
    "ev_mrf_conv_bwd_data_f32": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F,
                                 _P],
    "ev_mrf_conv_bwd_weight_f32": [_P] * 5 + [_I] * 6 + [_F] + [_I] * 5
    + [_P],
    "ev_mrf_conv_bwd_weight_max_clusters": [_I] * 7,
}
# the bf16 instances take the fp32 ones' arguments
for _name in ("ev_prefill_attention", "ev_prefill_attention_bwd", "ev_mrf_conv",
              "ev_mrf_conv_bwd_data", "ev_mrf_conv_bwd_weight"):
    SIGNATURES[_name + "_bf16"] = SIGNATURES[_name + "_f32"]
SIGNATURES["ev_mrf_conv_bwd_weight_max_clusters_bf16"] = [_I] * 7
# K1 and K5 with dropout (the s1 fine-tune): the arguments of the instance
# without, then the Philox seed, the layer, the keep threshold, 1 - p, the
# global batch row of batch row 0 and the layer's head of head 0, before the
# stream
for _name in ("ev_prefill_attention", "ev_prefill_attention_bwd"):
    for _dt in ("f32", "bf16"):
        _base = SIGNATURES[f"{_name}_{_dt}"]
        SIGNATURES[f"{_name}_dropout_{_dt}"] = _base[:-1] + [
            ctypes.c_ulonglong, _I, ctypes.c_uint, _F, _I, _I, _P]


class KernelLibrary:
    """The loaded shared library plus what its build reported."""

    def __init__(self, lib: ctypes.CDLL, path: str, seconds: float,
                 log: str):
        self.lib = lib
        self.path = path
        self.build_seconds = seconds
        self.build_log = log
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.ev_cuda_error_string.argtypes = [_I]
        lib.ev_cuda_error_string.restype = ctypes.c_char_p

    def __getattr__(self, name):
        return getattr(self.lib, name)


_loaded: Optional[KernelLibrary] = None


def _sources():
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def _headers():
    return sorted(glob.glob(os.path.join(CSRC, "*.cuh")))


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit to build")
    return path


def build() -> KernelLibrary:
    """Compile (or reuse) the kernel library and load it."""
    global _loaded
    if _loaded is not None:
        return _loaded
    sources = _sources()
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources + _headers():
        digest.update(os.path.basename(src).encode())
        with open(src, "rb") as f:
            digest.update(f.read())
    out_dir = os.path.join(BUILD_ROOT, digest.hexdigest()[:16])
    so = os.path.join(out_dir, "libeasevoice_kernels.so")
    t0 = time.perf_counter()
    log = "reused " + so
    if not os.path.exists(so):
        os.makedirs(out_dir, exist_ok=True)
        nvcc = _nvcc()
        tag = f"{os.getpid()}.tmp"
        objs = [os.path.join(out_dir, os.path.basename(src) + f".{tag}.o")
                for src in sources]
        procs = [subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", "-o", obj, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for src, obj in zip(sources, objs)]
        logs = [p.communicate()[0] for p in procs]
        log = "".join(logs)
        failed = [src for src, p in zip(sources, procs) if p.returncode]
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n{log}")
        tmp = f"{so}.{tag}"
        proc = subprocess.run([nvcc, "-shared", "-o", tmp, *objs],
                              capture_output=True, text=True)
        log += proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                               f"{log}")
        os.replace(tmp, so)
        for obj in objs:
            os.remove(obj)
    _loaded = KernelLibrary(ctypes.CDLL(so), so, time.perf_counter() - t0,
                            log)
    return _loaded


def error_string(code: int) -> str:
    """The CUDA runtime's message for error ``code``."""
    return build().ev_cuda_error_string(code).decode()


def check(code: int, name: str) -> None:
    """Raise when a kernel entry point returned a CUDA error code, with the
    runtime's message for it."""
    if code != 0:
        raise RuntimeError(f"{name}: CUDA error {code} "
                           f"({error_string(code)}) at launch")

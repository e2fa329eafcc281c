"""Build and load the port's hand-written CUDA kernels.

The sources under ``lifelong_clip_tpu_torch/csrc/`` (the fused LN-attention
block and its KV-prefix variant, and attention on projected q, k, v, each
forward and backward; ``mma.cuh`` holds the primitives both include) have a
plain C interface. At first use one ``nvcc``
per source, all started together, compiles them for ``sm_90a``, and one more
links them into a shared library under ``csrc/build/`` (listed in
``.gitignore``), which ``ctypes`` loads. The library name carries a hash of
the sources and flags, so an edited source rebuilds.

Nothing here runs at import time: a machine without ``nvcc`` or a GPU can
import every module of the port.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "csrc")
BUILD_DIR = os.path.join(CSRC, "build")
SOURCES = ("fused_block_attn.cu", "flash_attention.cu")
HEADERS = ("mma.cuh",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_VP, _I, _F, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, \
    ctypes.c_longlong
_SIGNATURES = {
    "llc_ln_fwd": [_I, _I, _VP, _VP, _VP, _VP, _I, _I, _F, _VP],
    "llc_ln_bwd": [_I, _I, _VP, _VP, _VP, _VP, _VP, _VP, _I, _I, _F, _VP],
    "llc_cast_bf16": [_I, _VP, _VP, _LL, _VP],
    "llc_partial_sums": [_I, _VP, _VP],
    "llc_gemm": [_I, _I, _I, _I, _VP, _LL, _LL, _VP, _LL, _LL, _F, _VP, _I,
                 _VP, _LL, _LL, _VP, _LL, _LL, _I, _F, _VP, _LL, _VP, _LL, _I,
                 _VP, _I, _LL, _LL, _VP],
    "llc_attn_fwd": [_VP, _VP, _VP, _VP, _I, _I, _I, _I, _F, _VP],
    "llc_attn_bwd": [_VP, _VP, _VP, _VP, _VP, _VP, _VP, _I, _I, _I, _I, _F,
                     _VP],
    "llc_mask_tile_map": [_VP, _VP, _I, _I, _VP],
    "llc_attn_prefix_fwd": [_VP, _VP, _VP, _I, _VP, _VP, _I, _I, _I, _I, _I,
                            _F, _VP],
    "llc_attn_prefix_bwd": [_VP, _VP, _VP, _VP, _I, _VP, _VP, _VP, _VP, _VP,
                            _I, _I, _I, _I, _I, _F, _VP],
    "llc_flash_fwd": [_I, _VP, _VP, _VP, _VP, _LL, _LL, _VP, _I, _I, _I, _I,
                      _I, _F, _VP],
    "llc_flash_bwd": [_I, _VP, _VP, _VP, _VP, _VP, _LL, _LL, _VP, _VP, _VP,
                      _VP, _I, _I, _I, _I, _I, _F, _VP],
}

_lock = threading.Lock()
_lib = None


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    cands = [os.path.join(CUDA_HOME, "bin", "nvcc")] if CUDA_HOME else []
    cands.append(shutil.which("nvcc") or "")
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: the port's CUDA kernels are built "
                       "from lifelong_clip_tpu_torch/csrc at first use and "
                       "need the CUDA toolkit (set CUDA_HOME)")


def library_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in SOURCES + HEADERS:
        with open(os.path.join(CSRC, src), "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"libllc_kernels_{h.hexdigest()[:12]}.so")


def build() -> str:
    """Compile each source (in parallel) and link them; returns the library
    path. A no-op when the library for these sources already exists. The
    compiler's register / shared-memory / spill report lands beside the
    library as ``<library>.ptxas.txt``."""
    out = library_path()
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=BUILD_DIR)
    nvcc = _nvcc()
    try:
        objs = [os.path.join(tmp, f"{i}.o") for i in range(len(SOURCES))]
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c",
                                   os.path.join(CSRC, src), "-o", obj],
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for src, obj in zip(SOURCES, objs)]
        logs = [p.communicate()[0] for p in procs]
        report = "".join(f"== {src}\n{log}" for src, log in zip(SOURCES, logs))
        if any(p.returncode != 0 for p in procs):
            raise RuntimeError(f"nvcc failed:\n{report}")
        part = os.path.join(tmp, "lib.so")
        # -lcuda: libcuda holds cuTensorMapEncodeTiled (the GEMM's TMA maps)
        run = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", *objs, "-lcuda",
                              "-o", part], capture_output=True, text=True)
        if run.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{run.stdout}{run.stderr}")
        with open(out + ".ptxas.txt", "w") as f:
            f.write(report)
        os.replace(part, out)   # atomic: concurrent builders race safely
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


def library():
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.llc_error_string.argtypes = [ctypes.c_int]
            lib.llc_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def call(name: str, *args) -> None:
    """Launch through the C interface; raise if the launch was refused."""
    lib = library()
    rc = getattr(lib, name)(*args)
    if rc != 0:
        raise RuntimeError(f"{name} failed: "
                           f"{lib.llc_error_string(rc).decode()} ({rc})")

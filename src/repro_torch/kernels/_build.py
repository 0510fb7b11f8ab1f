"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` compiles with its own ``nvcc`` process (all started
together) into an object file; one more ``nvcc`` links them into a shared
library with a plain C interface, loaded with ``ctypes``.  The library
lands in ``build/`` at the repository root, named by a hash of the sources
and flags, so an edited source never loads a stale build.  Nothing here
runs at import: :func:`library` builds on first use.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", *ARCH_FLAGS]

_P = ctypes.c_void_p
_I = ctypes.c_int

# C entry points: name -> argtypes (every entry returns a cudaError_t)
SIGNATURES = {
    "spoga_gemm_dequant_launch": [
        _P, _I, _P, _I, _P, _P, _P,  # x, x_bytes, w, w_bytes, xs, ws, out
        _I, _I, _I,                  # M, K, N
        _I, _I, _I,                  # n_x_slices, n_w_slices, slice_bits
        _P,                          # stream
    ],
    "spoga_gemm_launch": [
        _P, _I, _P, _I, _P,          # x, x_bytes, w, w_bytes, out
        _I, _I, _I,                  # M, K, N
        _I, _I, _I,                  # n_x_slices, n_w_slices, slice_bits
        _P,                          # stream
    ],
    "nibble_gemm_launch": [
        _P, _P, _P,                  # a, b, out
        _I, _I, _I,                  # M, K, N
        _P,                          # stream
    ],
    "deas_combine_launch": [
        _P, _P, _P, _P, _P,          # mm, ml, lm, ll, out
        _I, _I, _I,                  # M, N, vectorized (all pointers 16-byte aligned)
        _P,                          # stream
    ],
    "noop_launch": [
        _I, _I,                      # M, N: deas_combine's grid for that call
        _P,                          # stream
    ],
    "paged_attention_launch": [
        _P, _I,                      # q, q_is_bf16
        _P, _P, _I,                  # kp, vp, kv_int8
        _P, _P,                      # k_scale, v_scale (NULL for bf16 pools)
        _P, _P, _P,                  # tables, lengths, out
        _I, _I, _I, _I,              # B, Hkv, G, D
        _I, _I,                      # page_size, pages per table row
        _P,                          # stream
    ],
}

_LIB = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "the port's kernels")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build(verbose: bool = False) -> Path:
    """Compile the kernels (if this exact source set is not built yet) and
    return the shared library's path."""
    sources = _sources()
    lib_path = BUILD_DIR / f"repro_torch_kernels_{_digest()}.so"
    if lib_path.exists():
        return lib_path
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        extra = ["-Xptxas", "-v"] if verbose else []
        procs = []
        objs = []
        for src in sources:
            obj = Path(tmp) / (src.stem + ".o")
            objs.append(obj)
            procs.append((src, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, *extra, "-c", str(src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        failed = []
        for src, proc in procs:
            out, _ = proc.communicate()
            if verbose and out:
                print(out)
            if proc.returncode != 0:
                failed.append(f"{src.name}:\n{out}")
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        tmp_lib = Path(tmp) / lib_path.name
        link = subprocess.run(
            [nvcc, *ARCH_FLAGS, "-shared", *map(str, objs), "-o", str(tmp_lib)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(tmp_lib, lib_path)
    return lib_path


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def check(err: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")

"""Build and load the port's CUDA kernels.

The sources in ``repro_torch/csrc/`` are compiled with ``nvcc`` for
``sm_90a`` (Hopper) — one ``nvcc -c`` per source, all started together —
and linked into one shared library with a plain C interface, loaded with
``ctypes``.  Kernels that need more than 48 KB of shared memory (the tANS
tables up to table_log 15, the Huffman decode LUT) set ``cudaFuncAttributeMaxDynamicSharedMemorySize``
in their C entry point before each launch, and every entry point returns
``cudaGetLastError()``.  The build happens at first use, from the repository's sources
alone, into ``build/`` at the repository root; the library's name carries a
digest of the sources and flags, so an edited source builds anew and an
unchanged one loads the existing file.  The library is staged under a
temporary name and published with ``os.replace``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import List, Optional

SRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
# the bytes of one tile of K2's single-pass scan (csrc/delta.cu reads it as
# DTILE_BYTES); defined here alone, so that the checks that size inputs
# around the tile (ops.delta_decode_tile) read the value the kernel was built with
DELTA_TILE_BYTES = 16384
# the entries of the largest tANS table that K9 and K10 hold in shared memory
# (csrc/fse.cu reads it as FSE_SHARED_TABLE); a larger one stays in global memory
FSE_SHARED_TABLE = 1 << 15
COMPILE_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v",
                              f"-DDTILE_BYTES={DELTA_TILE_BYTES}",
                              f"-DFSE_SHARED_TABLE={FSE_SHARED_TABLE}"]

_P = ctypes.c_void_p
_I64 = ctypes.c_longlong
_I32 = ctypes.c_int
# C entry point -> argtypes (every pointer and the stream as c_void_p); each
# returns its cudaError_t as an int unless RESTYPES names another type
RESTYPES = {
    "repro_delta_decode_scratch": _I64,
    "repro_fused_delta_bitpack_decode_scratch": _I64,
    "repro_fused_delta_bitpack_decode_tile": _I64,
}
SIGNATURES = {
    "repro_delta_encode": [_P, _P, _I64, _I32, _P],
    "repro_byteshuffle": [_P, _P, _I64, _I64, _I32, _P],
    "repro_huffman_map": [_P, _P, _P, _P, _P, _I64, _P],
    "repro_fse_encode": [_P] * 11 + [_I32, _I64, _I32, _I32, _P],
    "repro_delta_decode_scratch": [_I64, _I32],
    "repro_delta_decode": [_P, _P, _P, _I64, _I64, _I32, _P],
    "repro_byteunshuffle": [_P, _P, _I64, _I64, _P],
    "repro_huffman_decode": [_P, _I64, _P, _P, _I32, _P, _I32, _I64, _P],
    "repro_fse_decode": [_P, _I64] + [_P] * 6 + [_I32, _I64, _I32, _I32, _P],
    "repro_lane_refill": [_P, _P, _P, _I64, _P],
    "repro_float_split": [_P] * 4 + [_I64] + [_I32] * 5 + [_P],
    "repro_float_merge": [_P] * 4 + [_I64] + [_I32] * 5 + [_P],
    "repro_histogram": [_P, _I64, _P, _P],
    "repro_bitpack": [_P, _P, _I64, _I32, _I32, _P],
    "repro_bitunpack": [_P, _P, _I64, _I32, _I32, _P],
    "repro_fused_delta_bitpack": [_P, _P, _I64, _I32, _I32, _P],
    "repro_fused_delta_bitpack_decode_scratch": [_I64, _I32, _I32],
    "repro_fused_delta_bitpack_decode_tile": [_I32, _I32],
    "repro_fused_delta_bitpack_decode": [_P, _P, _P, _I64, _I64, _I32, _I32, _P],
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
build_log: List[str] = []  # compiler output of this process's build (ptxas -v)
build_seconds: Optional[float] = None  # None until this process built the library


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found: the CUDA kernels are built with the CUDA toolkit on the"
        " machine that has the card"
    )


def _digest() -> str:
    h = hashlib.sha256(" ".join(COMPILE_FLAGS).encode())
    for p in sorted(SRC_DIR.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the kernels (if this source digest has no library yet)."""
    global build_seconds
    sources = sorted(SRC_DIR.glob("*.cu"))
    out = BUILD_DIR / f"librepro_torch_kernels_{_digest()}.so"
    if out.exists():
        return out
    nvcc = _nvcc()
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    stage = Path(tempfile.mkdtemp(prefix="stage-", dir=BUILD_DIR))
    try:
        objs = [stage / (src.stem + ".o") for src in sources]
        procs = [
            subprocess.Popen(
                [nvcc, *COMPILE_FLAGS, "-c", str(src), "-o", str(obj)],
                stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT,
                text=True,
            )
            for src, obj in zip(sources, objs)
        ]
        failed = []
        for src, proc in zip(sources, procs):
            text = proc.communicate()[0]
            build_log.append(f"== {src.name}\n{text}")
            if proc.returncode:
                failed.append(f"{src.name} (exit {proc.returncode}):\n{text}")
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        staged = stage / out.name
        link = subprocess.run(
            [nvcc, *ARCH_FLAGS, "-shared", "-o", str(staged), *map(str, objs)],
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            text=True,
        )
        if link.returncode:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(staged, out)
    finally:
        shutil.rmtree(stage, ignore_errors=True)
    build_seconds = time.perf_counter() - t0
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library, built at first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = RESTYPES.get(name, ctypes.c_int)
            _lib = lib
        return _lib

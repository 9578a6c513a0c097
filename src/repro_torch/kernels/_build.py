"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

Each source is compiled by its own ``nvcc`` (all started together) for
``sm_90a`` with a plain C interface, linked into one shared library under
``<repo>/build/kernels/`` and loaded with ``ctypes``. Nothing here runs at
import: :func:`library` builds on first use. The library's file name
carries a hash of the sources and flags, so an edited source rebuilds.
No ``--use_fast_math``: K3 and K5 must round and divide exactly as IEEE
f32 does.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
# C signature of every entry point: (argtypes, restype)
SIGNATURES = {
    "awp_pgd_step_f32": ([_P] * 6 + [_I] * 5 + [_P], _I),
    "awp_pgd_smem_bytes": ([_I], _I),
    "topk_row_f32": ([_P, _P] + [_I] * 5 + [_P], _I),
    "quant_project_f32": ([_P, _P, _I, _I, _I, _I, _P], _I),
    "dequant_matmul_f32": ([_P] * 5 + [_I] * 6 + [_P], _I),
    "dequant_matmul_experts_f32": ([_P] * 5 + [_I] * 5 + [_L] * 4
                                   + [_I] * 2 + [_P], _I),
    "dequant_matmul_smem_bytes": ([_I, _I], _I),
    "kv_dequant_u8": ([_P, _P, _P, _P, _I, _I, _I, _P], _I),
    "decode_attn": ([_P] * 10 + [_I] * 9 + [_P], _I),
    "decode_attn_paged": ([_P] * 11 + [_I] * 11 + [_P], _I),
}

_LIB: Optional[ctypes.CDLL] = None
_LOG: Dict[str, str] = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (looked on PATH and in CUDA_HOME)")


def sources():
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile every source in parallel and link the shared library;
    returns its path (reused when already built from the same sources).
    The ptxas report of each source is kept for :func:`build_log`."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib = BUILD_DIR / f"libawp_kernels_{_digest()}.so"
    if lib.exists():
        return lib
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = {}
        for src in sources():
            obj = Path(tmp) / (src.stem + ".o")
            procs[src.name] = (obj, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        failed = []
        for name, (_, proc) in procs.items():
            out, _ = proc.communicate()
            _LOG[name] = out
            if proc.returncode:
                failed.append(f"{name}:\n{out}")
        if failed:
            raise RuntimeError("nvcc failed\n" + "\n".join(failed))
        staged = Path(tmp) / lib.name
        link = subprocess.run(
            [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
             "-o", str(staged), *(str(o) for o, _ in procs.values())],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode:
            raise RuntimeError("nvcc link failed\n" + link.stdout)
        os.replace(staged, lib)            # atomic: no half-written library
    return lib


def build_log() -> Dict[str, str]:
    """ptxas output (registers, shared memory, spills) per source of the
    last build in this process; empty when the library was reused."""
    return dict(_LOG)


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        for name, (argtypes, restype) in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = restype
        _LIB = lib
    return _LIB


__all__ = ["BUILD_DIR", "CSRC", "SIGNATURES", "build", "build_log",
           "library", "sources"]

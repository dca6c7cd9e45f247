"""Build and load the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into its
own shared library with a plain C interface, loaded with ``ctypes``.
Libraries land in ``build/repro_torch_kernels/`` at the repository root,
named by a hash of their source and of the headers in ``csrc/``, so an
edited source or header builds anew and an unchanged one is reused.
Building happens at first use (or through ``build_all``), never at
import: machines without ``nvcc`` import this module freely.

``LAUNCHES`` counts kernel launches by kernel name.  Each wrapper adds
one right where it launches its kernel and nowhere else, so a count
taken around a run shows whether that run went through the kernel.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
#: C signature of each kernel source's entry point: (symbol, argtypes).
SIGNATURES = {
    "segment_sum": ("repro_segment_sum", [_I, _I, _P, _P, _L, _L, _P, _P]),
    "substr_find": ("repro_substr_find", [_I, _P, _P, _P, _P, _I, _P, _I, _L, _I, _P, _P]),
    "wkv6": ("repro_wkv6", [_I, _P, _P, _P, _P, _P, _P, _P, _P, ctypes.POINTER(_L), _P]),
    "flash_attention_sm90": (
        "repro_flash_attention_sm90",
        [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I] + [_L] * 12 + [_F, _I, _P],
    ),
    "flash_attention_f32_sm90": (
        "repro_flash_attention_f32_sm90",
        [_P] * 6 + [_I] * 6 + [_L] * 12 + [_F, _I, _P],
    ),
    "hash32x2": ("repro_hash32x2", [_P, _L, _I, _P, _P]),
    # the backward kernels of K4 and K5 (training; no TPU counterpart)
    "flash_attention_bwd_sm90": (
        "repro_flash_attention_bwd_sm90", [_P] * 10 + [ctypes.POINTER(_L), _F, _I, _P],
    ),
    "flash_attention_bwd_f32_sm90": (
        "repro_flash_attention_bwd_f32_sm90", [_P] * 11 + [ctypes.POINTER(_L), _F, _I, _P],
    ),
    "wkv6_bwd": ("repro_wkv6_bwd", [_I] + [_P] * 17 + [ctypes.POINTER(_L), _P]),
}

LAUNCHES: Dict[str, int] = {name: 0 for name in SIGNATURES}
#: nvcc's output (ptxas register and shared-memory report) per kernel.
BUILD_LOG: Dict[str, str] = {}

_LOCK = threading.Lock()
_FNS: Dict[str, object] = {}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def wants_grad(*tensors) -> bool:
    """Whether autograd would record a gradient through these tensors (None
    entries are skipped): a kernel writes its outputs through raw pointers,
    so such inputs must go through the kernel's autograd Function."""
    if not torch.is_grad_enabled():
        return False
    for t in tensors:  # a loop, not a generator: it runs in every decode-step layer
        if t is not None and t.requires_grad:
            return True
    return False


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _lib_path(name: str) -> Path:
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):  # the headers a source may include
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build_all() -> List[Path]:
    """Compile every kernel source that has no up-to-date library, one
    ``nvcc`` per source, all started together.  Raises on any failure."""
    with _LOCK:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs = []
        for name in SIGNATURES:
            out = _lib_path(name)
            if out.exists():
                continue
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
            proc = subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            )
            procs.append((name, out, tmp, proc))
        failed = []
        for name, out, tmp, proc in procs:
            log, _ = proc.communicate()
            BUILD_LOG[name] = log
            if proc.returncode != 0:
                failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
                continue
            os.replace(tmp, out)
        if failed:
            raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
        return [_lib_path(name) for name in SIGNATURES]


def kernel(name: str):
    """The ctypes entry point of kernel ``name``, building on first use."""
    fn = _FNS.get(name)
    if fn is None:
        path = _lib_path(name)
        if not path.exists():
            build_all()
        symbol, argtypes = SIGNATURES[name]
        fn = getattr(ctypes.CDLL(str(path)), symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _FNS[name] = fn
    return fn


def check(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError {err}")

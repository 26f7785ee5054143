"""Build and load the hand-written CUDA kernels.

Each source under ``csrc/`` is compiled by nvcc into its own shared library
with a plain C interface and loaded with ctypes (no PyTorch headers, so a
build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared \
         -Xcompiler -fPIC -o lib<name>.so csrc/<name>.cu

No ``--use_fast_math``: flush-to-zero would change which tiny residuals
count as survivors.  Libraries land in ``kernels/_build/`` under a name
keyed on a hash of the source and the flags, so a changed source rebuilds
and an unchanged one loads what is there.  All missing sources are compiled
in parallel, one nvcc process each.

``BUILD_LOGS`` holds nvcc's output of each source (its -Xptxas -v lines
name every kernel's registers and spills), kept beside the library so a
later process that loads it finds the log too.  ``LAUNCHES`` holds one
plain integer per kernel wrapper and dtype (``block_topk`` and ``quantize``
count their f32 launches, ``block_topk_bf16`` and ``quantize_bf16`` their
bf16 ones); a wrapper adds one where it launches its kernel and nowhere
else.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers / spills of every kernel into the build log
)

_P, _I = ctypes.c_void_p, ctypes.c_int
# C entry points of each source: name -> argtypes (every one returns the
# int value of cudaGetLastError() after its launch)
SIGNATURES = {
    "topk_compress": {
        "block_topk_f32": (_P, _P, _I, _I, _I, _P),
        "block_topk_bf16": (_P, _P, _I, _I, _I, _P),
        "block_topk_leaf_f32": (_P, _P, _I, _I, _I, _I, _P),
        "block_topk_leaf_bf16": (_P, _P, _I, _I, _I, _I, _P),
    },
    "pack_residuals": {
        "pack_sparse_blocks_f32": (_P, _P, _P, _I, _I, _I, _P),
        "unpack_sparse_blocks_f32": (_P, _P, _P, _I, _I, _I, _P),
    },
    "quantize": {
        "quantize_f32": (_P, _P, _P, _P, _I, _I, _I, _P),
        "quantize_bf16": (_P, _P, _P, _P, _I, _I, _I, _P),
    },
}

LAUNCHES = {
    "block_topk": 0, "block_topk_bf16": 0, "pack_sparse_blocks": 0, "unpack_sparse_blocks": 0,
    "quantize": 0, "quantize_bf16": 0,
}

_LIBS: dict[str, ctypes.CDLL] = {}
BUILD_LOGS: dict[str, str] = {}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def launch_counts() -> dict[str, int]:
    return dict(LAUNCHES)


def nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found (looked on PATH and in /usr/local/cuda/bin)")
    return found


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names=None) -> float:
    """Compile every listed source (default: all) that has no up-to-date
    library yet, in parallel; returns the wall seconds spent.  Raises with
    nvcc's output if any compile fails."""
    names = list(SIGNATURES) if names is None else list(names)
    todo = [n for n in names if not library_path(n).exists()]
    for n in set(names) - set(todo) - set(BUILD_LOGS):
        log = library_path(n).with_suffix(".log")
        BUILD_LOGS[n] = log.read_text() if log.exists() else ""
    t0 = time.perf_counter()
    if not todo:
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    exe = nvcc()
    procs = {}
    for n in todo:
        tmp = library_path(n).with_suffix(f".{os.getpid()}.tmp")
        cmd = [exe, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ))
    failed = []
    for n, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        BUILD_LOGS[n] = out
        if proc.returncode == 0:
            library_path(n).with_suffix(".log").write_text(out)
            os.replace(tmp, library_path(n))
        else:
            failed.append(f"--- nvcc {n}.cu (exit {proc.returncode}) ---\n{out}")
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built at first use."""
    lib = _LIBS.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        for fn, argtypes in SIGNATURES[name].items():
            getattr(lib, fn).argtypes = list(argtypes)
            getattr(lib, fn).restype = ctypes.c_int
        _LIBS[name] = lib
    return lib


def stream_for(t: torch.Tensor) -> int:
    """The handle of the current CUDA stream.  A kernel launches on the
    current device, so the tensor it works on must lie there."""
    if t.device.index != torch.cuda.current_device():
        raise ValueError(f"tensor on {t.device}, but the current CUDA device is {torch.cuda.current_device()}")
    return torch.cuda.current_stream().cuda_stream


def check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {rc}")

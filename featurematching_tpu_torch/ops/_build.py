"""Build and load the port's CUDA kernels.

Each source `csrc/<name>.cu` is compiled on first use by `nvcc` for `sm_90a`
into `build/kernels/lib<name>_<hash>.so` at the root of the checkout (the
hash covers the sources and the flags, so an edited source is rebuilt) and
loaded with `ctypes`. The libraries have a plain C interface: every entry
takes device pointers, ints and the CUDA stream, launches on that stream and
returns `cudaGetLastError()`. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, Optional, Sequence

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
SOURCES = (
    "layer_norm", "swin_block", "patch_expand", "dual_softmax", "coarse_transformer", "fine_stage",
    "swin_block_train", "sparse_focal_loss", "coarse_transformer_train",
    "fine_transformer_train", "window_attention", "swin_block_image", "wgrad",
    "dual_softmax_f32", "coarse_transformer_f32",
)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

PTR = ctypes.c_void_p
INT = ctypes.c_int
FLOAT = ctypes.c_float

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:12]}.so"


def build(names: Iterable[str] = SOURCES, ptxas_verbose: bool = False) -> Dict[str, str]:
    """Compile every library of `names` not built yet, one `nvcc` process
    per source, all started together. Returns each compiler's output."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    for name in names:
        out = _lib_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        if ptxas_verbose:
            cmd[1:1] = ["-Xptxas", "-v"]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        jobs.append((name, out, tmp, proc))
    logs, failed = {}, []
    for name, out, tmp, proc in jobs:
        logs[name], _ = proc.communicate()
        if proc.returncode == 0:
            os.replace(tmp, out)
        else:
            failed.append(name)
    if failed:
        raise RuntimeError(
            "nvcc failed for " + ", ".join(failed) + ":\n"
            + "\n".join(logs[n] for n in failed)
        )
    return logs


def _load(name: str) -> ctypes.CDLL:
    with _lock:
        if name not in _libs:
            path = _lib_path(name)
            if not path.exists():
                build([name])
            lib = ctypes.CDLL(str(path))
            lib.fm_error_string.argtypes = [INT]
            lib.fm_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
        return _libs[name]


def launch(lib_name: str, fn_name: str, argtypes: Sequence, *args) -> None:
    """Call the C entry `fn_name` of library `lib_name` (argtypes set, int
    result) and raise if the launch reported a CUDA error."""
    lib = _load(lib_name)
    fn = getattr(lib, fn_name)
    fn.argtypes = list(argtypes)
    fn.restype = INT
    err = fn(*args)
    if err != 0:
        raise RuntimeError(f"{fn_name}: CUDA error {err} ({lib.fm_error_string(err).decode()})")


def stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def check_cuda(t: torch.Tensor, name: str, dtype: Optional[torch.dtype] = None,
               shape: Optional[Sequence[int]] = None) -> None:
    """Raise unless `t` is a contiguous CUDA tensor of `dtype` and `shape`,
    16-byte aligned (the kernels use vector loads)."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if dtype is not None and t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: data pointer not 16-byte aligned")


def f32(t: torch.Tensor) -> torch.Tensor:
    """A contiguous float32 copy (or the tensor itself) for a kernel argument."""
    return t.to(torch.float32).contiguous()


def bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).contiguous()

"""Build and load the port's CUDA kernels.

Every ``kernels/**/csrc/*.cu`` source has a plain C interface (no PyTorch
headers), so ``nvcc`` compiles each one in seconds; device code shared by
several sources sits in ``csrc/*.cuh`` headers beside them. At first use the
sources are compiled in parallel, one ``nvcc`` per file, and linked into
one shared library that ``ctypes`` loads::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
         -Xcompiler -fPIC -c <source> -o <object>      (one per source)
    nvcc -shared -o libreprotorch_kernels.so <objects>

No ``--use_fast_math``: the channel's mask compare and Box-Muller stay
IEEE. The library lands in ``build/kernels/<hash>/`` at the checkout's
root, keyed by a hash of the sources and flags, so an edited source
(or header) rebuilds and an unchanged one loads the existing library.

Each wrapper counts the launches of its kernel in a ``LaunchCounter``
(one plain integer), so a run can show that its path went through the
kernel.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import List, Optional

import torch

_KERNELS_DIR = Path(__file__).resolve().parent
BUILD_ROOT = _KERNELS_DIR.parents[2] / "build" / "kernels"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC"]
LIB_NAME = "libreprotorch_kernels.so"

_PTR = ctypes.c_void_p
_I64 = ctypes.c_int64
_I32 = ctypes.c_int
_U32 = ctypes.c_uint32
_F32 = ctypes.c_float
# C entry points: name -> argtypes (every entry returns cudaGetLastError())
SIGNATURES = {
    "ota_client_fold_f32": [_PTR, _PTR, _I64, _PTR, _PTR, _PTR, _PTR, _I64,
                            _I32, _I32, _I32, _I32, _PTR],
    "masked_gradnorm_f32": [_PTR, _PTR, _PTR, _PTR, _PTR, _I64, _I32, _I32,
                            _I32, _PTR],
    "masked_gradnorm_rowblock_f32": [_PTR, _PTR, _PTR, _I64, _I32, _I32,
                                     _PTR],
    "ota_mask_weight_f32": [_PTR, _PTR, _I64, _PTR, _PTR, _PTR, _PTR, _I64,
                            _I32, _I32, _I32, _PTR],
    "ota_aggregate_f32": [_PTR, _I64, _PTR, _I64, _PTR, _PTR, _PTR, _PTR,
                          _I64, _I32, _I32, _I32, _I32, _PTR],
    "ota_aggregate_fused_f32": [_PTR, _I64, _U32, _U32, _U32, _U32, _PTR,
                                _PTR, _PTR, _I64, _I32, _I32, _I32, _PTR],
    "ota_mask_count_f32": [_PTR, _PTR, _I64, _PTR, _PTR, _PTR, _PTR, _I64,
                           _I32, _I32, _I32, _PTR],
    "ota_channel_f32": [_PTR, _PTR, _PTR, _PTR, _PTR, _I64, _I32, _I32,
                        _PTR],
    "threefry_chunked_u32": [_PTR, _I32, _I64, _I64, _I64, _I32, _PTR, _PTR],
    "threefry_flat_u32": [_PTR, _I32, _I64, _I64, _I32, _PTR, _PTR],
    "flash_attention_bf16": [_PTR, _PTR, _PTR, _PTR, _I32, _I32, _I32, _I32,
                             _I32, _I32, _F32, _PTR],
    "flash_attention_f32": [_PTR, _PTR, _PTR, _PTR, _I32, _I32, _I32, _I32,
                            _I32, _I32, _F32, _PTR],
    "flash_attention_bf16_hopper": [_PTR, _PTR, _PTR, _PTR, _I32, _I32, _I32,
                                    _I32, _I32, _I32, _F32, _PTR],
}


class LaunchCounter:
    """Number of launches of one kernel (a wrapper bumps ``count`` right
    after each launch and nowhere else)."""

    def __init__(self, name: str):
        self.name = name
        self.count = 0

    def reset(self) -> None:
        self.count = 0


class _Loaded:
    lib: Optional[ctypes.CDLL] = None
    build_seconds: float = 0.0
    ptxas_log: str = ""


def sources() -> List[Path]:
    return sorted(_KERNELS_DIR.glob("**/csrc/*.cu"))


def headers() -> List[Path]:
    """Device headers the sources include (part of the build's hash)."""
    return sorted(_KERNELS_DIR.glob("**/csrc/*.cuh"))


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on "
                           "PATH): the CUDA kernels cannot be built")
    return found


def _digest(srcs: List[Path]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in srcs:
        h.update(s.name.encode())
        h.update(s.read_bytes())
    return h.hexdigest()[:16]


def build(verbose: bool = False) -> Path:
    """Compile the sources into the shared library (if not built yet) and
    return its path. ``verbose`` adds ``-Xptxas -v`` and keeps its report
    (registers, shared memory, spills per kernel) in ``ptxas_log()``."""
    srcs = sources()
    out_dir = BUILD_ROOT / _digest(srcs + headers())
    lib_path = out_dir / LIB_NAME
    if lib_path.exists():
        return lib_path
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    extra = ["-Xptxas", "-v"] if verbose else []
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        objs, procs = [], []
        for s in srcs:
            obj = Path(tmp) / (s.stem + ".o")
            objs.append(str(obj))
            procs.append((s, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, *extra, "-c", str(s), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        logs, failed = [], []
        for s, proc in procs:
            log, _ = proc.communicate()
            logs.append(f"== {s.name}\n{log}")
            if proc.returncode != 0:
                failed.append(s.name)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(logs))
        tmp_lib = Path(tmp) / LIB_NAME
        link = subprocess.run([nvcc, *ARCH_FLAGS, "-shared", "-o",
                               str(tmp_lib), *objs],
                              capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}"
                               f"{link.stderr}")
        os.replace(tmp_lib, lib_path)
    _Loaded.build_seconds = time.perf_counter() - t0
    _Loaded.ptxas_log = "\n".join(logs)
    return lib_path


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    if _Loaded.lib is None:
        path = build()
        lib = ctypes.CDLL(str(path))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _Loaded.lib = lib
    return _Loaded.lib


def build_seconds() -> float:
    """Wall time of this process's build (0 if the library existed)."""
    return _Loaded.build_seconds


def ptxas_log() -> str:
    return _Loaded.ptxas_log


def check(err: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error at launch."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {err}")


def current_stream_handle(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def sm_count(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count

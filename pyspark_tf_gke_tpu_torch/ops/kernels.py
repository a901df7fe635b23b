"""Build and load the port's hand-written Hopper kernels (``csrc/*.cu``).

The sources are compiled at first use on the machine with the card —
one ``nvcc`` per source, all started together, then one link — into a
single shared library with a plain C interface under
``pyspark_tf_gke_tpu_torch/_build/`` (listed in ``.gitignore``), and
loaded with ``ctypes``. The library name carries a digest of the
sources and flags, so an edited source is rebuilt and a built one is
reused. Pointers and the stream are passed as ``ctypes.c_void_p``; each
C entry point returns ``cudaGetLastError()`` and :func:`check` raises on
anything but 0.

Nothing here runs at import time: the CPU tests import every module of
the package, and there is no ``nvcc`` on machines without CUDA.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import List, Optional

import torch

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"

ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
# -Xptxas=-v: each kernel's registers, shared memory and spills land in
# build_log (chip_smoke prints them)
NVCC_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                           "-Xptxas=-v"]

# dtype codes shared with csrc/common.cuh (enum DType): the kernels are
# built and checked on the card for these only
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float

# argtypes of every C entry point (the ctypes contract with csrc/)
SIGNATURES = {
    "port_layernorm": [_P] * 5 + [_I, _I, _F] + [_I] * 6 + [_P],
    "port_flash_attention_fwd": ([_P] * 7 + [_I] * 4 + [_L] * 9
                                 + [_I, _F, _I, _I, _I, _P]),
    "port_paged_attention": [_P] * 9 + [_I] * 13 + [_F, _I, _I, _I, _P],
    "port_layernorm_bwd": [_P] * 9 + [_I] * 7 + [_F, _I, _I, _P],
    "port_flash_attention_dq": ([_P] * 9 + [_I] * 4 + [_L] * 12
                                + [_I, _F, _I, _I, _I, _P]),
    "port_flash_attention_dkv": ([_P] * 10 + [_I] * 4 + [_L] * 12
                                 + [_I, _F, _I, _I, _I, _P]),
    "port_k4_fwd": [_P] * 7 + [_I] * 8 + [_P],
    "port_k4_dx": [_P] * 8 + [_I] * 7 + [_P],
    "port_k4_dw": [_P] * 6 + [_I] * 10 + [_P],
    "port_k5_fwd": [_P] * 7 + [_I] * 9 + [_P],
    "port_k5_dx": [_P] * 8 + [_I] * 11 + [_P],
    "port_k5_dw": [_P] * 6 + [_I] * 10 + [_P],
}

_lock = threading.Lock()
_library: Optional[ctypes.CDLL] = None
build_seconds: Optional[float] = None  # wall time of this process's build
build_log: str = ""  # the compilers' output of this process's build


def sources() -> List[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC_DIR.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"libport_kernels_{_digest()}.so"


def find_nvcc() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else
    ``/usr/local/cuda/bin/nvcc``, else ``nvcc`` on ``PATH``."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and Path(root, "bin", "nvcc").exists():
            return str(Path(root, "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME); the port's kernels are "
            "built from csrc/ at first use on a CUDA machine")
    return found


def build_commands(nvcc: str = "nvcc", out: Optional[Path] = None,
                   link_to: Optional[Path] = None):
    """``(compile commands, link command)`` that build ``out`` (default
    :func:`library_path`): one object per source, then one shared
    library, written to ``link_to`` when given (default ``out``)."""
    out = out if out is not None else library_path()
    objs, compiles = [], []
    for src in sources():
        obj = out.parent / f"{out.stem}_{src.stem}.o"
        objs.append(str(obj))
        compiles.append([nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)])
    link = [nvcc, *ARCH_FLAGS, "-shared", "-o",
            str(link_to if link_to is not None else out), *objs]
    return compiles, link


def build(out: Optional[Path] = None) -> Path:
    """Compile every source in parallel and link the library."""
    global build_seconds, build_log
    out = out if out is not None else library_path()
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".tmp{os.getpid()}.so")
    compiles, link = build_commands(find_nvcc(), out, link_to=tmp)
    t0 = time.perf_counter()
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in compiles]
    failures, logs = [], []
    for cmd, proc in zip(compiles, procs):
        log, _ = proc.communicate()
        logs.append(f"$ {' '.join(cmd)}\n{log}")
        if proc.returncode != 0:
            failures.append(logs[-1])
    if failures:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failures))
    result = subprocess.run(link, capture_output=True, text=True)
    if result.returncode != 0:
        raise RuntimeError(f"kernel link failed:\n$ {' '.join(link)}\n"
                           f"{result.stdout}{result.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent loader never sees half
    build_seconds = time.perf_counter() - t0
    build_log = "\n".join(logs)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if this source digest has
    no library yet."""
    global _library
    with _lock:
        if _library is None:
            if not torch.cuda.is_available():
                raise RuntimeError("the port's kernels need a CUDA device")
            path = library_path()
            if not path.exists():
                build(path)
            lib = ctypes.CDLL(str(path))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _library = lib
        return _library


def check(rc: int, kernel: str) -> None:
    """Raise when a C entry point reported a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"{kernel} kernel launch failed: CUDA error {rc}")


def launch_args(device: torch.device):
    """The trailing ``(device index, stream)`` arguments of every C
    entry point: PyTorch's current stream on ``device``."""
    return device.index, torch.cuda.current_stream(device).cuda_stream


def dtype_code(dtype: torch.dtype, kernel: str) -> int:
    if dtype not in DTYPE_CODES:
        raise TypeError(f"{kernel} kernel does not take dtype {dtype}")
    return DTYPE_CODES[dtype]


def require_cuda(kernel: str, *tensors: torch.Tensor) -> torch.device:
    """Every tensor on one CUDA device; returns it."""
    device = tensors[0].device
    for t in tensors:
        if t.device != device:
            raise ValueError(f"{kernel}: tensors on {t.device} and {device}")
    if device.type != "cuda":
        raise ValueError(f"{kernel} kernel runs on CUDA tensors, got "
                         f"{device}")
    return device

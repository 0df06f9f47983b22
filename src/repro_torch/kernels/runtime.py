"""Device probe and kernel build for the hand-written Hopper kernels.

Three jobs, counterparts of ``repro.kernels.runtime``:

  * ``resolve_device(device)`` — the one device decision. ``None`` means
    the card (``"cuda"``); a CUDA device must exist and be a Hopper part
    (compute capability 9.x), else it raises. The CPU is used only when
    a caller names it — entry points never drop to it silently.
  * ``library(name)`` — the kernels are CUDA C++ under ``csrc/`` with a
    plain C interface, compiled by ``nvcc`` for ``sm_90a`` into shared
    libraries under ``build/repro_torch/<hash>/`` at the root of the
    checkout the first time a kernel is needed, and loaded with
    ``ctypes``. The hash covers every source and the compiler flags, so
    an edited source rebuilds. All sources build in parallel, one
    ``nvcc`` each. A missing ``nvcc`` or a failed build raises with the
    compiler's output; nothing falls back to the plain versions.
  * ``platform(device)`` — the tuner's platform key: the card's compute
    capability and name, or ``cpu``.
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
from typing import Optional

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-fmad=false")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
_platforms: dict[int, str] = {}


def resolve_device(device=None) -> torch.device:
    """``None`` → the card. A CUDA device must be available and have
    compute capability 9.x (the kernels are built for sm_90a only)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU")
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    major, minor = torch.cuda.get_device_capability(index)
    if major != 9:
        raise RuntimeError(
            f"{torch.cuda.get_device_name(index)} has compute capability "
            f"{major}.{minor}; the kernels are built for Hopper (9.x)")
    return torch.device("cuda", index)


def platform(device=None) -> str:
    """The tuner's platform key for ``device``: a measured launch tile
    is valid only for the card it was measured on, e.g.
    ``cuda:sm_90:NVIDIA H100 80GB HBM3``; ``cpu`` for the CPU, where no
    kernel launches. ``None`` is the current CUDA device when there is
    one, else the CPU."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    dev = torch.device(device)
    if dev.type != "cuda":
        return "cpu"
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    key = _platforms.get(index)
    if key is None:
        major, minor = torch.cuda.get_device_capability(index)
        key = (f"cuda:sm_{major}{minor}:"
               f"{torch.cuda.get_device_name(index)}")
        _platforms[index] = key
    return key


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and Path("/usr/local/cuda/bin/nvcc").exists():
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found on PATH or under "
                           "/usr/local/cuda/bin; the CUDA kernels cannot "
                           "be built")
    return path


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _build_all(out_dir: Path) -> None:
    """Compile every ``csrc/*.cu`` into ``out_dir/lib<stem>.so``, one
    ``nvcc`` process per source, all started together."""
    nvcc = _nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = []
    for src in sorted(CSRC.glob("*.cu")):
        tmp = out_dir / f"lib{src.stem}.so.tmp{os.getpid()}"
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(src)]
        procs.append((src, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for src, tmp, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"--- {src.name} (exit {proc.returncode}) ---\n"
                          f"{out}")
        else:
            os.replace(tmp, out_dir / f"lib{src.stem}.so")
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))


def library(name: str) -> ctypes.CDLL:
    """The loaded shared library built from ``csrc/<name>.cu``."""
    with _lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        out_dir = BUILD_ROOT / _digest()
        path = out_dir / f"lib{name}.so"
        if not path.exists():
            _build_all(out_dir)
        lib = ctypes.CDLL(str(path))
        _libs[name] = lib
        return lib


def build() -> float:
    """Build (or find) and load every kernel library; returns the
    seconds it took (near 0 when the libraries were already built)."""
    # reprolint: disable=RL004 -- host work (nvcc, dlopen), nothing queued
    t0 = time.monotonic()
    for src in sorted(CSRC.glob("*.cu")):
        library(src.stem)
    return time.monotonic() - t0


def stream_ptr(device: torch.device) -> ctypes.c_void_p:
    """PyTorch's current stream on ``device``, as a C pointer."""
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def ptr(t: Optional[torch.Tensor]) -> ctypes.c_void_p:
    return ctypes.c_void_p(0 if t is None else t.data_ptr())

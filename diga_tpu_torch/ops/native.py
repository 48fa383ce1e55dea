"""Build and load the port's CUDA kernels: nvcc -> shared library -> ctypes.

Each source under ``diga_tpu_torch/csrc/`` has a plain C interface and is
compiled for ``sm_90a`` into ``diga_tpu_torch/_build/lib<name>.so`` (a
directory git ignores) at first use, or ahead of time by ``build()``,
which starts one nvcc per source, all together.  Nothing here runs at
import time, so the CPU tests import the kernel modules freely.
"""

from __future__ import annotations

import ctypes
import functools
import os
import shutil
import subprocess

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
SOURCES = {"group_norm": "group_norm.cu", "distill": "distill.cu"}
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# the kernels' element types, as the C entries number them
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_loaded: dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                           "the CUDA kernels are built on the machine with the card")
    return found


def library_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"lib{name}.so")


def build(names=None) -> dict[str, str]:
    """Compile the named sources (default: all), one nvcc each, in parallel.

    Returns each source's compiler output, which holds ``-Xptxas -v``'s
    registers, shared memory and spills per kernel.  Raises on any failure.
    """
    names = list(SOURCES) if names is None else list(names)
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    for name in names:
        tmp = library_path(name) + f".{os.getpid()}.tmp"
        cmd = [nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC_DIR, SOURCES[name])]
        procs[name] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT, text=True))
    logs, failed = {}, []
    for name, (tmp, proc) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(name)
        else:
            os.replace(tmp, library_path(name))
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The named kernel library, built first if missing or older than its source."""
    lib = _loaded.get(name)
    if lib is not None:
        return lib
    path = library_path(name)
    src = os.path.join(CSRC_DIR, SOURCES[name])
    if not os.path.exists(path) or os.path.getmtime(path) < os.path.getmtime(src):
        build([name])
    lib = ctypes.CDLL(path)
    _loaded[name] = lib
    return lib


def on_cpu(x: torch.Tensor) -> bool:
    """True for a CPU tensor (plain version), False for a CUDA one (kernel)."""
    if x.device.type == "cpu":
        return True
    if x.device.type == "cuda":
        return False
    raise ValueError(f"unsupported device {x.device} (the port runs on cuda or cpu)")


@functools.cache
def sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def launch(x: torch.Tensor, fn, *args) -> int:
    """Call the C entry ``fn(*args, stream)`` on x's device and current stream."""
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if x.device.index == torch.cuda.current_device():
        return fn(*args, stream)
    with torch.cuda.device(x.device):
        return fn(*args, stream)

"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` compiles on first use into its own shared library
with a plain C interface, under ``build/kernels/`` at the root of the
checkout (listed in ``.gitignore``). A library's file name carries a hash of
the sources and flags, so an edited source rebuilds and an unchanged one is
loaded as built. ``build_all`` starts one ``nvcc`` per source, all at once.
``nvcc -Xptxas -v`` writes each kernel's registers and shared memory to a
``.log`` beside its library.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("flash_attention", "decode_attention", "rglru_scan",
           "mlstm_chunk", "flash_attention_sm90", "decode_attention_sm90",
           "flash_attention_bwd", "mlstm_chunk_bwd")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# dtype codes of the C interface (csrc/common.cuh)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit to build")
    return path


def library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def build_all(names: tuple = SOURCES) -> List[Path]:
    """Compile every library that is not built yet, concurrently; raise with
    the compiler's output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = [(n, library_path(n)) for n in names
            if not library_path(n).exists()]
    procs = []
    for name, lib in todo:
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((lib, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for lib, tmp, proc in procs:
        log, _ = proc.communicate()
        lib.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"{lib.name}:\n{log}")
            continue
        os.replace(tmp, lib)   # atomic: a concurrent loader sees all or none
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return [library_path(n) for n in names]


def load(name: str) -> ctypes.CDLL:
    """The library built from ``csrc/<name>.cu``, built on first use."""
    if name not in _loaded:
        build_all((name,))
        _loaded[name] = ctypes.CDLL(str(library_path(name)))
    return _loaded[name]


def check_operands(align: int = 16, **tensors) -> None:
    """Raise unless every tensor lies on one CUDA device, is contiguous and
    ``align``-byte aligned (16 for the attention kernels' vector loads), and
    all share one dtype the kernels take. Raise ``RuntimeError`` first if
    autograd would record the call: a raw wrapper never records a graph,
    and its output would silently cut it. Flash attention (B1), the RG-LRU
    scan (B3) and the mLSTM (B4) are differentiated through their autograd
    functions, which call the wrappers with grad mode off; decode attention
    (B2), which no training path differentiates, has none."""
    if torch.is_grad_enabled():
        needs = [name for name, t in tensors.items() if t.requires_grad]
        if needs:
            raise RuntimeError(
                f"{', '.join(needs)} require grad, but a raw kernel wrapper "
                "records no graph: decode attention (B2) has no backward (it "
                "is never differentiated), and the others differentiate "
                "through their ops (FlashAttention, RGLRUScan, MLSTMChunk); "
                "call it under torch.no_grad() or detach the operands")
    first = next(iter(tensors.values()))
    for name, t in tensors.items():
        if t.device.type != "cuda" or t.device != first.device:
            raise ValueError(f"{name} must be on {first.device} (CUDA), "
                             f"not {t.device}")
        if t.dtype != first.dtype:
            raise TypeError(f"{name} is {t.dtype}, expected {first.dtype}")
        if not t.is_contiguous() or t.data_ptr() % align:
            raise ValueError(f"{name} must be contiguous and {align}-byte "
                             "aligned")
    dtype_code(first.dtype)


def raise_on_error(lib: ctypes.CDLL, fn: str, err: int) -> None:
    """Raise if a C entry point returned a CUDA error (a launch the device
    refused never runs, and no later synchronize reports it)."""
    if err:
        lib.kernel_error_string.restype = ctypes.c_char_p
        lib.kernel_error_string.argtypes = [ctypes.c_int]
        msg = lib.kernel_error_string(err).decode()
        raise RuntimeError(f"{fn} failed with CUDA error {err}: {msg}")


def dtype_code(dtype) -> int:
    code = DTYPE_CODES.get(dtype)
    if code is None:
        raise TypeError(f"the CUDA kernels take float32 or bfloat16, "
                        f"not {dtype}")
    return code

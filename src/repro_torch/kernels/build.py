"""Builds the CUDA sources in ``csrc/`` at first use and loads them.

Each ``csrc/<name>.cu`` becomes a shared library with a plain C
interface, compiled by ``nvcc`` for ``sm_90a`` and loaded with
``ctypes`` (no PyTorch headers, so a build takes seconds).  Libraries go
to ``build/repro_torch/`` at the root of the checkout, named after the
hash of their source and flags, so an edited source is rebuilt and an
unchanged one is loaded as it is.  All missing libraries are compiled at
once, one ``nvcc`` process per source.  A failed build raises with
nvcc's output; nothing here falls back.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

from repro_torch.kernels import instrument

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-lineinfo", "-Xptxas", "-v",
              "-shared", "-Xcompiler", "-fPIC")
NVCC_TIMEOUT_S = 600

_LIBS: dict = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found on PATH or in /usr/local/cuda/bin; "
                       "the CUDA kernels are built from source at first use")


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def library_path(src: Path) -> Path:
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{src.stem}_{digest[:16]}.so"


def build_all() -> dict[str, Path]:
    """Compile every source whose library is missing, all ``nvcc``
    processes started together.  Returns {source stem: library path}."""
    nvcc = None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    for src in sources():
        out = library_path(src)
        if out.exists():
            continue
        nvcc = nvcc or nvcc_path()
        tmp = out.with_name(f"{out.name}.tmp{os.getpid()}")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)]
        jobs.append((src, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failures = []
    for src, out, tmp, proc in jobs:
        try:
            log, _ = proc.communicate(timeout=NVCC_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            log, _ = proc.communicate()
            log += f"\nnvcc timed out after {NVCC_TIMEOUT_S} s"
        out.with_suffix(".log").write_text(log)
        if proc.returncode == 0:
            os.replace(tmp, out)
        else:
            tmp.unlink(missing_ok=True)
            failures.append(f"--- {src.name} (nvcc exit {proc.returncode})"
                            f"\n{log}")
    if failures:
        raise RuntimeError("building the CUDA kernels failed:\n"
                           + "\n".join(failures))
    return {src.stem: library_path(src) for src in sources()}


def build_log(stem: str) -> str:
    """nvcc's output (``-Xptxas -v``: registers, shared memory, spills)
    from the build of ``csrc/<stem>.cu``, or '' if it was not built here."""
    log = library_path(CSRC / f"{stem}.cu").with_suffix(".log")
    return log.read_text() if log.exists() else ""


def library(stem: str, signatures: dict) -> ctypes.CDLL:
    """The loaded library of ``csrc/<stem>.cu``, built if missing, with
    ``argtypes`` from ``signatures`` ({function: [ctypes types]}) and an
    ``int`` (cudaError_t) result for every function, plus its
    ``<stem>_error_string(int) -> char*``."""
    if stem not in _LIBS:
        lib = ctypes.CDLL(str(build_all()[stem]))
        for name, argtypes in signatures.items():
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        err_fn = getattr(lib, f"{stem}_error_string")
        err_fn.argtypes = [ctypes.c_int]
        err_fn.restype = ctypes.c_char_p
        _LIBS[stem] = lib
    return _LIBS[stem]


def launch(stem: str, signatures: dict, fn: str, device, *args) -> None:
    """Call launcher ``fn`` of ``csrc/<stem>.cu`` with ``args`` and the
    current stream of CUDA ``device``; raise if it returns a CUDA error
    (a refused launch never runs, and no synchronize would report it).
    Counted by ``instrument.count_launch`` while a capture is open."""
    import torch

    instrument.count_launch()
    lib = library(stem, signatures)
    if device.index in (None, torch.cuda.current_device()):
        err = getattr(lib, fn)(*args, torch.cuda.current_stream().cuda_stream)
    else:
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            err = getattr(lib, fn)(*args, stream)
    if err != 0:
        msg = getattr(lib, f"{stem}_error_string")(err).decode()
        raise RuntimeError(f"{fn}: CUDA error {err} ({msg})")

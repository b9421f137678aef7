"""Build and load the port's CUDA kernels.

Every ``kernels/*/csrc/*.cu`` is compiled with ``nvcc`` for ``sm_90a`` into
a shared library with a plain C interface and loaded with ``ctypes`` — no
PyTorch headers, so a build takes seconds, not minutes. Builds happen on
first CUDA use, one ``nvcc`` per source and all of them at once, into
``kernels/build`` inside the package (ignored by git). A library's name
carries a hash of its source and flags, so an edited source is rebuilt and
a stale one is never loaded. The hash also covers the headers
(``*.cuh``) beside a source, which the decode kernels share.

Each C entry point takes its pointers and the stream as ``void*`` and
returns ``cudaGetLastError()`` after its launch; ``check`` raises when
that is not 0 (a refused launch never runs, and a later synchronize would
not report it).

Nothing links ``-lcuda``: the flash kernel's TMA tensor maps are encoded
by ``cuTensorMapEncodeTiled`` of the CUDA driver API, which the source
reaches at run time through the runtime's ``cudaGetDriverEntryPoint``
(it includes ``cuda.h`` for the types only).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List

_KERNELS_DIR = Path(__file__).resolve().parent
BUILD_DIR = _KERNELS_DIR / "build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-shared", "-Xcompiler",
                           "-fPIC", "-Xptxas", "-v"]

_libs: Dict[str, ctypes.CDLL] = {}
build_logs: Dict[str, str] = {}         # name -> nvcc output (ptxas lines)


def sources() -> Dict[str, Path]:
    """Kernel name (the source's stem) -> path, for every package source."""
    return {p.stem: p for p in sorted(_KERNELS_DIR.glob("*/csrc/*.cu"))}


def nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to "
                           "build the port's kernels")
    return path


def library_path(src: Path) -> Path:
    h = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    for header in sorted(src.parent.glob("*.cuh")):
        h.update(header.read_bytes())
    digest = h.hexdigest()[:16]
    return BUILD_DIR / f"{src.stem}-{digest}.so"


def nvcc_command(src: Path, out: Path) -> List[str]:
    return [nvcc(), *NVCC_FLAGS, "-o", str(out), str(src)]


def build_all() -> Dict[str, Path]:
    """Build every source whose library is missing, all ``nvcc``s running
    at once. Returns name -> library path; raises on a failed build."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out: Dict[str, Path] = {}
    procs = {}
    for name, src in sources().items():
        lib = library_path(src)
        out[name] = lib
        if lib.exists():
            continue
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (subprocess.Popen(
            nvcc_command(src, tmp), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), tmp, lib)
    failed = []
    for name, (proc, tmp, lib) in procs.items():
        log, _ = proc.communicate()
        build_logs[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            continue
        os.replace(tmp, lib)            # atomic: concurrent builds agree
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return out


def load(name: str) -> ctypes.CDLL:
    """The named kernel library, built on first use."""
    lib = _libs.get(name)
    if lib is None:
        path = library_path(sources()[name])
        if not path.exists():
            build_all()
        lib = _libs[name] = ctypes.CDLL(str(path))
    return lib


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")

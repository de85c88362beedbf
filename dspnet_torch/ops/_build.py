"""Compiles kernel sources (``csrc/*.cu``) with nvcc, one library each, and
holds the card's limits that the wrappers' launch plans use.

A source ``<name>.cu`` is compiled for sm_90a into a shared library with a
plain C interface, ``build/libdspnet_<name>_<hash>.so`` at the repository
root, where the hash covers the source and the flags, so an edited source
builds anew and an unchanged one is reused. The compiler's resource report
(``-Xptxas -v``: registers, shared memory, spills per kernel) lands beside
the library as ``.log``. Wrappers load a library with ``load_library`` and
bind its functions with ctypes; every library exports
``dspnet_cuda_error_string`` for the error codes its entry points return.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Iterable, List

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

#: shared memory one block may use on Hopper (227 KB, dynamic and static)
MAX_SHARED_BYTES = 232448
#: streaming multiprocessors of an H100 SXM
H100_SMS = 132


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(cuda_home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the kernels need the CUDA toolkit to build")
    return found


def library_path(source: Path) -> Path:
    """Where the kernel source ``source`` builds to, for its current content."""
    digest = hashlib.sha256(source.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libdspnet_{source.stem}_{digest}.so"


def build_libraries(sources: Iterable[Path]) -> List[Path]:
    """Compile every source that has no library yet, one nvcc process each,
    all started together; return the libraries' paths in order."""
    sources = list(sources)
    libs = [library_path(s) for s in sources]
    jobs = []
    for source, lib in zip(sources, libs):
        if lib.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)],
                                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs.append((source, lib, tmp, proc))
    failed = []
    for source, lib, tmp, proc in jobs:
        out, _ = proc.communicate()
        lib.with_suffix(".log").write_text(out)
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {source}:\n{out}")
        else:
            os.replace(tmp, lib)
    if failed:
        raise RuntimeError("\n".join(failed))
    return libs


@functools.cache
def load_library(source: Path) -> ctypes.CDLL:
    """Build the kernel source ``source`` at first use and load it."""
    lib = ctypes.CDLL(str(build_libraries([source])[0]))
    lib.dspnet_cuda_error_string.argtypes = [ctypes.c_int]
    lib.dspnet_cuda_error_string.restype = ctypes.c_char_p
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise when an entry point returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what} failed: {lib.dspnet_cuda_error_string(err).decode()}")

"""Compiles every kernel source under ``csrc/`` with nvcc, one library each.

``csrc/<name>.cu`` is compiled for sm_90a into a shared library with a plain
C interface, ``build/libdspnet_<name>_<hash>.so`` at the repository root,
where the hash covers the source and the flags, so an edited source builds
anew and an unchanged one is reused. The compiler's resource report
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


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(cuda_home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the kernels need the CUDA toolkit to build")
    return found


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to, for its current content."""
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libdspnet_{name}_{digest}.so"


def build_libraries(names: Iterable[str]) -> List[Path]:
    """Compile every named source that has no library yet, one nvcc process
    each, all started together; return the libraries' paths in order."""
    names = list(names)
    libs = [library_path(n) for n in names]
    jobs = []
    for name, lib in zip(names, libs):
        if lib.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
                                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs.append((name, lib, tmp, proc))
    failed = []
    for name, lib, tmp, proc in jobs:
        out, _ = proc.communicate()
        lib.with_suffix(".log").write_text(out)
        if proc.returncode != 0:
            failed.append(f"nvcc failed on csrc/{name}.cu:\n{out}")
        else:
            os.replace(tmp, lib)
    if failed:
        raise RuntimeError("\n".join(failed))
    return libs


@functools.cache
def load_library(name: str) -> ctypes.CDLL:
    """Build ``csrc/<name>.cu`` at first use and load it."""
    lib = ctypes.CDLL(str(build_libraries([name])[0]))
    lib.dspnet_cuda_error_string.argtypes = [ctypes.c_int]
    lib.dspnet_cuda_error_string.restype = ctypes.c_char_p
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise when an entry point returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what} failed: {lib.dspnet_cuda_error_string(err).decode()}")

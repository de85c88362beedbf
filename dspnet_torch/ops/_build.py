"""Compiles kernel sources (``csrc/*.cu``) with nvcc, one library each, and
holds the card's limits that the wrappers' launch plans use.

A source ``<name>.cu`` is compiled for sm_90a into a shared library with a
plain C interface, ``build/libdspnet_<name>_<hash>.so`` at the repository
root, where the hash covers the source, the flags and the toolkit libraries
it links (``LINK_LIBS``: ``jpeg.cu`` links libnvjpeg), so an edited source
builds anew and an unchanged one is reused. A linked library's header and
shared object must be in the toolkit (``$CUDA_HOME``, else
``/usr/local/cuda``); a missing one raises, naming the path looked in. The compiler's resource report
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

#: toolkit libraries a source links, by the source's stem
LINK_LIBS = {"jpeg": ("nvjpeg",)}

#: shared memory one block may use on Hopper (227 KB, dynamic and static)
MAX_SHARED_BYTES = 232448
#: streaming multiprocessors of an H100 SXM
H100_SMS = 132


def _cuda_home() -> Path:
    return Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))


def _nvcc() -> str:
    path = _cuda_home() / "bin" / "nvcc"
    if path.exists():
        return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the kernels need the CUDA toolkit to build")
    return found


def link_flags(source: Path) -> List[str]:
    """The linker flags of ``source``: each of its toolkit libraries, with
    the toolkit's library directory as the run path. Raises when a library's
    header or shared object is missing from the toolkit."""
    libs = LINK_LIBS.get(source.stem, ())
    if not libs:
        return []
    home = _cuda_home()
    for lib in libs:
        for path in (home / "include" / f"{lib}.h", home / "lib64" / f"lib{lib}.so"):
            if not path.exists():
                raise RuntimeError(f"{source.name} links lib{lib}, but {path} does not exist "
                                   "(set CUDA_HOME to the CUDA toolkit that holds it)")
    return ([f"-L{home / 'lib64'}", f"-Xlinker=-rpath={home / 'lib64'}"]
            + [f"-l{lib}" for lib in libs])


def library_path(source: Path) -> Path:
    """Where the kernel source ``source`` builds to, for its current content,
    flags and linked libraries."""
    flags = " ".join(NVCC_FLAGS + [f"-l{lib}" for lib in LINK_LIBS.get(source.stem, ())])
    digest = hashlib.sha256(source.read_bytes() + flags.encode()).hexdigest()[:16]
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
        proc = subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source), *link_flags(source)],
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

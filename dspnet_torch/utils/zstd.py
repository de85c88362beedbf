"""Zstandard decompression through the system's ``libzstd.so.1`` (ctypes).

The JAX package's checkpoints (Orbax over tensorstore's OCDBT store) frame
every b-tree node, every manifest and every zarr chunk with zstd; the
card's machine has no Python zstd module, so the port binds the C library
that the system ships. There is no Python decoder to fall back to: where
the library cannot be loaded, :func:`library` raises and names the paths it
tried.

:func:`decompress` takes one frame or several concatenated ones. A single
frame that states its content size is decoded with one ``ZSTD_decompress``
into a buffer of that size; anything else (no content size, several
frames) goes through a ``ZSTD_DCtx`` streaming loop.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import functools
from typing import List

#: where :func:`library` looks, in order, after the loader's own search
_CANDIDATES = ("libzstd.so.1", "/lib/x86_64-linux-gnu/libzstd.so.1", "/usr/lib/x86_64-linux-gnu/libzstd.so.1",
               "/usr/lib64/libzstd.so.1", "/usr/local/lib/libzstd.so.1", "/usr/lib/libzstd.so.1")

_CONTENTSIZE_UNKNOWN = (1 << 64) - 1
_CONTENTSIZE_ERROR = (1 << 64) - 2
_MAGIC = b"\x28\xb5\x2f\xfd"


class ZstdError(ValueError):
    """libzstd refused the input (a corrupt or truncated frame)."""


class _Buffer(ctypes.Structure):  # ZSTD_inBuffer / ZSTD_outBuffer: {ptr, size, pos}
    _fields_ = [("ptr", ctypes.c_void_p), ("size", ctypes.c_size_t), ("pos", ctypes.c_size_t)]


def _candidates() -> List[str]:
    found = ctypes.util.find_library("zstd")
    return list(_CANDIDATES) + ([found] if found and found not in _CANDIDATES else [])


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The bound ``libzstd``; raises ``OSError`` naming every path tried."""
    errors = []
    for name in _candidates():
        try:
            lib = ctypes.CDLL(name)
        except OSError as e:
            errors.append(f"{name}: {e}")
            continue
        sz, vp, cvp = ctypes.c_size_t, ctypes.c_void_p, ctypes.c_void_p
        for fn, res, args in (("ZSTD_getFrameContentSize", ctypes.c_ulonglong, [cvp, sz]),
                              ("ZSTD_findFrameCompressedSize", sz, [cvp, sz]),
                              ("ZSTD_decompress", sz, [vp, sz, cvp, sz]),
                              ("ZSTD_isError", ctypes.c_uint, [sz]),
                              ("ZSTD_getErrorName", ctypes.c_char_p, [sz]),
                              ("ZSTD_createDCtx", vp, []),
                              ("ZSTD_freeDCtx", sz, [vp]),
                              ("ZSTD_DStreamOutSize", sz, []),
                              ("ZSTD_decompressStream", sz, [vp, ctypes.POINTER(_Buffer), ctypes.POINTER(_Buffer)]),
                              ("ZSTD_versionString", ctypes.c_char_p, [])):
            f = getattr(lib, fn)
            f.restype, f.argtypes = res, args
        return lib
    raise OSError("libzstd.so.1 (the zstd library, needed to read the JAX package's Orbax checkpoints) "
                  "could not be loaded; tried " + "; ".join(errors))


def version() -> str:
    return library().ZSTD_versionString().decode()


def _check(lib, code: int, what: str) -> int:
    if lib.ZSTD_isError(code):
        raise ZstdError(f"zstd {what}: {lib.ZSTD_getErrorName(code).decode()}")
    return code


def decompress(data: bytes) -> bytes:
    """The content of one zstd frame or of several concatenated frames."""
    lib = library()
    data = bytes(data)
    if not data.startswith(_MAGIC):
        raise ZstdError(f"zstd: no frame magic at the start ({data[:4].hex()})")
    size = lib.ZSTD_getFrameContentSize(data, len(data))
    if size == _CONTENTSIZE_ERROR:
        raise ZstdError("zstd: the frame header is corrupt")
    frame = lib.ZSTD_findFrameCompressedSize(data, len(data))
    if size != _CONTENTSIZE_UNKNOWN and not lib.ZSTD_isError(frame) and frame == len(data):
        out = ctypes.create_string_buffer(max(size, 1))
        n = _check(lib, lib.ZSTD_decompress(out, size, data, len(data)), "decompress")
        if n != size:
            raise ZstdError(f"zstd: the frame states {size} bytes and holds {n}")
        return out.raw[:n]
    return _stream(lib, data)


def _stream(lib, data: bytes) -> bytes:
    """Every frame in ``data`` through one ``ZSTD_DCtx``."""
    dctx = lib.ZSTD_createDCtx()
    if not dctx:
        raise MemoryError("ZSTD_createDCtx failed")
    try:
        src = ctypes.create_string_buffer(data, len(data))
        chunk = lib.ZSTD_DStreamOutSize()
        out = ctypes.create_string_buffer(chunk)
        inb = _Buffer(ctypes.cast(src, ctypes.c_void_p), len(data), 0)
        parts = []
        while True:
            outb = _Buffer(ctypes.cast(out, ctypes.c_void_p), chunk, 0)
            # 0: a frame ended and is flushed; else more input or output room is due
            left = _check(lib, lib.ZSTD_decompressStream(dctx, ctypes.byref(outb), ctypes.byref(inb)),
                          "stream")
            parts.append(out.raw[:outb.pos])
            if inb.pos == inb.size:
                if left == 0:
                    return b"".join(parts)
                if outb.pos < chunk:  # nothing left to flush: the input ended inside a frame
                    raise ZstdError(f"zstd: the input ends inside a frame ({len(data)} bytes read)")
    finally:
        lib.ZSTD_freeDCtx(dctx)

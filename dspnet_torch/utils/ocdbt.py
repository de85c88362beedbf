"""A read-only OCDBT key-value store over a directory (tensorstore's
"optionally-cooperative distributed b-tree", the store under every Orbax
checkpoint the JAX package writes).

Layout, as tensorstore writes it (``use_ocdbt`` checkpoints):

* ``manifest.ocdbt``: the store's configuration, a table of data files and
  the latest versions of the tree (older ones behind version-tree nodes);
  each version names its b-tree root by (data file, offset, length);
* data files ``d/<hex>`` (or under ``ocdbt.process_N/`` for the stores each
  process of a multi-process save writes): b-tree nodes and out-of-line
  values, back to back.

The manifest and every node are framed the same way: a 4-byte big-endian
magic (``0x0cdb3a2a`` manifest, ``0x0cdb20de`` b-tree node, ``0x0cdb1234``
version-tree node), the frame's length as 8 bytes little-endian, a varint
format version (0), a varint compression (0 none, 1 zstd), the body, and
the CRC-32C of everything before it, 4 bytes little-endian. Integers in a
body are LEB128 varints unless said otherwise, and arrays are stored column
by column:

* data-file table: count; for files 1.. the length of the path prefix
  shared with the previous file; each path's remaining length; each path's
  base-path length; the remaining bytes. A file's path is its base path
  (prefixed by the base path of the file that holds the table) and its
  relative path;
* b-tree node: height (1 byte), a data-file table, the entry count, the
  keys (prefix lengths shared with the previous key from the second on,
  suffix lengths, suffix bytes); a leaf then has value lengths, a kind per
  value (1 byte: 0 inline, 1 out of line), the out-of-line values' files
  and offsets, and the inline values back to back; an interior node has,
  between the key lengths and the key bytes, the length of the prefix its
  child's keys share, then its children's files, offsets, lengths and
  statistics (keys, tree bytes, out-of-line bytes). A child's keys are
  stored without the prefix its parent gives them.

:class:`OcdbtStore` reads the latest version. Every frame's magic, length,
version and checksum is checked, and a value that runs past the end of its
file is refused, each naming the file (and the key); so is a data file
whose path leaves the store's directory.
"""

from __future__ import annotations

import os
import struct
from typing import Dict, List, NamedTuple, Tuple

from dspnet_torch.utils import zstd

MANIFEST_MAGIC = 0x0CDB3A2A
BTREE_MAGIC = 0x0CDB20DE


class OcdbtError(ValueError):
    """The store's files are not what the format says: a bad magic,
    length or checksum, a truncated file, an unknown field value."""


def _crc32c_table() -> List[int]:
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table.append(c)
    return table


_CRC_TABLE = _crc32c_table()


def crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli), as the frames' trailers hold it."""
    c, t = 0xFFFFFFFF, _CRC_TABLE
    for b in data:
        c = t[(c ^ b) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


class _Reader:
    def __init__(self, data: bytes, where: str):
        self.data, self.pos, self.where = data, 0, where

    def _need(self, n: int):
        if self.pos + n > len(self.data):
            raise OcdbtError(f"{self.where}: the body ends early ({len(self.data)} bytes)")

    def byte(self) -> int:
        self._need(1)
        self.pos += 1
        return self.data[self.pos - 1]

    def varint(self) -> int:
        value = shift = 0
        while True:
            b = self.byte()
            value |= (b & 0x7F) << shift
            if b < 0x80:
                return value
            shift += 7
            if shift > 63:
                raise OcdbtError(f"{self.where}: a varint longer than 64 bits")

    def varints(self, n: int) -> List[int]:
        return [self.varint() for _ in range(n)]

    def take(self, n: int) -> bytes:
        self._need(n)
        self.pos += n
        return self.data[self.pos - n:self.pos]

    def u64(self) -> int:
        return struct.unpack("<Q", self.take(8))[0]

    def end(self):
        if self.pos != len(self.data):
            raise OcdbtError(f"{self.where}: {len(self.data) - self.pos} bytes left after the body")


def unframe(frame: bytes, magic: int, where: str) -> bytes:
    """The body of one frame, its magic, length, version and checksum
    checked."""
    if len(frame) < 18:
        raise OcdbtError(f"{where}: {len(frame)} bytes is too short for a frame (truncated?)")
    got_magic, length = struct.unpack(">I", frame[:4])[0], struct.unpack("<Q", frame[4:12])[0]
    if got_magic != magic:
        raise OcdbtError(f"{where}: magic {got_magic:#010x}, expected {magic:#010x}")
    if length != len(frame):
        raise OcdbtError(f"{where}: the frame states {length} bytes and {len(frame)} were read (truncated?)")
    crc = struct.unpack("<I", frame[-4:])[0]
    if crc32c(frame[:-4]) != crc:
        raise OcdbtError(f"{where}: CRC-32C mismatch")
    r = _Reader(frame[12:-4], where)
    version, compression = r.varint(), r.varint()
    if version != 0:
        raise OcdbtError(f"{where}: format version {version}, only 0 is known")
    if compression == 0:
        return r.data[r.pos:]
    if compression == 1:
        try:
            return zstd.decompress(r.data[r.pos:])
        except zstd.ZstdError as e:
            raise OcdbtError(f"{where}: {e}") from e
    raise OcdbtError(f"{where}: compression {compression}, only 0 (none) and 1 (zstd) are known")


def _prefixed(r: _Reader, n: int, extra: int = 0) -> Tuple[List[bytes], List[List[int]]]:
    """``n`` prefix-compressed strings (shared-prefix lengths from the
    second on, suffix lengths, then ``extra`` more varint columns read
    before the suffix bytes); returns the strings and the extra columns."""
    shared = [0] + r.varints(n - 1) if n else []
    suffix = r.varints(n)
    columns = [r.varints(n) for _ in range(extra)]
    out, prev = [], b""
    for i in range(n):
        if shared[i] > len(prev):
            raise OcdbtError(f"{r.where}: a key shares {shared[i]} bytes with one of {len(prev)}")
        prev = prev[:shared[i]] + r.take(suffix[i])
        out.append(prev)
    return out, columns


def _data_files(r: _Reader, base: str) -> List[Tuple[str, str]]:
    """A data-file table: (base path, relative path) per file, each base
    path prefixed by ``base``, the base path of the file holding the
    table."""
    paths, (base_len,) = _prefixed(r, r.varint(), extra=1)
    out = []
    for p, n in zip(paths, base_len):
        if n > len(p):
            raise OcdbtError(f"{r.where}: a base path of {n} bytes in a path of {len(p)}")
        full = base + p.decode()
        if full.startswith("/") or ".." in full.split("/"):  # the store reads its own directory only
            raise OcdbtError(f"{r.where}: data file {full!r} lies outside the store")
        out.append((base + p[:n].decode(), p[n:].decode()))
    return out


class _Ref(NamedTuple):
    base: str  # the base path of the file, which the nodes in it extend
    path: str  # the file, relative to the store's directory
    offset: int
    length: int


def _refs(r: _Reader, files, ids: List[int], offsets: List[int], lengths: List[int]) -> List[_Ref]:
    out = []
    for i, off, n in zip(ids, offsets, lengths):
        if i >= len(files):
            raise OcdbtError(f"{r.where}: data file {i} of a table of {len(files)}")
        out.append(_Ref(files[i][0], files[i][0] + files[i][1], off, n))
    return out


class Version(NamedTuple):
    generation: int
    root_height: int
    root: _Ref  # None for an empty tree
    num_keys: int
    commit_time_ns: int


class OcdbtStore:
    """The latest version of the OCDBT store in ``root`` (the directory
    holding ``manifest.ocdbt``). ``list()`` gives the keys in order;
    ``read(key)`` a value's bytes."""

    def __init__(self, root: str):
        self.root = os.path.abspath(root)
        self._index = None  # key -> bytes (inline) or _Ref (out of line)
        where = os.path.join(self.root, "manifest.ocdbt")
        try:
            with open(where, "rb") as f:
                frame = f.read()
        except FileNotFoundError:
            raise FileNotFoundError(f"no OCDBT store in {self.root}: {where} is missing") from None
        r = _Reader(unframe(frame, MANIFEST_MAGIC, where), where)
        # the configuration: uuid, manifest kind, the inline and node size
        # limits, the version tree's arity, the compression (and zstd level)
        r.take(16)
        kind, _inline_max, _node_max, _arity = r.varint(), r.varint(), r.varint(), r.byte()
        compression = r.varint()
        if compression == 1:
            r.take(4)  # the zstd level, a 32-bit integer; reading needs none
        elif compression != 0:
            raise OcdbtError(f"{where}: compression method {compression}")
        if kind != 0:
            raise OcdbtError(f"{where}: manifest kind {kind} (numbered manifests); the JAX package's "
                             "checkpoints have a single manifest (kind 0), the only kind read here")
        files = _data_files(r, "")
        n = r.varint()
        gens, heights = r.varints(n), [r.byte() for _ in range(n)]
        ids, offsets, lengths = r.varints(n), r.varints(n), r.varints(n)
        num_keys, _tree_bytes, _indirect_bytes = r.varints(n), r.varints(n), r.varints(n)
        times = [r.u64() for _ in range(n)]
        self.versions = []
        for i in range(n):  # an empty tree's root points nowhere
            root = _refs(r, files, ids[i:i + 1], offsets[i:i + 1], lengths[i:i + 1])[0] if num_keys[i] else None
            self.versions.append(Version(gens[i], heights[i], root, num_keys[i], times[i]))
        # the version-tree nodes that hold the older versions, column by
        # column (latest generation, file, offset, length, generation count,
        # commit time, height): checked, not followed
        m = r.varint()
        r.varints(m)
        _refs(r, files, r.varints(m), r.varints(m), r.varints(m))
        r.varints(m)
        for _ in range(m):
            r.u64()
        for _ in range(m):
            r.byte()
        r.end()
        if any(a.generation >= b.generation for a, b in zip(self.versions, self.versions[1:])):
            raise OcdbtError(f"{where}: versions out of order")

    def _read_file(self, ref: _Ref, what: str) -> bytes:
        path = os.path.join(self.root, ref.path)
        with open(path, "rb") as f:
            f.seek(ref.offset)
            data = f.read(ref.length)
        if len(data) != ref.length:
            raise OcdbtError(f"{path}: {what} at bytes {ref.offset}..{ref.offset + ref.length} runs past "
                             f"the end of the file ({ref.offset + len(data)} bytes; truncated?)")
        return data

    def _walk(self, ref: _Ref, height: int, prefix: bytes, index: Dict[bytes, object]):
        where = f"{os.path.join(self.root, ref.path)} @ {ref.offset}"
        r = _Reader(unframe(self._read_file(ref, "a b-tree node"), BTREE_MAGIC, where), where)
        got = r.byte()
        if got != height:
            raise OcdbtError(f"{where}: a node of height {got} where {height} was expected")
        files = _data_files(r, ref.base)
        n = r.varint()
        if height:
            keys, (common,) = _prefixed(r, n, extra=1)
            children = _refs(r, files, r.varints(n), r.varints(n), r.varints(n))
            for _ in range(3):  # keys, tree bytes, out-of-line bytes under each child
                r.varints(n)
            r.end()
            for key, c, child in zip(keys, common, children):
                if c > len(key):
                    raise OcdbtError(f"{where}: a child's common prefix of {c} bytes on a key of {len(key)}")
                self._walk(child, height - 1, prefix + key[:c], index)
            return
        keys, _ = _prefixed(r, n)
        lengths = r.varints(n)
        kinds = [r.byte() for _ in range(n)]
        if any(k > 1 for k in kinds):
            raise OcdbtError(f"{where}: value kind {max(kinds)}, only 0 (inline) and 1 (out of line) are known")
        out = [i for i, k in enumerate(kinds) if k]
        ids, offsets = r.varints(len(out)), r.varints(len(out))
        for i, ref_i in zip(out, _refs(r, files, ids, offsets, [lengths[i] for i in out])):
            index[prefix + keys[i]] = ref_i
        for i, k in enumerate(kinds):
            if not k:
                index[prefix + keys[i]] = r.take(lengths[i])
        r.end()

    def _entries(self) -> Dict[bytes, object]:
        if self._index is None:
            index: Dict[bytes, object] = {}
            latest = self.versions[-1] if self.versions else None
            if latest is not None and latest.root is not None:
                self._walk(latest.root, latest.root_height, b"", index)
            self._index = dict(sorted(index.items()))
        return self._index

    def list(self) -> List[str]:
        """Every key of the latest version, in order."""
        return [k.decode() for k in self._entries()]

    def __contains__(self, key: str) -> bool:
        return key.encode() in self._entries()

    def read(self, key: str) -> bytes:
        """The value of ``key``; ``KeyError`` when the store has none."""
        try:
            value = self._entries()[key.encode()]
        except KeyError:
            raise KeyError(f"{key!r} is not in the OCDBT store {self.root}") from None
        if isinstance(value, _Ref):
            return self._read_file(value, f"the value of {key!r}")
        return value

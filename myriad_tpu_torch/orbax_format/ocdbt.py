"""A read-only reader of OCDBT, the key-value database Orbax writes by default.

An OCDBT directory holds ``manifest.ocdbt`` and data files under ``d/``
(Orbax adds one database a process, ``ocdbt.process_0/``, which the root's
B-tree refers into).  Every manifest and node is one encoded structure::

    magic (uint32 big-endian) | length (uint64 LE, the whole structure)
    | version (varint, 0) | compression (varint: 0 none, 1 zstd)
    | body (compressed as the field says) | crc32c (uint32 LE, of all before it)

The manifest's body is the config (uuid, manifest kind, inline-value limit,
node-size limit, version-tree arity, compression), a data-file table and the
inline list of versions, each with its B-tree root (data file, offset,
length, height).  A B-tree node's body is its height, a data-file table, then
its entries column by column: key prefix lengths shared with the previous
key, suffix lengths, (interior nodes) the common prefix each subtree strips
from its keys, the key bytes, then either each child's address and counts or
each value's length, kind (0 inline, 1 indirect), the indirect values'
(data file, offset) and the inline bytes.  Data-file paths are relative to
the database directory.  Only the newest version is read.  Anything else
raises ``OcdbtError`` naming the field.
"""

from __future__ import annotations

import os
import struct
from typing import BinaryIO, Dict, List, Optional, Tuple, Union

import numpy as np

from myriad_tpu_torch.orbax_format import zstd

MANIFEST_MAGIC = 0x0CDB3A2A
BTREE_MAGIC = 0x0CDB20DE
_MISSING = (1 << 64) - 1  # the offset of an empty tree's root address
_COMPRESSION = {0: "none", 1: "zstd"}


class OcdbtError(ValueError):
    """An OCDBT structure the reader does not take, or a damaged one."""


class _Cursor:
    """Reads the fields of one decoded body, front to back."""

    def __init__(self, data: bytes, what: str):
        self.data, self.pos, self.what = data, 0, what

    def _need(self, n: int, field: str) -> None:
        if self.pos + n > len(self.data):
            raise OcdbtError(f"{self.what}: {field} runs past the end")

    def varint(self, field: str) -> int:
        value = shift = 0
        for _ in range(10):
            self._need(1, field)
            b = self.data[self.pos]
            self.pos += 1
            value |= (b & 0x7F) << shift
            if not b & 0x80:
                if value >= 1 << 64:
                    raise OcdbtError(f"{self.what}: {field} above 64 bits")
                return value
            shift += 7
        raise OcdbtError(f"{self.what}: {field} is a varint of more than 10 bytes")

    def varints(self, n: int, field: str) -> List[int]:
        return [self.varint(field) for _ in range(n)]

    def take(self, n: int, field: str) -> bytes:
        self._need(n, field)
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def byte(self, field: str) -> int:
        return self.take(1, field)[0]

    def done(self) -> None:
        if self.pos != len(self.data):
            raise OcdbtError(f"{self.what}: {len(self.data) - self.pos} bytes after its last field")


def decode_structure(blob: bytes, magic: int, what: str, limit: int = 1 << 31) -> bytes:
    """The body of one encoded structure, its header and crc32c checked."""
    if len(blob) < 4 + 8 + 1 + 1 + 4:
        raise OcdbtError(f"{what}: {len(blob)} bytes is shorter than its header and footer")
    got_magic = struct.unpack(">I", blob[:4])[0]
    if got_magic != magic:
        raise OcdbtError(f"{what}: magic {got_magic:#010x}, expected {magic:#010x}")
    length = struct.unpack("<Q", blob[4:12])[0]
    if length != len(blob):
        raise OcdbtError(f"{what}: length field {length} for a structure of {len(blob)} bytes")
    want = struct.unpack("<I", blob[-4:])[0]
    got = zstd.crc32c(np.frombuffer(blob, dtype=np.uint8, count=len(blob) - 4))
    if got != want:
        raise OcdbtError(f"{what}: crc32c {got:#010x} where the footer says {want:#010x}")
    head = _Cursor(blob[12:-4], what)
    version = head.varint("version")
    if version != 0:
        raise OcdbtError(f"{what}: version {version} (the reader takes 0)")
    compression = head.varint("compression_format")
    body = head.data[head.pos:]
    if compression == 0:
        return bytes(body)
    if compression == 1:
        out = zstd.decompress(body)
        if out.size > limit:
            raise OcdbtError(f"{what}: {out.size} decoded bytes above max_decoded_node_bytes")
        return out.tobytes()
    raise OcdbtError(f"{what}: compression_format {compression} (the reader takes 0 and 1)")


def _data_file_table(cur: _Cursor) -> List[str]:
    n = cur.varint("data_file_table.num_files")
    prefix = cur.varints(max(n - 1, 0), "data_file_table.path_prefix_length")
    suffix = cur.varints(n, "data_file_table.path_suffix_length")
    base = cur.varints(n, "data_file_table.base_path_length")
    paths: List[str] = []
    for i in range(n):
        keep = prefix[i - 1] if i else 0
        if paths and keep > len(paths[-1]):
            raise OcdbtError(f"{cur.what}: data file {i} shares more than its predecessor's path")
        head = paths[-1][:keep] if paths else ""
        path = head + cur.take(suffix[i], "data_file_table.path").decode()
        if base[i] > len(path):
            raise OcdbtError(f"{cur.what}: data file {i}'s base path is longer than its path")
        parts = path.split("/")
        if path.startswith("/") or ".." in parts:
            raise OcdbtError(f"{cur.what}: data file path {path!r} leaves the database")
        paths.append(path)
    return paths


def _keys(cur: _Cursor, n: int, interior: bool) -> Tuple[List[bytes], List[int]]:
    prefix = cur.varints(max(n - 1, 0), "key_prefix_length")
    suffix = cur.varints(n, "key_suffix_length")
    common = cur.varints(n, "subtree_common_prefix_length") if interior else []
    keys: List[bytes] = []
    for i in range(n):
        keep = prefix[i - 1] if i else 0
        if keys and keep > len(keys[-1]):
            raise OcdbtError(f"{cur.what}: key {i} shares more than its predecessor's length")
        keys.append((keys[-1][:keep] if keys else b"") + cur.take(suffix[i], "key_suffix"))
    for i, c in enumerate(common):
        if c > len(keys[i]):
            raise OcdbtError(f"{cur.what}: subtree_common_prefix_length {c} above key {i}'s length")
    return keys, common


# A value: bytes held inline, or (data file path, offset, length).
Value = Union[bytes, Tuple[str, int, int]]


class OcdbtReader:
    """The keys and values of the newest version of an OCDBT database.

    ``keys()`` lists every key in order; ``get(key)`` returns its value's
    bytes or None.  Data files stay open until ``close()``.
    """

    def __init__(self, root: str):
        self.root = os.path.abspath(root)
        self._files: Dict[str, BinaryIO] = {}
        manifest = os.path.join(self.root, "manifest.ocdbt")
        with open(manifest, "rb") as f:
            blob = f.read()
        cur = _Cursor(decode_structure(blob, MANIFEST_MAGIC, manifest), manifest)
        cur.take(16, "config.uuid")
        kind = cur.varint("config.manifest_kind")
        if kind != 0:
            raise OcdbtError(f"{manifest}: manifest_kind {kind} (the reader takes 0, single)")
        self.max_inline_value_bytes = cur.varint("config.max_inline_value_bytes")
        self.max_decoded_node_bytes = cur.varint("config.max_decoded_node_bytes")
        cur.byte("config.version_tree_arity_log2")
        method = cur.varint("config.compression_method")
        if method not in _COMPRESSION:
            raise OcdbtError(f"{manifest}: config.compression_method {method} (the reader "
                             "takes 0, none, and 1, zstd)")
        if method == 1:
            cur.take(4, "config.zstd_level")
        files = _data_file_table(cur)
        n = cur.varint("versions.num_versions")
        if n == 0:
            raise OcdbtError(f"{manifest}: no version in the manifest")
        generation = cur.varints(n, "versions.generation_number")
        height = [cur.byte("versions.root_height") for _ in range(n)]
        file_id = cur.varints(n, "versions.root.data_file_id")
        offset = cur.varints(n, "versions.root.offset")
        length = cur.varints(n, "versions.root.length")
        num_keys = cur.varints(n, "versions.root.num_keys")
        cur.varints(2 * n, "versions.root.statistics")
        cur.take(8 * n, "versions.commit_time")
        cur.varint("version_tree_nodes.num_nodes")  # older versions: never read
        newest = max(range(n), key=generation.__getitem__)
        self.generation = generation[newest]
        self._values: Dict[bytes, Value] = {}
        if offset[newest] != _MISSING:
            if file_id[newest] >= len(files):
                raise OcdbtError(f"{manifest}: root data_file_id {file_id[newest]} of "
                                 f"{len(files)} files")
            self._walk(files[file_id[newest]], offset[newest], length[newest], height[newest],
                       b"")
        if len(self._values) != num_keys[newest]:
            raise OcdbtError(f"{manifest}: the tree holds {len(self._values)} keys where its "
                             f"root says {num_keys[newest]}")

    # -- the tree ----------------------------------------------------------------
    def _read(self, path: str, offset: int, length: int) -> bytes:
        f = self._files.get(path)
        if f is None:
            f = self._files[path] = open(os.path.join(self.root, path), "rb")
        data = os.pread(f.fileno(), length, offset)
        if len(data) != length:
            raise OcdbtError(f"{path}: {length} bytes at {offset} run past the file's end")
        return data

    def _walk(self, path: str, offset: int, length: int, height: int, prefix: bytes) -> None:
        what = f"{path}@{offset}"
        cur = _Cursor(decode_structure(self._read(path, offset, length), BTREE_MAGIC, what,
                                       self.max_decoded_node_bytes), what)
        got = cur.byte("height")
        if got != height:
            raise OcdbtError(f"{what}: height {got} where its parent says {height}")
        files = _data_file_table(cur)
        n = cur.varint("num_entries")
        keys, common = _keys(cur, n, interior=height > 0)

        def file_of(i: int) -> str:
            if i >= len(files):
                raise OcdbtError(f"{what}: data_file_id {i} of {len(files)} files")
            return files[i]

        if height > 0:
            ids = cur.varints(n, "child.data_file_id")
            offsets = cur.varints(n, "child.offset")
            lengths = cur.varints(n, "child.length")
            cur.varints(3 * n, "child.statistics")
            cur.done()
            for i in range(n):
                self._walk(file_of(ids[i]), offsets[i], lengths[i], height - 1,
                           prefix + keys[i][:common[i]])
            return
        lengths = cur.varints(n, "value_length")
        kinds = cur.varints(n, "value_kind")
        if any(k > 1 for k in kinds):
            raise OcdbtError(f"{what}: value_kind {max(kinds)} (0 inline and 1 indirect known)")
        m = sum(kinds)
        ids = cur.varints(m, "value.data_file_id")
        offsets = cur.varints(m, "value.offset")
        j = 0
        for i in range(n):
            key = prefix + keys[i]
            if key in self._values:
                raise OcdbtError(f"{what}: key {key!r} twice")
            if kinds[i]:
                self._values[key] = (file_of(ids[j]), offsets[j], lengths[i])
                j += 1
            else:
                self._values[key] = cur.take(lengths[i], "inline_value")
        cur.done()

    # -- the key-value interface -----------------------------------------------
    def keys(self) -> List[str]:
        return sorted(k.decode() for k in self._values)

    def get(self, key: str) -> Optional[bytes]:
        value = self._values.get(key.encode())
        if value is None or isinstance(value, bytes):
            return value
        return self._read(*value)

    def close(self) -> None:
        for f in self._files.values():
            f.close()
        self._files.clear()

    def __enter__(self) -> "OcdbtReader":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class DirectoryStore:
    """A plain directory as a key-value source (the ``use_ocdbt: false``
    layout): key ``a/b`` is the file ``root/a/b``."""

    def __init__(self, root: str):
        self.root = os.path.abspath(root)

    def _path(self, key: str) -> str:
        if key.startswith("/") or ".." in key.split("/"):
            raise ValueError(f"key {key!r} leaves {self.root}")
        return os.path.join(self.root, key)

    def get(self, key: str) -> Optional[bytes]:
        try:
            with open(self._path(key), "rb") as f:
                return f.read()
        except FileNotFoundError:
            return None

    def close(self) -> None:
        pass

    def __enter__(self) -> "DirectoryStore":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

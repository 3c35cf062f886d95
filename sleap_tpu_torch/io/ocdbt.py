"""A read-only reader of OCDBT key-value stores (tensorstore's format).

Orbax writes checkpoints through tensorstore into an OCDBT store: a
``manifest.ocdbt`` at the root, b-tree nodes, and data files holding the
values that are not stored inline. This module reads the latest version of
such a store with nothing but the standard library and the port's own zstd
decoder (:mod:`sleap_tpu_torch.io.zstd`).

Format, as tensorstore writes it (every integer a LEB128 varint unless said
otherwise; columns are stored one after the other, each over all entries):

- Manifest and nodes are enveloped: magic (uint32 big-endian: ``0x0cdb3a2a``
  manifest, ``0x0cdb20de`` b-tree node), total length (uint64 little-endian),
  format version (0), compression (0 none, 1 zstd), the body, and a CRC-32C
  of everything before it (uint32 little-endian).
- Manifest body: config (uuid: 16 bytes; manifest kind: 0 single, others
  raise; max inline value bytes; max decoded node bytes; version tree arity
  log2: 1 byte; compression method, followed by a zstd level as int32
  little-endian when it is 1), a data file table, then the newest versions
  (count; generation, root height (1 byte), root node's data file, offset
  and length, key count, tree bytes, indirect value bytes; commit time as
  uint64 little-endian), then references to older version tree nodes, which
  a reader of the latest version does not need.
- Data file table: count; path prefix length shared with the previous path
  (all but the first); path suffix length; base path length; then the
  suffixes. A path is relative to the store's root.
- B-tree node body: height (1 byte), data file table, entry count; key
  prefix length shared with the previous key (all but the first); key
  suffix length; in inner nodes the length of the prefix common to the
  subtree's keys; the key suffixes. A leaf then has value length, value
  kind (0 inline, 1 in a data file), data file and offset of each value in
  a data file, and the inline values. An inner node has the child's data
  file, offset, length, key count, tree bytes and indirect value bytes. A
  child's keys are stored without the common prefix its parent names.
"""

from __future__ import annotations

import os
import struct
from typing import Dict, List, Tuple, Union

from sleap_tpu_torch.io.zstd import decompress

__all__ = ["OcdbtError", "OcdbtReader"]

_MANIFEST_MAGIC = 0x0CDB3A2A
_NODE_MAGIC = 0x0CDB20DE
_FORMAT_VERSION = 0


class OcdbtError(ValueError):
    """A store this reader cannot read: corrupt, or a format it does not know."""


def _crc32c_table() -> List[int]:
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table.append(c)
    return table


_CRC32C = _crc32c_table()


def crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli) of ``data``."""
    c = 0xFFFFFFFF
    table = _CRC32C
    for b in data:
        c = table[(c ^ b) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


class _Cursor:
    """Sequential reads of varints, bytes and fixed-width integers."""

    def __init__(self, data: bytes, what: str):
        self.data, self.pos, self.what = data, 0, what

    def varint(self) -> int:
        value, shift = 0, 0
        while True:
            if self.pos >= len(self.data):
                raise OcdbtError(f"Truncated {self.what}.")
            b = self.data[self.pos]
            self.pos += 1
            value |= (b & 0x7F) << shift
            if b < 0x80:
                return value
            shift += 7
            if shift > 63:
                raise OcdbtError(f"Varint too long in {self.what}.")

    def varints(self, n: int) -> List[int]:
        return [self.varint() for _ in range(n)]

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise OcdbtError(f"Truncated {self.what}.")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def byte(self) -> int:
        return self.take(1)[0]

    def uint(self, fmt: str) -> int:
        n = struct.calcsize(fmt)
        return struct.unpack(fmt, self.take(n))[0]


def _envelope(raw: bytes, magic: int, what: str) -> bytes:
    """The body of an enveloped manifest or node, checked and decompressed."""
    if len(raw) < 18:
        raise OcdbtError(f"Truncated {what}.")
    (got,) = struct.unpack_from(">I", raw, 0)
    if got != magic:
        raise OcdbtError(f"Bad magic {got:#010x} in {what}, expected {magic:#010x}.")
    (length,) = struct.unpack_from("<Q", raw, 4)
    if length != len(raw):
        raise OcdbtError(f"{what} is {len(raw)} bytes, its header says {length}.")
    (want,) = struct.unpack_from("<I", raw, len(raw) - 4)
    if crc32c(raw[:-4]) != want:
        raise OcdbtError(f"CRC-32C mismatch in {what}.")
    cur = _Cursor(raw[:-4], what)
    cur.pos = 12
    version = cur.varint()
    if version != _FORMAT_VERSION:
        raise OcdbtError(f"{what} has OCDBT format version {version}; this reader knows {_FORMAT_VERSION}.")
    compression = cur.varint()
    body = raw[cur.pos:-4]
    if compression == 0:
        return body
    if compression == 1:
        return decompress(body)
    raise OcdbtError(f"Unknown compression {compression} in {what}.")


def _data_files(cur: _Cursor) -> List[str]:
    n = cur.varint()
    prefix = [0] + cur.varints(max(n - 1, 0))
    suffix = cur.varints(n)
    cur.varints(n)  # base path lengths: where the base path ends in each path
    paths: List[bytes] = []
    for i in range(n):
        prev = paths[-1] if paths else b""
        if prefix[i] > len(prev):
            raise OcdbtError(f"Bad path prefix in {cur.what}.")
        paths.append(prev[:prefix[i]] + cur.take(suffix[i]))
    out = []
    for p in paths:
        path = p.decode("utf-8")
        if path.startswith("/") or ".." in path.split("/"):
            raise OcdbtError(f"Data file path {path!r} leaves the store.")
        out.append(path)
    return out


def _keys(cur: _Cursor, n: int, inner: bool) -> Tuple[List[bytes], List[int]]:
    prefix = [0] + cur.varints(max(n - 1, 0))
    suffix = cur.varints(n)
    common = cur.varints(n) if inner else [0] * n
    keys: List[bytes] = []
    for i in range(n):
        prev = keys[-1] if keys else b""
        if prefix[i] > len(prev):
            raise OcdbtError(f"Bad key prefix in {cur.what}.")
        keys.append(prev[:prefix[i]] + cur.take(suffix[i]))
    return keys, common


class OcdbtReader:
    """The latest version of the OCDBT store rooted at ``root``.

    ``keys()`` lists its keys in order and ``read(key)`` returns a value's
    bytes. The b-tree is read at construction; values in data files are read
    when asked for.
    """

    def __init__(self, root: Union[str, os.PathLike]):
        self.root = os.fspath(root)
        raw = self._file("manifest.ocdbt")
        cur = _Cursor(_envelope(raw, _MANIFEST_MAGIC, "manifest.ocdbt"), "manifest.ocdbt")
        cur.take(16)  # uuid
        kind = cur.varint()
        if kind != 0:
            raise OcdbtError(
                f"Manifest kind {kind} (numbered manifests) is not supported; only 0 (single)."
            )
        cur.varint()  # max inline value bytes
        cur.varint()  # max decoded node bytes
        cur.byte()  # version tree arity log2
        method = cur.varint()
        if method == 1:
            cur.uint("<i")  # zstd level
        elif method != 0:
            raise OcdbtError(f"Unknown compression method {method} in the manifest config.")
        files = _data_files(cur)
        n = cur.varint()
        if n == 0:
            raise OcdbtError("The manifest holds no version.")
        generation = cur.varints(n)
        height = [cur.byte() for _ in range(n)]
        file_id, offset, length = cur.varints(n), cur.varints(n), cur.varints(n)
        num_keys = cur.varints(n)
        latest = max(range(n), key=generation.__getitem__)
        self.generation = generation[latest]
        self._values: Dict[bytes, Union[bytes, Tuple[str, int, int]]] = {}
        if num_keys[latest]:
            self._node(files, file_id[latest], offset[latest], length[latest],
                       height[latest], b"")
        if len(self._values) != num_keys[latest]:
            raise OcdbtError(
                f"Read {len(self._values)} keys, the manifest says {num_keys[latest]}."
            )

    def _file(self, path: str, offset: int = 0, length: int = -1) -> bytes:
        with open(os.path.join(self.root, path), "rb") as f:
            f.seek(offset)
            data = f.read(length)
        if length >= 0 and len(data) != length:
            raise OcdbtError(f"{path} is shorter than {offset + length} bytes.")
        return data

    def _node(self, files: List[str], fid: int, offset: int, length: int, height: int,
              prefix: bytes) -> None:
        if fid >= len(files):
            raise OcdbtError(f"Data file {fid} is not in the table of {len(files)}.")
        what = f"b-tree node {files[fid]}@{offset}"
        cur = _Cursor(_envelope(self._file(files[fid], offset, length), _NODE_MAGIC, what), what)
        if cur.byte() != height:
            raise OcdbtError(f"{what} has another height than its parent says.")
        node_files = _data_files(cur)
        n = cur.varint()
        keys, common = _keys(cur, n, inner=height > 0)
        if height > 0:
            fids, offs, lens = cur.varints(n), cur.varints(n), cur.varints(n)
            cur.varints(3 * n)  # key count, tree bytes, indirect value bytes
            for i in range(n):
                self._node(node_files, fids[i], offs[i], lens[i], height - 1,
                           prefix + keys[i][:common[i]])
            return
        lens = cur.varints(n)
        kinds = cur.varints(n)
        indirect = [i for i in range(n) if kinds[i] == 1]
        if any(k not in (0, 1) for k in kinds):
            raise OcdbtError(f"Unknown value kind in {what}.")
        fids, offs = cur.varints(len(indirect)), cur.varints(len(indirect))
        for j, i in enumerate(indirect):
            if fids[j] >= len(node_files):
                raise OcdbtError(f"Value in data file {fids[j]}, not in the table of {what}.")
            self._values[prefix + keys[i]] = (node_files[fids[j]], offs[j], lens[i])
        for i in range(n):
            if kinds[i] == 0:
                self._values[prefix + keys[i]] = cur.take(lens[i])
        if cur.pos != len(cur.data):
            raise OcdbtError(f"{len(cur.data) - cur.pos} bytes left over in {what}.")

    def keys(self) -> List[str]:
        """Every key, in order."""
        return [k.decode("utf-8") for k in sorted(self._values)]

    def __contains__(self, key: Union[str, bytes]) -> bool:
        return (key.encode() if isinstance(key, str) else key) in self._values

    def read(self, key: Union[str, bytes]) -> bytes:
        """The value of ``key``; ``KeyError`` if the store does not hold it."""
        ref = self._values[key.encode() if isinstance(key, str) else key]
        if isinstance(ref, bytes):
            return ref
        return self._file(*ref)

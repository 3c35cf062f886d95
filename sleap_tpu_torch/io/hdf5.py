"""A reader and a writer for the HDF5 files that users and SLEAP write
(``.slp`` files, HDF5 videos, analysis files, Keras weight files), in plain
Python and numpy (``zlib`` from the standard library): the port reads and
writes them where ``h5py`` is not installed.

Reader (:class:`File`), after the HDF5 file format specification, version 3;
it reads what h5py 3 writes through its public API, with either ``libver``
and under SWMR:

- superblock versions 0 to 3; object headers version 1 and 2, with
  continuation blocks;
- groups as symbol tables (version 1 B-trees, symbol table nodes, a local
  heap), as compact link messages, or in dense storage (a fractal heap and
  a version 2 B-tree name index: :mod:`~sleap_tpu_torch.io.hdf5_index`);
  ``keys()`` and ``.attrs`` in h5py's order: creation order where the
  object tracks it, name order otherwise (``visititems`` in name order,
  each object once, soft and external links skipped, as h5py visits);
- hard, soft (both group styles) and external links: an external link's
  file is looked for as libhdf5 looks under h5py's default access
  settings: an absolute name as it is, then the name (of an absolute one,
  its last part) beside the file holding the link, then relative to the
  working directory;
- dataspaces (scalar, simple, null), fill values, datatypes: fixed-point,
  floating point, fixed-length strings (null-padded or null-terminated),
  enums (an ``int8`` enum of ``FALSE``/``TRUE`` is h5py's ``bool``),
  compounds with the member offsets the file gives, arrays,
  variable-length strings through the global heap, object references
  (:class:`Reference`; ``f[ref]`` opens the target) and committed (named)
  datatypes, wherever a dataset or attribute uses one (``f[name]`` of one
  is a :class:`Datatype`);
- data layout versions 3 and 4: compact; contiguous (an undefined address
  is an empty or unwritten dataset), in the file or in external raw data
  files (names relative to the working directory, as libhdf5 resolves them
  by default; a missing or short file raises ``OSError`` naming it); and
  chunked, indexed by a version 1 B-tree, a single chunk, an implicit
  index, a fixed array, an extensible array or a version 2 B-tree, with
  each chunk's filter mask and the "do not filter partial edge chunks"
  flag honoured;
- filters: deflate, shuffle, fletcher32 (checked, then stripped; a
  mismatch raises ``OSError``), scale-offset (integers, and floats by
  D-scaling, with the fill-value rule) and h5py's lzf. LZF decodes in host
  C (:func:`sleap_tpu_torch.io.lzf.decode_host`) for ``File(path,
  device="cuda")``, the default, and in Python for ``device="cpu"``; the
  route is picked at the first LZF chunk, so a file without LZF never
  builds the kernel library;
- attribute messages versions 1 to 3, compact or in dense storage.

What stays outside (nbit and szip filters, region references, virtual
datasets, shared object header message tables, fractal heaps with I/O
filters, user-defined links) raises :class:`UnsupportedFeature`, which
names the feature and the file; no read returns zeros or unset memory for
it. The API is h5py's, cut down: ``File(path)``, ``f[name]``, ``f[ref]``,
``.attrs``, ``ds[...]``, ``ds.shape``, ``ds.dtype``, ``ds.chunks``,
``ds.maxshape``, ``in``, ``keys()``, ``visititems``.

Writer (:class:`Writer`): what ``write_labels``, the frame exporters and
the analysis export write, laid out as h5py's ``libver="earliest"`` lays it
out: superblock version 0, symbol-table groups (nested too), datasets of
numeric, ``bool`` (an ``int8`` enum), compound and fixed-length string
types, and of variable-length UTF-8 strings (a ``str``, or an object array
of them, as h5py stores them: one global heap collection holds every
string), and attributes of the fixed-size types. A dataset is contiguous
and uncompressed (empty ones with an undefined address), or, with
``compression="gzip"`` (at level ``compression_opts``) or ``chunks``,
chunked (layout message version 3, a version 1 B-tree chunk index of node
type 1; none for an empty dataset) and deflated through a filter pipeline.
The default chunk is one row of the first axis, grouped to at least 64 KiB
where rows are smaller: one encoded frame or one raw frame a chunk, so a
reader inflates one frame at a time; :func:`guess_chunk` is h5py's own
choice. ``Writer(path, "a")`` reads the file there first and writes it
again with what is added: a group that tracks creation order keeps it
(link info and link messages, the added links last); a dataset filtered
with lzf, scale-offset or fletcher32, which the writer does not write, is
written deflated (level 4) with its chunks; a file holding soft or external
links, object references or committed datatypes raises
:class:`UnsupportedFeature` naming them, and nothing is dropped.
"""

from __future__ import annotations

import mmap
import os
import posixpath
import struct
import zlib
from typing import Any, Callable, Dict, List, Optional, Set, Tuple

import numpy as np

from sleap_tpu_torch.io import hdf5_index as hx

SIGNATURE = b"\x89HDF\r\n\x1a\n"

# Object header message types.
_DATASPACE, _LINK_INFO, _DATATYPE, _FILL_OLD, _FILL = 0x1, 0x2, 0x3, 0x4, 0x5
_LINK, _EXTERNAL, _LAYOUT, _GROUP_INFO, _FILTERS, _ATTRIBUTE = 0x6, 0x7, 0x8, 0xA, 0xB, 0xC
_CONTINUATION, _SYMBOL_TABLE, _ATTRIBUTE_INFO = 0x10, 0x11, 0x15

# Filters.
_DEFLATE, _SHUFFLE, _FLETCHER32, _SCALEOFFSET, _LZF = 1, 2, 3, 6, 32000
_FILTER_NAMES = {3: "fletcher32", 4: "szip", 5: "nbit", 6: "scaleoffset", 32000: "lzf"}
_READ_FILTERS = {_DEFLATE, _SHUFFLE, _FLETCHER32, _SCALEOFFSET, _LZF}

_SOFT_LINK_HOPS = 16  # libhdf5's limit on soft links followed in one lookup (H5L_NUM_LINKS)
_SOHM = "shared object header message tables"


class UnsupportedFeature(ValueError):
    """The file uses an HDF5 feature outside the subset this module reads."""


class VlenStr:
    """The datatype of variable-length strings (read as ``bytes`` in
    datasets and ``str`` in attributes, as h5py 3 reads them); each element
    on disk is a length (4 bytes), a global heap collection's address and an
    object index (4 bytes)."""

    def __repr__(self) -> str:
        return "VlenStr()"


class RefType:
    """The datatype of object references (h5py's ``ref_dtype``): each
    element on disk is the target's object header address."""

    def __repr__(self) -> str:
        return "RefType()"


class Reference:
    """An object reference; ``file[ref]`` opens its target, as h5py's
    ``Reference`` does. A null reference is false."""

    __slots__ = ("addr",)

    def __init__(self, addr: Optional[int]):
        self.addr = addr

    def __bool__(self) -> bool:
        return self.addr is not None

    def __repr__(self) -> str:
        return f"<HDF5 object reference to {self.addr}>" if self else "<HDF5 null reference>"


def _pad8(n: int) -> int:
    return (n + 7) & ~7


def _unshuffle(data: bytes, itemsize: int) -> bytes:
    """Undo the shuffle filter: bytes grouped by their position in the element."""
    n = len(data) // itemsize
    if itemsize <= 1 or n <= 1:
        return data
    body = np.frombuffer(data, np.uint8, n * itemsize).reshape(itemsize, n).T.tobytes()
    return body + data[n * itemsize:]


def fletcher32(data: bytes) -> int:
    """HDF5's Fletcher-32 checksum (``H5_checksum_fletcher32``): 16-bit words
    taken high byte first, both sums folded to 16 bits every 360 words, an
    odd last byte as the high byte of a word."""
    n = len(data)
    words = np.frombuffer(data, ">u2", n // 2).astype(np.int64)
    full = len(words) // 360 * 360
    blocks = [words[:full].reshape(-1, 360)] if full else []
    if full < len(words):
        blocks.append(words[full:].reshape(1, -1))
    sum1 = sum2 = 0
    for block in blocks:
        t = block.shape[1]
        totals, weighted = block.sum(axis=1), block @ np.arange(t, 0, -1, dtype=np.int64)
        for total, weight in zip(totals.tolist(), weighted.tolist()):
            sum2 += t * sum1 + weight
            sum1 += total
            sum1 = (sum1 & 0xFFFF) + (sum1 >> 16)
            sum2 = (sum2 & 0xFFFF) + (sum2 >> 16)
    if n % 2:
        sum1 += data[-1] << 8
        sum2 += sum1
        sum1 = (sum1 & 0xFFFF) + (sum1 >> 16)
        sum2 = (sum2 & 0xFFFF) + (sum2 >> 16)
    sum1 = (sum1 & 0xFFFF) + (sum1 >> 16)
    sum2 = (sum2 & 0xFFFF) + (sum2 >> 16)
    return (sum2 << 16) | sum1


def _scaleoffset_decode(data: bytes, values: Tuple[int, ...], fail: Callable[[str], Exception]) -> bytes:
    """Undo the scale-offset filter (``H5Z__filter_scaleoffset``): a 21-byte
    header (the bits per value, the minimum), then the values packed most
    significant bit first; each value plus the minimum (integers) or over
    10^D plus the minimum (floats, D-scaling), the all-ones value standing
    for the fill value where one is defined."""
    scale_type, scale, n, cls, size, sign, order, fill_defined = values[:8]
    if order != 0:
        raise fail("big-endian scale-offset data")
    if cls == 1 and scale_type != 0:
        raise fail("the scale-offset filter's E-scaling")
    minbits = int.from_bytes(data[:4], "little")
    minval = int.from_bytes(data[5:5 + min(8, data[4])], "little")
    if minbits == 8 * size:
        return data[21:21 + n * size]
    v = np.zeros(n, np.uint64)
    if minbits:
        bits = np.unpackbits(np.frombuffer(data, np.uint8, offset=21))[:n * minbits].reshape(n, minbits)
        for k in range(minbits):
            v = (v << np.uint64(1)) | bits[:, k].astype(np.uint64)
    all_ones = np.uint64((1 << minbits) - 1)
    fill = struct.pack(f"<{len(values) - 8}I", *values[8:])[:size] if fill_defined else None
    if cls == 0:
        unsigned = np.dtype(f"<u{size}")
        out = (v + np.uint64(minval)).astype(unsigned)  # wraps as the C sum does
        if fill is not None:
            out = np.where(v == all_ones, np.frombuffer(fill, unsigned)[0], out)
        return out.astype(unsigned).tobytes()
    if size not in (4, 8):
        raise fail(f"scale-offset on {size}-byte floats")
    real, signed = np.dtype(f"<f{size}"), np.dtype(f"<i{size}")
    scale = struct.unpack("<i", struct.pack("<I", scale))[0]
    lowest = np.frombuffer(minval.to_bytes(8, "little")[:size], real)[0]
    ints = v.astype(np.dtype(f"<u{size}")).view(signed)
    out = ints.astype(real) / real.type(10.0 ** scale) + lowest
    if fill is not None:
        out = np.where(ints == signed.type(all_ones), np.frombuffer(fill, real)[0], out)
    return out.astype(real).tobytes()


# --------------------------------------------------------------------------- #
# Reader
# --------------------------------------------------------------------------- #


class Group:
    """A group of a read :class:`File`."""

    def __init__(self, file: File, addr: int, path: str):
        self.file, self._oh, self.name = file, addr, path

    def __repr__(self) -> str:
        return f"<HDF5 group {self.name!r} ({len(self.keys())} members)>"

    @property
    def _members(self) -> Dict[str, Any]:
        return self.file._link_table(self._oh)

    @property
    def attrs(self) -> Dict[str, Any]:
        return self.file._attr_table(self._oh)

    def keys(self) -> List[str]:
        """Member names in h5py's order: creation order where the group
        tracks it, name order otherwise."""
        return list(self._members)

    def _resolve(self, name: str, hops: int = 0):
        """The object at ``name``, following soft and external links; None
        where a link on the way is missing."""
        parts = [p for p in name.split("/") if p and p != "."]
        node = self.file if name.startswith("/") else self
        path = "/" if name.startswith("/") else self.name
        for part in parts:
            if not isinstance(node, Group) or part not in node._members:
                return None
            node = node._follow(node._members[part], posixpath.join(path, part), hops)
            if node is None:
                return None
            path = node.name
        return node

    def _follow(self, target: Any, path: str, hops: int):
        """The object a link of this group points at, named ``path`` (an
        external link's target keeps its name in its own file, as in h5py)."""
        f = self.file
        if not isinstance(target, tuple):
            return f._object(target, path)
        if hops >= _SOFT_LINK_HOPS:
            raise KeyError(f"{path} in {f.filename}: more than {_SOFT_LINK_HOPS} soft links on the way.")
        if target[0] == "soft":
            obj = self._resolve(target[1], hops + 1)
            if obj is None:
                return None
            return (Group if isinstance(obj, Group) else type(obj))(obj.file, obj._oh, path)
        if target[0] == "external":
            return f._external_file(target[1])._resolve(target[2], hops + 1)
        raise f._fail(f"user-defined links of type {target[1]} ({path})")

    def __getitem__(self, name):
        if isinstance(name, Reference):
            return self.file._dereference(name)
        node = self._resolve(name)
        if node is None:
            raise KeyError(f"{name!r} not found in {self.file.filename}:{self.name}")
        return node

    def __contains__(self, name: str) -> bool:
        """Whether the link exists (a dangling soft link too, as in h5py)."""
        head, _, last = name.rstrip("/").rpartition("/")
        if not last:
            return True
        parent = self._resolve(head) if head else (self.file if name.startswith("/") else self)
        return isinstance(parent, Group) and last in parent._members

    def visititems(self, func: Callable[[str, Any], Any]):
        """Call ``func(relative name, object)`` on every object below this
        group, as h5py does: each object once, through hard links only,
        parents first and names in name order; stop at the first value that
        is not None and return it."""
        seen = {self._oh}

        def walk(group: Group, prefix: str):
            members = group._members
            for key in sorted(members, key=str.encode):
                target = members[key]
                if isinstance(target, tuple) or target in seen:
                    continue
                seen.add(target)
                obj = group.file._object(target, posixpath.join(group.name, key))
                name = f"{prefix}{key}"
                out = func(name, obj)
                if out is not None:
                    return out
                if isinstance(obj, Group):
                    out = walk(obj, name + "/")
                    if out is not None:
                        return out
            return None

        return walk(self, "")


class Datatype:
    """A committed (named) datatype of a read :class:`File`."""

    def __init__(self, file: File, addr: int, path: str):
        self.file, self._oh, self.name = file, addr, path
        self.dtype = file._committed_dtype_at(addr)

    def __repr__(self) -> str:
        return f"<HDF5 named type {self.name!r} ({self.dtype})>"

    @property
    def attrs(self) -> Dict[str, Any]:
        return self.file._attr_table(self._oh)


def _on_card(device) -> bool:
    return getattr(device, "type", str(device).split(":")[0]) == "cuda"


class File(Group):
    """A read-only HDF5 file: its root group, plus ``close``.

    ``File(path)`` maps the file; use it as a context manager, or call
    ``close``, to release it (and the files its external links opened).
    ``device`` picks LZF's route: host C for "cuda" (the default), Python
    for "cpu".
    """

    def __init__(self, path: str, mode: str = "r", device="cuda"):
        if mode != "r":
            raise ValueError("sleap_tpu_torch.io.hdf5.File reads only; use Writer to write.")
        self.filename = str(path)
        self.device = device
        self._fh = open(path, "rb")
        try:
            self._buf = mmap.mmap(self._fh.fileno(), 0, access=mmap.ACCESS_READ)
        except ValueError:
            self._fh.close()
            raise OSError(f"{path} is empty, not an HDF5 file.")
        self._headers: Dict[int, list] = {}
        self._attr_tracked: Set[int] = set()  # objects whose attributes keep creation order
        self._links_tracked: Set[int] = set()  # groups whose links keep creation order
        self._link_cache: Dict[int, Dict[str, Any]] = {}
        self._attr_cache: Dict[int, Dict[str, Any]] = {}
        self._heaps: Dict[int, Dict[int, Tuple[int, int]]] = {}
        self._fractal_heaps: Dict[int, hx.FractalHeap] = {}
        self._external: Dict[str, File] = {}
        self._paths: Optional[Dict[int, str]] = None
        self._lzf_decode: Optional[Callable[[bytes, int], bytes]] = None
        self._committed_users: Set[int] = set()  # objects whose datatype or an attribute's is committed
        try:
            root = self._read_superblock()
        except BaseException:
            self.close()
            raise
        super().__init__(self, root, "/")

    def __enter__(self) -> "File":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def close(self) -> None:
        if self._buf is not None:
            self._buf.close()
            self._fh.close()
            self._buf = None
        for other in self._external.values():
            other.close()
        self._external.clear()

    # -- low-level access --------------------------------------------------- #
    def _fail(self, feature: str) -> UnsupportedFeature:
        return UnsupportedFeature(f"{self.filename}: {feature} is not supported by the port's HDF5 reader.")

    def _uint(self, pos: int, n: int) -> int:
        return int.from_bytes(self._buf[pos:pos + n], "little")

    def _addr(self, pos: int) -> Optional[int]:
        """An address field: ``None`` where it is undefined (all ones)."""
        raw = self._uint(pos, self._O)
        return None if raw == (1 << (8 * self._O)) - 1 else raw + self._base

    def _cstr(self, pos: int) -> Tuple[str, int]:
        """A null-terminated string and the position just after its null."""
        end = self._buf.find(b"\0", pos)
        return self._buf[pos:end].decode("utf-8"), end + 1

    def _bytes(self, pos: int, n: int) -> np.ndarray:
        """``n`` bytes of the file at ``pos``, as a writable uint8 array."""
        if pos + n > len(self._buf):
            raise OSError(f"{self.filename}: truncated file (reading {n} bytes at {pos}).")
        return np.frombuffer(self._buf, np.uint8, n, pos).copy()

    def _read_superblock(self) -> int:
        pos = 0
        while self._buf[pos:pos + 8] != SIGNATURE:
            pos = 512 if pos == 0 else pos * 2
            if pos + 8 > len(self._buf):
                raise OSError(f"{self.filename} is not an HDF5 file (no superblock signature).")
        version = self._buf[pos + 8]
        if version in (0, 1):
            self._O, self._L = self._buf[pos + 13], self._buf[pos + 14]
            p = pos + 24 + (4 if version == 1 else 0)
            self._base = 0
            self._base = self._addr(p) or 0
            root_entry = p + 4 * self._O
            return self._addr(root_entry + self._O)
        if version in (2, 3):
            self._O, self._L = self._buf[pos + 9], self._buf[pos + 10]
            self._base = 0
            self._base = self._addr(pos + 12) or 0
            return self._addr(pos + 12 + 3 * self._O)
        raise self._fail(f"superblock version {version}")

    def _lzf(self, data: bytes, size: int) -> bytes:
        """One LZF chunk decoded on the route of the file's device, picked
        at the first LZF chunk."""
        if self._lzf_decode is None:
            from sleap_tpu_torch.io import lzf

            self._lzf_decode = lzf.decode_host if _on_card(self.device) else (
                lambda data, size: lzf.decode_plain(data))
        return self._lzf_decode(data, size)

    # -- object headers ----------------------------------------------------- #
    def _messages(self, addr: int) -> List[Tuple[int, int, int, int, int]]:
        """``(type, flags, data position, size, creation order)`` of every
        message of the object header at ``addr``, continuation blocks
        included (the creation order is 0 where the header keeps none)."""
        if addr in self._headers:
            return self._headers[addr]
        buf = self._buf
        msgs = []
        if buf[addr:addr + 4] == b"OHDR":
            if buf[addr + 4] != 2:
                raise self._fail(f"object header version {buf[addr + 4]}")
            flags = buf[addr + 5]
            if flags & 0x04:
                self._attr_tracked.add(addr)
            p = addr + 6 + (16 if flags & 0x20 else 0) + (4 if flags & 0x10 else 0)
            width = 1 << (flags & 3)
            blocks = [(p + width, self._uint(p, width))]
            head = 6 if flags & 0x04 else 4
            while blocks:
                start, size = blocks.pop(0)
                p, end = start, start + size
                while p + head <= end:
                    mtype, msize, mflags = buf[p], self._uint(p + 1, 2), buf[p + 3]
                    order = self._uint(p + 4, 2) if flags & 0x04 else 0
                    data = p + head
                    if mtype == _CONTINUATION:
                        cont, length = self._addr(data), self._uint(data + self._O, self._L)
                        if buf[cont:cont + 4] != b"OCHK":
                            raise OSError(f"{self.filename}: bad continuation block at {cont}.")
                        blocks.append((cont + 4, length - 8))
                    elif mtype:
                        msgs.append((mtype, mflags, data, msize, order))
                    p = data + msize
        elif buf[addr] == 1:
            size = self._uint(addr + 8, 4)
            blocks = [(addr + 16, size)]
            while blocks:
                start, size = blocks.pop(0)
                p, end = start, start + size
                while p + 8 <= end:
                    mtype, msize, mflags = struct.unpack_from("<HHB", buf, p)
                    data = p + 8
                    if mtype == _CONTINUATION:
                        blocks.append((self._addr(data), self._uint(data + self._O, self._L)))
                    elif mtype:
                        msgs.append((mtype, mflags, data, msize, 0))
                    p = data + msize
        else:
            raise self._fail(f"object header version {buf[addr]} at {addr}")
        self._headers[addr] = msgs
        return msgs

    def _object(self, addr: int, path: str):
        types = {m[0] for m in self._messages(addr)}
        if _LAYOUT in types:
            return Dataset(self, addr, path)
        if _DATATYPE in types:
            return Datatype(self, addr, path)
        return Group(self, addr, path)

    def _shared(self, pos: int) -> int:
        """The object header a shared message at ``pos`` points at (a
        committed datatype's); a message in a shared message table raises."""
        version, kind = self._buf[pos], self._buf[pos + 1]
        if version == 1:
            return self._addr(pos + 8 + self._L)
        if version == 2 or (version == 3 and kind == 2):
            return self._addr(pos + 2)
        raise self._fail(_SOHM)

    def _committed_dtype_at(self, addr: int) -> Any:
        """The datatype held by the named datatype object at ``addr``."""
        for mtype, mflags, data, _, _ in self._messages(addr):
            if mtype == _DATATYPE:
                if mflags & 0x02:
                    return self._committed_dtype_at(self._shared(data))
                return self._dtype(data)[0]
        raise OSError(f"{self.filename}: no datatype in the named datatype at {addr}.")

    def _external_file(self, name: str) -> "File":
        """The file an external link names, looked for as libhdf5 does under
        default access settings."""
        if name not in self._external:
            rel = os.path.basename(name) if os.path.isabs(name) else name
            candidates = ([name] if os.path.isabs(name) else []) + [
                os.path.join(os.path.dirname(os.path.abspath(self.filename)), rel), rel]
            found = next((c for c in candidates if os.path.isfile(c)), None)
            if found is None:
                raise KeyError(f"{self.filename}: the file {name!r} of an external link was not found "
                               f"(looked for {candidates}).")
            self._external[name] = File(found, device=self.device)
        return self._external[name]

    def _dereference(self, ref: Reference):
        if not ref:
            raise ValueError(f"{self.filename}: a null object reference cannot be opened.")
        if self._paths is None:  # each object's first path, hard links in name order, parents first
            self._paths = {self._oh: "/"}

            def walk(addr: int, path: str) -> None:
                members = self._link_table(addr)
                for key in sorted(members, key=str.encode):
                    target = members[key]
                    if isinstance(target, tuple) or target in self._paths:
                        continue
                    self._paths[target] = posixpath.join(path, key)
                    if not {_LAYOUT, _DATATYPE} & {m[0] for m in self._messages(target)}:
                        walk(target, self._paths[target])

            walk(self._oh, "/")
        return self._object(ref.addr, self._paths.get(ref.addr, ""))

    # -- datatypes, dataspaces, attributes ---------------------------------- #
    def _dtype(self, pos: int) -> Tuple[Any, int]:
        """The datatype message at ``pos`` as a numpy dtype (or
        :class:`VlenStr`, :class:`RefType`), and the position after it."""
        buf = self._buf
        cls, version = buf[pos] & 0x0F, buf[pos] >> 4
        bits = self._uint(pos + 1, 3)
        size = self._uint(pos + 4, 4)
        p = pos + 8
        order = ">" if bits & 1 else "<"
        if cls == 0:  # fixed-point
            offset, precision = struct.unpack_from("<HH", buf, p)
            if offset or precision != 8 * size or size not in (1, 2, 4, 8):
                raise self._fail(f"a {precision}-bit integer at bit offset {offset}")
            return np.dtype(f"{order}{'i' if bits & 8 else 'u'}{size}"), p + 4
        if cls == 1:  # floating point
            if size not in (2, 4, 8) or bits & 0x40:
                raise self._fail(f"a {size}-byte (or VAX-order) float")
            return np.dtype(f"{order}f{size}"), p + 12
        if cls == 3:  # fixed-length string
            if bits & 0x0F not in (0, 1):
                raise self._fail("space-padded strings")
            return np.dtype(f"S{size}"), p
        if cls == 6:  # compound
            names, formats, offsets = [], [], []
            for _ in range(bits & 0xFFFF):
                name, end = self._cstr(p)
                p = p + _pad8(end - p) if version < 3 else end
                shape: Tuple[int, ...] = ()
                if version == 1:
                    offset, rank = self._uint(p, 4), buf[p + 4]
                    shape = struct.unpack_from(f"<{rank}I", buf, p + 16)
                    p += 32
                elif version == 2:
                    offset = self._uint(p, 4)
                    p += 4
                else:
                    width = (size.bit_length() + 7) // 8 or 1
                    offset = self._uint(p, width)
                    p += width
                member, p = self._dtype(p)
                if not isinstance(member, np.dtype):
                    raise self._fail(f"{member!r} members of a compound")
                names.append(name)
                formats.append((member, shape) if shape else member)
                offsets.append(offset)
            dtype = np.dtype({"names": names, "formats": formats, "offsets": offsets, "itemsize": size})
            return dtype, p
        if cls == 7:  # reference
            if version == 1 and bits & 0x0F == 0 and size == self._O:
                return RefType(), p
            raise self._fail("region references" if bits & 0x0F == 1 else "references of HDF5 1.12's format")
        if cls == 8:  # enum
            base, p = self._dtype(p)
            names = []
            for _ in range(bits & 0xFFFF):
                name, end = self._cstr(p)
                p = p + _pad8(end - p) if version < 3 else end
                names.append(name)
            values = np.frombuffer(buf, base, len(names), p).tolist()
            p += base.itemsize * len(names)
            if base == np.int8 and dict(zip(names, values)) == {"FALSE": 0, "TRUE": 1}:
                return np.dtype("?"), p
            return base, p
        if cls == 9:  # variable-length
            base, p = self._dtype(p)
            if bits & 0x0F != 1:
                raise self._fail("variable-length sequences")
            return VlenStr(), p
        if cls == 10:  # array
            rank = buf[p]
            if version < 3:
                dims = struct.unpack_from(f"<{rank}I", buf, p + 4)
                p += 4 + 8 * rank
            else:
                dims = struct.unpack_from(f"<{rank}I", buf, p + 1)
                p += 1 + 4 * rank
            base, p = self._dtype(p)
            if not isinstance(base, np.dtype):
                raise self._fail(f"arrays of {base!r}")
            return np.dtype((base, tuple(dims))), p
        names = {2: "time", 4: "bitfield", 5: "opaque"}
        raise self._fail(f"the {names.get(cls, cls)} datatype class")

    def _dataspace(self, pos: int) -> Tuple[Optional[Tuple[int, ...]], Optional[tuple]]:
        """The dataspace message at ``pos`` as (shape, maximum shape, None
        on an unlimited axis); (None, None) for a null dataspace."""
        version, rank, flags = self._buf[pos], self._buf[pos + 1], self._buf[pos + 2]
        if version == 1:
            p = pos + 8
        elif version == 2:
            if self._buf[pos + 3] == 2:
                return None, None
            p = pos + 4
        else:
            raise self._fail(f"dataspace version {version}")
        shape = tuple(self._uint(p + i * self._L, self._L) for i in range(rank))
        if not flags & 1:
            return shape, shape
        unlimited = (1 << (8 * self._L)) - 1
        top = (self._uint(p + (rank + i) * self._L, self._L) for i in range(rank))
        return shape, tuple(None if m == unlimited else m for m in top)

    def _references(self, raw: bytes, count: int) -> List[Reference]:
        addrs = np.frombuffer(raw, f"<u{self._O}", count).tolist()
        null = (1 << (8 * self._O)) - 1
        return [Reference(None if a in (0, null) else a + self._base) for a in addrs]

    def _attribute(self, pos: int) -> Tuple[str, Any, bool]:
        """(name, value, whether its datatype is committed) of the
        attribute message at ``pos``."""
        buf = self._buf
        version = buf[pos]
        name_size, type_size, space_size = struct.unpack_from("<HHH", buf, pos + 2)
        committed = False
        if version == 1:
            p = pos + 8
            name = buf[p:p + name_size - 1].decode()
            p += _pad8(name_size)
            dtype, _ = self._dtype(p)
            p += _pad8(type_size)
            shape, _ = self._dataspace(p)
            p += _pad8(space_size)
        elif version in (2, 3):
            flags = buf[pos + 1]
            if flags & 0x02:
                raise self._fail(_SOHM)
            p = pos + (8 if version == 2 else 9)
            name = buf[p:p + name_size - 1].decode()
            p += name_size
            if flags & 0x01:
                dtype, committed = self._committed_dtype_at(self._shared(p)), True
            else:
                dtype, _ = self._dtype(p)
            p += type_size
            shape, _ = self._dataspace(p)
            p += space_size
        else:
            raise self._fail(f"attribute message version {version}")
        if shape is None:
            return name, None, committed
        count = int(np.prod(shape))
        if isinstance(dtype, VlenStr):
            values = [s.decode("utf-8") for s in self._vlen_strings(p, count)]
            return name, values[0] if shape == () else np.array(values, dtype=object).reshape(shape), committed
        if isinstance(dtype, RefType):
            refs = self._references(self._buf[p:p + count * self._O], count)
            return name, refs[0] if shape == () else np.array(refs, dtype=object).reshape(shape), committed
        arr = np.frombuffer(self._bytes(p, count * dtype.itemsize), dtype, count).reshape(shape)
        return name, arr[()] if shape == () else arr, committed

    def _fractal_heap(self, addr: int) -> hx.FractalHeap:
        if addr not in self._fractal_heaps:
            self._fractal_heaps[addr] = hx.FractalHeap(self, addr)
        return self._fractal_heaps[addr]

    def _attr_table(self, addr: int) -> Dict[str, Any]:
        """Attribute name -> value, in h5py's order: creation order where
        the object header tracks it, name order otherwise."""
        if addr in self._attr_cache:
            return self._attr_cache[addr]
        items = []  # (creation order, name, value)
        committed = False
        for mtype, mflags, data, _, order in self._messages(addr):
            if mtype == _ATTRIBUTE:
                if mflags & 0x02:
                    raise self._fail(_SOHM)
                name, value, shared = self._attribute(data)
                items.append((order, name, value))
                committed |= shared
            elif mtype == _ATTRIBUTE_INFO:
                flags = self._buf[data + 1]
                p = data + 2 + (2 if flags & 1 else 0)
                heap, index = self._addr(p), self._addr(p + self._O)
                if heap is None:
                    continue
                fheap = self._fractal_heap(heap)
                for record in hx.btree2_records(self, index, 8)[0]:
                    if self._buf[record + 8] & 0x02:
                        raise self._fail(_SOHM)
                    name, value, shared = self._attribute(fheap.object(record)[0])
                    items.append((self._uint(record + 9, 4), name, value))
                    committed |= shared
        tracked = addr in self._attr_tracked
        items.sort(key=lambda item: item[0] if tracked else item[1].encode())
        if committed:
            self._committed_users.add(addr)
        self._attr_cache[addr] = {name: value for _, name, value in items}
        return self._attr_cache[addr]

    def _vlen_strings(self, pos: int, count: int) -> List[bytes]:
        """``count`` variable-length strings whose heap IDs start at ``pos``."""
        out = []
        step = 8 + self._O
        for i in range(count):
            p = pos + i * step
            length, collection = self._uint(p, 4), self._addr(p + 4)
            if collection is None or length == 0:
                out.append(b"")
                continue
            start, size = self._global_heap(collection)[self._uint(p + 4 + self._O, 4)]
            out.append(self._buf[start:start + min(size, length)])
        return out

    def _global_heap(self, addr: int) -> Dict[int, Tuple[int, int]]:
        if addr not in self._heaps:
            if self._buf[addr:addr + 4] != b"GCOL":
                raise OSError(f"{self.filename}: bad global heap collection at {addr}.")
            end = addr + self._uint(addr + 8, self._L)
            objects, p = {}, addr + 8 + self._L
            while p + 8 + self._L <= end:
                index = self._uint(p, 2)
                size = self._uint(p + 8, self._L)
                if index == 0:
                    break
                objects[index] = (p + 8 + self._L, size)
                p += 8 + self._L + _pad8(size)
            self._heaps[addr] = objects
        return self._heaps[addr]

    def _local_heap(self, addr: int) -> int:
        """The data segment of the local heap at ``addr``."""
        if self._buf[addr:addr + 4] != b"HEAP":
            raise OSError(f"{self.filename}: bad local heap at {addr}.")
        return self._addr(addr + 8 + 2 * self._L)

    # -- groups -------------------------------------------------------------- #
    def _link(self, pos: int) -> Tuple[int, str, Any]:
        """(creation order, name, target) of the link message at ``pos``:
        an object header address, ``("soft", path)``, ``("external", file,
        path)`` or ``("user", type)``."""
        buf = self._buf
        flags = buf[pos + 1]
        p = pos + 2
        kind = order = 0
        if flags & 0x08:
            kind = buf[p]
            p += 1
        if flags & 0x04:
            order = self._uint(p, 8)
            p += 8
        p += 1 if flags & 0x10 else 0
        width = 1 << (flags & 3)
        n = self._uint(p, width)
        name = buf[p + width:p + width + n].decode("utf-8")
        p += width + n
        if kind == 0:
            return order, name, self._addr(p)
        value = buf[p + 2:p + 2 + self._uint(p, 2)]
        if kind == 1:
            return order, name, ("soft", value.decode("utf-8"))
        if kind == 64:
            file_name, obj_path = value[1:].split(b"\0")[:2]
            return order, name, ("external", file_name.decode("utf-8"), obj_path.decode("utf-8"))
        return order, name, ("user", kind)

    def _link_table(self, addr: int) -> Dict[str, Any]:
        """Link name -> target (see :meth:`_link`), in h5py's order:
        creation order where the group tracks it, name order otherwise."""
        if addr in self._link_cache:
            return self._link_cache[addr]
        links = []  # (creation order, name, target)
        tracked = False
        for mtype, _, data, _, _ in self._messages(addr):
            if mtype == _SYMBOL_TABLE:
                btree, names_at = self._addr(data), self._local_heap(self._addr(data + self._O))
                for snod in self._btree_children(btree):
                    if self._buf[snod:snod + 4] != b"SNOD":
                        raise OSError(f"{self.filename}: bad symbol table node at {snod}.")
                    entry = 2 * self._O + 24
                    for i in range(self._uint(snod + 6, 2)):
                        e = snod + 8 + i * entry
                        name, _ = self._cstr(names_at + self._uint(e, self._O))
                        if self._uint(e + 2 * self._O, 4) == 2:  # a soft link: its value in the heap
                            value, _ = self._cstr(names_at + self._uint(e + 2 * self._O + 8, 4))
                            links.append((0, name, ("soft", value)))
                        else:
                            links.append((0, name, self._addr(e + self._O)))
            elif mtype == _LINK:
                links.append(self._link(data))
            elif mtype == _LINK_INFO:
                flags = self._buf[data + 1]
                tracked = bool(flags & 1)
                p = data + 2 + (8 if flags & 1 else 0)
                heap, index = self._addr(p), self._addr(p + self._O)
                if heap is not None:
                    fheap = self._fractal_heap(heap)
                    for record in hx.btree2_records(self, index, 5)[0]:
                        links.append(self._link(fheap.object(record + 4)[0]))
        links.sort(key=lambda link: link[0] if tracked else link[1].encode())
        if tracked:
            self._links_tracked.add(addr)
        self._link_cache[addr] = {name: target for _, name, target in links}
        return self._link_cache[addr]

    def _btree_children(self, addr: int, chunk_rank: int = 0):
        """Leaf children of a version 1 B-tree: symbol table node addresses
        for a group's tree, or ``(chunk offsets, filter mask, size,
        address)`` for a chunk index of ``chunk_rank`` dimensions (the
        dataset's, plus one)."""
        buf = self._buf
        node_type = 1 if chunk_rank else 0
        if buf[addr:addr + 4] != b"TREE" or buf[addr + 4] != node_type:
            raise OSError(f"{self.filename}: bad B-tree node at {addr}.")
        level, entries = buf[addr + 5], self._uint(addr + 6, 2)
        key_size = 8 + 8 * chunk_rank if chunk_rank else self._L
        p = addr + 8 + 2 * self._O
        for i in range(entries):
            key = p + i * (key_size + self._O)
            child = self._addr(key + key_size)
            if level > 0:
                yield from self._btree_children(child, chunk_rank)
            elif not chunk_rank:
                yield child
            else:
                size, mask = struct.unpack_from("<II", buf, key)
                offsets = struct.unpack_from(f"<{chunk_rank}Q", buf, key + 8)
                yield offsets, mask, size, child


class Dataset:
    """A dataset of a read :class:`File`; ``ds[...]`` reads it."""

    def __init__(self, file: File, addr: int, path: str):
        self.file, self._oh, self.name = file, addr, path
        self._chunk_rows: Optional[Dict[int, list]] = None
        self._external: Optional[List[Tuple[str, int, int]]] = None
        self.filters: List[Tuple[int, Tuple[int, ...]]] = []
        self.chunks: Optional[Tuple[int, ...]] = None
        self._shape = self.maxshape = None
        fill = None
        for mtype, mflags, data, _, _ in file._messages(addr):
            if mflags & 0x02 and mtype != _DATATYPE:
                raise file._fail(_SOHM)
            if mtype == _DATASPACE:
                self._shape, self.maxshape = file._dataspace(data)
            elif mtype == _DATATYPE:
                if mflags & 0x02:
                    self.dtype = file._committed_dtype_at(file._shared(data))
                    file._committed_users.add(addr)
                else:
                    self.dtype, _ = file._dtype(data)
            elif mtype == _LAYOUT:
                self._layout(data)
            elif mtype == _FILTERS:
                self._filters(data)
            elif mtype == _EXTERNAL:
                self._external = self._external_slots(data)
            elif mtype == _FILL:
                version, p = file._buf[data], data + 4
                if version == 3:
                    defined, p = file._buf[data + 1] & 0x20, data + 2
                else:
                    defined = file._buf[data + 3]
                if defined:
                    size = file._uint(p, 4)
                    fill = file._bytes(p + 4, size) if size else None
            elif mtype == _FILL_OLD and fill is None:
                size = file._uint(data, 4)
                fill = file._bytes(data + 4, size) if size else None
        self._fill = fill
        # A filter outside the subset is refused when the data is read (the
        # dataset opens, as in h5py).
        self._refused = next((f"the {_FILTER_NAMES.get(fid, fid)} filter ({path})"
                              for fid, _ in self.filters if fid not in _READ_FILTERS), None)

    def _layout(self, pos: int) -> None:
        f = self.file
        version, cls = f._buf[pos], f._buf[pos + 1]
        if version not in (3, 4):
            raise f._fail(f"data layout version {version}")
        self._layout_class = cls
        self._partial_unfiltered = False
        if cls == 0:
            size = f._uint(pos + 2, 2)
            self._compact = (pos + 4, size)
        elif cls == 1:
            self._data_addr = f._addr(pos + 2)
        elif cls == 2 and version == 3:
            rank = f._buf[pos + 2]
            self._index = ("v1 B-tree", f._addr(pos + 3), None)
            dims = struct.unpack_from(f"<{rank}I", f._buf, pos + 3 + f._O)
            self.chunks, self._element_size = tuple(dims[:-1]), dims[-1]
        elif cls == 2:
            flags, rank, width = f._buf[pos + 2], f._buf[pos + 3], f._buf[pos + 4]
            dims = [f._uint(pos + 5 + i * width, width) for i in range(rank)]
            self.chunks, self._element_size = tuple(dims[:-1]), dims[-1]
            self._partial_unfiltered = bool(flags & 1)
            p = pos + 5 + rank * width
            kind, p = f._buf[p], p + 1
            single = None
            if kind == hx.SINGLE and flags & 2:
                single = (f._uint(p, f._L), f._uint(p + f._L, 4))
                p += f._L + 4
            elif not hx.SINGLE <= kind <= hx.BTREE2:
                raise f._fail(f"chunk index type {kind}")
            p += {hx.FIXED_ARRAY: 1, hx.EXTENSIBLE_ARRAY: 5, hx.BTREE2: 6}.get(kind, 0)
            self._index = (kind, f._addr(p), single)
        elif cls == 3:
            raise f._fail(f"virtual datasets ({self.name})")
        else:
            raise f._fail(f"data layout class {cls}")

    def _filters(self, pos: int) -> None:
        f = self.file
        version, count = f._buf[pos], f._buf[pos + 1]
        p = pos + (8 if version == 1 else 2)
        for _ in range(count):
            filter_id = f._uint(p, 2)
            if version == 1 or filter_id >= 256:
                name_len = f._uint(p + 2, 2)
                p += 4
            else:
                name_len = 0
                p += 2
            n_values = f._uint(p + 2, 2)
            p += 4 + (_pad8(name_len) if version == 1 else name_len)
            values = struct.unpack_from(f"<{n_values}I", f._buf, p)
            p += 4 * n_values + (4 if version == 1 and n_values % 2 else 0)
            self.filters.append((filter_id, values))

    def _external_slots(self, pos: int) -> List[Tuple[str, int, int]]:
        """(file name, offset, size) of each slot of an External Data Files
        message; the names are in the local heap it names."""
        f = self.file
        used, names_at = f._uint(pos + 6, 2), f._local_heap(f._addr(pos + 8))
        p = pos + 8 + f._O
        slots = []
        for _ in range(used):
            name, _ = f._cstr(names_at + f._uint(p, f._L))
            slots.append((name, f._uint(p + f._L, f._L), f._uint(p + 2 * f._L, f._L)))
            p += 3 * f._L
        return slots

    def __repr__(self) -> str:
        return f"<HDF5 dataset {self.name!r}: shape {self.shape}, type {self.dtype}>"

    @property
    def shape(self) -> Optional[Tuple[int, ...]]:
        return self._shape

    @property
    def attrs(self) -> Dict[str, Any]:
        return self.file._attr_table(self._oh)

    @property
    def parent(self) -> Group:
        return self.file[posixpath.dirname(self.name) or "/"]

    def __getitem__(self, key):
        """Read the dataset; an int or a step-1 slice on the first axis (with
        any index on the others) reads only the rows it selects."""
        if self._shape is None:
            raise self.file._fail(f"reading a dataset with a null dataspace ({self.name})")
        if not isinstance(key, tuple):
            key = (key,)
        if not self._shape:
            if key not in ((), (Ellipsis,)):
                raise IndexError(f"{self.name} is a scalar dataset: index it with () or ...")
            value = self._rows(0, 1)
            return value[()] if key == () and isinstance(value, np.ndarray) else value
        first, rest = (key[0], key[1:]) if key else (Ellipsis, ())
        if first is not Ellipsis:
            n = self._shape[0]
            if isinstance(first, (int, np.integer)):
                i = int(first) + n if first < 0 else int(first)
                if not 0 <= i < n:
                    raise IndexError(f"Index {int(first)} out of range for {self.name} of {n} rows.")
                return self._rows(i, i + 1)[(0,) + rest]
            if isinstance(first, slice) and first.step in (None, 1):
                start, stop, _ = first.indices(n)
                return self._rows(start, max(start, stop))[(slice(None),) + rest]
        return self._rows(0, self._shape[0])[key]

    def _rows(self, start: int, stop: int) -> np.ndarray:
        """Rows ``[start, stop)`` of the first axis (the whole of a scalar)."""
        f = self.file
        if self._refused:
            raise f._fail(self._refused)
        shape = self._shape
        row_shape = shape[1:] if shape else ()
        out_shape = ((stop - start),) + row_shape if shape else ()
        kind = self.dtype if isinstance(self.dtype, (VlenStr, RefType)) else None
        raw_dtype = self.dtype if kind is None else np.dtype(
            f"V{8 + f._O}" if isinstance(kind, VlenStr) else f"V{f._O}")
        row_items = int(np.prod(row_shape))
        count = (stop - start) * row_items if shape else 1
        itemsize = raw_dtype.itemsize
        if self._layout_class == 2:
            raw = self._read_chunked(start, stop, raw_dtype)
        elif self._layout_class == 0:
            pos, _ = self._compact
            raw = f._bytes(pos + start * row_items * itemsize, count * itemsize)
        elif self._external is not None:
            raw = self._read_external(start * row_items * itemsize, count * itemsize)
        elif self._data_addr is None:
            raw = self._filled(count, raw_dtype)
        else:
            raw = f._bytes(self._data_addr + start * row_items * itemsize, count * itemsize)
        if kind is not None:
            if isinstance(kind, VlenStr):
                values = self._vlen_values(raw, count)
            else:
                values = f._references(raw.tobytes(), count)
            if not shape:
                return values[0]
            out = np.empty(count, dtype=object)
            out[:] = values
            return out.reshape(out_shape)
        arr = np.frombuffer(raw, self.dtype, count)
        return arr.reshape(out_shape + self.dtype.shape)

    def _read_external(self, start: int, n: int) -> np.ndarray:
        """``n`` bytes from byte ``start`` of the data held in external raw
        data files, their names relative to the working directory (libhdf5's
        default); a missing or short file raises ``OSError`` naming it."""
        out = bytearray()
        unlimited = (1 << (8 * self.file._L)) - 1
        at = 0  # the slot's first byte in the dataset's data
        for name, offset, size in self._external:
            end = float("inf") if size == unlimited else at + size
            pos = start + len(out)
            if len(out) < n and pos < end:
                want = int(min(n - len(out), end - pos))
                try:
                    with open(name, "rb") as fh:
                        fh.seek(offset + pos - at)
                        data = fh.read(want)
                except OSError as e:
                    raise OSError(f"{self.file.filename}: {self.name}: cannot open its external raw data "
                                  f"file {name!r} ({e.strerror}).") from e
                if len(data) < want:
                    raise OSError(f"{self.file.filename}: {self.name}: its external raw data file {name!r} "
                                  f"ends {want - len(data)} bytes short of the dataset.")
                out += data
            at = end
        if len(out) < n:
            raise OSError(f"{self.file.filename}: {self.name}: its external files hold less than its data.")
        return np.frombuffer(bytes(out), np.uint8)

    def _vlen_values(self, raw: np.ndarray, count: int) -> List[bytes]:
        """Heap IDs read into a buffer -> the strings they point at."""
        f = self.file
        out = []
        data = raw.tobytes()
        step = 8 + f._O
        for i in range(count):
            length = int.from_bytes(data[i * step:i * step + 4], "little")
            collection = int.from_bytes(data[i * step + 4:i * step + 4 + f._O], "little")
            index = int.from_bytes(data[i * step + 4 + f._O:(i + 1) * step], "little")
            if length == 0 or collection == (1 << (8 * f._O)) - 1:
                out.append(b"")
                continue
            start, size = f._global_heap(collection + f._base)[index]
            out.append(f._buf[start:start + min(size, length)])
        return out

    def _filled(self, count: int, dtype: np.dtype) -> np.ndarray:
        if self._fill is None:
            return np.zeros(count * dtype.itemsize, np.uint8)
        return np.tile(self._fill, count)

    def _chunk_entries(self) -> List[Tuple[Tuple[int, ...], int, int, int]]:
        """(element offsets, filter mask, stored size, address) of every
        written chunk, from the dataset's chunk index."""
        f = self.file
        kind, addr, single = self._index
        chunks, shape = self.chunks, self._shape or (1,)
        rank = len(chunks)
        chunk_bytes = int(np.prod(chunks)) * self._element_size
        if addr is None:
            return []
        if kind == "v1 B-tree":
            return [(o[:rank], m, s, a) for o, m, s, a in f._btree_children(addr, rank + 1)]
        if kind == hx.SINGLE:
            size, mask = single if single else (chunk_bytes, 0)
            return [((0,) * rank, mask, size, addr)]
        if kind == hx.BTREE2:
            return [(tuple(s * c for s, c in zip(scaled, chunks)), m, size, a)
                    for scaled, m, size, a in hx.btree2_chunks(f, addr, bool(self.filters), rank, chunk_bytes)]
        grid = np.indices([-(-n // c) for n, c in zip(shape, chunks)]).reshape(rank, -1).T
        top = self.maxshape or shape
        max_chunks = [None if m is None else -(-m // c) for m, c in zip(top, chunks)]
        unlimited = next((d for d, m in enumerate(top) if m is None), None)
        index = hx.linear_index(grid, max_chunks, unlimited)
        if kind == hx.IMPLICIT:
            return [(tuple(int(s) * c for s, c in zip(scaled, chunks)), 0, chunk_bytes, addr + int(i) * chunk_bytes)
                    for scaled, i in zip(grid, index)]
        read = hx.fixed_array if kind == hx.FIXED_ARRAY else hx.extensible_array
        elements = read(f, addr, bool(self.filters), chunk_bytes)
        out = []
        for scaled, i in zip(grid.tolist(), index.tolist()):
            if i >= len(elements.addr) or elements.addr[i] == hx.UNDEFINED:
                continue
            out.append((tuple(s * c for s, c in zip(scaled, chunks)), int(elements.mask[i]),
                        int(elements.size[i]), int(elements.addr[i]) + f._base))
        return out

    def _decode_chunk(self, offsets, mask: int, size: int, addr: int, dtype: np.dtype) -> bytes:
        """A chunk's bytes through the filter pipeline, in reverse, skipping
        the filters its mask marks (and all of them for a partial edge chunk
        where the layout says so)."""
        f = self.file
        if addr + size > len(f._buf):
            raise OSError(f"{f.filename}: truncated file (chunk of {self.name} at {addr}).")
        raw = f._buf[addr:addr + size]
        n_items = int(np.prod(self.chunks))
        chunk_bytes = n_items * dtype.itemsize
        if self._partial_unfiltered and any(o + c > n for o, c, n in zip(offsets, self.chunks, self._shape)):
            mask = ~0
        for i, (filter_id, values) in reversed(list(enumerate(self.filters))):
            if mask & (1 << i):
                continue
            if filter_id == _DEFLATE:
                raw = zlib.decompress(raw)
            elif filter_id == _SHUFFLE:
                raw = _unshuffle(raw, values[0] if values else dtype.itemsize)
            elif filter_id == _FLETCHER32:
                stored = int.from_bytes(raw[-4:], "little")
                raw = raw[:-4]
                computed = fletcher32(raw)
                swapped = ((computed & 0x00FF00FF) << 8) | ((computed >> 8) & 0x00FF00FF)
                if stored not in (computed, swapped):
                    raise OSError(f"{f.filename}: {self.name}: data error detected by the Fletcher-32 "
                                  f"checksum (chunk at {tuple(offsets)}).")
            elif filter_id == _SCALEOFFSET:
                raw = _scaleoffset_decode(raw, values, lambda what: f._fail(f"{what} ({self.name})"))
            else:
                raw = f._lzf(raw, values[2] if len(values) > 2 and values[2] else chunk_bytes)
        if len(raw) < chunk_bytes:
            raise OSError(f"{f.filename}: {self.name}: the chunk at {tuple(offsets)} holds {len(raw)} "
                          f"bytes, not {chunk_bytes}.")
        return raw

    def _read_chunked(self, start: int, stop: int, dtype: np.dtype) -> np.ndarray:
        shape = self._shape or (1,)
        chunks = self.chunks
        if self._chunk_rows is None:
            self._chunk_rows = {}
            for entry in self._chunk_entries():
                self._chunk_rows.setdefault(entry[0][0] // chunks[0], []).append(entry)
        out_shape = (stop - start,) + tuple(shape[1:])
        out = self._filled(int(np.prod(out_shape)), dtype).view(dtype).reshape(out_shape)
        flat = out.reshape(-1).view(np.uint8)
        for row in range(start // chunks[0], -(-stop // chunks[0])):
            for offsets, mask, size, addr in self._chunk_rows.get(row, ()):
                raw = self._decode_chunk(offsets, mask, size, addr, dtype)
                block = np.frombuffer(raw, dtype, int(np.prod(chunks))).reshape(chunks)
                src, dst = [], []
                for d, (o, c, n) in enumerate(zip(offsets, chunks, shape)):
                    a, b = (max(o, start), min(o + c, stop)) if d == 0 else (o, min(o + c, n))
                    src.append(slice(a - o, b - o))
                    dst.append(slice(a - start, b - start) if d == 0 else slice(a, b))
                out[tuple(dst)] = block[tuple(src)]
        return flat


# --------------------------------------------------------------------------- #
# Writer
# --------------------------------------------------------------------------- #

_UNDEF = (1 << 64) - 1
_LEAF_K, _INTERNAL_K = 4, 16  # h5py's group B-tree parameters
_CHUNK_K = 32  # HDF5's chunk B-tree K, fixed for superblock version 0
_SNOD_SIZE = 8 + 2 * _LEAF_K * 40
_TREE_SIZE = 24 + (2 * _INTERNAL_K + 1) * 8 + 2 * _INTERNAL_K * 8


def _encode_dtype(dt: np.dtype) -> bytes:
    """A version 1 datatype message for ``dt``, as h5py encodes it."""
    order = 1 if dt.byteorder == ">" else 0
    if dt.names is not None:
        body = b""
        for name in dt.names:
            member, offset = dt.fields[name][:2]
            encoded = name.encode() + b"\0"
            body += encoded.ljust(_pad8(len(encoded)), b"\0")
            body += struct.pack("<I28x", offset) + _encode_dtype(member)
        return struct.pack("<BHxI", 0x16, len(dt.names), dt.itemsize) + body
    if dt.kind == "b":
        base = struct.pack("<BBxxIHH", 0x10, 0x08, 1, 0, 8)
        names = b"FALSE\0\0\0TRUE\0\0\0\0"
        return struct.pack("<BHxI", 0x18, 2, 1) + base + names + b"\x00\x01"
    if dt.kind in "iu":
        return struct.pack("<BBxxIHH", 0x10, order | (8 if dt.kind == "i" else 0), dt.itemsize, 0,
                           8 * dt.itemsize)
    if dt.kind == "f":
        exp, mant, bias = {2: (5, 10, 15), 4: (8, 23, 127), 8: (11, 52, 1023)}[dt.itemsize]
        bits = 8 * dt.itemsize
        return struct.pack("<BBBxIHHBBBBI", 0x11, order | 0x20, bits - 1, dt.itemsize, 0, bits,
                           mant, exp, 0, mant, bias)
    if dt.kind == "S":
        return struct.pack("<BBxxI", 0x13, 1, dt.itemsize)  # null-padded, ASCII
    raise TypeError(f"Cannot write a dataset or attribute of dtype {dt} to HDF5.")


def _encode_dataspace(shape: Tuple[int, ...]) -> bytes:
    return struct.pack("<BBBx4x", 1, len(shape), 0) + struct.pack(f"<{len(shape)}Q", *shape)


def _message(mtype: int, data: bytes) -> Tuple[int, bytes]:
    data = data.ljust(_pad8(len(data)), b"\0")
    if len(data) > 0xFFFF:
        raise ValueError(f"An HDF5 object header message of {len(data)} bytes exceeds 64 KiB.")
    return mtype, data


def _lookup3(data: bytes) -> int:
    """Jenkins' lookup3 hash with an initial value of 0: the checksum of
    HDF5's version 2 metadata (``H5_checksum_lookup3``)."""
    m = 0xFFFFFFFF

    def rot(x: int, k: int) -> int:
        return ((x << k) | (x >> (32 - k))) & m

    a = b = c = (0xDEADBEEF + len(data)) & m
    tail = len(data) % 12 or (12 if data else 0)
    words = np.frombuffer(data[:len(data) - tail], "<u4").tolist()
    for i in range(0, len(words), 3):  # mix
        a, b, c = (a + words[i]) & m, (b + words[i + 1]) & m, (c + words[i + 2]) & m
        for x, y, z, k in ((0, 2, 1, 4), (1, 0, 2, 6), (2, 1, 0, 8), (0, 2, 1, 16), (1, 0, 2, 19), (2, 1, 0, 4)):
            v = [a, b, c]
            v[x] = ((v[x] - v[y]) & m) ^ rot(v[y], k)
            v[y] = (v[y] + v[z]) & m
            a, b, c = v
    if not tail:
        return c
    x, y, z = np.frombuffer(data[len(data) - tail:].ljust(12, b"\0"), "<u4").tolist()
    v = [(a + x) & m, (b + y) & m, (c + z) & m]
    for x, y, k in ((2, 1, 14), (0, 2, 11), (1, 0, 25), (2, 1, 16), (0, 2, 4), (1, 0, 14), (2, 1, 24)):  # final
        v[x] = ((v[x] ^ v[y]) - rot(v[y], k)) & m
    return v[2]


_CHUNK_BASE, _CHUNK_MIN, _CHUNK_MAX = 16 * 1024, 8 * 1024, 1024 * 1024


def guess_chunk(shape: Tuple[int, ...], itemsize: int) -> Tuple[int, ...]:
    """The chunk shape h5py picks for a dataset it chunks on its own
    (h5py's ``filters.guess_chunk``): halve the axes in turn until a chunk
    is near a target size that grows with the dataset's."""
    chunks = np.array([n if n != 0 else 1024 for n in shape], dtype="=f8")
    if len(chunks) == 0:
        raise ValueError("Chunks not allowed for scalar datasets.")
    target = _CHUNK_BASE * (2 ** np.log10(np.prod(chunks) * itemsize / (1024.0 * 1024)))
    target = min(max(target, _CHUNK_MIN), _CHUNK_MAX)
    idx = 0
    while True:
        chunk_bytes = np.prod(chunks) * itemsize
        if (chunk_bytes < target or abs(chunk_bytes - target) / target < 0.5) and chunk_bytes < _CHUNK_MAX:
            break
        if np.prod(chunks) == 1:
            break
        chunks[idx % len(chunks)] = np.ceil(chunks[idx % len(chunks)] / 2.0)
        idx += 1
    return tuple(int(x) for x in chunks)


# A variable-length UTF-8 string: class 9 (sequence type 1, null-terminated,
# charset 1) of 16-byte heap IDs, over a 1-byte unsigned base type.
_VLEN_STR_TYPE = struct.pack("<BBBBI", 0x19, 0x01, 0x01, 0x00, 16) + struct.pack(
    "<BBxxIHH", 0x10, 0, 1, 0, 8)


def _is_vlen(data: Any) -> bool:
    return isinstance(data, str) or (isinstance(data, np.ndarray) and data.dtype == object)


def _as_array(value: Any) -> np.ndarray:
    if isinstance(value, str):
        value = value.encode("utf-8")
    if isinstance(value, bytes):
        return np.array(np.bytes_(value) if value else np.bytes_(b"\0"))
    if isinstance(value, bool):
        return np.array(value)
    if isinstance(value, int):
        return np.array(value, np.int64)
    if isinstance(value, float):
        return np.array(value, np.float64)
    return np.asarray(value)


class WritableGroup:
    """A group being built by :class:`Writer`. With ``track_order`` its
    links and attributes keep the order they were added in (creation
    order, as h5py's ``track_order=True``); otherwise readers list them by
    name."""

    def __init__(self, track_order: bool = False):
        self.children: Dict[str, Any] = {}
        self.attrs: Dict[str, Any] = {}
        self.track_order = track_order

    def _parent_of(self, name: str) -> Tuple["WritableGroup", str]:
        """The group that holds ``name`` (made where missing), and its last part."""
        parts = [p for p in name.split("/") if p]
        group = self
        for part in parts[:-1]:
            group = group.children.setdefault(part, WritableGroup())
        return group, parts[-1]

    def require_group(self, name: str) -> "WritableGroup":
        parent, leaf = self._parent_of(name)
        return parent.children.setdefault(leaf, WritableGroup())

    def create_dataset(self, name: str, data: Optional[np.ndarray] = None, shape=None, dtype=None,
                       compression: Optional[str] = "gzip", compression_opts: Optional[int] = 4,
                       chunks: Optional[Tuple[int, ...]] = None) -> "WritableDataset":
        """A dataset of ``data``, or of zeros of ``shape`` and ``dtype`` to
        fill by assignment. ``compression`` "gzip" (deflate at level
        ``compression_opts``) or ``chunks`` make it chunked; ``None`` and no
        chunks, contiguous. A ``str``, or an object array of them, is a
        dataset of variable-length UTF-8 strings, always contiguous."""
        parent, leaf = self._parent_of(name)
        if leaf in parent.children:
            raise ValueError(f"{name!r} already exists.")
        if compression not in (None, "gzip"):
            raise ValueError(f"Compression {compression!r} is not supported (gzip or None).")
        if _is_vlen(data):
            strings = np.array(data, dtype=object)
            if not all(isinstance(v, str) for v in strings.reshape(-1)):
                raise TypeError(f"{name!r}: an object array must hold str (variable-length strings).")
            if chunks is not None:
                raise ValueError(f"{name!r}: variable-length strings are written contiguous.")
            parent.children[leaf] = WritableDataset(strings)
            return parent.children[leaf]
        if data is None:
            if shape is None:
                raise ValueError(f"{name!r}: give data, or a shape and dtype.")
            data = np.zeros(shape, np.dtype(dtype if dtype is not None else "f4"))
        else:
            data = np.asarray(data, dtype=dtype)
            if shape is not None and tuple(shape) != data.shape:
                raise ValueError(f"{name!r}: data of shape {data.shape} given for shape {tuple(shape)}.")
        _encode_dtype(data.dtype)  # fail now on an unwritable dtype
        level = (4 if compression_opts is None else int(compression_opts)) if compression else None
        parent.children[leaf] = WritableDataset(np.asarray(data, order="C"), level, chunks)
        return parent.children[leaf]


def _default_chunks(shape: Tuple[int, ...], itemsize: int) -> Tuple[int, ...]:
    """One row of the first axis, or as many as make 64 KiB where rows are
    smaller."""
    row = itemsize * int(np.prod(shape[1:], dtype=np.int64))
    rows = max(1, min(shape[0], (64 << 10) // max(row, 1)))
    return (rows,) + tuple(max(1, n) for n in shape[1:])


class WritableDataset:
    """A dataset being built by :class:`Writer`: ``ds[...] = values``
    assigns into its array (as ``dset[i, :n] = row``)."""

    def __init__(self, data: np.ndarray, level: Optional[int] = None,
                 chunks: Optional[Tuple[int, ...]] = None):
        self.data = data
        self.attrs: Dict[str, Any] = {}
        self.track_order = False  # attributes in creation order
        self.level = level
        chunked = (level is not None or chunks is not None) and data.ndim > 0
        if chunked and chunks is None:
            chunks = (_default_chunks(data.shape, data.dtype.itemsize) if data.size
                      else guess_chunk(data.shape, data.dtype.itemsize))
        if chunked and (len(chunks) != data.ndim or min(chunks) < 1):
            raise ValueError(f"Chunks {chunks} do not fit a dataset of shape {data.shape}.")
        self.chunks = tuple(int(c) for c in chunks) if chunked else None

    @property
    def shape(self) -> Tuple[int, ...]:
        return self.data.shape

    @property
    def dtype(self) -> np.dtype:
        return self.data.dtype

    def __setitem__(self, key, value) -> None:
        self.data[key] = value


class Writer(WritableGroup):
    """Builds an HDF5 file in memory and writes it on ``close`` (or on
    leaving a ``with`` block without an exception): the root group. Mode
    "w" starts empty; "a" starts from the file at ``path`` where there is
    one, read for ``device`` (LZF's route, see :class:`File`)."""

    def __init__(self, path: str, mode: str = "w", device="cuda"):
        super().__init__()
        if mode not in ("w", "a"):
            raise ValueError(f"Writer mode {mode!r} is not supported ('w' or 'a').")
        self.filename = str(path)
        if mode == "a" and os.path.exists(self.filename):
            with File(self.filename, device=device) as f:
                _copy_group(f, self)

    def __enter__(self) -> "Writer":
        return self

    def __exit__(self, exc_type, *exc) -> None:
        if exc_type is None:
            self.close()

    def close(self) -> None:
        self._blocks: List[Tuple[int, Any]] = []
        self._eof = 96  # the superblock
        self._heap_ids: Dict[int, List[Tuple[int, int]]] = {}
        self._write_global_heap(self)
        root, stab = self._write_group(self)
        superblock = SIGNATURE + struct.pack("<8BHHI", 0, 0, 0, 0, 0, 8, 8, 0, _LEAF_K, _INTERNAL_K, 0)
        superblock += struct.pack("<4Q", 0, _UNDEF, self._eof, _UNDEF)
        superblock += struct.pack("<QQII2Q", 0, root, 1 if stab else 0, 0, *(stab or (0, 0)))
        self._blocks.append((0, superblock))
        tmp = self.filename + ".tmp"
        with open(tmp, "wb") as fh:
            for addr, data in sorted(self._blocks, key=lambda b: b[0]):
                fh.seek(addr)
                fh.write(data)
            fh.truncate(self._eof)
        os.replace(tmp, self.filename)

    def _reserve(self, size: int) -> int:
        addr = self._eof
        self._eof += _pad8(size)
        return addr

    def _write_global_heap(self, root: WritableGroup) -> None:
        """One global heap collection with every variable-length string of
        the file, as HDF5 writes it: objects from index 1 (empty strings
        too), then the free space (index 0) to at least 4096 bytes; the
        (length, index) pairs of each dataset's strings go to
        ``self._heap_ids[id(dataset)]``, of each attribute's to
        ``self._heap_ids[(id(owner), name)]``."""
        strings, stack, objects = [], [root], []
        while stack:
            group = stack.pop()
            objects.append(group)
            for name in sorted(group.children, key=lambda n: n.encode()):
                child = group.children[name]
                if isinstance(child, WritableGroup):
                    stack.append(child)
                else:
                    objects.append(child)
                    if child.data.dtype == object:
                        strings.append((id(child), child.data.reshape(-1)))
        for obj in objects:
            strings += [((id(obj), name), np.array(value, dtype=object).reshape(-1))
                        for name, value in obj.attrs.items() if _is_vlen(value)]
        if not strings:
            return
        body = bytearray()
        index = 0
        for key, values in strings:
            ids = []
            for value in values:
                encoded = value.encode("utf-8")
                index += 1
                body += struct.pack("<HHIQ", index, 0, 0, len(encoded))
                body += encoded.ljust(_pad8(len(encoded)), b"\0")
                ids.append((len(encoded), index))
            self._heap_ids[key] = ids
        size = max(4096, 16 + len(body) + 16)
        body += struct.pack("<HHIQ", 0, 0, 0, size - 16 - len(body))
        self._heap_addr = self._reserve(size)
        self._blocks.append((self._heap_addr, (b"GCOL" + struct.pack("<B3xQ", 1, size) + bytes(body))
                             .ljust(size, b"\0")))

    def _object_header(self, messages: List[Tuple[int, bytes]], track_order: bool = False) -> int:
        """An object header of ``messages``: version 1, or, for an object
        whose attributes keep their creation order, version 2 with that
        order on each attribute message (and a lookup3 checksum)."""
        if not track_order:
            body = b"".join(struct.pack("<HHB3x", t, len(d), 0) + d for t, d in messages)
            addr = self._reserve(16 + len(body))
            self._blocks.append((addr, struct.pack("<BBHII4x", 1, 0, len(messages), 1, len(body)) + body))
            return addr
        body, order = bytearray(), 0
        for t, d in messages:
            body += struct.pack("<BHBH", t, len(d), 0, order if t == _ATTRIBUTE else 0) + d
            order += t == _ATTRIBUTE
        width = 0 if len(body) < 1 << 8 else 1 if len(body) < 1 << 16 else 2
        block = b"OHDR" + bytes([2, 0x04 | width]) + len(body).to_bytes(1 << width, "little") + body
        block += _lookup3(block).to_bytes(4, "little")
        addr = self._reserve(len(block))
        self._blocks.append((addr, block))
        return addr

    def _attribute_messages(self, owner: Any) -> List[Tuple[int, bytes]]:
        """The attribute messages of ``owner``'s attributes; a ``str`` (or an
        object array of them) is a variable-length UTF-8 string, as h5py
        stores one."""
        out = []
        for name, value in owner.attrs.items():
            encoded = name.encode() + b"\0"
            if _is_vlen(value):
                shape = np.shape(value)
                dtype, space = _VLEN_STR_TYPE, _encode_dataspace(shape)
                raw = b"".join(struct.pack("<IQI", length, self._heap_addr, index)
                               for length, index in self._heap_ids[(id(owner), name)])
            else:
                arr = _as_array(value)
                dtype, space, raw = _encode_dtype(arr.dtype), _encode_dataspace(arr.shape), arr.tobytes()
            data = struct.pack("<BxHHH", 1, len(encoded), len(dtype), len(space))
            for part in (encoded, dtype, space):
                data += part.ljust(_pad8(len(part)), b"\0")
            out.append(_message(_ATTRIBUTE, data + raw))
        return out

    def _write_dataset(self, ds: WritableDataset) -> int:
        data = ds.data
        if ds.chunks is not None:
            return self._write_chunked(ds)
        if data.dtype == object:
            raw = b"".join(struct.pack("<IQI", length, self._heap_addr, index)
                           for length, index in self._heap_ids[id(ds)])
            addr = self._reserve(len(raw)) if raw else _UNDEF
            if raw:
                self._blocks.append((addr, raw))
            messages = [
                _message(_DATASPACE, _encode_dataspace(data.shape)),
                _message(_DATATYPE, _VLEN_STR_TYPE),
                _message(_FILL, struct.pack("<4BI", 2, 2, 0, 1, 0)),  # late, on alloc, defined, empty
                _message(_LAYOUT, struct.pack("<BBQQ", 3, 1, addr, len(raw))),
            ]
            return self._object_header(messages + self._attribute_messages(ds), ds.track_order)
        if data.nbytes:
            addr = self._reserve(data.nbytes)
            self._blocks.append((addr, memoryview(data.reshape(-1).view(np.uint8))))
        else:
            addr = _UNDEF
        messages = [
            _message(_DATASPACE, _encode_dataspace(data.shape)),
            _message(_DATATYPE, _encode_dtype(data.dtype)),
            _message(_FILL, struct.pack("<4B", 2, 2, 2, 0)),  # late, if set, undefined
            _message(_LAYOUT, struct.pack("<BBQQ", 3, 1, addr, data.nbytes)),
        ]
        return self._object_header(messages + self._attribute_messages(ds), ds.track_order)

    def _write_chunked(self, ds: WritableDataset) -> int:
        """Chunks (deflated where the dataset has a level), indexed by a
        version 1 B-tree of node type 1, as HDF5 writes them: each key the
        chunk's stored size, filter mask and offsets (plus a 0 for the
        element), the last key past the last chunk."""
        data, chunks = ds.data, ds.chunks
        rank = data.ndim
        grid = [range(0, n, c) for n, c in zip(data.shape, chunks)]
        entries = []  # (offsets, size, address), in the order of the offsets
        for offsets in np.ndindex(*[len(g) for g in grid]):
            start = tuple(g[i] for g, i in zip(grid, offsets))
            block = data[tuple(slice(o, o + c) for o, c in zip(start, chunks))]
            if block.shape != chunks:  # an edge chunk is stored whole, zero-filled
                full = np.zeros(chunks, data.dtype)
                full[tuple(slice(0, n) for n in block.shape)] = block
                block = full
            raw = np.ascontiguousarray(block).tobytes()
            if ds.level is not None:
                raw = zlib.compress(raw, ds.level)
            addr = self._reserve(len(raw))
            self._blocks.append((addr, raw))
            entries.append((start, len(raw), addr))
        if not entries:  # an empty dataset: no chunk, no index
            return self._chunked_header(ds, _UNDEF)
        key_size = 8 + 8 * (rank + 1)
        node_size = 24 + (2 * _CHUNK_K + 1) * key_size + 2 * _CHUNK_K * 8

        def key(offsets, size=0):
            return struct.pack("<II", size, 0) + struct.pack(f"<{rank + 1}Q", *offsets, 0)

        last = entries[-1][0]
        end_key = key((last[0] + chunks[0],) + tuple(last[1:]))
        # Leaves hold (first key, child, size) runs; internal levels key each
        # child node by its first key.
        level = [(key(o, size), addr) for o, size, addr in entries]
        depth = 0
        while True:
            groups = [level[i:i + 2 * _CHUNK_K] for i in range(0, len(level), 2 * _CHUNK_K)]
            addrs = [self._reserve(node_size) for _ in groups]
            nodes = []
            for n, children in enumerate(groups):
                left = addrs[n - 1] if n else _UNDEF
                right = addrs[n + 1] if n + 1 < len(addrs) else _UNDEF
                block = bytearray(b"TREE" + struct.pack("<BBHQQ", 1, depth, len(children), left, right))
                for k, child in children:
                    block += k + struct.pack("<Q", child)
                block += groups[n + 1][0][0] if n + 1 < len(groups) else end_key
                self._blocks.append((addrs[n], bytes(block.ljust(node_size, b"\0"))))
                nodes.append((children[0][0], addrs[n]))
            if len(nodes) == 1:
                btree = nodes[0][1]
                break
            level, depth = nodes, depth + 1
        return self._chunked_header(ds, btree)

    def _chunked_header(self, ds: WritableDataset, btree: int) -> int:
        data, chunks, rank = ds.data, ds.chunks, ds.data.ndim
        layout = struct.pack("<BBBQ", 3, 2, rank + 1, btree)
        layout += struct.pack(f"<{rank + 1}I", *chunks, data.dtype.itemsize)
        messages = [
            _message(_DATASPACE, _encode_dataspace(data.shape)),
            _message(_DATATYPE, _encode_dtype(data.dtype)),
            _message(_FILL, struct.pack("<4B", 2, 3, 2, 0)),  # incremental, if set, undefined
            _message(_LAYOUT, layout),
        ]
        if ds.level is not None:  # deflate, optional, one value: the level; padded to 8 bytes
            pipeline = struct.pack("<BB6x", 1, 1) + struct.pack("<HHHH", 1, 0, 1, 1)
            messages.append(_message(_FILTERS, pipeline + struct.pack("<I4x", ds.level)))
        return self._object_header(messages + self._attribute_messages(ds), ds.track_order)

    def _write_group(self, group: WritableGroup) -> Tuple[int, Optional[Tuple[int, int]]]:
        """Write a group and everything in it; return its object header
        address and its (B-tree, local heap) addresses, None for a group in
        creation order (link info, group info and a link message a member,
        each with its creation order)."""
        names = list(group.children) if group.track_order else sorted(group.children, key=lambda n: n.encode())
        entries = []
        for name in names:
            child = group.children[name]
            if isinstance(child, WritableGroup):
                addr, stab = self._write_group(child)
                entries.append((addr, 1 if stab else 0, stab or (0, 0)))
            else:
                entries.append((self._write_dataset(child), 0, (0, 0)))
        if group.track_order:
            messages = [_message(_LINK_INFO, struct.pack("<BBQQQ", 0, 1, len(names), _UNDEF, _UNDEF)),
                        _message(_GROUP_INFO, struct.pack("<BB", 0, 0))]
            for order, (name, (addr, _, _)) in enumerate(zip(names, entries)):
                encoded = name.encode()
                wide = len(encoded) > 0xFF  # the name's length in 2 bytes, not 1
                messages.append(_message(_LINK, struct.pack("<BBQB", 1, 0x14 | wide, order, 1)
                                         + len(encoded).to_bytes(2 if wide else 1, "little") + encoded
                                         + struct.pack("<Q", addr)))
            return self._object_header(messages + self._attribute_messages(group), True), None

        heap, offsets = bytearray(8), []  # offset 0 is the empty name
        for name in names:
            offsets.append(len(heap))
            encoded = name.encode() + b"\0"
            heap += encoded.ljust(_pad8(len(encoded)), b"\0")
        free = len(heap)
        heap += struct.pack("<QQ", 1, 16)  # the free block, last of its list
        heap_addr = self._reserve(32)
        segment = self._reserve(len(heap))
        self._blocks.append((heap_addr, b"HEAP" + struct.pack("<B3xQQQ", 0, len(heap), free, segment)))
        self._blocks.append((segment, bytes(heap)))

        # Symbol table nodes of up to 2 * leaf K entries, keyed by the
        # heap offset of their last name.
        level: List[Tuple[int, int, int]] = []  # (address, first key, last key)
        for i in range(0, len(entries), 2 * _LEAF_K):
            snod = self._reserve(_SNOD_SIZE)
            block = bytearray(b"SNOD" + struct.pack("<BxH", 1, len(entries[i:i + 2 * _LEAF_K])))
            for j, (addr, cache, stab) in enumerate(entries[i:i + 2 * _LEAF_K]):
                block += struct.pack("<QQII2Q", offsets[i + j], addr, cache, 0, *stab)
            self._blocks.append((snod, bytes(block.ljust(_SNOD_SIZE, b"\0"))))
            level.append((snod, 0, offsets[min(i + 2 * _LEAF_K, len(entries)) - 1]))
        depth = 0
        while True:
            nodes = []
            groups = [level[i:i + 2 * _INTERNAL_K] for i in range(0, len(level), 2 * _INTERNAL_K)]
            addrs = [self._reserve(_TREE_SIZE) for _ in groups or [[]]]
            for n, children in enumerate(groups or [[]]):
                left = addrs[n - 1] if n else _UNDEF
                right = addrs[n + 1] if n + 1 < len(addrs) else _UNDEF
                block = bytearray(b"TREE" + struct.pack("<BBHQQ", 0, depth, len(children), left, right))
                block += struct.pack("<Q", groups[n - 1][-1][2] if n else 0)
                for addr, _, last in children:
                    block += struct.pack("<QQ", addr, last)
                self._blocks.append((addrs[n], bytes(block.ljust(_TREE_SIZE, b"\0"))))
                nodes.append((addrs[n], 0, children[-1][2] if children else 0))
            if len(nodes) == 1:
                btree = nodes[0][0]
                break
            level, depth = nodes, depth + 1

        messages = [_message(_SYMBOL_TABLE, struct.pack("<QQ", btree, heap_addr))]
        return self._object_header(messages + self._attribute_messages(group)), (btree, heap_addr)


def _copy_attrs(src, dst) -> None:
    """``src``'s attributes into ``dst``, in their order; references and
    committed datatypes raise."""
    f = src.file
    attrs = src.attrs
    for name, value in attrs.items():
        if isinstance(value, Reference) or (isinstance(value, np.ndarray) and value.dtype == object
                                            and any(isinstance(v, Reference) for v in value.flat)):
            raise f._fail(f"appending to a file with object references (attribute {name!r} of {src.name})")
    if src._oh in f._committed_users:
        raise f._fail(f"appending to a file with committed datatypes ({src.name})")
    dst.attrs.update(attrs)
    dst.track_order = dst.track_order or src._oh in f._attr_tracked


def _copy_group(src: Group, dst: WritableGroup) -> None:
    """Everything under ``src`` (a read group) into ``dst``: subgroups, in
    their order (creation order where ``src`` tracks it), datasets with
    their chunking and deflate level (level 4 for a dataset that lzf,
    scale-offset or fletcher32 filtered, which the writer does not write),
    and attributes. Soft and external links, object references and
    committed datatypes raise :class:`UnsupportedFeature`: the writer
    writes none of them, and drops nothing."""
    f = src.file
    members = src._members
    dst.track_order = src._oh in f._links_tracked
    _copy_attrs(src, dst)
    for name, target in members.items():
        where = posixpath.join(src.name, name)
        if isinstance(target, tuple):
            raise f._fail(f"appending to a file with {target[0]} links ({where})")
        obj = src[name]
        if isinstance(obj, Datatype):
            raise f._fail(f"appending to a file with committed datatypes ({where})")
        if isinstance(obj, Group):
            _copy_group(obj, dst.require_group(name))
            continue
        if isinstance(obj.dtype, RefType):
            raise f._fail(f"appending to a file with object references ({where})")
        data = obj[()] if obj.shape == () else obj[...]
        if isinstance(obj.dtype, VlenStr):
            strings = np.array(data, dtype=object)
            for i, v in enumerate(strings.reshape(-1)):
                strings.reshape(-1)[i] = v.decode("utf-8")
            ds = dst.create_dataset(name, data=strings if obj.shape != () else strings[()], compression=None)
        else:
            levels = [values[0] if values else 4 for fid, values in obj.filters if fid == _DEFLATE]
            if not levels and any(fid in (_LZF, _SCALEOFFSET, _FLETCHER32) for fid, _ in obj.filters):
                levels = [4]
            ds = dst.create_dataset(name, data=data, compression="gzip" if levels else None,
                                    compression_opts=levels[0] if levels else None, chunks=obj.chunks)
        _copy_attrs(obj, ds)

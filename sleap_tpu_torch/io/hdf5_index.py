"""The indexed structures of HDF5 that :mod:`sleap_tpu_torch.io.hdf5` reads
in files written with ``libver="latest"`` (and by SWMR writers), after the
HDF5 file format specification, version 3:

- version 2 B-trees (``BTHD``, ``BTIN``, ``BTLF``) at any depth:
  :func:`btree2_records` gives the positions of their records in order;
- fractal heaps (``FRHP``, ``FHIB``, ``FHDB``): :class:`FractalHeap` finds
  a heap ID's object (managed, in direct blocks under nested indirect
  blocks; tiny, inside the ID; huge, through a type 1 B-tree);
- the data layout version 4 chunk indexes: single chunk, implicit, fixed
  array (``FAHD``, ``FADB``, paged), extensible array (``EAHD``, ``EAIB``,
  ``EASB``, ``EADB``, paged) and version 2 B-tree (records 10 and 11):
  :func:`fixed_array` and :func:`extensible_array` give their elements in
  index order (:func:`linear_index` maps a chunk to its element),
  :func:`btree2_chunks` the chunks a B-tree lists.

Every function takes the reading :class:`~sleap_tpu_torch.io.hdf5.File`
(its mapped buffer and its address and length widths) and gives positions
in that buffer, so an object read from a heap is parsed where it lies.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Dict, List, Optional, Tuple

import numpy as np

if TYPE_CHECKING:  # pragma: no cover
    from sleap_tpu_torch.io.hdf5 import File

UNDEFINED = np.uint64(0xFFFFFFFFFFFFFFFF)


def _log2(n: int) -> int:
    """floor(log2(n)) for n > 0 (``H5VM_log2_gen``)."""
    return int(n).bit_length() - 1


def _enc_size(n: int) -> int:
    """Bytes that encode values up to ``n`` (``H5VM_limit_enc_size``)."""
    return _log2(n) // 8 + 1


def _le(cols: np.ndarray) -> np.ndarray:
    """Little-endian unsigned integers from the (n, k) uint8 columns."""
    out = np.zeros(len(cols), np.uint64)
    for k in range(cols.shape[1] - 1, -1, -1):
        out = (out << np.uint64(8)) | cols[:, k].astype(np.uint64)
    return out


def _expect(f: "File", addr: int, signature: bytes) -> None:
    if addr is None or f._buf[addr:addr + 4] != signature:
        raise OSError(f"{f.filename}: bad {signature.decode()} block at {addr}.")


# --------------------------------------------------------------------------- #
# Version 2 B-trees
# --------------------------------------------------------------------------- #


def btree2_records(f: "File", addr: int, record_type: int) -> Tuple[List[int], int]:
    """Positions of the records of the version 2 B-tree at ``addr``, in the
    tree's order, and the record size. The widths of an internal node's
    child pointers come from the node and record sizes, as
    ``H5B2__hdr_init`` computes them."""
    _expect(f, addr, b"BTHD")
    if f._buf[addr + 5] != record_type:
        raise OSError(f"{f.filename}: B-tree at {addr} holds type {f._buf[addr + 5]} records, "
                      f"not {record_type}.")
    node_size, record_size, depth = f._uint(addr + 6, 4), f._uint(addr + 10, 2), f._uint(addr + 12, 2)
    root = f._addr(addr + 16)
    if root is None:
        return [], record_size
    root_count = f._uint(addr + 16 + f._O, 2)
    leaf_max = (node_size - 10) // record_size
    count_size = _enc_size(leaf_max)
    total_max, total_size = [leaf_max], [0]
    for d in range(1, depth + 1):
        pointer = f._O + count_size + (total_size[d - 1] if d > 1 else 0)
        most = (node_size - (10 + pointer)) // (record_size + pointer)
        total_max.append((most + 1) * total_max[d - 1] + most)
        total_size.append(_enc_size(total_max[d]))
    out: List[int] = []

    def walk(node: int, count: int, d: int) -> None:
        _expect(f, node, b"BTIN" if d else b"BTLF")
        records = node + 6
        if d == 0:
            out.extend(records + i * record_size for i in range(count))
            return
        p = records + count * record_size
        pointer = f._O + count_size + (total_size[d - 1] if d > 1 else 0)
        for i in range(count + 1):
            q = p + i * pointer
            walk(f._addr(q), f._uint(q + f._O, count_size), d - 1)
            if i < count:
                out.append(records + i * record_size)

    walk(root, root_count, depth)
    return out, record_size


# --------------------------------------------------------------------------- #
# Fractal heaps
# --------------------------------------------------------------------------- #


class FractalHeap:
    """A fractal heap: :meth:`object` turns a heap ID into the position and
    length of its object in the file."""

    def __init__(self, f: "File", addr: int):
        _expect(f, addr, b"FRHP")
        self.f = f
        O, L = f._O, f._L
        self.id_len = f._uint(addr + 5, 2)
        if f._uint(addr + 7, 2):
            raise f._fail("fractal heaps with I/O filters")
        max_managed = f._uint(addr + 10, 4)
        self._huge_btree = f._addr(addr + 14 + L)
        p = addr + 14 + 10 * L + 2 * O
        self.width = f._uint(p, 2)
        self.start = f._uint(p + 2, L)
        max_direct = f._uint(p + 2 + L, L)
        max_heap_bits = f._uint(p + 2 + 2 * L, 2)
        self.root = f._addr(p + 6 + 2 * L)
        self.root_rows = f._uint(p + 6 + 2 * L + O, 2)
        start_bits = _log2(self.start)
        self.first_row_bits = start_bits + _log2(self.width)
        self.max_direct_rows = _log2(max_direct) - start_bits + 2
        self.off_size = (max_heap_bits + 7) // 8
        self.len_size = min((_log2(max_direct) + 7) // 8, _enc_size(max_managed))
        self._huge: Optional[Dict[int, Tuple[int, int]]] = None

    def _row_size(self, row: int) -> int:
        return self.start if row == 0 else self.start << (row - 1)

    def _lookup(self, off: int) -> Tuple[int, int]:
        """(row, column) of heap offset ``off`` in the doubling table."""
        if off < self.start * self.width:
            return 0, off // self.start
        high = _log2(off)
        row = high - self.first_row_bits + 1
        return row, (off - (1 << high)) // self._row_size(row)

    def _managed(self, off: int) -> int:
        f = self.f
        if self.root is None:
            raise OSError(f"{f.filename}: heap object at offset {off} of an empty heap.")
        if self.root_rows == 0:  # the root is a direct block
            return self.root + off
        block = self.root
        row, col = self._lookup(off)
        while row >= self.max_direct_rows:
            _expect(f, block, b"FHIB")
            child = f._addr(block + 5 + f._O + self.off_size + (row * self.width + col) * f._O)
            _expect(f, child, b"FHIB")
            block = child
            row, col = self._lookup(off - f._uint(block + 5 + f._O, self.off_size))
        _expect(f, block, b"FHIB")
        direct = f._addr(block + 5 + f._O + self.off_size + (row * self.width + col) * f._O)
        _expect(f, direct, b"FHDB")
        return direct + off - f._uint(direct + 5 + f._O, self.off_size)

    def _huge_objects(self) -> Dict[int, Tuple[int, int]]:
        """Huge object ID -> (address, length), from the type 1 B-tree."""
        if self._huge is None:
            f = self.f
            self._huge = {}
            if self._huge_btree is not None:
                records, _ = btree2_records(f, self._huge_btree, 1)
                for r in records:
                    self._huge[f._uint(r + f._O + f._L, f._L)] = (f._addr(r), f._uint(r + f._O, f._L))
        return self._huge

    def object(self, pos: int) -> Tuple[int, int]:
        """(position, length) of the object whose heap ID starts at ``pos``."""
        f = self.f
        kind = (f._buf[pos] >> 4) & 3
        if kind == 0:
            off = f._uint(pos + 1, self.off_size)
            return self._managed(off), f._uint(pos + 1 + self.off_size, self.len_size)
        if kind == 2:  # tiny: the object is in the ID
            if self.id_len - 1 <= 16:
                return pos + 1, (f._buf[pos] & 0x0F) + 1
            return pos + 2, (((f._buf[pos] & 0x0F) << 8) | f._buf[pos + 1]) + 1
        if kind == 1:
            if f._O + f._L <= self.id_len - 1:  # the ID holds the address and length
                return f._addr(pos + 1), f._uint(pos + 1 + f._O, f._L)
            key = f._uint(pos + 1, min(self.id_len - 1, 8))
            if key not in self._huge_objects():
                raise OSError(f"{f.filename}: huge heap object {key} is not in its B-tree.")
            return self._huge_objects()[key]
        raise OSError(f"{f.filename}: bad fractal heap ID at {pos}.")


# --------------------------------------------------------------------------- #
# Chunk indexes of data layout version 4
# --------------------------------------------------------------------------- #

# Chunk index types of the data layout message, version 4.
SINGLE, IMPLICIT, FIXED_ARRAY, EXTENSIBLE_ARRAY, BTREE2 = 1, 2, 3, 4, 5


class Elements:
    """Chunk index elements in linear index order: addresses (``UNDEFINED``
    where a chunk was never written), stored sizes and filter masks."""

    def __init__(self, addr: np.ndarray, size: np.ndarray, mask: np.ndarray):
        self.addr, self.size, self.mask = addr, size, mask

    @staticmethod
    def concat(parts: List["Elements"]) -> "Elements":
        if not parts:
            empty = np.zeros(0, np.uint64)
            return Elements(empty, empty, empty)
        return Elements(*(np.concatenate([getattr(p, k) for p in parts]) for k in ("addr", "size", "mask")))


def _elements(f: "File", pos: int, n: int, esize: int, filtered: bool, chunk_bytes: int) -> Elements:
    """``n`` array elements of ``esize`` bytes at ``pos``: an address, then
    (filtered) the stored size and the filter mask."""
    raw = np.frombuffer(f._buf, np.uint8, n * esize, pos).reshape(n, esize)
    addr = _le(raw[:, :f._O])
    if f._O < 8:
        addr[addr == np.uint64((1 << (8 * f._O)) - 1)] = UNDEFINED
    if filtered:
        return Elements(addr, _le(raw[:, f._O:esize - 4]), _le(raw[:, esize - 4:]))
    return Elements(addr, np.full(n, chunk_bytes, np.uint64), np.zeros(n, np.uint64))


def _undefined(n: int) -> Elements:
    return Elements(np.full(n, UNDEFINED, np.uint64), np.zeros(n, np.uint64), np.zeros(n, np.uint64))


def _bit(f: "File", bitmap: int, i: int) -> bool:
    """Bit ``i`` of a page bitmap, most significant bit first (``H5VM_bit_get``)."""
    return bool(f._buf[bitmap + i // 8] & (0x80 >> (i % 8)))


def fixed_array(f: "File", addr: int, filtered: bool, chunk_bytes: int) -> Elements:
    _expect(f, addr, b"FAHD")
    esize, page_bits = f._buf[addr + 6], f._buf[addr + 7]
    n = f._uint(addr + 8, f._L)
    block = f._addr(addr + 8 + f._L)
    if block is None or n == 0:
        return _undefined(n)
    _expect(f, block, b"FADB")
    page = 1 << page_bits
    if n <= page:
        return _elements(f, block + 6 + f._O, n, esize, filtered, chunk_bytes)
    pages = -(-n // page)
    bitmap = block + 6 + f._O
    first = bitmap + (pages + 7) // 8 + 4
    parts = []
    for p in range(pages):
        count = min(page, n - p * page)
        if _bit(f, bitmap, p):
            parts.append(_elements(f, first + p * (page * esize + 4), count, esize, filtered, chunk_bytes))
        else:
            parts.append(_undefined(count))
    return Elements.concat(parts)


def extensible_array(f: "File", addr: int, filtered: bool, chunk_bytes: int) -> Elements:
    """Every element of the extensible array at ``addr`` up to its highest
    index set: the index block's own elements, then the data blocks of each
    super block (the first ones' addresses in the index block, the rest in
    secondary blocks), paged where a data block holds more elements than a
    page."""
    _expect(f, addr, b"EAHD")
    buf, O, L = f._buf, f._O, f._L
    esize, max_bits, iblock_elmts, min_elmts, min_ptrs, page_bits = (buf[addr + k] for k in range(6, 12))
    n = f._uint(addr + 12 + 4 * L, L)  # max index set
    iblock = f._addr(addr + 12 + 6 * L)
    if iblock is None or n == 0:
        return _undefined(n)
    _expect(f, iblock, b"EAIB")
    off_size = (max_bits + 7) // 8
    page = 1 << page_bits
    n_sblks = 1 + max_bits - _log2(min_elmts)
    iblock_sblks = 2 * _log2(min_ptrs)
    n_dblk_addrs = 2 * (min_ptrs - 1)
    p = iblock + 6 + O
    parts = [_elements(f, p, iblock_elmts, esize, filtered, chunk_bytes)]
    dblk_addrs = p + iblock_elmts * esize
    sblk_addrs = dblk_addrs + n_dblk_addrs * O
    got, dblk = iblock_elmts, 0  # elements listed, data blocks of the index block used
    prefix = 10 + O + off_size  # a data block's header and checksum
    for s in range(n_sblks):
        if got >= n:
            break
        count, nelmts = 1 << (s // 2), min_elmts << ((s + 1) // 2)
        paged = nelmts > page
        if s < iblock_sblks:
            if paged:
                raise f._fail("paged data blocks in an extensible array's index block")
            for _ in range(count):
                d = f._addr(dblk_addrs + dblk * O)
                dblk += 1
                if d is None:
                    parts.append(_undefined(nelmts))
                else:
                    _expect(f, d, b"EADB")
                    parts.append(_elements(f, d + 6 + O + off_size, nelmts, esize, filtered, chunk_bytes))
            got += count * nelmts
            continue
        sblock = f._addr(sblk_addrs + (s - iblock_sblks) * O)
        got += count * nelmts
        if sblock is None:
            parts.append(_undefined(count * nelmts))
            continue
        _expect(f, sblock, b"EASB")
        npages = nelmts // page if paged else 0
        bitmap = sblock + 6 + O + off_size
        addrs = bitmap + count * ((npages + 7) // 8)  # a bitmap of whole bytes for each data block
        for i in range(count):
            d = f._addr(addrs + i * O)
            if d is None:
                parts.append(_undefined(nelmts))
                continue
            _expect(f, d, b"EADB")
            if not paged:
                parts.append(_elements(f, d + 6 + O + off_size, nelmts, esize, filtered, chunk_bytes))
                continue
            for pg in range(npages):
                if _bit(f, bitmap, i * npages + pg):
                    parts.append(_elements(f, d + prefix + pg * (page * esize + 4), page, esize,
                                           filtered, chunk_bytes))
                else:
                    parts.append(_undefined(page))
    out = Elements.concat(parts)
    return Elements(out.addr[:n], out.size[:n], out.mask[:n])


def btree2_chunks(f: "File", addr: int, filtered: bool, rank: int, chunk_bytes: int
                  ) -> List[Tuple[Tuple[int, ...], int, int, int]]:
    """(scaled offsets, filter mask, size, address) of each chunk of a
    version 2 B-tree chunk index (records of type 10, or 11 when filtered)."""
    records, record_size = btree2_records(f, addr, 11 if filtered else 10)
    O = f._O
    size_width = record_size - O - 4 - 8 * rank if filtered else 0
    out = []
    for r in records:
        p = r + O + (size_width + 4 if filtered else 0)
        scaled = tuple(f._uint(p + 8 * d, 8) for d in range(rank))
        if filtered:
            out.append((scaled, f._uint(r + O + size_width, 4), f._uint(r + O, size_width), f._addr(r)))
        else:
            out.append((scaled, 0, chunk_bytes, f._addr(r)))
    return out


def linear_index(grid: np.ndarray, max_chunks: List[Optional[int]], unlimited: Optional[int]) -> np.ndarray:
    """Each chunk's index in a fixed or extensible array (or an implicit
    index): row-major over the chunk grid of the dataset's maximum
    dimensions, the unlimited dimension (an extensible array's) moved first
    (``H5VM_swizzle_coords``)."""
    order = list(range(grid.shape[1]))
    if unlimited:
        order = [unlimited] + [d for d in order if d != unlimited]
    index = np.zeros(len(grid), np.int64)
    for d in order:
        index = index * (max_chunks[d] or 1) + grid[:, d]
    return index

"""A Zstandard decoder (RFC 8878) in pure Python, with XXH64.

The port reads orbax checkpoints, whose key-value store and zarr chunks are
zstd frames, on machines that may have neither ``zstandard`` nor
``compression.zstd``; this module is the one decoder it uses everywhere.
It decodes every frame a compressor writes without a dictionary:

- frame headers with any window and content-size field, the content size
  known or not, and the optional XXH64 content checksum (checked);
- raw, RLE and compressed blocks;
- literals raw, RLE, Huffman-coded (1 or 4 streams) and treeless (the
  previous block's Huffman table);
- sequences with predefined, RLE, FSE-compressed and repeated tables, and
  the three repeat offsets;
- concatenated frames, and skippable frames (skipped).

Frames that name a dictionary raise, as does any stream that is truncated
or corrupt (:class:`ZstdError`). Pure Python is slow next to a C decoder,
and fast enough for model checkpoints of a few megabytes.
"""

from __future__ import annotations

import struct
from typing import List, Optional, Sequence, Tuple

__all__ = ["ZstdError", "decompress", "xxh64"]

_FRAME_MAGIC = 0xFD2FB528
_SKIPPABLE_MASK = 0xFFFFFFF0
_SKIPPABLE_MAGIC = 0x184D2A50
_MAX_BLOCK = 128 * 1024


class ZstdError(ValueError):
    """A stream that is not valid zstd, or uses a feature not supported."""


# --------------------------------------------------------------------------- #
# XXH64
# --------------------------------------------------------------------------- #

_M64 = (1 << 64) - 1
_P1 = 0x9E3779B185EBCA87
_P2 = 0xC2B2AE3D27D4EB4F
_P3 = 0x165667B19E3779F9
_P4 = 0x85EBCA77C2B2AE63
_P5 = 0x27D4EB2F165667C5


def _rotl(x: int, r: int) -> int:
    return ((x << r) | (x >> (64 - r))) & _M64


def _round(acc: int, lane: int) -> int:
    acc = (acc + lane * _P2) & _M64
    return (_rotl(acc, 31) * _P1) & _M64


def _merge(acc: int, val: int) -> int:
    acc ^= _round(0, val)
    return (acc * _P1 + _P4) & _M64


def xxh64(data: bytes, seed: int = 0) -> int:
    """The 64-bit xxHash of ``data``."""
    n = len(data)
    p = 0
    if n >= 32:
        v1 = (seed + _P1 + _P2) & _M64
        v2 = (seed + _P2) & _M64
        v3 = seed & _M64
        v4 = (seed - _P1) & _M64
        stripes = n // 32
        lanes = struct.unpack_from(f"<{4 * stripes}Q", data, 0)
        for i in range(0, 4 * stripes, 4):
            v1 = _rotl((v1 + lanes[i] * _P2) & _M64, 31) * _P1 & _M64
            v2 = _rotl((v2 + lanes[i + 1] * _P2) & _M64, 31) * _P1 & _M64
            v3 = _rotl((v3 + lanes[i + 2] * _P2) & _M64, 31) * _P1 & _M64
            v4 = _rotl((v4 + lanes[i + 3] * _P2) & _M64, 31) * _P1 & _M64
        h = (_rotl(v1, 1) + _rotl(v2, 7) + _rotl(v3, 12) + _rotl(v4, 18)) & _M64
        for v in (v1, v2, v3, v4):
            h = _merge(h, v)
        p = 32 * stripes
    else:
        h = (seed + _P5) & _M64
    h = (h + n) & _M64
    while p + 8 <= n:
        (k,) = struct.unpack_from("<Q", data, p)
        h ^= _round(0, k)
        h = (_rotl(h, 27) * _P1 + _P4) & _M64
        p += 8
    if p + 4 <= n:
        (k,) = struct.unpack_from("<I", data, p)
        h ^= (k * _P1) & _M64
        h = (_rotl(h, 23) * _P2 + _P3) & _M64
        p += 4
    while p < n:
        h ^= (data[p] * _P5) & _M64
        h = (_rotl(h, 11) * _P1) & _M64
        p += 1
    h ^= h >> 33
    h = (h * _P2) & _M64
    h ^= h >> 29
    h = (h * _P3) & _M64
    return h ^ (h >> 32)


# --------------------------------------------------------------------------- #
# Bit streams
# --------------------------------------------------------------------------- #


class _BackwardBits:
    """A bit stream read from its last byte towards its first, as zstd's
    entropy-coded streams are: the last byte's highest set bit marks the
    start, and reads past the first byte give zeros. ``pos`` is the count
    of bits left, negative once more were read than the stream holds."""

    __slots__ = ("data", "pos")

    def __init__(self, data: bytes):
        if not data or data[-1] == 0:
            raise ZstdError("Bit stream without its end mark.")
        self.data = data
        self.pos = 8 * (len(data) - 1) + data[-1].bit_length() - 1

    def read(self, n: int) -> int:
        """The next ``n`` (at most 56) bits, first read the most significant."""
        if n == 0:
            return 0
        self.pos -= n
        p = self.pos
        if p >= 0:
            b = p >> 3
            return (int.from_bytes(self.data[b:b + 8], "little") >> (p & 7)) & ((1 << n) - 1)
        return (int.from_bytes(self.data[:8], "little") << -p) & ((1 << n) - 1)


# --------------------------------------------------------------------------- #
# FSE
# --------------------------------------------------------------------------- #


def _read_fse_counts(data: bytes, pos: int, max_symbol: int, max_log: int
                     ) -> Tuple[List[int], int, int]:
    """An FSE table description at ``data[pos:]``: the normalized counts,
    the accuracy log and the position after it."""
    bit = pos * 8

    def peek(n: int) -> int:
        byte = bit >> 3
        chunk = int.from_bytes(data[byte:byte + 8], "little")
        return (chunk >> (bit & 7)) & ((1 << n) - 1)

    log = peek(4) + 5
    bit += 4
    if log > max_log:
        raise ZstdError(f"FSE accuracy log {log} above {max_log}.")
    remaining = (1 << log) + 1
    threshold = 1 << log
    nbits = log + 1
    counts: List[int] = []
    while remaining > 1:
        if len(counts) > max_symbol:
            raise ZstdError("FSE table description has too many symbols.")
        big = 2 * threshold - 1 - remaining
        low = peek(nbits - 1)
        if low < big:
            value = low
            bit += nbits - 1
        else:
            value = peek(nbits)
            if value >= threshold:
                value -= big
            bit += nbits
        count = value - 1
        remaining -= abs(count)
        counts.append(count)
        if count == 0:
            while True:
                rep = peek(2)
                bit += 2
                counts.extend([0] * rep)
                if rep != 3:
                    break
        while remaining < threshold:
            nbits -= 1
            threshold >>= 1
    if remaining != 1 or len(counts) > max_symbol + 1:
        raise ZstdError("Corrupt FSE table description.")
    if bit > len(data) * 8:
        raise ZstdError("FSE table description runs past its block.")
    return counts, log, (bit + 7) >> 3


def _fse_table(counts: Sequence[int], log: int) -> List[Tuple[int, int, int]]:
    """The decoding table: (symbol, bits to read, base of the next state)
    for every state."""
    size = 1 << log
    symbols = [0] * size
    high = size - 1
    nxt = [0] * len(counts)
    for s, c in enumerate(counts):
        if c == -1:
            symbols[high] = s
            high -= 1
            nxt[s] = 1
        else:
            nxt[s] = c
    step = (size >> 1) + (size >> 3) + 3
    mask = size - 1
    p = 0
    for s, c in enumerate(counts):
        for _ in range(max(c, 0)):
            symbols[p] = s
            p = (p + step) & mask
            while p > high:
                p = (p + step) & mask
    if p != 0:
        raise ZstdError("Corrupt FSE distribution.")
    table = []
    for u in range(size):
        s = symbols[u]
        n = nxt[s]
        nxt[s] += 1
        nb = log - (n.bit_length() - 1)
        table.append((s, nb, (n << nb) - size))
    return table


def _rle_table(symbol: int) -> List[Tuple[int, int, int]]:
    return [(symbol, 0, 0)]


# --------------------------------------------------------------------------- #
# Huffman
# --------------------------------------------------------------------------- #


def _huffman_table(weights: List[int]) -> Tuple[List[Tuple[int, int]], int]:
    """The decoding table from the weights of all symbols but the last: a
    list of (symbol, bits) for every ``max_bits``-bit prefix."""
    total = sum(1 << (w - 1) for w in weights if w > 0)
    if total == 0:
        raise ZstdError("Huffman weights are all zero.")
    max_bits = total.bit_length()  # the power of two above total
    left = (1 << max_bits) - total
    if left & (left - 1):
        raise ZstdError("Huffman weights do not complete a tree.")
    weights = weights + [left.bit_length()]
    if max_bits > 11:
        raise ZstdError(f"Huffman code of {max_bits} bits is too long.")
    size = 1 << max_bits
    starts = [0] * (max_bits + 2)
    rank_counts = [0] * (max_bits + 2)
    for w in weights:
        rank_counts[w] += 1
    nxt = 0
    for w in range(1, max_bits + 1):
        starts[w] = nxt
        nxt += rank_counts[w] << (w - 1)
    table: List[Tuple[int, int]] = [(0, 0)] * size
    for s, w in enumerate(weights):
        if w == 0:
            continue
        n = 1 << (w - 1)
        entry = (s, max_bits + 1 - w)
        table[starts[w]:starts[w] + n] = [entry] * n
        starts[w] += n
    return table, max_bits


def _read_huffman_tree(data: bytes, pos: int):
    """A Huffman tree description at ``data[pos:]``: (table, max_bits), and
    the position after it."""
    header = data[pos]
    pos += 1
    if header >= 128:
        n = header - 127
        nbytes = (n + 1) // 2
        raw = data[pos:pos + nbytes]
        if len(raw) < nbytes:
            raise ZstdError("Truncated Huffman weights.")
        weights = []
        for b in raw:
            weights += [b >> 4, b & 15]
        return _huffman_table(weights[:n]), pos + nbytes
    end = pos + header
    if end > len(data):
        raise ZstdError("Truncated Huffman weights.")
    counts, log, p = _read_fse_counts(data[:end], pos, 255, 6)
    table = _fse_table(counts, log)
    bits = _BackwardBits(data[p:end])
    s1 = bits.read(log)
    s2 = bits.read(log)
    weights: List[int] = []
    while len(weights) < 255:
        sym, nb, base = table[s1]
        weights.append(sym)
        s1 = base + bits.read(nb)
        if bits.pos < 0:
            weights.append(table[s2][0])
            break
        sym, nb, base = table[s2]
        weights.append(sym)
        s2 = base + bits.read(nb)
        if bits.pos < 0:
            weights.append(table[s1][0])
            break
    else:
        raise ZstdError("Too many Huffman weights.")
    return _huffman_table(weights), end


def _huffman_stream(data: bytes, n: int, table, max_bits: int) -> bytes:
    """Decode ``n`` symbols from one backward Huffman stream."""
    if not data or data[-1] == 0:
        raise ZstdError("Huffman stream without its end mark.")
    value = int.from_bytes(data, "little")
    bits = value.bit_length() - 1
    out = bytearray(n)
    mask = (1 << max_bits) - 1
    # Work through the stream in windows of 1024 bits: shifting
    # the whole stream's int for every symbol would cost its size each time.
    i = 0
    window_bits = 1024
    while i < n:
        lo = max(bits - window_bits, 0)
        # Bits [lo - max_bits, bits) hold the window and the peek margin.
        base = lo - max_bits
        if base >= 0:
            win = (value >> base) & ((1 << (bits - base)) - 1)
        else:
            win = (value & ((1 << bits) - 1)) << -base
        p = bits - base  # bits left in win
        stop = lo - base  # leave the window here
        while i < n and p > stop:
            s, nb = table[(win >> (p - max_bits)) & mask]
            out[i] = s
            p -= nb
            i += 1
        bits = p + base
        if bits < 0 or (bits == 0 and i < n):
            raise ZstdError("Huffman stream overflow.")
    if bits != 0:
        raise ZstdError("Huffman stream not consumed.")
    return bytes(out)


# --------------------------------------------------------------------------- #
# Sequences
# --------------------------------------------------------------------------- #

_LL_BASE = list(range(16)) + [16, 18, 20, 22, 24, 28, 32, 40, 48, 64, 128, 256, 512, 1024,
                              2048, 4096, 8192, 16384, 32768, 65536]
_LL_BITS = [0] * 16 + [1, 1, 1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16]
_ML_BASE = [i + 3 for i in range(32)] + [35, 37, 39, 41, 43, 47, 51, 59, 67, 83, 99, 131, 259,
                                         515, 1027, 2051, 4099, 8195, 16387, 32771, 65539]
_ML_BITS = [0] * 32 + [1, 1, 1, 1, 2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16]
_LL_DEFAULT = ([4, 3] + [2] * 11 + [1] * 3 + [2] * 9 + [3, 2] + [1] * 5 + [-1] * 4, 6)
_ML_DEFAULT = ([1, 4, 3] + [2] * 6 + [1] * 37 + [-1] * 7, 6)
_OF_DEFAULT = ([1] * 6 + [2] * 3 + [1] * 15 + [-1] * 5, 5)
_LL_MAX, _ML_MAX, _OF_MAX = (35, 9), (52, 9), (31, 8)  # (largest symbol, largest log)


class _FrameState:
    """What blocks of one frame hand on: the Huffman table, the three FSE
    tables and the repeat offsets."""

    def __init__(self):
        self.huffman = None
        self.tables = {"ll": None, "of": None, "ml": None}
        self.reps = [1, 4, 8]


def _seq_table(kind: str, mode: int, data: bytes, pos: int, state: _FrameState):
    max_symbol, max_log = {"ll": _LL_MAX, "ml": _ML_MAX, "of": _OF_MAX}[kind]
    if mode == 0:
        counts, log = {"ll": _LL_DEFAULT, "ml": _ML_DEFAULT, "of": _OF_DEFAULT}[kind]
        table = (_fse_table(counts, log), log)
    elif mode == 1:
        if pos >= len(data):
            raise ZstdError("Truncated RLE sequence table.")
        if data[pos] > max_symbol:
            raise ZstdError("RLE sequence symbol out of range.")
        table = (_rle_table(data[pos]), 0)
        pos += 1
    elif mode == 2:
        counts, log, pos = _read_fse_counts(data, pos, max_symbol, max_log)
        table = (_fse_table(counts, log), log)
    else:
        table = state.tables[kind]
        if table is None:
            raise ZstdError("Repeated sequence table with none before it.")
    state.tables[kind] = table
    return table, pos


def _sequences(data: bytes, pos: int, state: _FrameState) -> List[Tuple[int, int, int]]:
    """The (literal length, offset, match length) of each sequence of a
    compressed block, offsets resolved against the repeat offsets."""
    if pos >= len(data):
        raise ZstdError("Truncated sequences section.")
    b0 = data[pos]
    if b0 == 0:
        return []
    if b0 < 128:
        n_seq, pos = b0, pos + 1
    elif b0 < 255:
        n_seq, pos = ((b0 - 128) << 8) + data[pos + 1], pos + 2
    else:
        n_seq, pos = data[pos + 1] + (data[pos + 2] << 8) + 0x7F00, pos + 3
    modes = data[pos]
    pos += 1
    if modes & 3:
        raise ZstdError("Reserved bits set in the sequence modes.")
    (ll_t, ll_log), pos = _seq_table("ll", modes >> 6, data, pos, state)
    (of_t, of_log), pos = _seq_table("of", (modes >> 4) & 3, data, pos, state)
    (ml_t, ml_log), pos = _seq_table("ml", (modes >> 2) & 3, data, pos, state)

    bits = _BackwardBits(data[pos:])
    read = bits.read
    ll_s = read(ll_log)
    of_s = read(of_log)
    ml_s = read(ml_log)
    r1, r2, r3 = state.reps
    out = []
    for i in range(n_seq):
        ll_code, ll_nb, ll_base = ll_t[ll_s]
        of_code, of_nb, of_base = of_t[of_s]
        ml_code, ml_nb, ml_base = ml_t[ml_s]
        if of_code > 31 or ll_code > 35 or ml_code > 52:
            raise ZstdError("Sequence code out of range.")
        of_value = (1 << of_code) + read(of_code)
        ml = _ML_BASE[ml_code] + read(_ML_BITS[ml_code])
        ll = _LL_BASE[ll_code] + read(_LL_BITS[ll_code])
        if of_value > 3:
            offset = of_value - 3
            r1, r2, r3 = offset, r1, r2
        else:
            idx = of_value - 1 + (ll == 0)  # 0..3: which repeat offset
            if idx == 0:
                offset = r1
            elif idx == 1:
                offset = r2
                r1, r2 = r2, r1
            elif idx == 2:
                offset = r3
                r1, r2, r3 = r3, r1, r2
            else:
                offset = r1 - 1
                if offset == 0:
                    raise ZstdError("Repeat offset of zero.")
                r1, r2, r3 = offset, r1, r2
        out.append((ll, offset, ml))
        if i + 1 < n_seq:
            ll_s = ll_base + read(ll_nb)
            ml_s = ml_base + read(ml_nb)
            of_s = of_base + read(of_nb)
    if bits.pos != 0:
        raise ZstdError("Sequence bit stream not consumed exactly.")
    state.reps = [r1, r2, r3]
    return out


# --------------------------------------------------------------------------- #
# Blocks and frames
# --------------------------------------------------------------------------- #


def _literals(data: bytes, state: _FrameState) -> Tuple[bytes, int]:
    """The literals section of a compressed block: its bytes and the
    position after it."""
    b0 = data[0]
    kind = b0 & 3
    size_format = (b0 >> 2) & 3
    if kind in (0, 1):  # raw, RLE
        if size_format in (0, 2):
            regen, pos = b0 >> 3, 1
        elif size_format == 1:
            regen, pos = (b0 >> 4) + (data[1] << 4), 2
        else:
            regen, pos = (b0 >> 4) + (data[1] << 4) + (data[2] << 12), 3
        if kind == 0:
            lit = data[pos:pos + regen]
            if len(lit) != regen:
                raise ZstdError("Truncated raw literals.")
            return bytes(lit), pos + regen
        if pos >= len(data):
            raise ZstdError("Truncated RLE literals.")
        return bytes([data[pos]]) * regen, pos + 1
    # Huffman-coded, with a new tree (2) or the last block's (3).
    if size_format <= 1:
        h = int.from_bytes(data[:3], "little")
        regen, comp, pos = (h >> 4) & 0x3FF, (h >> 14) & 0x3FF, 3
    elif size_format == 2:
        h = int.from_bytes(data[:4], "little")
        regen, comp, pos = (h >> 4) & 0x3FFF, (h >> 18) & 0x3FFF, 4
    else:
        h = int.from_bytes(data[:5], "little")
        regen, comp, pos = (h >> 4) & 0x3FFFF, (h >> 22) & 0x3FFFF, 5
    streams = 1 if size_format == 0 else 4
    end = pos + comp
    if end > len(data) or regen > _MAX_BLOCK:
        raise ZstdError("Literals section runs past its block.")
    if kind == 2:
        state.huffman, pos = _read_huffman_tree(data[:end], pos)
    elif state.huffman is None:
        raise ZstdError("Treeless literals with no Huffman table before them.")
    table, max_bits = state.huffman
    if streams == 1:
        return _huffman_stream(data[pos:end], regen, table, max_bits), end
    if end - pos < 6:
        raise ZstdError("Truncated jump table.")
    s1, s2, s3 = struct.unpack_from("<3H", data, pos)
    pos += 6
    per = (regen + 3) // 4
    sizes = [s1, s2, s3, end - pos - s1 - s2 - s3]
    counts = [per, per, per, regen - 3 * per]
    if sizes[3] < 0 or counts[3] < 0:
        raise ZstdError("Corrupt jump table.")
    parts = []
    for size, count in zip(sizes, counts):
        parts.append(_huffman_stream(data[pos:pos + size], count, table, max_bits))
        pos += size
    return b"".join(parts), end


def _compressed_block(block: bytes, out: bytearray, state: _FrameState) -> None:
    lit, pos = _literals(block, state)
    seqs = _sequences(block, pos, state)
    lp = 0
    for ll, offset, ml in seqs:
        if lp + ll > len(lit):
            raise ZstdError("Sequence reads past its literals.")
        out += lit[lp:lp + ll]
        lp += ll
        start = len(out) - offset
        if start < 0:
            raise ZstdError("Match offset before the start of the frame.")
        if offset >= ml:
            out += out[start:start + ml]
        else:
            pattern = out[start:]
            out += (pattern * (ml // offset + 1))[:ml]
    out += lit[lp:]


def _frame(data: bytes, pos: int) -> Tuple[bytes, int]:
    """Decode the frame whose header starts at ``data[pos]`` (after its
    magic): its content and the position after it."""
    fhd = data[pos]
    pos += 1
    fcs_code = fhd >> 6
    single = (fhd >> 5) & 1
    checksum = (fhd >> 2) & 1
    dict_code = fhd & 3
    if fhd & 8:
        raise ZstdError("Reserved bit set in the frame header.")
    if not single:
        pos += 1  # window descriptor: the whole frame is kept in memory
    dict_size = (0, 1, 2, 4)[dict_code]
    dict_id = int.from_bytes(data[pos:pos + dict_size], "little")
    pos += dict_size
    if dict_id:
        raise ZstdError(f"Frame needs dictionary {dict_id}; dictionaries are not supported.")
    fcs_size = (1 if single else 0, 2, 4, 8)[fcs_code]
    content_size: Optional[int] = None
    if fcs_size:
        content_size = int.from_bytes(data[pos:pos + fcs_size], "little")
        if fcs_size == 2:
            content_size += 256
        pos += fcs_size
    if pos > len(data):
        raise ZstdError("Truncated frame header.")

    out = bytearray()
    state = _FrameState()
    while True:
        if pos + 3 > len(data):
            raise ZstdError("Truncated block header.")
        h = data[pos] | (data[pos + 1] << 8) | (data[pos + 2] << 16)
        pos += 3
        last, kind, size = h & 1, (h >> 1) & 3, h >> 3
        if kind == 1:  # RLE: one byte, repeated
            if pos >= len(data):
                raise ZstdError("Truncated RLE block.")
            out += bytes([data[pos]]) * size
            pos += 1
        else:
            block = data[pos:pos + size]
            if len(block) != size or size > _MAX_BLOCK:
                raise ZstdError("Truncated or oversized block.")
            pos += size
            if kind == 0:
                out += block
            elif kind == 2:
                _compressed_block(block, out, state)
            else:
                raise ZstdError("Reserved block type.")
        if last:
            break
    if content_size is not None and len(out) != content_size:
        raise ZstdError(f"Frame content is {len(out)} bytes, its header says {content_size}.")
    if checksum:
        if pos + 4 > len(data):
            raise ZstdError("Truncated content checksum.")
        (want,) = struct.unpack_from("<I", data, pos)
        pos += 4
        if xxh64(bytes(out)) & 0xFFFFFFFF != want:
            raise ZstdError("Content checksum mismatch.")
    return bytes(out), pos


def decompress(data: bytes) -> bytes:
    """Decode every frame of ``data`` (zstd frames and skippable frames,
    concatenated) and return the joined content."""
    data = bytes(data)
    parts = []
    pos = 0
    while pos < len(data):
        if pos + 4 > len(data):
            raise ZstdError("Truncated frame magic.")
        (magic,) = struct.unpack_from("<I", data, pos)
        pos += 4
        if magic == _FRAME_MAGIC:
            try:
                content, pos = _frame(data, pos)
            except (IndexError, struct.error) as e:  # a read past the end of the data
                raise ZstdError("Truncated or corrupt zstd frame.") from e
            parts.append(content)
        elif magic & _SKIPPABLE_MASK == _SKIPPABLE_MAGIC:
            if pos + 4 > len(data):
                raise ZstdError("Truncated skippable frame.")
            (size,) = struct.unpack_from("<I", data, pos)
            pos += 4 + size
            if pos > len(data):
                raise ZstdError("Truncated skippable frame.")
        else:
            raise ZstdError(f"Not a zstd frame: magic {magic:#010x}.")
    return b"".join(parts)

"""LZF decompression, as h5py's ``lzf`` filter (HDF5 filter 32000) stores
chunks: liblzf's format, where a control byte below 32 starts a run of that
many plus one literal bytes, and any other control byte a back reference of
``ctrl >> 5`` plus two bytes (seven and more take a length byte) at a
distance of ``((ctrl & 31) << 8) + next byte + 1`` (overlapping copies
repeat the bytes just written).

Two routes, picked by :mod:`sleap_tpu_torch.io.hdf5` from the ``device`` a
file is read for:

- ``"cpu"``: :func:`decode_plain`, in Python;
- ``"cuda"``: :func:`decode_host`, ``sleap_hdf5_lzf_decode`` in host C
  (``csrc/hdf5.cu``, built into the kernel library). A failed build raises;
  there is no fallback to the plain version.

No kernel: each token depends on the bytes decoded before it, and the JAX
package decodes LZF on the host through h5py's filter.
"""

from __future__ import annotations

import numpy as np


def decode_plain(data: bytes) -> bytes:
    """Decompress one LZF stream (``lzf_decompress``); raise ``ValueError``
    on a stream that reads past its end or refers before its start."""
    src = memoryview(bytes(data))
    n = len(src)
    out = bytearray()
    i = 0
    while i < n:
        ctrl = src[i]
        i += 1
        if ctrl < 32:
            run = ctrl + 1
            if i + run > n:
                raise ValueError("LZF data is corrupt: a literal run past the end of the chunk.")
            out += src[i:i + run]
            i += run
            continue
        length = ctrl >> 5
        if i >= n:
            raise ValueError("LZF data is corrupt: a back reference past the end of the chunk.")
        if length == 7:
            length += src[i]
            i += 1
            if i >= n:
                raise ValueError("LZF data is corrupt: a back reference past the end of the chunk.")
        distance = ((ctrl & 0x1F) << 8) + src[i] + 1
        i += 1
        length += 2
        start = len(out) - distance
        if start < 0:
            raise ValueError("LZF data is corrupt: a back reference before the start of the chunk.")
        if distance >= length:
            out += out[start:start + length]
        else:  # the copy overlaps what it writes: the last `distance` bytes repeat
            pattern = bytes(out[start:])
            out += (pattern * (length // distance + 1))[:length]
    return bytes(out)


_HOST_ERRORS = {2: "a back reference before the start of the chunk, or a token past its end"}


def decode_host(data: bytes, size: int) -> bytes:
    """:func:`decode_plain` in host C (``sleap_hdf5_lzf_decode``), into a
    buffer of ``size`` bytes (the chunk's size, as h5py's filter sizes it)
    that grows as h5py's does when the stream holds more."""
    from sleap_tpu_torch.ops import _build

    src = np.frombuffer(bytes(data), np.uint8)
    capacity = max(int(size), 1)
    written = np.zeros(1, np.int64)
    while True:
        out = np.empty(capacity, np.uint8)
        err = _build.entry("sleap_hdf5_lzf_decode")(src.ctypes.data, src.size, out.ctypes.data, capacity,
                                                    written.ctypes.data)
        if err == 1:  # the output buffer is full: grow it by the input's size, as h5py does
            capacity += max(src.size, 1)
            continue
        if err:
            raise ValueError(f"LZF data is corrupt ({_HOST_ERRORS.get(err, err)}).")
        return out[:int(written[0])].tobytes()

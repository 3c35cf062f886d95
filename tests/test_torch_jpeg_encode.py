"""The port's JPEG encoder (``sleap_tpu_torch.io.jpeg.imencode``) against
cv2's, on the CPU route: byte-equal to ``cv2.imencode(".jpg", img)`` for
gray, (H, W, 1) and BGR frames of sizes below, at and past one MCU, odd and
even, and a 256^2 frame of smooth shapes and noise; the port's decoder and
cv2's read the bytes back to the same frame. The plain stages against
float references within libjpeg's own rounding: colour conversion within
half a level (Y) and one level (the 2x2 chroma means), the integer DCT
within one unit of the true coefficient. The host entropy coder of the
card's route (``sleap_jpeg_encode_scan``, host C in ``csrc/jpeg.cu``),
built here with the system C++ compiler, gives the plain coder's bytes."""

from __future__ import annotations

import ctypes
import shutil
import subprocess
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

from sleap_tpu_torch.io import jpeg
from sleap_tpu_torch.ops import _build

SIZES = [(1, 1), (9, 2), (50, 3), (8, 8), (16, 16), (33, 17), (29, 37), (72, 100), (256, 256)]
KINDS = ["gray", "gray_hw1", "bgr"]


def _frame(h, w, kind, seed):
    """Smooth shapes plus noise, every coefficient band in use."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:h, :w].astype(np.float64)
    base = 120 + 90 * np.sin(xx / (w / 5.0 + 1)) * np.cos(yy / (h / 4.0 + 1))
    c = 1 if kind != "bgr" else 3
    img = base[..., None] + rng.normal(0, 12, (h, w, c))
    if c == 3:
        img[..., 1] = 255 - img[..., 1]
        img[..., 2] = 30 + 200 * xx / max(w - 1, 1)
    img = np.clip(img, 0, 255).astype(np.uint8)
    return img[..., 0] if kind == "gray" else img


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("h,w", SIZES, ids=[f"{h}x{w}" for h, w in SIZES])
def test_bytes_equal_cv2_and_decode_back(h, w, kind):
    img = _frame(h, w, kind, seed=h * 1000 + w)
    got = jpeg.imencode(img, "cpu")
    ok, want = cv2.imencode(".jpg", img)
    assert ok and got == want.tobytes()
    back = jpeg.imdecode(got, "cpu")
    np.testing.assert_array_equal(back, cv2.imdecode(np.frombuffer(got, np.uint8), cv2.IMREAD_UNCHANGED))


@pytest.mark.parametrize("value", [0, 255])
def test_flat_extremes_and_noise(value):
    """Flat frames at the ends of the range (all-zero AC, the largest DC
    differences) and uniform noise (the longest AC codes, 0xFF stuffing)."""
    rng = np.random.default_rng(value)
    for img in (np.full((40, 56, 3), value, np.uint8), rng.integers(0, 256, (40, 56, 3), dtype=np.uint8),
                rng.integers(0, 256, (23, 31), dtype=np.uint8)):
        assert jpeg.imencode(img, "cpu") == cv2.imencode(".jpg", img)[1].tobytes()


def test_markers_are_cv2s():
    """SOI, JFIF 1.01 APP0, one DQT a table, SOF0 (ids 1-3, 2x2/1x1/1x1),
    DHT DC0 AC0 DC1 AC1, SOS, ..., EOI."""
    data = jpeg.imencode(_frame(20, 30, "bgr", 0), "cpu")
    markers, pos = [], 2
    while data[pos + 1] != 0xDA:
        length = int.from_bytes(data[pos + 2:pos + 4], "big")
        markers.append((data[pos + 1], data[pos + 4:pos + 2 + length]))
        pos += 2 + length
    assert [m for m, _ in markers] == [0xE0, 0xDB, 0xDB, 0xC0, 0xC4, 0xC4, 0xC4, 0xC4]
    assert markers[0][1] == b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00"
    assert markers[3][1][6:] == bytes([1, 0x22, 0, 2, 0x11, 1, 3, 0x11, 1])
    assert [b[0] for m, b in markers[4:]] == [0x00, 0x10, 0x01, 0x11]
    assert data[:2] == b"\xff\xd8" and data[-2:] == b"\xff\xd9"


def test_colour_stage_within_half_a_level_of_float():
    img = _frame(37, 45, "bgr", 3)
    frame = jpeg.frame_layout(37, 45, 3)
    samples = jpeg.ycc_plain(torch.from_numpy(img), frame)
    planes = []
    for c in frame.components:
        blocks = samples[c.offset:c.offset + c.blocks_w * c.blocks_h].view(c.blocks_h, c.blocks_w, 8, 8)
        planes.append(blocks.permute(0, 2, 1, 3).reshape(8 * c.blocks_h, 8 * c.blocks_w).double().numpy())
    b, g, r = (img[..., k].astype(np.float64) for k in range(3))
    y = 0.299 * r + 0.587 * g + 0.114 * b
    assert np.abs(planes[0][:37, :45] - y).max() <= 0.5 + 1e-3
    cb = -0.16874 * r - 0.33126 * g + 0.5 * b + 128
    pad = np.pad(cb, ((0, 1), (0, 1)), mode="edge")[:38, :46]
    mean = pad.reshape(19, 2, 23, 2).mean(axis=(1, 3))
    assert np.abs(planes[1][:19, :23] - mean).max() <= 1.0 + 1e-3


def test_dct_stage_within_one_unit_of_float():
    """With every quantisation step 1 (divisor 8, the DCT's own scale), the
    integer DCT is the true one within a unit."""
    rng = np.random.default_rng(4)
    samples = torch.from_numpy(rng.integers(0, 256, (50, 64), dtype=np.uint8))
    ones = torch.from_numpy(np.stack([jpeg.divisors(np.ones(64, np.uint16))] * 2))
    got = jpeg.fdct_plain(samples, ones, torch.zeros(50, dtype=torch.int64)).double().numpy()
    k = np.arange(8)
    basis = np.cos((2 * k[None, :] + 1) * k[:, None] * np.pi / 16) * np.where(k == 0, np.sqrt(0.5), 1)[:, None]
    x = samples.double().numpy().reshape(-1, 8, 8) - 128
    want = np.einsum("ui,nij,vj->nuv", basis, x, basis) / 4
    assert np.abs(got.reshape(-1, 8, 8) - want).max() <= 1.0


def test_quantisation_tables_are_quality_95():
    """``(t * 10 + 50) // 100`` of the standard tables, as cv2's DQT
    segments hold them (zigzag order)."""
    assert jpeg.quant_table(jpeg.STD_LUMA)[:8].tolist() == [2, 1, 1, 2, 2, 4, 5, 6]
    data = cv2.imencode(".jpg", _frame(16, 16, "bgr", 1))[1].tobytes()
    for t, basic in enumerate((jpeg.STD_LUMA, jpeg.STD_CHROMA)):
        at = data.index(b"\xff\xdb\x00\x43" + bytes([t]))
        table = np.frombuffer(data, np.uint8, 64, at + 5)
        np.testing.assert_array_equal(table, jpeg.quant_table(basic)[jpeg.ZIGZAG[:64]])


def test_encoding_refuses_what_cv2_would_not_write_alike():
    with pytest.raises(ValueError, match="uint8"):
        jpeg.imencode(np.zeros((4, 4), np.float32), "cpu")
    with pytest.raises(ValueError, match="BGR"):
        jpeg.imencode(np.zeros((4, 4, 4), np.uint8), "cpu")


def test_card_route_raises_on_cpu_tensors():
    frame = jpeg.frame_layout(8, 8, 1)
    with pytest.raises(ValueError, match="CUDA"):
        jpeg.ycc_cuda(torch.zeros((8, 8), dtype=torch.uint8), frame)
    with pytest.raises(ValueError, match="CUDA"):
        jpeg.fdct_cuda(torch.zeros((1, 64), dtype=torch.uint8), torch.zeros((2, 3, 64), dtype=torch.int32),
                       frame)


@pytest.fixture(scope="module")
def host_library(tmp_path_factory):
    """``csrc/jpeg.cu``'s host C (everything outside ``__CUDACC__``) built
    with the system C++ compiler, bound as the kernel library binds it."""
    cxx = shutil.which("c++") or shutil.which("g++")
    if cxx is None:
        pytest.skip("no C++ compiler to build the host entropy coder")
    lib = tmp_path_factory.mktemp("host") / "libjpeghost.so"
    src = Path(_build.CSRC) / "jpeg.cu"
    subprocess.run([cxx, "-x", "c++", "-std=c++17", "-O2", "-shared", "-fPIC", "-o", str(lib), str(src)],
                   check=True, capture_output=True)
    cdll = ctypes.CDLL(str(lib))

    def entry(name):
        fn = getattr(cdll, name)
        fn.argtypes = _build.SIGNATURES[name]
        fn.restype = ctypes.c_int
        return fn

    return entry


@pytest.mark.parametrize("kind", ["gray", "bgr"])
def test_host_entropy_coder_equals_the_plain_one(kind, host_library, monkeypatch):
    monkeypatch.setattr(_build, "entry", host_library)
    for seed, (h, w) in enumerate([(1, 1), (9, 2), (33, 17), (72, 100), (120, 88)]):
        img = jpeg._as_frame(_frame(h, w, kind, seed))
        frame = jpeg.frame_layout(h, w, 1 if img.ndim == 2 else 3)
        coefs = jpeg.fdct_plain(jpeg.ycc_plain(torch.from_numpy(img), frame), jpeg._divisor_tables(),
                                jpeg.block_tables(frame))
        assert jpeg.encode_scan_host(coefs, frame) == jpeg.encode_scan_plain(coefs.numpy(), frame)


def test_host_coders_in_two_threads_keep_their_own_buffers(host_library, monkeypatch):
    """A render decodes in its reader thread while its caller encodes, and
    both host coders release the GIL: each thread has its own scratch, so
    sizes that round to the same buffer do not mix the two."""
    import threading

    monkeypatch.setattr(_build, "entry", host_library)
    data = cv2.imencode(".jpg", _frame(256, 256, "bgr", 0))[1].tobytes()
    header = jpeg.parse(data)
    want_coefs = jpeg.coefficients_host(data, header).clone()
    img = jpeg._as_frame(_frame(64, 64, "bgr", 1))
    frame = jpeg.frame_layout(64, 64, 3)
    coefs = jpeg.fdct_plain(jpeg.ycc_plain(torch.from_numpy(img), frame), jpeg._divisor_tables(),
                            jpeg.block_tables(frame))
    want_bytes = jpeg.encode_scan_plain(coefs.numpy(), frame)
    units = 6 * frame.mcux * frame.mcuy
    pool = [1 << max(16, (n - 1).bit_length()) for n in (len(data) + 16, 512 * units + 64)]
    assert pool[0] == pool[1]  # one buffer for both, were the pool shared
    assert jpeg._scratch(1).ctypes.data == jpeg._scratch(1).ctypes.data
    faults, start = [], threading.Barrier(2, timeout=60)

    def decode():
        start.wait()
        out = torch.empty_like(want_coefs)
        for _ in range(300):
            try:
                jpeg.coefficients_host(data, header, out)
            except ValueError as e:
                faults.append(f"decode: {e}")
                continue
            if not torch.equal(out, want_coefs):
                faults.append("decode: wrong coefficients")

    def encode():
        start.wait()
        for _ in range(300):
            if jpeg.encode_scan_host(coefs, frame) != want_bytes:
                faults.append("encode: wrong bytes")

    threads = [threading.Thread(target=decode), threading.Thread(target=encode)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert not faults, f"{len(faults)} faults, the first {faults[0]}"


def test_recorded_hashes_of_the_small_frames():
    """``encoded.json`` (cv2's bytes, recorded for the card, which has no
    cv2) holds for the port's CPU route on the frames below 100 x 100."""
    import hashlib
    import json

    root = Path(__file__).resolve().parent / "torch_data" / "jpeg"
    record = json.loads((root / "encoded.json").read_text())["frames"]
    checked = 0
    for name, want in record.items():
        if "crop" in name or "1024" in name:
            continue
        img = jpeg.imdecode((root / f"{name}.jpg").read_bytes(), "cpu")
        data = jpeg.imencode(img, "cpu")
        assert hashlib.sha256(data).hexdigest() == want["sha256"] and len(data) == want["bytes"], name
        checked += 1
    assert checked == 15  # 13, and the 4:4:0 and 4:1:1 stills

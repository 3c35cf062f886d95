"""Peak-finding kernels for Hopper: wrappers, plain versions, launch counts.

Three CUDA kernels (``csrc/peaks.cu``) replace the Pallas kernels of
:mod:`sleap_tpu.ops.pallas_peaks` (top-down and bottom-up paths):

``global_peaks`` <- ``find_global_peaks_integral_pallas`` / ``_peak_kernel``
    Per (sample, channel) map of float32 or bf16 values, read as they lie:
    the max, the first-occurrence argmax and the integral-regression
    centroid of the (2*half+1)^2 window around it (zero outside the map);
    xy is NaN below threshold. ``half < 0`` gives the unrefined grid peak
    (``find_global_peaks_rough``). A map holding a NaN gets value NaN and xy
    kept (NaN < threshold is false); its argmax is the first NaN in
    row-major order on the grid route, as ``jnp.argmax`` in the JAX rough
    peaks, and H*W on the integral route, as in the TPU kernel, so (x, y) =
    (0, H) plus the offsets of the window there, masked to the map. Bound by reading the maps once: on
    the top-down path (64 crops x 13 nodes of 40x40) that is 5.3 MB per
    batch in float32, 2.7 MB in bf16, against two compares per value.
    Design (``csrc/peaks.cu``, ``global_slab_kernel``): maps laid out as a
    conv head writes them (one map channel-major, or a sample's H x W x C
    block channels-last) are copied into shared memory by one TMA bulk copy
    per block and scanned there by one warp per map; lanes merge by one key
    (order-preserving value bits, then the smallest index) in two warp
    reductions, and the window is read from shared memory. A block takes a
    map or a sample, or, when those are too few to keep the SMs busy or too
    large for shared memory, a thread block cluster splits its rows (each
    block holding the window's halo) and exchanges keys through distributed
    shared memory. Any other strides take ``global_band_kernel``: a cluster
    of 8 blocks per map scans bands of rows through the strides and merges
    in the first block's shared memory (:func:`global_peaks_plan` reads the
    plan).

``local_peaks`` <- ``find_local_peaks_fused_pallas`` / ``_local_peaks_kernel``
    Strict 8-neighbour NMS above threshold (border = -inf), the top K by
    value with ties to the smallest row-major index, optional integral
    refinement on the raw map; empty slots are -inf. At the main path's 16
    centroid maps of 64^2 (0.26 MB, 0.08 us at 3.35 TB/s) it is bound by
    latency, not bytes. Design (``csrc/peaks.cu``, ``local_peaks_kernel``):
    each map is cut into 8 parts (8 bands of 8 rows at 64^2, so 128
    blocks on the path) that form one thread block cluster, stage tiles of
    8 x 256 pixels plus halo into shared memory (-inf outside the map) and
    run the NMS there; peaks order by one 64-bit key (the value's
    order-preserving bits above ~index), each thread keeps a top-K in
    registers behind the block's cut-off, warps merge by warp max, and the
    cluster's first block merges the parts' lists from its peers' shared
    memory and refines the winners from the raw map, in the same launch.
    Any H x W, channel count and strides; K <= 64.

``local_peaks_hwcs`` <- ``find_local_peaks_fused_pallas_hwcs`` / ``_hwcs_kernel``
    ``local_peaks``'s contract on bf16 maps (H*W <= 2^16, threshold > 0, the
    5x5 window or none), through the TPU kernel's packed int32 key
    ``bf16_bits << 16 | (H*W - 1 - index)``: one integer orders peaks by value
    then by smaller index, so every merge is an integer max. On the bottom-up
    main path (16 samples x 256^2 x 13 channels, channels-last from the head
    conv) it is bound by reading the maps once: 27 MB, 8.1 us at 3.35 TB/s.
    Design (``csrc/peaks.cu``, ``hwcs_band_kernel``): the TPU kernel's row
    stream, in parallel bands. A block owns 16 rows x up to 256 columns x up
    to 16 channels of one sample and streams them through a 4-row ring in
    shared memory: 16-byte ``cp.async`` copies of whole channels-last rows
    three rows ahead where the rows allow it (:func:`hwcs_fast_rows`), else
    strided loads prefetched into registers. Each thread has one channel and
    fixed columns, keeps the separable NMS state of its columns and a
    top-K of its survivors in registers behind a per-channel cut-off (no
    atomic per survivor), and the last block of each sample merges the
    bands' candidates and refines the winners from the raw map, in the same
    launch. The workspace (candidates, tickets) is kept per device and
    stream.
A CPU tensor runs the plain version (:func:`global_peaks_plain`,
:func:`local_peaks_plain`, :func:`local_peaks_hwcs_plain`); a CUDA tensor
launches the kernel, and anything else raises. The plain versions are also
what the tests and ``chip_smoke.py`` hold the kernels against. Tolerance:
values, masks and integer peak locations are exact; refined xy agree within
1e-4 px (window sums in another order, FMA contraction).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from sleap_tpu_torch.ops._build import entry, launch

MAX_K = 64
GLOBAL_DTYPES = (torch.float32, torch.bfloat16)  # what kernel global_peaks reads
HWCS_MAX_PIXELS = 2**16  # the packed key's 16-bit index
HWCS_HALF = 2  # kernel 4's integral window is 5 x 5
HWCS_BAND_ROWS = 16  # rows per block of kernel 4
HWCS_MAX_COLS = 256  # columns per block of kernel 4 (8 per thread)
HWCS_MAX_CHANNELS = 16  # channels per block of kernel 4 (one per 32 threads)
_EMPTY_KEY = -(2**31)


# --------------------------------------------------------------------------- #
# Plain versions
# --------------------------------------------------------------------------- #


def integral_regression(
    cms: torch.Tensor, xv: torch.Tensor, yv: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Weighted centroid of (samples, height, width, channels) maps."""
    z = cms.sum(dim=(1, 2))
    x_hat = (xv.reshape(1, 1, -1, 1) * cms).sum(dim=(1, 2)) / z
    y_hat = (yv.reshape(1, -1, 1, 1) * cms).sum(dim=(1, 2)) / z
    return x_hat, y_hat


def extract_patches(
    maps: torch.Tensor, xy: torch.Tensor, map_inds: torch.Tensor, size: int
) -> torch.Tensor:
    """(size, size) patches of (n_maps, H, W) maps centred on integer peaks.

    Zero outside the map. NaN peaks read the patch at (0, 0); callers rely
    on the NaN of the peak itself instead.
    """
    half = size // 2
    H, W = maps.shape[1], maps.shape[2]
    padded = F.pad(maps, (half, half, half, half))
    x = torch.nan_to_num(xy[:, 0]).long().clamp(0, W - 1)
    y = torch.nan_to_num(xy[:, 1]).long().clamp(0, H - 1)
    offs = torch.arange(size, device=maps.device)
    rows = (y[:, None] + offs)[:, :, None]
    cols = (x[:, None] + offs)[:, None, :]
    return padded[map_inds[:, None, None], rows, cols]


def _integral_refine(maps: torch.Tensor, xy: torch.Tensor, map_inds: torch.Tensor,
                     half: int) -> torch.Tensor:
    size = 2 * half + 1
    patches = extract_patches(maps, xy, map_inds, size)[..., None]
    gv = torch.arange(size, dtype=torch.float32, device=maps.device) - half
    dx, dy = integral_regression(patches, xv=gv, yv=gv)
    return xy + torch.cat([dx, dy], dim=1)


def _flat_maps(cms: torch.Tensor) -> torch.Tensor:
    S, H, W, C = cms.shape
    return cms.permute(0, 3, 1, 2).reshape(S * C, H, W).float()


def global_peaks_plain(
    cms: torch.Tensor, threshold: float, half: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel ``global_peaks``'s contract in plain PyTorch.

    Args:
        cms: (S, H, W, C) maps.
        half: integral window half-size; < 0 for the grid peak.

    Returns:
        xy (S, C, 2), NaN below threshold; vals (S, C). A map holding a NaN
        gets val NaN and xy kept; its argmax is its first NaN when
        ``half < 0`` (``jnp.argmax``'s), else H*W (no value equals the NaN
        max), whose window around (0, H) is masked to the map, not clamped
        into it.
    """
    S, H, W, C = cms.shape
    maps = _flat_maps(cms)
    flat = maps.reshape(S * C, H * W)
    vals = flat.amax(dim=1)
    lin = torch.arange(H * W, device=cms.device)
    hit = flat == vals[:, None]
    if half < 0:
        hit = hit | flat.isnan()
    idx = torch.where(hit, lin, H * W).amin(dim=1)  # first occurrence
    ix, iy = idx % W, idx // W
    xy = torch.stack([ix, iy], dim=-1).float()
    if half >= 0:
        size = 2 * half + 1
        # One more zero row below: a NaN map's window is centred on row H.
        padded = F.pad(maps, (half, half, half, half + 1))
        offs = torch.arange(size, device=cms.device)
        rows = (iy[:, None] + offs)[:, :, None]
        cols = (ix[:, None] + offs)[:, None, :]
        patches = padded[torch.arange(S * C, device=cms.device)[:, None, None], rows, cols]
        gv = offs.float() - half
        dx, dy = integral_regression(patches[..., None], xv=gv, yv=gv)
        xy = xy + torch.cat([dx, dy], dim=1)
    xy = torch.where((vals < threshold)[:, None], float("nan"), xy)
    return xy.reshape(S, C, 2), vals.reshape(S, C)


def _nms(maps: torch.Tensor, threshold: float) -> torch.Tensor:
    """Strict 8-neighbour maxima above threshold of (n, H, W) maps; out-of-map
    neighbours count as -inf."""
    H, W = maps.shape[1], maps.shape[2]
    padded = F.pad(maps, (1, 1, 1, 1), value=float("-inf"))
    nbr = torch.full_like(maps, float("-inf"))
    for dy in (0, 1, 2):
        for dx in (0, 1, 2):
            if (dy, dx) != (1, 1):
                nbr = torch.maximum(nbr, padded[:, dy:dy + H, dx:dx + W])
    return (maps > nbr) & (maps > threshold)


def local_peaks_plain(
    cms: torch.Tensor, max_peaks: int, threshold: float, half: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel ``local_peaks``'s contract in plain PyTorch.

    Args:
        cms: (S, H, W, C) maps.
        half: integral window half-size; < 0 for unrefined peaks.

    Returns:
        peaks (S, C, K, 2), NaN in empty slots; vals (S, C, K), -inf in
        empty slots.
    """
    S, H, W, C = cms.shape
    K = max_peaks
    maps = _flat_maps(cms)
    masked = torch.where(_nms(maps, threshold), maps, float("-inf")).reshape(S * C, H * W)
    if H * W < K:
        masked = F.pad(masked, (0, K - H * W), value=float("-inf"))
    # Stable descending sort: equal values keep ascending index order.
    vals, idx = torch.sort(masked, dim=1, descending=True, stable=True)
    vals, idx = vals[:, :K], idx[:, :K]
    peaks = torch.stack([idx % W, idx // W], dim=-1).float()
    if half >= 0:
        map_inds = torch.arange(S * C, device=cms.device).repeat_interleave(K)
        peaks = _integral_refine(maps, peaks.reshape(-1, 2), map_inds, half)
    peaks = torch.where(torch.isfinite(vals).reshape(-1, 1), peaks.reshape(-1, 2), float("nan"))
    return peaks.reshape(S, C, K, 2), vals.reshape(S, C, K)


def local_peaks_hwcs_plain(
    cms: torch.Tensor, max_peaks: int, threshold: float, half: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel ``local_peaks_hwcs``'s contract in plain PyTorch, by its keys.

    Args:
        cms: (S, H, W, C) bf16 maps, H * W <= 2^16, any strides.
        half: 2 for the 5x5 integral window, < 0 for unrefined peaks.

    Returns:
        As :func:`local_peaks_plain` on ``cms.float()``.
    """
    S, H, W, C = cms.shape
    K = max_peaks
    maps = _flat_maps(cms)
    bits = cms.permute(0, 3, 1, 2).reshape(S * C, H * W).view(torch.int16).to(torch.int32)
    inv = H * W - 1 - torch.arange(H * W, dtype=torch.int32, device=cms.device)
    keys = ((bits & 0xFFFF) << 16) | inv
    keys = torch.where(_nms(maps, threshold).reshape(S * C, H * W), keys, _EMPTY_KEY)
    if H * W < K:
        keys = F.pad(keys, (0, K - H * W), value=_EMPTY_KEY)
    keys = torch.topk(keys, K, dim=1).values  # peak keys are unique
    valid = keys != _EMPTY_KEY
    lin = H * W - 1 - (keys & 0xFFFF)
    vals = torch.where(valid, (keys & -65536).view(torch.float32), float("-inf"))
    peaks = torch.stack([lin % W, lin // W], dim=-1).float().reshape(-1, 2)
    if half >= 0:
        map_inds = torch.arange(S * C, device=cms.device).repeat_interleave(K)
        peaks = _integral_refine(maps, peaks, map_inds, half)
    peaks = torch.where(valid.reshape(-1, 1), peaks, float("nan"))
    return peaks.reshape(S, C, K, 2), vals.reshape(S, C, K)


def hwcs_ok(cms: torch.Tensor, threshold: float, half: int) -> bool:
    """Whether kernel ``local_peaks_hwcs`` takes these maps and settings:
    bf16 (S, H, W, C) maps with H * W <= 2^16, threshold > 0 and the 5x5
    window or none (``local_peaks_hwcs_ok`` without the TPU's tiling terms)."""
    return (
        cms.dtype == torch.bfloat16
        and cms.ndim == 4
        and cms.shape[1] * cms.shape[2] <= HWCS_MAX_PIXELS
        and threshold > 0
        and half in (-1, HWCS_HALF)
    )


def hwcs_blocks(H: int, W: int) -> int:
    """Blocks of kernel 4 per sample and channel group: bands of
    :data:`HWCS_BAND_ROWS` rows by segments of :data:`HWCS_MAX_COLS` columns.
    Each leaves K candidate keys per channel in the workspace. Channels come
    in groups of :data:`HWCS_MAX_CHANNELS`, so any channel count fits, and
    the shared memory (a 4-row ring, at most 33 KB) does not depend on C."""
    return -(-H // HWCS_BAND_ROWS) * -(-W // HWCS_MAX_COLS)


def hwcs_fast_rows(cms: torch.Tensor) -> bool:
    """Whether kernel 4 copies whole rows with 16-byte async copies: one
    block spans the width and all channels, and each row is W * C contiguous
    bf16 values starting on a 16-byte boundary. The kernel's entry decides
    this itself (``hwcs_fast_rows`` in ``csrc/peaks.cu``); this mirror names
    the path in tests and in ``chip_smoke.py``."""
    S, H, W, C = cms.shape
    sS, sH, sW, sC = cms.stride()
    return (
        sC == 1 and sW == C and C <= HWCS_MAX_CHANNELS and W <= HWCS_MAX_COLS
        and (W * C) % 8 == 0 and sH % 8 == 0 and sS % 8 == 0
        and cms.data_ptr() % 16 == 0
    )


# --------------------------------------------------------------------------- #
# CUDA wrappers
# --------------------------------------------------------------------------- #


def _check_maps(cms: torch.Tensor, dtypes=(torch.float32,)) -> None:
    if not cms.is_cuda:
        raise ValueError(f"The CUDA peak kernels take CUDA tensors, got {cms.device}.")
    if cms.dtype not in dtypes or cms.ndim != 4:
        names = " or ".join(str(d).removeprefix("torch.") for d in dtypes)
        raise ValueError(f"Expected (S, H, W, C) {names} maps, got {cms.dtype} {tuple(cms.shape)}.")
    if cms.shape[1] * cms.shape[2] >= 2**31:
        raise ValueError("Maps larger than 2**31 pixels are not supported.")


def _launch(name: str, cms: torch.Tensor, *args) -> None:
    launch(name, cms.get_device(), cms.data_ptr(), *cms.stride(), *cms.shape, *args)


def global_peaks_cuda(
    cms: torch.Tensor, threshold: float, half: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch kernel ``global_peaks`` on float32 or bf16 maps, read in place;
    same contract as :func:`global_peaks_plain`, float32 outputs."""
    _check_maps(cms, GLOBAL_DTYPES)
    S, H, W, C = cms.shape
    # One allocation, xy then vals; as_strided views cost the host less than
    # slicing.
    out = cms.new_empty(3 * S * C, dtype=torch.float32)
    xy = out.as_strided((S, C, 2), (2 * C, 2, 1))
    vals = out.as_strided((S, C), (C, 1), 2 * S * C)
    if S * C == 0:
        return xy, vals
    if H * W == 0:
        raise ValueError("Global peaks of empty maps are undefined.")
    _launch(
        "sleap_global_peaks", cms, int(cms.dtype == torch.bfloat16), float(threshold), int(half),
        xy.data_ptr(), vals.data_ptr(),
    )
    global_peaks_cuda.launches += 1
    return xy, vals


global_peaks_cuda.launches = 0


def global_peaks_plan(cms: torch.Tensor, half: int) -> int:
    """The plan kernel ``global_peaks`` takes for these CUDA maps, from its
    library and without a launch: the blocks of a thread block cluster that
    share a map or a sample on the slab route (1 for a block alone), or 0
    for the band route."""
    S, H, W, C = cms.shape
    sS, sH, sW, sC = cms.stride()
    with torch.cuda.device(cms.device):
        return entry("sleap_global_plan")(
            sH, sW, sC, S, H, W, C, int(cms.dtype == torch.bfloat16), int(half))


def local_peaks_cuda(
    cms: torch.Tensor, max_peaks: int, threshold: float, half: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch kernel ``local_peaks``; same contract as :func:`local_peaks_plain`."""
    _check_maps(cms)
    if not 1 <= max_peaks <= MAX_K:
        raise ValueError(f"The local peaks kernel takes 1 <= max_peaks <= {MAX_K}, got {max_peaks}.")
    S, H, W, C = cms.shape
    peaks = cms.new_empty((S, C, max_peaks, 2))
    vals = cms.new_empty((S, C, max_peaks))
    if S * C == 0:
        return peaks, vals
    _launch(
        "sleap_local_peaks", cms, int(max_peaks), float(threshold), int(half),
        peaks.data_ptr(), vals.data_ptr(),
    )
    local_peaks_cuda.launches += 1
    return peaks, vals


local_peaks_cuda.launches = 0


_HWCS_WORKSPACES = {}


def _hwcs_workspace(device: torch.device, n_cand: int, n_samples: int):
    """Kernel 4's candidate keys and per-sample tickets, kept per device and
    stream and grown on demand: the kernel leaves the tickets at zero, so
    one ``torch.zeros`` serves every later call on that stream."""
    key = (device.index, torch._C._cuda_getCurrentRawStream(device.index))
    ws = _HWCS_WORKSPACES.get(key)
    if ws is None or ws[0].numel() < n_cand or ws[1].numel() < n_samples:
        ws = (
            torch.empty(n_cand, dtype=torch.int32, device=device),
            torch.zeros(n_samples, dtype=torch.int32, device=device),
        )
        _HWCS_WORKSPACES[key] = ws
    return ws


def local_peaks_hwcs_cuda(
    cms: torch.Tensor, max_peaks: int, threshold: float, half: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch kernel ``local_peaks_hwcs``; same contract as
    :func:`local_peaks_hwcs_plain`."""
    if cms.dtype != torch.bfloat16 or cms.ndim != 4:
        raise ValueError(f"Expected (S, H, W, C) bfloat16 maps, got {cms.dtype} {tuple(cms.shape)}.")
    S, H, W, C = cms.shape
    if H * W > HWCS_MAX_PIXELS:
        raise ValueError(f"The bf16 local peaks kernel takes H * W <= 2**16, got {H} x {W}.")
    if half not in (-1, HWCS_HALF):
        raise ValueError("The bf16 local peaks kernel refines with the 5 x 5 window only.")
    if not threshold > 0:
        raise ValueError(f"The bf16 local peaks kernel takes threshold > 0, got {threshold}.")
    if not 1 <= max_peaks <= MAX_K:
        raise ValueError(f"The local peaks kernel takes 1 <= max_peaks <= {MAX_K}, got {max_peaks}.")
    if S > 65535:
        raise ValueError(f"The bf16 local peaks kernel takes at most 65535 samples, got {S}.")
    if not cms.is_cuda:
        raise ValueError(f"The CUDA peak kernels take CUDA tensors, got {cms.device}.")
    peaks = cms.new_empty((S, C, max_peaks, 2), dtype=torch.float32)
    vals = cms.new_empty((S, C, max_peaks), dtype=torch.float32)
    if S * C == 0:
        return peaks, vals
    n_cand = S * C * hwcs_blocks(H, W) * max_peaks
    cand, tickets = _hwcs_workspace(cms.device, n_cand, S)
    _launch(
        "sleap_local_peaks_hwcs", cms, int(max_peaks), float(threshold), int(half >= 0),
        cand.data_ptr(), tickets.data_ptr(), peaks.data_ptr(), vals.data_ptr(),
    )
    local_peaks_hwcs_cuda.launches += 1
    return peaks, vals


local_peaks_hwcs_cuda.launches = 0


# --------------------------------------------------------------------------- #
# Device dispatch
# --------------------------------------------------------------------------- #


def global_peaks(cms: torch.Tensor, threshold: float, half: int):
    """CPU tensor -> plain version; otherwise the CUDA kernel (or raise)."""
    if cms.device.type == "cpu":
        return global_peaks_plain(cms, threshold, half)
    return global_peaks_cuda(cms, threshold, half)


def local_peaks(cms: torch.Tensor, max_peaks: int, threshold: float, half: int):
    """CPU tensor -> plain version; otherwise the CUDA kernel (or raise)."""
    if cms.device.type == "cpu":
        return local_peaks_plain(cms, max_peaks, threshold, half)
    return local_peaks_cuda(cms, max_peaks, threshold, half)


def local_peaks_hwcs(cms: torch.Tensor, max_peaks: int, threshold: float, half: int):
    """CPU tensor -> plain version; otherwise the CUDA kernel (or raise)."""
    if cms.device.type == "cpu":
        return local_peaks_hwcs_plain(cms, max_peaks, threshold, half)
    return local_peaks_hwcs_cuda(cms, max_peaks, threshold, half)

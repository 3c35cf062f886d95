"""The port's ground-truth codecs against the JAX package's on the same
seeded inputs: grid vectors, confidence maps (single and multi-instance,
NaN nodes, instances outside the grid), offsets and their masks,
multi-instance maps with offsets, part affinity fields and edge points,
instance centroids, centered boxes and ``crop_and_resize`` with boxes off
the image. The JAX functions map over samples (``vmap``), the port's
broadcast over the leading axes, so each port call takes the whole batch.

Tolerance: 1e-6 absolute on every value (maps lie in [0, 1], offsets are a
few units, crops of pixel values to 255 come out bitwise equal); the same
float32 operations in the same order on both sides.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sleap_tpu.data.instance_centroids import get_instance_centroids as jax_centroids
from sleap_tpu.ops import confmaps as jc
from sleap_tpu.ops import edge_maps as je
from sleap_tpu.ops import grid as jg
from sleap_tpu.ops import offsets as jo
from sleap_tpu.ops import peak_finding as jpf
from sleap_tpu_torch.data.instance_centroids import get_instance_centroids
from sleap_tpu_torch.ops import confmaps as tc
from sleap_tpu_torch.ops import edge_maps as te
from sleap_tpu_torch.ops import grid as tg
from sleap_tpu_torch.ops import offsets as to
from sleap_tpu_torch.ops import peak_finding as tpf

torch.set_num_threads(1)
TOL = 1e-6


@pytest.fixture(autouse=True)
def _highest_precision():
    with jax.default_matmul_precision("highest"):
        yield


def _close(port, ref, tol=TOL):
    port = port.detach().cpu().numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    ref = np.asarray(ref)
    assert port.shape == ref.shape, (port.shape, ref.shape)
    np.testing.assert_array_equal(np.isnan(port), np.isnan(ref))
    np.testing.assert_allclose(port, ref, rtol=0, atol=tol, equal_nan=True)


def _instances(rng, b=3, i=4, n=5, size=(40, 48), nan_frac=0.15):
    """(b, i, n, 2) xy: some NaN nodes, one wholly NaN instance, one
    instance off the grid, one on its far edge."""
    h, w = size
    pts = rng.uniform(-4, [w + 4, h + 4], (b, i, n, 2)).astype("f4")
    pts[rng.random((b, i, n)) < nan_frac] = np.nan
    pts[0, -1] = np.nan
    pts[1, 0] = rng.uniform(w + 5, w + 20, (n, 2))
    pts[2, 1, :, 0] = w - 2  # on the last grid column (stride 2): not strictly inside
    return pts


@pytest.mark.parametrize("size,stride", [((40, 48), 1), ((40, 48), 2), ((37, 29), 4)])
def test_grid_vectors(size, stride):
    h, w = size
    for port, ref in zip(tg.make_grid_vectors(h, w, stride), jg.make_grid_vectors(h, w, stride)):
        _close(port, ref, 0)
    x = np.linspace(-9, 9, 31, dtype="f4")
    _close(tg.gaussian_pdf(torch.from_numpy(x), 2.5), jg.gaussian_pdf(jnp.asarray(x), 2.5))


@pytest.mark.parametrize("stride,sigma", [(1, 1.5), (2, 2.5), (4, 5.0)])
def test_confmaps(stride, sigma):
    rng = np.random.default_rng(stride)
    inst = _instances(rng)
    xv, yv = tg.make_grid_vectors(40, 48, stride)
    jxv, jyv = jg.make_grid_vectors(40, 48, stride)
    # Single instance: one instance per sample.
    ref = jax.vmap(lambda p: jc.make_confmaps(p, jxv, jyv, sigma))(jnp.asarray(inst[:, 0]))
    _close(tc.make_confmaps(torch.from_numpy(inst[:, 0]), xv, yv, sigma), ref)
    # Every instance at once (what the class maps use).
    ref = jax.vmap(jax.vmap(lambda p: jc.make_confmaps(p, jxv, jyv, sigma)))(jnp.asarray(inst))
    _close(tc.make_confmaps(torch.from_numpy(inst), xv, yv, sigma), ref)
    # Multi-instance, with the out-of-grid instances dropped.
    keep = jax.vmap(lambda i: jc._instances_in_image(i, jxv, jyv))(jnp.asarray(inst))
    _close(tc._instances_in_image(torch.from_numpy(inst), xv, yv), keep, 0)
    assert not np.asarray(keep)[1, 0] and not np.asarray(keep)[0, -1]
    ref = jax.vmap(lambda i: jc.make_multi_confmaps(i, jxv, jyv, sigma))(jnp.asarray(inst))
    _close(tc.make_multi_confmaps(torch.from_numpy(inst), xv, yv, sigma), ref)


@pytest.mark.parametrize("stride", [1, 2, 4])
def test_offsets_and_masks(stride):
    rng = np.random.default_rng(10 + stride)
    pts = _instances(rng)[:, 0]
    xv, yv = tg.make_grid_vectors(40, 48, stride)
    jxv, jyv = jg.make_grid_vectors(40, 48, stride)
    ref_off = jax.vmap(lambda p: jo.make_offsets(p, jxv, jyv, stride))(jnp.asarray(pts))
    off = to.make_offsets(torch.from_numpy(pts), xv, yv, stride)
    _close(off, ref_off)
    cms = tc.make_confmaps(torch.from_numpy(pts), xv, yv, 2.0)
    for threshold in (0.2, 0.5):
        ref = jo.mask_offsets(ref_off, jnp.asarray(cms.numpy()), threshold)
        _close(to.mask_offsets(off, cms, threshold), ref)


@pytest.mark.parametrize("stride,sigma", [(2, 2.5), (4, 1.5)])
def test_multi_confmaps_with_offsets(stride, sigma):
    rng = np.random.default_rng(20 + stride)
    inst = _instances(rng)
    xv, yv = tg.make_grid_vectors(40, 48, stride)
    jxv, jyv = jg.make_grid_vectors(40, 48, stride)
    ref_cm, ref_off = jax.vmap(
        lambda i: jc.make_multi_confmaps_with_offsets(i, jxv, jyv, stride, sigma)
    )(jnp.asarray(inst))
    cm, off = tc.make_multi_confmaps_with_offsets(torch.from_numpy(inst), xv, yv, stride, sigma)
    _close(cm, ref_cm)
    _close(off, ref_off)


@pytest.mark.parametrize("stride,sigma", [(1, 3.0), (4, 5.0)])
def test_pafs_and_edge_points(stride, sigma):
    rng = np.random.default_rng(30 + stride)
    inst = _instances(rng)
    inst[0, 0, 1] = inst[0, 0, 0]  # a zero-length edge: NaN field, zeroed in the sum
    edge_inds = [(0, 1), (1, 2), (2, 3), (1, 4)]
    jedges = jnp.asarray(edge_inds, jnp.int32)
    src, dst = te.get_edge_points(torch.from_numpy(inst), edge_inds)
    jsrc, jdst = je.get_edge_points(jnp.asarray(inst.reshape(-1, 5, 2)), jedges)
    _close(src, np.asarray(jsrc).reshape(3, 4, 4, 2), 0)
    _close(dst, np.asarray(jdst).reshape(3, 4, 4, 2), 0)
    xv, yv = tg.make_grid_vectors(40, 48, stride)
    jxv, jyv = jg.make_grid_vectors(40, 48, stride)
    # One instance's edges, NaN where an endpoint is missing.
    ref = je.make_pafs(jxv, jyv, jsrc[1], jdst[1], sigma)
    _close(te.make_pafs(xv, yv, src[0, 1], dst[0, 1], sigma), ref)
    ref = je.make_edge_maps(jxv, jyv, jsrc[1], jdst[1], sigma)
    _close(te.make_edge_maps(xv, yv, src[0, 1], dst[0, 1], sigma), ref)
    grid = np.stack(np.meshgrid(np.asarray(jxv), np.asarray(jyv)), -1)
    ref = je.distance_to_edge(jnp.asarray(grid), jsrc[1], jdst[1])
    _close(te.distance_to_edge(torch.from_numpy(grid), src[0, 1], dst[0, 1]), ref)
    ref = jax.vmap(lambda s, d: je.make_multi_pafs(jxv, jyv, s, d, sigma))(
        jsrc.reshape(3, 4, 4, 2), jdst.reshape(3, 4, 4, 2))
    out = te.make_multi_pafs(xv, yv, src, dst, sigma)
    _close(out, ref)
    assert np.isfinite(out.numpy()).all()


@pytest.mark.filterwarnings("ignore:All-NaN slice")
@pytest.mark.parametrize("anchor_ind", [None, 0, 2])
def test_instance_centroids(anchor_ind):
    rng = np.random.default_rng(40)
    inst = _instances(rng, nan_frac=0.3)
    inst[2, 2, 1:] = np.nan  # only the first node visible
    ref = np.stack([jax_centroids(i, anchor_ind) for i in inst])
    _close(get_instance_centroids(torch.from_numpy(inst), anchor_ind), ref.astype("f4"))

    # The trainer's in-jit form (jnp.nanmin / nanmax, anchor override).
    def centroids_of(instances):
        mids = (jnp.nanmin(instances, axis=1) + jnp.nanmax(instances, axis=1)) / 2.0
        if anchor_ind is not None:
            anchors = instances[:, anchor_ind, :]
            mids = jnp.where(jnp.isnan(anchors).any(axis=-1)[:, None], mids, anchors)
        return mids

    _close(get_instance_centroids(torch.from_numpy(inst), anchor_ind),
           jax.vmap(centroids_of)(jnp.asarray(inst)))


def test_centered_bboxes_and_crops():
    rng = np.random.default_rng(50)
    images = rng.uniform(0, 255, (3, 37, 45, 2)).astype("f4")
    # Centroids inside, near and past every edge.
    centroids = np.array([[10.3, 12.7], [-3.0, 20.5], [44.6, 36.2], [22.5, 40.0],
                          [60.0, -9.0], [0.0, 0.0]], "f4")
    for box_h, box_w in ((9, 9), (16, 12), (1, 5)):
        boxes = tpf.make_centered_bboxes(torch.from_numpy(centroids), box_h, box_w)
        jboxes = jpf.make_centered_bboxes(jnp.asarray(centroids), box_h, box_w)
        _close(boxes, jboxes)
        inds = np.array([0, 1, 2, 2, 1, 0], "i4")
        for crop in ((box_h, box_w), (7, 11)):  # unit spacing, and resampled
            ref = jpf.crop_and_resize(jnp.asarray(images), jboxes, jnp.asarray(inds), crop)
            out = tpf.crop_and_resize(torch.from_numpy(images), boxes, torch.from_numpy(inds), crop)
            _close(out, ref)
    # uint8 frames are read as float32.
    u8 = images.astype(np.uint8)
    boxes = tpf.make_centered_bboxes(torch.from_numpy(centroids[:3]), 8, 8)
    ref = jpf.crop_and_resize(jnp.asarray(u8), jnp.asarray(boxes.numpy()), jnp.arange(3), (8, 8))
    _close(tpf.crop_and_resize(torch.from_numpy(u8), boxes, torch.arange(3), (8, 8)), ref)


def test_trainer_crops_need_the_general_crop():
    """At the trainer's shapes (1024^2 frames in [0, 1], 160^2 crops centred
    on fractional centroids) the port's ``crop_and_resize`` equals JAX's to
    1e-6, while the unit-spacing crop of inference (``crop_bboxes_unit``,
    the crop kernel's contract) does not: it samples ``floor(x1) + i +
    frac(x1)`` where the general crop samples ``x1 + (x2 - x1) * i / 159``,
    and the float32 positions differ by up to ~6e-5 px far from the origin.
    So the trainer cuts its ground-truth crops with ``crop_and_resize``."""
    rng = np.random.default_rng(51)
    images = rng.random((4, 1024, 1024, 1), dtype=np.float32)
    centroids = (rng.random((4, 2)) * 1064 - 20).astype("f4")
    boxes = tpf.make_centered_bboxes(torch.from_numpy(centroids), 160, 160)
    ref = np.asarray(jpf.crop_and_resize(jnp.asarray(images), jnp.asarray(boxes.numpy()),
                                         jnp.arange(4), (160, 160)))
    out = tpf.crop_and_resize(torch.from_numpy(images), boxes, torch.arange(4), (160, 160))
    _close(out, ref)
    unit = tpf.crop_bboxes_unit(torch.from_numpy(images), boxes[:, [1, 0]], torch.arange(4),
                                (160, 160))
    assert np.abs(unit.numpy() - ref).max() > 10 * TOL

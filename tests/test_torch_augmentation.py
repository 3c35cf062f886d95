"""The port's augmentation against the JAX package's: the affine matrix,
``apply_affine`` given a matrix, flips with a skeleton's ``flip_idx``, and
``augment_example``'s whole chain given the values JAX drew (rotation,
scale, translation, flip, random crop, noise, contrast, brightness),
sample by sample; the port's draws are reproducible from a seed and stay in
the configured ranges.

Tolerance: 1e-5 absolute on images in [0, 1] and on points (the inverse
matrix and the sample positions are float32 on both sides, on 48 x 40
frames); flips and crops exact. Every chain is held to 1e-5 with the port
given JAX's inverse of the matrix (``torch.linalg.inv`` patched to
``jnp.linalg.inv``): the chain of every transform then reads at most
8.7e-6. That chain runs once more with the port's own inverse, at 3e-5:
the two LAPACK inverses differ by up to 8e-6 in the translation (float32
rounding), which moves sample positions by as much; on these white-noise
frames (slopes up to 1 a px) and through a gamma as low as 0.5 (slope up to
~3.5 at the frames' darkest values) that reads 1.24e-5 over the four seeds.
"""

import dataclasses
import math

import attr
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sleap_tpu.config import AugmentationConfig as JaxAugmentationConfig
from sleap_tpu.core.skeleton import Skeleton as JaxSkeleton
from sleap_tpu.data import augmentation as ja
from sleap_tpu_torch.config import AugmentationConfig
from sleap_tpu_torch.core.skeleton import Skeleton
from sleap_tpu_torch.data import augmentation as ta

torch.set_num_threads(1)
TOL = 1e-5
H, W, C = 40, 48, 2


@pytest.fixture(autouse=True)
def _highest_precision():
    with jax.default_matmul_precision("highest"):
        yield


def _example(seed, n_inst=3, n_nodes=5):
    rng = np.random.default_rng(seed)
    image = rng.uniform(0, 1, (H, W, C)).astype("f4")
    pts = rng.uniform(2, [W - 2, H - 2], (n_inst, n_nodes, 2)).astype("f4")
    pts[0, 1] = np.nan
    pts[-1] = np.nan
    return image, pts


def _skeletons():
    names = ["head", "l_ear", "r_ear", "l_leg", "r_leg"]
    skels = []
    for cls in (Skeleton, JaxSkeleton):
        s = cls("mouse")
        for n in names:
            s.add_node(n)
        s.add_edge("head", "l_ear")
        s.add_edge("head", "r_ear")
        s.add_symmetry("r_leg", "l_leg")
        s.add_symmetry("l_ear", "r_ear")
        skels.append(s)
    return skels


def test_affine_matrix():
    for angle, scale, tx, ty in ((0.3, 1.1, 2.0, -3.5), (-2.9, 0.9, 0.0, 0.0), (0.0, 1.0, 5, 5)):
        ref = ja._affine_matrix(jnp.float32(angle), jnp.float32(scale),
                                jnp.asarray([tx, ty], jnp.float32), (W / 2 - 0.5, H / 2 - 0.5))
        out = ta._affine_matrix(torch.tensor(angle), torch.tensor(scale), torch.tensor([tx, ty]),
                                (W / 2 - 0.5, H / 2 - 0.5))
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=1e-5)
    batched = ta._affine_matrix(torch.tensor([0.3, -2.9]), torch.tensor([1.1, 0.9]),
                                torch.tensor([[2.0, -3.5], [0.0, 0.0]]), (5.0, 7.0))
    assert batched.shape == (2, 3, 3)


@pytest.mark.parametrize("angle,scale,translate", [(0.4, 1.0, (0, 0)), (-1.3, 1.08, (3.3, -4.1)),
                                                   (math.pi, 0.93, (-1.5, 2.25))])
def test_apply_affine_given_matrix(angle, scale, translate):
    image, pts = _example(1)
    matrix = np.asarray(ja._affine_matrix(jnp.float32(angle), jnp.float32(scale),
                                          jnp.asarray(translate, jnp.float32),
                                          (W / 2 - 0.5, H / 2 - 0.5)))
    ref_img, ref_pts = ja.apply_affine(jnp.asarray(image), jnp.asarray(pts), jnp.asarray(matrix))
    img, out_pts = ta.apply_affine(torch.from_numpy(image)[None], torch.from_numpy(pts)[None],
                                   torch.from_numpy(matrix.copy())[None])
    np.testing.assert_allclose(img[0].numpy(), np.asarray(ref_img), rtol=0, atol=TOL)
    np.testing.assert_allclose(out_pts[0].numpy(), np.asarray(ref_pts), rtol=0, atol=TOL)
    # Some taps fell outside the frame and read 0 on their own.
    assert (img.numpy() == 0).mean() < 0.5


def test_flips_swap_symmetric_nodes():
    skel, jskel = _skeletons()
    assert skel.flip_idx() == jskel.flip_idx() == [0, 2, 1, 4, 3]
    _, pts = _example(2)
    for tfn, jfn, size in ((ta.flip_instances_lr, ja.flip_instances_lr, W),
                           (ta.flip_instances_ud, ja.flip_instances_ud, H)):
        for idx in (None, skel.flip_idx()):
            ref = jfn(jnp.asarray(pts), size, None if idx is None else jnp.asarray(idx))
            out = tfn(torch.from_numpy(pts), size, idx)
            np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def _config(**kw):
    return AugmentationConfig(**kw), JaxAugmentationConfig(**kw)


def _jax_draws(key, cfg, image_shape):
    """The values ``augment_example`` draws from ``key``, in the port's
    draw names (each line mirrors the JAX function's own draw)."""
    h, w, c = image_shape
    keys = jax.random.split(key, 10)
    d = {}
    if cfg.rotate or cfg.scale or cfg.translate:
        d["angle"] = (jax.random.uniform(keys[0], minval=jnp.deg2rad(cfg.rotation_min_angle),
                                         maxval=jnp.deg2rad(cfg.rotation_max_angle))
                      if cfg.rotate else 0.0)
        d["scale"] = (jax.random.uniform(keys[1], minval=cfg.scale_min, maxval=cfg.scale_max)
                      if cfg.scale else 1.0)
        d["translate"] = (jax.random.uniform(keys[2], (2,), minval=cfg.translate_min,
                                             maxval=cfg.translate_max)
                          if cfg.translate else jnp.zeros(2))
    if cfg.random_flip:
        d["flip"] = jax.random.bernoulli(keys[3])
    ch, cw = cfg.random_crop_height, cfg.random_crop_width
    if cfg.random_crop and (ch < h or cw < w):
        d["crop_offset"] = jnp.stack([jax.random.randint(keys[8], (), 0, max(h - ch, 1)),
                                      jax.random.randint(keys[9], (), 0, max(w - cw, 1))])
        h, w = min(ch, h), min(cw, w)
    if cfg.uniform_noise:
        d["uniform_noise"] = jax.random.uniform(keys[4], (h, w, c),
                                                minval=cfg.uniform_noise_min_val / 255.0,
                                                maxval=cfg.uniform_noise_max_val / 255.0)
    if cfg.gaussian_noise:
        d["gaussian_noise"] = jax.random.normal(keys[5], (h, w, c))
    if cfg.contrast:
        d["gamma"] = jax.random.uniform(keys[6], minval=cfg.contrast_min_gamma,
                                        maxval=cfg.contrast_max_gamma)
    if cfg.brightness:
        d["brightness"] = jax.random.uniform(keys[7], minval=cfg.brightness_min_val / 255.0,
                                             maxval=cfg.brightness_max_val / 255.0)
    return d


CHAINS = {
    "geometric": dict(rotate=True, rotation_min_angle=-30, rotation_max_angle=30, scale=True,
                      translate=True),
    "flip_lr": dict(random_flip=True),
    "flip_ud": dict(random_flip=True, flip_horizontal=False),
    "crop": dict(random_crop=True, random_crop_height=24, random_crop_width=32),
    "photometric": dict(uniform_noise=True, gaussian_noise=True, contrast=True,
                        brightness=True, brightness_max_val=40.0),
    "everything": dict(rotate=True, scale=True, scale_min=0.8, translate=True, random_flip=True,
                       random_crop=True, random_crop_height=32, random_crop_width=40,
                       uniform_noise=True, gaussian_noise=True, contrast=True, brightness=True),
}


# Each chain with JAX's inverse of the matrix, at TOL; and the chain of every
# transform once more with the port's own inverse, at OWN_INVERSE_TOL.
CHAIN_CASES = [(chain, True) for chain in sorted(CHAINS)] + [("everything", False)]
OWN_INVERSE_TOL = 3e-5


def _jax_inv(matrix):
    return torch.from_numpy(np.array(jnp.linalg.inv(jnp.asarray(matrix.numpy()))))


@pytest.mark.parametrize(
    "chain, jax_inverse", CHAIN_CASES,
    ids=[c if j else f"{c}-own_inverse" for c, j in CHAIN_CASES],
)
def test_augment_example_given_jax_draws(chain, jax_inverse, monkeypatch):
    cfg, jcfg = _config(**CHAINS[chain])
    tol = TOL
    if jax_inverse:
        monkeypatch.setattr(torch.linalg, "inv", _jax_inv)
    else:
        tol = OWN_INVERSE_TOL
    skel, jskel = _skeletons()
    for seed in range(4):
        image, pts = _example(10 + seed)
        key = jax.random.PRNGKey(seed)
        draws = {k: torch.as_tensor(np.asarray(v))[None]
                 for k, v in _jax_draws(key, jcfg, image.shape).items()}
        cases = [(jcfg, draws)]
        if cfg.random_flip:
            # These keys all draw a flip: the unflipped branch is JAX's
            # chain without the flip, given the same other draws.
            cases.append((attr.evolve(jcfg, random_flip=False),
                          {**draws, "flip": ~draws["flip"]}))
        for jc, d in cases:
            ref_img, ref_pts = ja.augment_example(key, jnp.asarray(image), jnp.asarray(pts), jc,
                                                  jnp.asarray(jskel.flip_idx(), jnp.int32))
            img, out_pts = ta.apply_augmentation(torch.from_numpy(image)[None],
                                                 torch.from_numpy(pts)[None], d, cfg,
                                                 skel.flip_idx())
            assert img.shape[1:] == ref_img.shape
            np.testing.assert_allclose(img[0].numpy(), np.asarray(ref_img), rtol=0, atol=tol)
            np.testing.assert_allclose(out_pts[0].numpy(), np.asarray(ref_pts), rtol=0, atol=TOL)


def test_batch_applies_each_samples_draws():
    """A batch of 4 equals its samples augmented one at a time."""
    cfg, _ = _config(**CHAINS["everything"])
    examples = [_example(20 + i) for i in range(4)]
    images = torch.from_numpy(np.stack([e[0] for e in examples]))
    pts = torch.from_numpy(np.stack([e[1] for e in examples]))
    draws = ta.draw_augmentation(cfg, 4, (H, W, C), torch.Generator().manual_seed(3))
    img, out_pts = ta.apply_augmentation(images, pts, draws, cfg, [0, 2, 1, 4, 3])
    for i in range(4):
        one = {k: v[i:i + 1] for k, v in draws.items()}
        img_i, pts_i = ta.apply_augmentation(images[i:i + 1], pts[i:i + 1], one, cfg,
                                             [0, 2, 1, 4, 3])
        torch.testing.assert_close(img[i:i + 1], img_i, rtol=0, atol=1e-6)
        torch.testing.assert_close(out_pts[i:i + 1], pts_i, rtol=0, atol=1e-6, equal_nan=True)


def test_draws_are_seeded_and_in_range():
    cfg, _ = _config(**{**CHAINS["everything"], "rotation_min_angle": -20,
                        "rotation_max_angle": 45, "translate_min": -3, "translate_max": 7})
    n = 256
    a = ta.draw_augmentation(cfg, n, (H, W, C), torch.Generator().manual_seed(5))
    b = ta.draw_augmentation(cfg, n, (H, W, C), torch.Generator().manual_seed(5))
    c = ta.draw_augmentation(cfg, n, (H, W, C), torch.Generator().manual_seed(6))
    assert a.keys() == b.keys() == set(ta.draw_augmentation(
        cfg, 1, (H, W, C), torch.Generator()).keys())
    for k in a:
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)
        assert not torch.equal(a[k], c[k])

    def within(x, lo, hi):
        return bool((x >= lo).all() and (x <= hi).all())

    assert within(a["angle"], math.radians(-20), math.radians(45))
    assert within(a["scale"], cfg.scale_min, cfg.scale_max)
    assert within(a["translate"], -3, 7)
    assert 0.3 < a["flip"].float().mean() < 0.7
    assert a["crop_offset"].dtype == torch.int64
    assert within(a["crop_offset"][:, 0], 0, H - 32 - 1) and within(a["crop_offset"][:, 1], 0, W - 40 - 1)
    assert a["uniform_noise"].shape == (n, 32, 40, C)
    assert within(a["uniform_noise"], 0.0, 10.0 / 255)
    assert abs(float(a["gaussian_noise"].std()) - 1.0) < 0.05
    assert within(a["gamma"], 0.5, 2.0)
    assert within(a["brightness"], 0.0, 10.0 / 255)
    # Nothing configured, nothing drawn.
    assert ta.draw_augmentation(AugmentationConfig(), 4, (H, W, C), torch.Generator()) == {}


def test_configs_have_the_same_fields():
    assert ([(f.name, f.default) for f in dataclasses.fields(AugmentationConfig)]
            == [(f.name, f.default) for f in JaxAugmentationConfig.__attrs_attrs__])

"""The port's ``ops/utils.py`` against the JAX package's on the CPU, exact:
``group_array`` and ``compute_iou`` on seeded inputs, and ``match_points``
(the port's LAP solver on the points' device, JAX's on-chip solver) on
square and rectangular point sets, as numpy arrays and as torch tensors;
the indices are int32 numpy in both."""

import numpy as np
import pytest
import torch

from sleap_tpu.ops import utils as jutils
from sleap_tpu_torch.ops import utils


def test_group_array_matches_jax():
    rng = np.random.default_rng(0)
    X = rng.normal(size=(9, 4))
    for groups, axis in ((rng.integers(0, 3, 9), 0), (np.array(list("abcab")), 0),
                         (np.array([2, 1, 2, 0]), 1)):
        n = X.shape[axis]
        groups = groups[:n] if len(groups) >= n else np.resize(groups, n)
        got, want = utils.group_array(X, groups, axis), jutils.group_array(X, groups, axis)
        assert list(got) == list(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])


def test_compute_iou_matches_jax():
    rng = np.random.default_rng(1)
    for _ in range(200):
        b1 = np.sort(rng.integers(0, 20, 4).reshape(2, 2), axis=0).reshape(-1)  # y1 x1 y2 x2
        b2 = np.sort(rng.integers(0, 20, 4).reshape(2, 2), axis=0).reshape(-1)
        np.testing.assert_equal(utils.compute_iou(b1, b2), jutils.compute_iou(b1, b2))
    assert utils.compute_iou(np.array([0, 0, 1, 1]), np.array([1, 1, 2, 2])) == 1 / 7


@pytest.mark.parametrize("n,m,seed", [(2, 2, 0), (3, 2, 1), (2, 5, 2), (6, 6, 3), (9, 4, 4), (1, 7, 5),
                                      (12, 12, 6)])
def test_match_points_matches_jax(n, m, seed):
    rng = np.random.default_rng(seed)
    p1 = rng.uniform(0, 50, (n, 2))
    p2 = rng.uniform(0, 50, (m, 2))
    want = jutils.match_points(p1, p2)
    for a, b in ((p1, p2), (torch.from_numpy(p1), torch.from_numpy(p2))):
        got = utils.match_points(a, b)
        assert all(isinstance(x, np.ndarray) and x.dtype == np.int32 for x in got)
        assert len(got[0]) == min(n, m)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])


def test_match_points_pairs_nearest():
    i1, i2 = utils.match_points(np.array([[0.0, 0.0], [5.0, 5.0], [20.0, 20.0]]),
                                np.array([[5.2, 5.0], [19.8, 20.0]]))
    assert dict(zip(i1.tolist(), i2.tolist())) == {1: 0, 2: 1}

"""The port's example-stream blocks (``sleap_tpu_torch.data.dataset_ops``),
its ``data/utils.py`` and its prefetching against the JAX package's, on the
CPU: the same example dicts (the port's ``LabelsReader`` of a seeded project)
through each block of both packages give the same output exactly (arrays
bitwise, orders and keys the same), including ``Shuffler``'s order
for a seed and ``split_labels_train_val``'s split, ``Batcher``'s padding by
dtype, and ``prefetch``'s ``buffer_size`` (how far the producer runs ahead).
"""

import threading
import time

import numpy as np
import pytest
import torch

from sleap_tpu.core.instance import Instance as JaxInstance
from sleap_tpu.core.instance import LabeledFrame as JaxLabeledFrame
from sleap_tpu.core.labels import Labels as JaxLabels
from sleap_tpu.core.skeleton import Skeleton as JaxSkeleton
from sleap_tpu.data import dataset_ops as jops
from sleap_tpu.data import prefetch as jprefetch
from sleap_tpu.data import utils as jutils
from sleap_tpu.data.providers import LabelsReader as JaxLabelsReader
from sleap_tpu.io.video import Video as JaxVideo
from sleap_tpu_torch.core.instance import Instance, LabeledFrame
from sleap_tpu_torch.core.labels import Labels
from sleap_tpu_torch.core.skeleton import Skeleton
from sleap_tpu_torch.data import dataset_ops as ops
from sleap_tpu_torch.data import prefetch
from sleap_tpu_torch.data import utils
from sleap_tpu_torch.data.providers import LabelsReader
from sleap_tpu_torch.io.video import Video


def _labels_pair(n_frames=7, seed=0):
    """The same labels in both packages: 48 x 64 frames, one to three
    instances of three nodes a frame, some frames without instances."""
    rng = np.random.default_rng(seed)
    frames = rng.integers(0, 255, (n_frames, 48, 64, 1), np.uint8)
    counts = rng.integers(0, 4, n_frames)
    counts[:2] = (1, 3)[:n_frames]
    pts = [rng.uniform(5, 40, (c, 3, 2)) for c in counts]
    out = []
    for skel_cls, inst_cls, lf_cls, labels_cls, video_cls in (
            (Skeleton, Instance, LabeledFrame, Labels, Video),
            (JaxSkeleton, JaxInstance, JaxLabeledFrame, JaxLabels, JaxVideo)):
        skel = skel_cls.from_names_and_edge_inds(["a", "b", "c"], [(0, 1), (1, 2)])
        video = video_cls.from_numpy(frames)
        out.append(labels_cls([lf_cls(video=video, frame_idx=i,
                                      instances=[inst_cls(skeleton=skel, points=p) for p in pts[i]])
                               for i in range(n_frames)]))
    return out


@pytest.fixture(scope="module")
def examples():
    """The port's preloaded examples, and the same dicts for the JAX blocks."""
    labels, _ = _labels_pair()
    got = ops.Preloader().transform_dataset(LabelsReader.from_user_instances(labels))
    return got, [dict(ex) for ex in got]


def _assert_same(got, want):
    got, want = list(got), list(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert list(g) == list(w)
        for k in w:
            np.testing.assert_array_equal(np.asarray(g[k]), np.asarray(w[k]), err_msg=k)
            assert np.asarray(g[k]).dtype == np.asarray(w[k]).dtype, k


def test_preloaded_examples_match_jax():
    """Each package's reader of the same project through its Preloader:
    the same frames, images and instances."""
    labels, jlabels = _labels_pair()
    got = ops.Preloader().transform_dataset(LabelsReader.from_user_instances(labels))
    want = jops.Preloader().transform_dataset(JaxLabelsReader.from_user_instances(jlabels))
    assert isinstance(got, list) and len(got) == len(want) >= 4
    for g, w in zip(got, want):
        for k in ("image", "frame_ind", "video_ind", "instances"):
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


@pytest.mark.parametrize("seed,buffer_size", [(0, 2), (1, 3), (7, 64), (None, 1)])
def test_shuffler_order_matches_jax(examples, seed, buffer_size):
    got, want = examples
    if seed is None:  # unseeded: the same frames, in an order of its own
        order = [int(e["frame_ind"]) for e in ops.Shuffler(buffer_size=buffer_size).transform_dataset(got)]
        assert sorted(order) == sorted(int(e["frame_ind"]) for e in got)
        return
    _assert_same(ops.Shuffler(seed=seed, buffer_size=buffer_size).transform_dataset(got),
                 jops.Shuffler(seed=seed, buffer_size=buffer_size).transform_dataset(want))
    _assert_same(ops.Shuffler(shuffle=False).transform_dataset(got), want)


def test_key_blocks_match_jax(examples):
    got, want = examples
    even = lambda ex: int(ex["frame_ind"]) % 2 == 0  # noqa: E731
    twice = lambda ex: {**ex, "twice": ex["frame_ind"] * 2}  # noqa: E731
    for block, jblock in (
            (ops.LambdaFilter(even), jops.LambdaFilter(even)),
            (ops.LambdaFilter(), jops.LambdaFilter()),
            (ops.KeyRenamer(["image", "scale"], ["img", "s"]), jops.KeyRenamer(["image", "scale"], ["img", "s"])),
            (ops.KeyRenamer(["image"], ["img"], drop_old=False), jops.KeyRenamer(["image"], ["img"], drop_old=False)),
            (ops.KeyFilter(["image", "frame_ind"]), jops.KeyFilter(["image", "frame_ind"])),
            (ops.KeyFilter(), jops.KeyFilter()),
            (ops.LambdaMap(twice), jops.LambdaMap(twice)),
            (ops.LambdaMap(), jops.LambdaMap())):
        _assert_same(block.transform_dataset(got), jblock.transform_dataset(want))


@pytest.mark.parametrize("batch_size,drop_remainder", [(2, False), (2, True), (3, False), (8, False)])
def test_batcher_unbatcher_match_jax(examples, batch_size, drop_remainder):
    got, want = examples
    batches = list(ops.Batcher(batch_size, drop_remainder).transform_dataset(got))
    jbatches = list(jops.Batcher(batch_size, drop_remainder).transform_dataset(want))
    _assert_same(batches, jbatches)
    # Frames of 1 to 3 instances: the instance counts differ inside a batch.
    assert any(np.isnan(b["instances"]).all(axis=(-1, -2)).any() for b in batches if len(b["image"]) > 1)
    _assert_same(ops.Unbatcher().transform_dataset(batches), jops.Unbatcher().transform_dataset(jbatches))


def test_batcher_pads_by_dtype_as_jax():
    exs = [{"f": np.zeros((1, 2), np.float32), "i": np.zeros(1, np.int32), "u": np.ones(1, np.uint8),
            "b": np.ones(1, bool), "same": np.arange(3)},
           {"f": np.ones((3, 2), np.float32), "i": np.ones(3, np.int32), "u": np.ones(3, np.uint8),
            "b": np.ones(3, bool), "same": np.arange(3)}]
    got = next(ops.Batcher(batch_size=2).transform_dataset(exs))
    want = next(jops.Batcher(batch_size=2).transform_dataset(exs))
    _assert_same([got], [want])
    assert np.isnan(got["f"][0, 1:]).all() and (got["i"][0, 1:] == -1).all()
    assert (got["u"][0, 1:] == 0).all() and not got["b"][0, 1:].any()


@pytest.mark.parametrize("epochs,repeat", [(2, True), (1, True), (3, False)])
def test_repeater_matches_jax(examples, epochs, repeat):
    got, want = examples
    _assert_same(ops.Repeater(repeat, epochs).transform_dataset(got),
                 jops.Repeater(repeat, epochs).transform_dataset(want))
    assert list(ops.Repeater(epochs=-1).transform_dataset([])) == []  # an empty source ends


def test_repeater_forever(examples):
    got, _ = examples
    stream = ops.Repeater().transform_dataset(got)
    assert len([next(stream) for _ in range(4 * len(got))]) == 4 * len(got)


@pytest.mark.parametrize("enabled,buffer_size", [(True, 1), (True, 2), (False, 1)])
def test_prefetcher_chain_gives_every_example_back(examples, enabled, buffer_size):
    got, want = examples
    chain = ops.Unbatcher().transform_dataset(ops.Prefetcher(enabled, buffer_size).transform_dataset(
        ops.Batcher(batch_size=2).transform_dataset(ops.Shuffler(seed=3, buffer_size=2).transform_dataset(got))))
    jchain = jops.Unbatcher().transform_dataset(jops.Prefetcher(enabled, buffer_size).transform_dataset(
        jops.Batcher(batch_size=2).transform_dataset(jops.Shuffler(seed=3, buffer_size=2).transform_dataset(want))))
    _assert_same(chain, jchain)


def _run_ahead(make_prefetcher, buffer_size):
    """Items a prefetcher's producer takes before the consumer reads one:
    a full queue and the one its put waits on."""
    taken = []
    lock = threading.Lock()

    def source():
        for i in range(20):
            with lock:
                taken.append(i)
            yield i

    it = make_prefetcher(source(), buffer_size)
    deadline = time.time() + 5
    while len(taken) < buffer_size + 1 and time.time() < deadline:
        time.sleep(0.01)
    time.sleep(0.1)
    ahead = len(taken)
    assert list(it) == list(range(20))
    return ahead


@pytest.mark.parametrize("buffer_size", [1, 2, 5])
def test_prefetch_buffer_size_matches_jax(buffer_size):
    for make in (lambda it, n: prefetch.prefetch(it, buffer_size=n),
                 lambda it, n: prefetch.ThreadedPrefetcher(it, buffer_size=n)):
        assert _run_ahead(make, buffer_size) == buffer_size + 1
    assert _run_ahead(lambda it, n: jprefetch.prefetch(it, buffer_size=n), buffer_size) == buffer_size + 1
    assert _run_ahead(lambda it, n: prefetch.prefetch(it), 2) == 3  # the default, JAX's 2


def test_prefetch_raises_the_producers_error():
    def source():
        yield 1
        raise KeyError("broken frame")

    it = prefetch.prefetch(source(), buffer_size=1)
    assert next(it) == 1
    with pytest.raises(KeyError, match="broken frame"):
        next(it)


@pytest.mark.parametrize("fraction,seed", [(0.25, 1), (0.5, 0), (0.1, 3), (0.9, 2)])
def test_split_labels_train_val_matches_jax(fraction, seed):
    labels, jlabels = _labels_pair()
    train, val = ops.split_labels_train_val(labels, fraction, seed=seed)
    jtrain, jval = jops.split_labels_train_val(jlabels, fraction, seed=seed)
    assert type(train) is Labels and type(val) is Labels
    assert [lf.frame_idx for lf in train] == [lf.frame_idx for lf in jtrain]
    assert [lf.frame_idx for lf in val] == [lf.frame_idx for lf in jval]
    assert len(val) >= 1 and len(train) >= 1


def test_split_of_one_frame_matches_jax():
    labels, jlabels = _labels_pair(n_frames=1)
    got = [len(x) for x in ops.split_labels_train_val(labels, 0.5, seed=0)]
    assert got == [len(x) for x in jops.split_labels_train_val(jlabels, 0.5, seed=0)] == [1, 0]


def test_group_examples_match_jax():
    rng = np.random.default_rng(0)
    exs = [{"video_ind": np.array([v]), "frame_ind": np.array([f]), "x": i}
           for i, (v, f) in enumerate(zip(rng.integers(0, 2, 12), rng.integers(0, 3, 12)))]
    got, want = ops.group_examples(exs), jops.group_examples(exs)
    assert list(got) == list(want)
    assert all([e["x"] for e in got[k]] == [e["x"] for e in want[k]] for k in want)
    got_runs = [(k, [e["x"] for e in b]) for k, b in ops.group_examples_iter(exs)]
    assert got_runs == [(k, [e["x"] for e in b]) for k, b in jops.group_examples_iter(exs)]
    assert list(ops.group_examples_iter([])) == []


def test_data_utils_match_jax(capsys):
    for x in (1, [1, 2], "a", (3,)):
        assert utils.ensure_list(x) == jutils.ensure_list(x)
    a = np.arange(6).reshape(2, 3)
    for rank, prepend in ((4, True), (4, False), (2, True), (1, False)):
        want = jutils.expand_to_rank(a, rank, prepend)
        np.testing.assert_array_equal(utils.expand_to_rank(a, rank, prepend), want)
        got = utils.expand_to_rank(torch.from_numpy(a), rank, prepend)
        assert isinstance(got, torch.Tensor) and tuple(got.shape) == want.shape
    example = {"image": np.zeros((4, 5, 1), np.uint8), "frame_ind": 3}
    assert utils.describe_tensors(example, return_description=True) == \
        jutils.describe_tensors(example, return_description=True)
    utils.describe_tensors(example)
    assert capsys.readouterr().out.rstrip("\n") == jutils.describe_tensors(example, return_description=True)
    desc = utils.describe_tensors({"t": torch.zeros(2, 3)}, return_description=True)
    assert desc == "t: type=Tensor, shape=torch.Size([2, 3]), dtype=torch.float32, device=cpu"

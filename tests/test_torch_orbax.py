"""Reading orbax run folders without JAX: the port's zstd decoder, OCDBT
reader and checkpoint reader against the libraries that wrote the data.

- ``io/zstd.py`` against ``zstandard`` on random bytes, runs of one byte,
  repeated text and float32 arrays, at levels -5, 1, 3 and 19, with and
  without a checksum, with the content size unknown, with concatenated and
  skippable frames, and on hypothesis-generated data; a corrupted checksum
  raises;
- ``io/ocdbt.py`` against ``tensorstore`` on stores with inner b-tree nodes,
  uncompressed nodes and many versions; an unknown format version raises;
- ``io/orbax.read_params`` on the five ``.convergence_runs`` folders, leaf
  by leaf bitwise equal to orbax's restore as the JAX loader runs it, and
  on multi-chunk zarr arrays with a missing chunk.

Everything is exact: the readers return bytes and arrays, not estimates.
"""

import json
import os
import struct
from pathlib import Path

import jax
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from sleap_tpu.inference.predictors import load_trained_model as jax_load_trained_model
from sleap_tpu_torch.io import orbax as torch_orbax
from sleap_tpu_torch.io.ocdbt import OcdbtError, OcdbtReader, crc32c
from sleap_tpu_torch.io.zstd import ZstdError, decompress, xxh64

RUNS = Path(__file__).resolve().parent.parent / ".convergence_runs"
FOLDERS = sorted(p.name for p in RUNS.iterdir() if (p / "best_model.ckpt").is_dir())


@pytest.fixture(scope="module")
def zstandard():
    return pytest.importorskip("zstandard")


def _data(kind):
    rng = np.random.RandomState(0)
    if kind == "random":
        return rng.bytes(70_000)
    if kind == "one_byte_runs":
        return b"".join(bytes([b]) * n for b, n in zip(rng.randint(0, 256, 60),
                                                      rng.randint(1, 5000, 60)))
    if kind == "text":
        words = [b"pose", b"estimation", b"of", b"animals", b"with", b"sleap", b"\n"]
        return b" ".join(words[i] for i in rng.randint(0, len(words), 40_000))
    if kind == "float32":  # weights-like: small normal values
        return (rng.randn(60_000) * 0.05).astype(np.float32).tobytes()
    raise ValueError(kind)


@pytest.mark.parametrize("checksum", [False, True])
@pytest.mark.parametrize("level", [-5, 1, 3, 19])
@pytest.mark.parametrize("kind", ["random", "one_byte_runs", "text", "float32"])
def test_zstd_matches_zstandard(zstandard, kind, level, checksum):
    data = _data(kind)
    frame = zstandard.ZstdCompressor(level=level, write_checksum=checksum).compress(data)
    assert decompress(frame) == data


@pytest.mark.parametrize("kind", ["text", "float32"])
def test_zstd_unknown_content_size_and_small_windows(zstandard, kind):
    """Streamed frames (no content size in the header) of many blocks, as
    tensorstore writes its data files."""
    data = _data(kind) * 3
    params = zstandard.ZstdCompressionParameters.from_level(3, window_log=14)
    cctx = zstandard.ZstdCompressor(compression_params=params)
    chunks = cctx.compressobj()
    frame = b"".join(chunks.compress(data[i:i + 5000]) for i in range(0, len(data), 5000))
    frame += chunks.flush()
    assert not zstandard.get_frame_parameters(frame).content_size or \
        zstandard.get_frame_parameters(frame).content_size == zstandard.CONTENTSIZE_UNKNOWN
    assert decompress(frame) == data


def test_zstd_concatenated_and_skippable_frames(zstandard):
    a, b = _data("text"), _data("float32")
    cctx = zstandard.ZstdCompressor(level=3, write_checksum=True)
    skippable = struct.pack("<II", 0x184D2A5E, 7) + b"padding"
    assert decompress(cctx.compress(a) + skippable + cctx.compress(b)) == a + b
    assert decompress(skippable) == b""
    assert decompress(cctx.compress(b"")) == b""


def test_zstd_corrupted_checksum_raises(zstandard):
    frame = bytearray(zstandard.ZstdCompressor(level=3, write_checksum=True).compress(_data("text")))
    frame[-1] ^= 0x40
    with pytest.raises(ZstdError, match="checksum"):
        decompress(bytes(frame))
    with pytest.raises(ZstdError, match="magic"):
        decompress(b"\x00\x01\x02\x03rest")
    for cut in (5, 9, len(frame) // 2, len(frame) - 5):  # truncated frames
        with pytest.raises(ZstdError):
            decompress(bytes(frame[:cut]))


def test_xxh64_known_values():
    """Published XXH64 values (seed 0) of the empty input and of "abc"."""
    assert xxh64(b"") == 0xEF46DB3751D8E999
    assert xxh64(b"abc") == 0x44BC2CF5AD770999


@settings(max_examples=40, deadline=None)
@given(
    data=st.lists(st.binary(min_size=0, max_size=200), max_size=40).map(
        lambda parts: b"".join(p * (1 + len(p) % 7) for p in parts)),
    level=st.sampled_from([-3, 1, 6, 19]),
)
def test_zstd_hypothesis(data, level):
    zstandard = pytest.importorskip("zstandard")
    assert decompress(zstandard.ZstdCompressor(level=level, write_checksum=True).compress(data)) == data


# --------------------------------------------------------------------------- #
# OCDBT
# --------------------------------------------------------------------------- #


def _tensorstore_kv(path, **config):
    ts = pytest.importorskip("tensorstore")
    spec = {"driver": "ocdbt", "base": f"file://{path}"}
    if config:
        spec["config"] = config
    return ts, ts.KvStore.open(spec).result()


def _assert_store_matches(path):
    _, kv = _tensorstore_kv(path)
    keys = [k.decode() for k in kv.list().result()]
    reader = OcdbtReader(path)
    assert reader.keys() == sorted(keys)
    for k in keys:
        assert reader.read(k) == kv.read(k).result().value, k
    return reader


@pytest.mark.parametrize("compression", ["zstd", None])
def test_ocdbt_inner_nodes_and_many_versions_match_tensorstore(tmp_path, compression):
    ts, kv = _tensorstore_kv(
        tmp_path, max_decoded_node_bytes=300, max_inline_value_bytes=16,
        version_tree_arity_log2=1,
        compression={"id": "zstd", "level": 3} if compression else None,
    )
    for g in range(20):  # one version each, 20 versions in all
        with ts.Transaction() as txn:
            for i in range(10):
                kv.with_transaction(txn)[f"key/{g:03d}/{i:04d}"] = f"value-{g}-{i}-".encode() * (i + 1)
    kv.delete_range(ts.KvStore.KeyRange("key/004", "key/007")).result()
    reader = _assert_store_matches(tmp_path)
    assert len(reader.keys()) == 170 and reader.generation > 20


def test_ocdbt_unknown_format_version_raises(tmp_path):
    _, kv = _tensorstore_kv(tmp_path)
    kv["a"] = b"1"
    path = tmp_path / "manifest.ocdbt"
    raw = bytearray(path.read_bytes())
    raw[12] = 7  # the format version varint
    raw[-4:] = struct.pack("<I", crc32c(bytes(raw[:-4])))
    path.write_bytes(bytes(raw))
    with pytest.raises(OcdbtError, match="format version 7"):
        OcdbtReader(tmp_path)
    raw[-1] ^= 1
    path.write_bytes(bytes(raw))
    with pytest.raises(OcdbtError, match="CRC-32C"):
        OcdbtReader(tmp_path)


@pytest.mark.parametrize("folder", FOLDERS)
def test_ocdbt_checkpoint_stores_match_tensorstore(folder):
    _assert_store_matches(RUNS / folder / "best_model.ckpt")


# --------------------------------------------------------------------------- #
# Orbax checkpoints
# --------------------------------------------------------------------------- #


def test_five_trained_folders_are_checked():
    assert FOLDERS == [
        "min_tracks_2node.UNet.topdown_multiclass",
        "minimal_instance.UNet.bottomup",
        "minimal_instance.UNet.centered_instance",
        "minimal_instance.UNet.centroid",
        "minimal_robot.UNet.single_instance",
    ]


@pytest.mark.parametrize("folder", FOLDERS)
def test_read_params_bitwise_equals_orbax_restore(folder):
    path = str(RUNS / folder)
    want = jax.tree_util.tree_map(np.asarray, jax_load_trained_model(path).variables["params"])
    got = torch_orbax.read_params(os.path.join(path, "best_model.ckpt"))
    flat_got = jax.tree_util.tree_flatten_with_path(got)[0]
    flat_want = jax.tree_util.tree_flatten_with_path(want)[0]
    assert [k for k, _ in flat_got] == [k for k, _ in flat_want]
    for (key, g), (_, w) in zip(flat_got, flat_want):
        assert (g.dtype, g.shape) == (w.dtype, w.shape), key
        assert g.tobytes() == w.tobytes(), key


def test_multi_chunk_arrays_with_a_missing_chunk(tmp_path):
    """A zarr v2 array of 3 x 4 chunks over a 7 x 9 array, one chunk never
    written (it reads as the fill value), in an orbax-style folder."""
    ts = pytest.importorskip("tensorstore")
    shape, fill = (7, 9), 1.5
    arr = ts.open({
        "driver": "zarr",
        "kvstore": {"driver": "ocdbt", "base": f"file://{tmp_path}"},
        "path": "params.layer.kernel",
        "metadata": {"chunks": [3, 4], "compressor": {"id": "zstd", "level": 1},
                     "dtype": "<f4", "shape": list(shape), "fill_value": fill,
                     "dimension_separator": "."},
        "create": True,
    }).result()
    want = np.random.RandomState(3).randn(*shape).astype(np.float32)
    arr[:, :8] = want[:, :8]  # the last chunk column only partly; chunk (0, 2) ...
    arr[3:, 8:] = want[3:, 8:]  # ... row 0 of column 2 never written
    want[:3, 8:] = fill
    (tmp_path / "_CHECKPOINT_METADATA").write_text(json.dumps(
        {"item_handlers": "orbax.checkpoint.StandardCheckpointHandler"}))
    (tmp_path / "_METADATA").write_text(json.dumps({"tree_metadata": {"x": {
        "key_metadata": [{"key": "params"}, {"key": "layer"}, {"key": "kernel"}],
        "value_metadata": {"value_type": "jax.Array", "skip_deserialize": False}}}}))
    store = OcdbtReader(tmp_path)
    assert "params.layer.kernel/0.2" not in store and "params.layer.kernel/1.2" in store
    got = torch_orbax.read_params(str(tmp_path))["layer"]["kernel"]
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_other_handlers_are_refused(tmp_path):
    (tmp_path / "_CHECKPOINT_METADATA").write_text(json.dumps(
        {"item_handlers": "orbax.checkpoint.JsonCheckpointHandler"}))
    with pytest.raises(ValueError, match="StandardCheckpointHandler"):
        torch_orbax.read_params(str(tmp_path))


@pytest.mark.parametrize("folder", FOLDERS)
def test_read_variables_of_a_unet_folder(folder):
    """The UNet folders hold no running statistics: ``batch_stats`` is
    empty and ``params`` is ``read_params``'s tree."""
    ckpt = str(RUNS / folder / "best_model.ckpt")
    got = torch_orbax.read_variables(ckpt)
    assert set(got) == {"params", "batch_stats"} and got["batch_stats"] == {}
    flat_got = jax.tree_util.tree_flatten_with_path(got["params"])[0]
    flat_want = jax.tree_util.tree_flatten_with_path(torch_orbax.read_params(ckpt))[0]
    assert [k for k, _ in flat_got] == [k for k, _ in flat_want]
    assert all(np.array_equal(g, w) for (_, g), (_, w) in zip(flat_got, flat_want))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_read_variables_with_batch_stats_bitwise_equals_orbax_restore(tmp_path, dtype):
    """A checkpoint as the JAX trainer saves a batch-norm backbone's
    (``{"params", "batch_stats"}``), written by orbax, read back bitwise."""
    import orbax.checkpoint as ocp

    rng = np.random.RandomState(5)
    variables = {
        "params": {
            "backbone_module": {
                "stem_conv": {"kernel": rng.randn(7, 7, 3, 8).astype(dtype)},
                "stem_bn": {"scale": rng.rand(8).astype(dtype), "bias": rng.randn(8).astype(dtype)},
            },
            "SingleInstanceConfmapsHead": {"kernel": rng.randn(1, 1, 8, 3).astype(dtype),
                                           "bias": rng.randn(3).astype(dtype)},
        },
        "batch_stats": {"backbone_module": {"stem_bn": {
            "mean": rng.randn(8).astype(dtype), "var": rng.rand(8).astype(dtype) + 0.5}}},
    }
    path = str(tmp_path / "best_model.ckpt")
    ckptr = ocp.StandardCheckpointer()
    ckptr.save(path, jax.tree_util.tree_map(np.asarray, variables))
    ckptr.wait_until_finished()
    want = jax.tree_util.tree_map(np.asarray, ocp.StandardCheckpointer().restore(path))
    got = torch_orbax.read_variables(path)
    flat_got = jax.tree_util.tree_flatten_with_path(got)[0]
    flat_want = jax.tree_util.tree_flatten_with_path(want)[0]
    assert [k for k, _ in flat_got] == [k for k, _ in flat_want]
    for (key, g), (_, w) in zip(flat_got, flat_want):
        assert (g.dtype, g.shape) == (w.dtype, w.shape), key
        assert g.tobytes() == w.tobytes(), key
    np.testing.assert_array_equal(got["batch_stats"]["backbone_module"]["stem_bn"]["var"],
                                  variables["batch_stats"]["backbone_module"]["stem_bn"]["var"])
    assert torch_orbax.read_params(path).keys() == variables["params"].keys()

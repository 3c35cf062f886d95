"""The port's PAF grouping and LAP solver against the JAX package's, on the
same numpy inputs.

Tolerances: ``col4row``, matches, assembled instances and masks exact; line
scores within 1e-5 on float32 PAFs (the line sums run in another order) and
1e-6 on bf16 PAFs (sampled values are bf16 on both sides); instance scores,
sums of a few line scores whose order XLA picks, within 1e-6 relative.
"""

import jax
import jax.numpy as jnp
import networkx as nx
import numpy as np
import pytest
import torch
from scipy.optimize import linear_sum_assignment

from sleap_tpu.ops import lap as jlap
from sleap_tpu.ops import paf_grouping as jpg
from sleap_tpu_torch.ops import lap as tlap
from sleap_tpu_torch.ops import paf_grouping as tpg

torch.set_num_threads(1)

SCORE_RTOL = 1e-6


@pytest.fixture(autouse=True)
def _highest_precision():
    """Full-f32 matmuls on the JAX side, for this file only."""
    with jax.default_matmul_precision("highest"):
        yield


# --------------------------------------------------------------------------- #
# Edge order without networkx
# --------------------------------------------------------------------------- #


def _nx_toposort(edges):
    dg = nx.DiGraph(edges)
    root = next(nx.topological_sort(dg))
    return tuple(edges.index(e) for e in nx.bfs_edges(dg, root))


@pytest.mark.parametrize(
    "edges",
    [
        [(0, 1), (1, 2), (2, 3), (3, 4)],  # chain
        [(0, 1), (0, 2), (0, 3), (0, 4)],  # star
        [(3, 4), (1, 2), (2, 3), (0, 1)],  # a chain listed out of order
        [(2, 0), (2, 1), (0, 3), (1, 3), (3, 4), (4, 5), (1, 5)],  # diamond + extra parents
        [(4, 1), (0, 1), (0, 2), (5, 6)],  # two roots and a second component
        [(0, 1), (0, 1), (1, 2)],  # a repeated edge
        [(0, 1)],  # the trained bottom-up folder's skeleton (A -> B)
    ],
)
def test_toposort_edges_matches_networkx(edges):
    assert tpg.toposort_edges(edges) == _nx_toposort(edges)


def test_paf_scorer_from_config_matches_jax():
    from sleap_tpu.config import (
        MultiInstanceConfig,
        MultiInstanceConfmapsHeadConfig,
        PartAffinityFieldsHeadConfig,
    )

    cfg = MultiInstanceConfig(
        confmaps=MultiInstanceConfmapsHeadConfig(part_names=["a", "b", "c"], output_stride=4),
        pafs=PartAffinityFieldsHeadConfig(edges=[["b", "c"], ["a", "b"]], output_stride=8),
    )
    got = tpg.PAFScorer.from_config(cfg, min_line_scores=0.1)
    want = jpg.PAFScorer.from_config(cfg, min_line_scores=0.1)
    assert (got.part_names, got.edges, got.pafs_stride) == (want.part_names, want.edges, 8)
    assert got.edge_inds == want.edge_inds and got.min_line_scores == 0.1
    assert got.sorted_edge_inds == tuple(want.sorted_edge_inds) == (1, 0)


def test_toposort_edges_trained_skeleton_names():
    scorer = tpg.PAFScorer(part_names=["A", "B"], edges=[("A", "B")], pafs_stride=4)
    assert scorer.sorted_edge_inds == (0,)
    bench = [f"n{i}" for i in range(13)]
    scorer = tpg.PAFScorer(part_names=bench, edges=list(zip(bench[:-1], bench[1:])))
    assert scorer.sorted_edge_inds == _nx_toposort(scorer.edge_inds)


# --------------------------------------------------------------------------- #
# LAP
# --------------------------------------------------------------------------- #


def _lap_costs(n, seed, batch=6):
    """Random costs: real-valued, integer-valued (many ties) and with
    ``PAD_COST`` entries (forbidden pairs)."""
    rng = np.random.default_rng(seed)
    real = rng.uniform(-2, 2, (batch, n, n)).astype(np.float32)
    ties = rng.integers(-2, 2, (batch, n, n)).astype(np.float32)
    padded = np.where(rng.uniform(size=(batch, n, n)) < 0.3, np.float32(jlap.PAD_COST), real)
    return np.concatenate([real, ties, padded, np.zeros((1, n, n), np.float32)])


@pytest.mark.parametrize("n", list(range(1, 13)) + [13, 16])
def test_solve_lap_matches_jax(n):
    costs = _lap_costs(n, seed=n)
    want = np.asarray(jax.vmap(jlap.solve_lap)(jnp.asarray(costs))[0])
    col4row, row4col = tlap.solve_lap(torch.from_numpy(costs))
    np.testing.assert_array_equal(col4row.numpy(), want)
    np.testing.assert_array_equal(
        row4col.numpy()[np.arange(len(costs))[:, None], col4row.numpy()],
        np.broadcast_to(np.arange(n), (len(costs), n)),
    )
    for cost, cols in zip(costs.astype(np.float64), col4row.numpy()):
        r, c = linear_sum_assignment(cost)
        assert cost[np.arange(n), cols].sum() == pytest.approx(cost[r, c].sum(), abs=1e-3)


def test_prepare_cost_and_assignment_is_valid():
    rng = np.random.default_rng(3)
    cost = rng.uniform(-1, 1, (5, 5)).astype(np.float32)
    cost[1, 2] = np.nan
    row_mask = np.array([1, 1, 0, 1, 1], bool)
    col_mask = np.array([1, 0, 1, 1, 1], bool)
    want = np.asarray(jlap.prepare_cost(jnp.asarray(cost), jnp.asarray(row_mask), jnp.asarray(col_mask)))
    got = tlap.prepare_cost(torch.from_numpy(cost), torch.from_numpy(row_mask), torch.from_numpy(col_mask))
    np.testing.assert_array_equal(got.numpy(), want)
    col4row = np.array(jlap.solve_lap(jnp.asarray(want))[0])
    np.testing.assert_array_equal(
        tlap.assignment_is_valid(got, torch.from_numpy(col4row).long()).numpy(),
        np.asarray(jlap.assignment_is_valid(jnp.asarray(want), jnp.asarray(col4row))),
    )


# --------------------------------------------------------------------------- #
# Line scores and matching
# --------------------------------------------------------------------------- #


EDGES = ((0, 1), (1, 2), (0, 3))


def _paf_inputs(seed, S=2, N=4, K=3, Hs=12, Ws=16, stride=2):
    rng = np.random.default_rng(seed)
    pafs = rng.uniform(-1, 1, (S, Hs, Ws, 2 * len(EDGES))).astype(np.float32)
    peaks = np.stack(
        [rng.uniform(-3, Ws * stride + 3, (S, N, K)), rng.uniform(-3, Hs * stride + 3, (S, N, K))],
        axis=-1,
    ).astype(np.float32)
    peaks[rng.uniform(size=(S, N, K)) < 0.2] = np.nan
    peaks[0, 1, 0] = peaks[0, 0, 0]  # a zero-length line
    return pafs, peaks


def _jax_scores(pafs, peaks, stride):
    return np.asarray(jpg.score_paf_lines_batch(
        jnp.asarray(pafs), jnp.asarray(peaks), jnp.asarray(EDGES, jnp.int32),
        n_line_points=10, pafs_stride=stride,
    ))


def test_score_paf_lines_f32_matches_jax():
    pafs, peaks = _paf_inputs(0)
    want = _jax_scores(pafs, peaks, 2)
    got = tpg.score_paf_lines_batch(
        torch.from_numpy(pafs), torch.from_numpy(peaks), torch.tensor(EDGES),
        n_line_points=10, pafs_stride=2,
    ).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    assert np.isfinite(want).sum() > 20
    np.testing.assert_allclose(np.nan_to_num(got), np.nan_to_num(want), atol=1e-5, rtol=0)


def test_score_paf_lines_bf16_matches_jax():
    pafs, peaks = _paf_inputs(1)
    jpafs = jnp.asarray(pafs).astype(jnp.bfloat16)
    bits = np.asarray(jpafs).view(np.uint16).view(np.int16)
    tpafs = torch.from_numpy(bits.copy()).view(torch.bfloat16)
    want = np.asarray(jpg.score_paf_lines_batch(
        jpafs, jnp.asarray(peaks), jnp.asarray(EDGES, jnp.int32), n_line_points=10, pafs_stride=2,
    ))
    got = tpg.score_paf_lines_batch(
        tpafs, torch.from_numpy(peaks), torch.tensor(EDGES), n_line_points=10, pafs_stride=2,
    ).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(np.nan_to_num(got), np.nan_to_num(want), atol=1e-6, rtol=0)


@pytest.mark.parametrize("K", [3, 8, 13])
def test_match_candidates_matches_jax(K):
    rng = np.random.default_rng(K)
    scores = rng.uniform(-1, 1, (2, 3, K, K)).astype(np.float32)
    scores[rng.uniform(size=scores.shape) < 0.3] = np.nan
    scores[0, 0, 0] = np.nan  # a source peak with no candidate at all
    scores[1, 2] = np.round(scores[1, 2])  # ties
    want = [np.asarray(a) for a in jpg.match_candidates_batch(jnp.asarray(scores))]
    got = [a.numpy() for a in tpg.match_candidates_batch(torch.from_numpy(scores))]
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])


# --------------------------------------------------------------------------- #
# Assembly
# --------------------------------------------------------------------------- #


def _group_both(peaks, vals, dst, scores, edges, order, **kwargs):
    want = jpg.group_instances_batch(
        jnp.asarray(peaks), jnp.asarray(vals), jnp.asarray(dst, jnp.int32), jnp.asarray(scores),
        edge_inds_tuple=tuple(edges), sorted_edge_inds=tuple(order), **kwargs,
    )
    got = tpg.group_instances_batch(
        torch.from_numpy(peaks), torch.from_numpy(vals), torch.from_numpy(dst),
        torch.from_numpy(scores), edge_inds_tuple=tuple(edges), sorted_edge_inds=tuple(order),
        **kwargs,
    )
    for key in ("instances", "instance_peak_vals", "instance_valid"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]), err_msg=key)
    np.testing.assert_allclose(got["instance_scores"].numpy(), np.asarray(want["instance_scores"]),
                               rtol=SCORE_RTOL, atol=0)
    return {k: v.numpy() for k, v in got.items()}


def _crafted(N, K, edges, conns):
    """Peaks at distinct points; ``conns`` maps (edge, src peak) to
    (dst peak, score); everything else is padding (NaN score)."""
    peaks = (np.arange(N * K * 2, dtype=np.float32).reshape(1, N, K, 2) + 1) * 3
    vals = np.linspace(0.3, 0.9, N * K, dtype=np.float32).reshape(1, N, K)
    dst = np.tile(np.arange(K, dtype=np.int64), (1, len(edges), 1))
    scores = np.full((1, len(edges), K), np.nan, np.float32)
    for (e, k), (d, s) in conns.items():
        row = dst[0, e]  # a swap keeps it a permutation, as the LAP gives
        j = int(np.argmax(row == d))
        row[j], row[k] = row[k], row[j]
        scores[0, e, k] = s
    assert all(dst[0, e, k] == d for (e, k), (d, _) in conns.items())
    return peaks, vals, dst, scores


# (name, nodes, edges, assembly order, connections, instances expected with
# min_instance_peaks 0 and 3)
SCENARIOS = [
    # fresh (0,0)-(1,0) and (2,0)-(3,0), then a join of the two instances
    # with no node in common: they merge.
    ("fresh_join_merge", 4, [(0, 1), (2, 3), (1, 3)], [0, 1, 2],
     {(0, 0): (0, 0.9), (1, 0): (0, 0.8), (2, 0): (0, 0.7)}, (1, 1)),
    ("extend", 4, [(0, 1), (1, 2), (2, 3)], [0, 1, 2],
     {(0, 0): (0, 0.9), (1, 0): (1, 0.8), (2, 1): (0, 0.7), (0, 1): (1, 0.5)}, (2, 1)),
    # A join whose instances share node 1: the slot moves, no merge.
    ("join_overlap", 3, [(0, 1), (2, 1), (0, 2)], [0, 1, 2],
     {(0, 0): (0, 0.9), (1, 0): (1, 0.8), (2, 0): (0, 0.7)}, (2, 1)),
    # Two edges between the same nodes: one instance gets two peaks of node
    # 1 (three slots), and the later insertion (larger stamp) wins.
    ("two_peaks_of_one_node", 2, [(0, 1), (0, 1)], [0, 1],
     {(0, 0): (0, 0.9), (1, 0): (1, 0.6)}, (1, 1)),
    # A source that is unassigned while its destination is: nothing happens.
    ("src_new_dst_assigned", 3, [(0, 1), (2, 1)], [0, 1],
     {(0, 0): (0, 0.9), (1, 1): (0, 0.8)}, (1, 0)),
    # Scores below min_line_scores are not connections.
    ("below_min_line_score", 2, [(0, 1), (0, 1)], [0, 1],
     {(0, 0): (0, 0.1), (0, 1): (1, 0.3)}, (1, 0)),
    # Fewer assembly steps than output rows (T = 2 < M = 3): the JAX
    # package's "no instance" rank T is then a real row, which gathers the
    # unassigned slots into one more instance. The port keeps that.
    ("fewer_steps_than_rows", 2, [(0, 1)], [0],
     {(0, 0): (0, 0.1), (0, 1): (1, 0.3)}, (2, 1)),
]


@pytest.mark.parametrize("scenario", SCENARIOS, ids=[s[0] for s in SCENARIOS])
@pytest.mark.parametrize("min_instance_peaks", [0, 3])
def test_group_instances_crafted_matches_jax(scenario, min_instance_peaks):
    _, N, edges, order, conns, n_inst = scenario
    peaks, vals, dst, scores = _crafted(N, 2, edges, conns)
    got = _group_both(peaks, vals, dst, scores, edges, order,
                      min_instance_peaks=min_instance_peaks)
    assert got["instance_valid"].sum() == n_inst[min_instance_peaks > 0]


def test_group_instances_two_peaks_of_one_node_keeps_the_later():
    _, N, edges, order, conns, _ = SCENARIOS[3]
    peaks, vals, dst, scores = _crafted(N, 2, edges, conns)
    got = _group_both(peaks, vals, dst, scores, edges, order)
    np.testing.assert_array_equal(got["instances"][0, 0, 1], peaks[0, 1, 1])


@pytest.mark.parametrize("seed", range(4))
def test_group_instances_random_matches_jax(seed):
    """Random matches on a graph with cycles, every edge in the order."""
    rng = np.random.default_rng(seed)
    S, N, K = 3, 5, 4
    edges = [(0, 1), (1, 2), (2, 0), (1, 3), (3, 4), (0, 4), (4, 2)]
    peaks = rng.uniform(0, 50, (S, N, K, 2)).astype(np.float32)
    vals = rng.uniform(0.2, 1, (S, N, K)).astype(np.float32)
    missing = rng.uniform(size=(S, N, K)) < 0.2
    peaks[missing], vals[missing] = np.nan, 0.0
    dst = np.stack([[rng.permutation(K) for _ in edges] for _ in range(S)])
    scores = rng.uniform(0, 1, (S, len(edges), K)).astype(np.float32)
    scores[rng.uniform(size=scores.shape) < 0.2] = np.nan
    order = list(rng.permutation(len(edges)))
    for kwargs in ({}, {"min_instance_peaks": 3}, {"max_instances": 3}):
        _group_both(peaks, vals, dst, scores, edges, order, **kwargs)


def test_paf_scorer_end_to_end_matches_jax():
    pafs, peaks = _paf_inputs(5, S=2, N=4, K=3)
    names = ["a", "b", "c", "d"]
    edges = [(names[s], names[d]) for s, d in EDGES]
    vals = np.where(np.isnan(peaks[..., 0]), 0.0, 0.5).astype(np.float32)
    jsc = jpg.PAFScorer(part_names=names, edges=edges, pafs_stride=2, min_line_scores=-1.0)
    tsc = tpg.PAFScorer(part_names=names, edges=edges, pafs_stride=2, min_line_scores=-1.0)
    jm = jsc.score_and_match(jnp.asarray(pafs), jnp.asarray(peaks))
    tm = tsc.score_and_match(torch.from_numpy(pafs), torch.from_numpy(peaks))
    np.testing.assert_array_equal(tm[0].numpy(), np.asarray(jm[0]))
    want = jsc.group_batch(jnp.asarray(peaks), jnp.asarray(vals), jm[0], jm[1])
    got = tsc.group_batch(torch.from_numpy(peaks), torch.from_numpy(vals), tm[0], tm[1])
    np.testing.assert_array_equal(got["instance_valid"].numpy(), np.asarray(want["instance_valid"]))
    assert got["instance_valid"].sum() >= 2
    np.testing.assert_array_equal(got["instances"].numpy(), np.asarray(want["instances"]))
    np.testing.assert_allclose(got["instance_scores"].numpy(), np.asarray(want["instance_scores"]),
                               rtol=SCORE_RTOL, atol=0)
    assert tsc.sorted_edge_inds == tuple(jsc.sorted_edge_inds)

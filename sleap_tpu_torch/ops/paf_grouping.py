"""Part-affinity-field grouping: peaks -> multi-instance poses.

Port of :mod:`sleap_tpu.ops.paf_grouping`'s batched path with the same
static shapes: peaks arrive as (samples, nodes, K, 2), every edge scores all
K x K candidate pairs, a batched LAP matches them, and greedy assembly runs
as a fixed sequence of masked steps over (edge, source peak), batched over
samples. Results equal the JAX functions' on the same inputs:

- PAF values are sampled by a gather at the nearest pixel (the JAX package
  writes that lookup as one-hot matmuls, a TPU form with the same values);
  bf16 PAFs are gathered in bf16 and then cast, as JAX keeps them bit-exact
  until after selection.
- ``max_edge_length`` takes ``max(pafs.shape[1:])``, channel axis included.
- Assembly keeps the insertion stamps (``2t`` for a source slot, ``2t + 1``
  for a destination slot) and the rule that the largest stamp wins when one
  instance holds two peaks of a node, ranks instances by creation order,
  and selects rather than multiplies around NaN.

The host form of assembly, one sample at a time on numpy arrays
(:func:`assign_connections_to_instances`, :func:`make_predicted_instances`,
:meth:`PAFScorer.group_sample`), is the JAX package's too.

Nothing here imports ``networkx``: :func:`toposort_edges` reproduces its
topological sort and breadth-first walk.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from sleap_tpu_torch.ops.lap import PAD_COST, solve_lap


def toposort_edges(edge_inds: Sequence[Tuple[int, int]]) -> Tuple[int, ...]:
    """Edge order for assembly: breadth-first from the first root.

    Reproduces ``next(nx.topological_sort(nx.DiGraph(edges)))`` (the first
    node, in order of appearance, with no incoming edge) and
    ``nx.bfs_edges`` from it (successors in order of first insertion). Edges
    not on that walk are left out, as in the reference.
    """
    edges = [tuple(e) for e in edge_inds]
    nodes: Dict[int, None] = {}
    succ: Dict[int, Dict[int, None]] = {}
    for s, d in edges:
        nodes.setdefault(s)
        nodes.setdefault(d)
        succ.setdefault(s, {}).setdefault(d)
        succ.setdefault(d, {})
    in_degree = {n: 0 for n in nodes}
    for s in succ:
        for d in succ[s]:
            in_degree[d] += 1
    roots = [n for n in nodes if in_degree[n] == 0]
    if not roots:
        raise ValueError("The skeleton's edges contain a cycle; no root to sort from.")
    root = roots[0]
    seen, queue, walk = {root}, deque([root]), []
    while queue:
        parent = queue.popleft()
        for child in succ[parent]:
            if child not in seen:
                seen.add(child)
                queue.append(child)
                walk.append((parent, child))
    return tuple(edges.index(e) for e in walk)


def score_paf_lines_batch(
    pafs: torch.Tensor,
    peaks: torch.Tensor,
    edge_inds: torch.Tensor,
    n_line_points: int = 10,
    pafs_stride: int = 1,
    max_edge_length_ratio: float = 0.25,
    dist_penalty_weight: float = 1.0,
) -> torch.Tensor:
    """Score all candidate connections for every edge.

    Args:
        pafs: (S, H', W', 2 * n_edges) PAFs at stride ``pafs_stride``.
        peaks: (S, n_nodes, K, 2) xy peaks in image scale (NaN = missing).
        edge_inds: (n_edges, 2) int (src_node, dst_node).

    Returns:
        (S, n_edges, K, K) penalized line scores, NaN where either endpoint
        is missing.
    """
    S, Hs, Ws, _ = pafs.shape
    E = edge_inds.shape[0]
    K = peaks.shape[2]
    dev = peaks.device
    max_edge_length = max_edge_length_ratio * float(max(pafs.shape[1:])) * pafs_stride
    edge_inds = edge_inds.to(device=dev, dtype=torch.long)

    src = peaks[:, edge_inds[:, 0]]  # (S, E, K, 2)
    dst = peaks[:, edge_inds[:, 1]]
    src_e = src[:, :, :, None, :]  # (S, E, K, 1, 2)
    dst_e = dst[:, :, None, :, :]  # (S, E, 1, K, 2)

    # Nearest-pixel subscripts of the line sample points.
    t = torch.linspace(0.0, 1.0, n_line_points, device=dev).reshape(1, 1, 1, 1, -1, 1)
    xy = src_e[..., None, :] + (dst_e - src_e)[..., None, :] * t  # (S, E, K, K, P, 2)
    cols = torch.round(xy[..., 0] / pafs_stride).nan_to_num(0.0).clamp(0, Ws - 1).long()
    rows = torch.round(xy[..., 1] / pafs_stride).nan_to_num(0.0).clamp(0, Hs - 1).long()

    paf_e = pafs.reshape(S, Hs, Ws, E, 2)
    n_samp = K * K * n_line_points
    sm = torch.arange(S, device=dev)[:, None, None]
    ed = torch.arange(E, device=dev)[None, :, None]
    sampled = paf_e[sm, rows.reshape(S, E, n_samp), cols.reshape(S, E, n_samp), ed]
    sampled = sampled.float()  # (S, E, P', 2)
    paf_x = sampled[..., 0].reshape(S, E, K, K, -1)
    paf_y = sampled[..., 1].reshape(S, E, K, K, -1)

    disp = dst_e - src_e  # (S, E, K, K, 2)
    length = torch.sqrt(torch.sum(torch.square(disp), dim=-1, keepdim=True))
    unit = disp / length
    line_scores = paf_x * unit[..., 0:1] + paf_y * unit[..., 1:2]  # (S, E, K, K, P)
    mean_scores = torch.mean(line_scores, dim=-1)
    # A tensor numerator: ``float / tensor`` would multiply by a reciprocal.
    max_len = torch.tensor(max_edge_length, dtype=torch.float32, device=dev)
    penalty = torch.clamp(max_len / length[..., 0] - 1.0, max=0.0) * dist_penalty_weight
    return mean_scores + penalty  # NaN propagates from missing peaks


def match_candidates_batch(
    scores: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """LAP matching per (sample, edge) on the negated score matrix.

    Args:
        scores: (S, E, K, K); NaN marks invalid candidate pairs.

    Returns:
        dst_for_src: (S, E, K) int64 matched destination peak per source peak.
        match_scores: (S, E, K) the score of each match (NaN for padding).
        match_valid: (S, E, K) bool, True where the match used a real entry.
    """
    cost = torch.where(torch.isnan(scores), PAD_COST, -scores)
    dst_for_src, _ = solve_lap(cost)
    match_scores = scores.gather(3, dst_for_src[..., None])[..., 0]
    return dst_for_src, match_scores, ~torch.isnan(match_scores)


def group_instances_batch(
    peaks: torch.Tensor,
    peak_vals: torch.Tensor,
    dst_for_src: torch.Tensor,
    match_scores: torch.Tensor,
    edge_inds_tuple: Tuple[Tuple[int, int], ...],
    sorted_edge_inds: Tuple[int, ...],
    min_line_scores: float = 0.25,
    min_instance_peaks: int = 0,
    max_instances: Optional[int] = None,
) -> Dict[str, torch.Tensor]:
    """Greedy instance assembly, batched over samples.

    The reference's sequential union of connections (a dict of slot ->
    instance), as one masked step per (edge in ``sorted_edge_inds``, source
    peak). State: a label per (sample, node, peak slot) and the slot's
    insertion stamp.

    Args:
        peaks: (S, N, K, 2) xy peaks (NaN-padded).
        peak_vals: (S, N, K) peak values.
        dst_for_src: (S, E, K) matched destination peak per source peak.
        match_scores: (S, E, K) line scores; NaN where the match is padding.
        max_instances: output bound M; defaults to N * K // 2 + 1.

    Returns:
        ``instances`` (S, M, N, 2), ``instance_peak_vals`` (S, M, N),
        ``instance_scores`` (S, M), ``instance_valid`` (S, M): instances in
        creation order, NaN/False padded.
    """
    S, N, K, _ = peaks.shape
    dev = peaks.device
    M = max_instances if max_instances is not None else N * K // 2 + 1
    T = len(sorted_edge_inds) * K

    dst_for_src = dst_for_src.long()
    valid_conn = match_scores >= min_line_scores  # False for NaN padding
    col_iota = torch.arange(K, device=dev)
    labels = torch.full((S, N, K), -1, dtype=torch.long, device=dev)
    stamps = torch.zeros((S, N, K), dtype=torch.long, device=dev)
    next_id = torch.zeros(S, dtype=torch.long, device=dev)

    t = 0
    for e in sorted_edge_inds:
        sn, dn = edge_inds_tuple[e]
        for k in range(K):
            ok = valid_conn[:, e, k]
            dk = dst_for_src[:, e, k]
            sl = labels[:, sn, k].clone()  # label of the source slot
            dl = labels[:, dn].gather(1, dk[:, None])[:, 0]

            fresh = ok & (sl < 0) & (dl < 0)
            extend = ok & (sl >= 0) & (dl < 0)
            join = ok & (sl >= 0) & (dl >= 0)
            # (src unassigned, dst assigned) does nothing, as in the reference.

            labels[:, sn, k] = torch.where(fresh, next_id, sl)
            stamps[:, sn, k] = torch.where(fresh, 2 * t, stamps[:, sn, k])

            # Destination slot: fresh -> the new id, extend/join -> the
            # source's label; stamped only on first insertion. The row is
            # read after the source write, so sn == dn stays right.
            dst_label = torch.where(fresh, next_id, sl)
            col_hit = (col_iota[None, :] == dk[:, None]) & (fresh | extend | join)[:, None]
            labels[:, dn] = torch.where(col_hit, dst_label[:, None], labels[:, dn])
            stamp_hit = col_hit & (fresh | extend)[:, None]
            stamps[:, dn] = torch.where(stamp_hit, 2 * t + 1, stamps[:, dn])

            # Join: merge the destination's old instance into the source's
            # iff the two share no node (checked after the reassignment).
            has_src = (labels == sl[:, None, None]).any(dim=2)  # (S, N)
            has_dst = (labels == dl[:, None, None]).any(dim=2)
            overlap = (has_src & has_dst).any(dim=1)
            merge = join & ~overlap & (sl != dl)
            relabel = merge[:, None, None] & (labels == dl[:, None, None])
            labels = torch.where(relabel, sl[:, None, None], labels)

            next_id = next_id + fresh.long()
            t += 1

    # Rank surviving ids by creation order and bound the output at M.
    flat = labels.reshape(S, N * K)
    id_hits = flat[:, :, None] == torch.arange(T, device=dev)[None, None, :]  # (S, NK, T)
    present = id_hits.any(dim=1)
    if min_instance_peaks > 0:
        present = present & (id_hits.sum(dim=1) >= min_instance_peaks)
    rank = torch.cumsum(present.long(), dim=1) - 1
    rank = torch.where(present, rank, T)
    rank_padded = torch.cat([rank, torch.full((S, 1), T, dtype=torch.long, device=dev)], dim=1)
    slot_rank = rank_padded.gather(1, torch.where(flat >= 0, flat, T)).reshape(S, N, K)
    slot_rank = torch.where(slot_rank < M, slot_rank, M)

    # One instance holding two peaks of a node: the largest stamp wins.
    one_hot = slot_rank[..., None] == torch.arange(M, device=dev)  # (S, N, K, M)
    keyed = torch.where(one_hot, stamps[..., None] + 1, 0)
    winner_k = keyed.argmax(dim=2)  # (S, N, M)
    has_slot = one_hot.any(dim=2)  # (S, N, M)

    gathered = peaks.gather(2, winner_k[..., None].expand(S, N, M, 2))  # (S, N, M, 2)
    inst_pts = torch.where(has_slot[..., None], gathered, float("nan")).permute(0, 2, 1, 3)
    gathered_vals = peak_vals.gather(2, winner_k)
    inst_vals = torch.where(has_slot, gathered_vals, float("nan")).permute(0, 2, 1)

    # Instance scores: matched-connection scores whose source slot belongs
    # to the instance, by final assignments.
    e_src = torch.tensor([s for s, _ in edge_inds_tuple], dtype=torch.long, device=dev)
    src_labels = labels[:, e_src]  # (S, E, K)
    src_rank = slot_rank[:, e_src]
    conn_scores = torch.where(valid_conn & (src_labels >= 0), match_scores, 0.0)
    score_oh = src_rank[..., None] == torch.arange(M, device=dev)  # (S, E, K, M)
    inst_scores = torch.where(score_oh, conn_scores[..., None], 0.0).sum(dim=(1, 2))

    return {
        "instances": inst_pts,
        "instance_peak_vals": inst_vals,
        "instance_scores": inst_scores,
        "instance_valid": has_slot.any(dim=1),
    }


def assign_connections_to_instances(
    connections: Dict[int, List[Tuple[int, int, float]]],
    edge_inds: Sequence[Tuple[int, int]],
    sorted_edge_inds: Sequence[int],
    min_instance_peaks: Union[int, float] = 0,
    n_nodes: Optional[int] = None,
) -> Dict[Tuple[int, int], int]:
    """Greedy union of one sample's connections ``{edge: [(src_peak,
    dst_peak, score), ...]}``, edges in ``sorted_edge_inds`` order, into
    ``{(node, peak): instance id}``; two partial instances merge when they
    share no node. Instances with fewer than ``min_instance_peaks`` peaks
    (a fraction of ``n_nodes`` when a float) are dropped."""
    instance_assignments: Dict[Tuple[int, int], int] = {}
    for e in sorted_edge_inds:
        src_node, dst_node = edge_inds[e]
        for src_peak, dst_peak, _score in connections.get(e, []):
            src_id = (src_node, src_peak)
            dst_id = (dst_node, dst_peak)
            src_instance = instance_assignments.get(src_id)
            dst_instance = instance_assignments.get(dst_id)
            if src_instance is None and dst_instance is None:
                new_instance = max(instance_assignments.values(), default=-1) + 1
                instance_assignments[src_id] = new_instance
                instance_assignments[dst_id] = new_instance
            elif src_instance is not None and dst_instance is None:
                instance_assignments[dst_id] = src_instance
            elif src_instance is not None and dst_instance is not None:
                instance_assignments[dst_id] = src_instance
                src_nodes = {pid[0] for pid, inst in instance_assignments.items() if inst == src_instance}
                dst_nodes = {pid[0] for pid, inst in instance_assignments.items() if inst == dst_instance}
                if not src_nodes & dst_nodes:
                    for pid, inst in list(instance_assignments.items()):
                        if inst == dst_instance:
                            instance_assignments[pid] = src_instance

    if min_instance_peaks > 0:
        if isinstance(min_instance_peaks, float):
            if n_nodes is None:
                n_nodes = len({n for e in edge_inds for n in e})
            min_instance_peaks = int(min_instance_peaks * n_nodes)
        ids, counts = np.unique(list(instance_assignments.values()), return_counts=True)
        keep = {i for i, c in zip(ids, counts) if c >= min_instance_peaks}
        instance_assignments = {pid: inst for pid, inst in instance_assignments.items() if inst in keep}
    return instance_assignments


def make_predicted_instances(
    peaks: np.ndarray,
    peak_vals: np.ndarray,
    connections: Dict[int, List[Tuple[int, int, float]]],
    instance_assignments: Dict[Tuple[int, int], int],
    edge_inds: Sequence[Tuple[int, int]],
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """One sample's instances (n_instances, n_nodes, 2), peak scores
    (n_instances, n_nodes) and instance scores (the sum of the scores of
    the connections whose source peak it holds), NaN where an instance has
    no peak of a node; ``peaks`` (n_nodes, K, 2), ``peak_vals`` (n_nodes, K)."""
    instance_ids = sorted(set(instance_assignments.values()))
    remap = {old: new for new, old in enumerate(instance_ids)}
    n_instances = len(instance_ids)
    n_nodes = peaks.shape[0]

    instance_scores = np.zeros(n_instances, "float32")
    for e, conns in connections.items():
        src_node, _ = edge_inds[e]
        for src_peak, _dst_peak, score in conns:
            src_id = (src_node, src_peak)
            if src_id in instance_assignments:
                instance_scores[remap[instance_assignments[src_id]]] += score

    pred_instances = np.full((n_instances, n_nodes, 2), np.nan, "float32")
    pred_peak_scores = np.full((n_instances, n_nodes), np.nan, "float32")
    for (node_ind, peak_ind), inst in instance_assignments.items():
        i = remap[inst]
        pred_instances[i, node_ind] = peaks[node_ind, peak_ind]
        pred_peak_scores[i, node_ind] = peak_vals[node_ind, peak_ind]
    return pred_instances, pred_peak_scores, instance_scores


@dataclass
class PAFScorer:
    """Peak grouping by PAFs: line scores, matching and assembly."""

    part_names: List[str]
    edges: List[Tuple[str, str]]
    pafs_stride: int = 1
    max_edge_length_ratio: float = 0.25
    dist_penalty_weight: float = 1.0
    n_points: int = 10
    min_instance_peaks: Union[int, float] = 0
    min_line_scores: float = 0.25
    sorted_edge_inds: Tuple[int, ...] = field(init=False)

    def __post_init__(self):
        self.part_names = list(self.part_names)
        self.edges = [tuple(e) for e in self.edges]
        self.sorted_edge_inds = toposort_edges(self.edge_inds)

    @property
    def edge_inds(self) -> List[Tuple[int, int]]:
        return [(self.part_names.index(s), self.part_names.index(d)) for s, d in self.edges]

    @classmethod
    def from_config(cls, config, **kwargs) -> "PAFScorer":
        """From a ``sleap_tpu.config.MultiInstanceConfig`` (read by attribute)."""
        return cls(
            part_names=list(config.confmaps.part_names),
            edges=[tuple(e) for e in config.pafs.edges],
            pafs_stride=config.pafs.output_stride,
            **kwargs,
        )

    def resolved_min_instance_peaks(self) -> int:
        """Fractional ``min_instance_peaks`` resolved against the node count."""
        if isinstance(self.min_instance_peaks, float):
            return int(self.min_instance_peaks * len(self.part_names))
        return int(self.min_instance_peaks)

    def score_and_match(self, pafs: torch.Tensor, peaks: torch.Tensor):
        """Line scoring, then matching: (dst_for_src, match_scores, match_valid)."""
        scores = score_paf_lines_batch(
            pafs,
            peaks,
            torch.tensor(self.edge_inds, dtype=torch.long, device=peaks.device).reshape(-1, 2),
            n_line_points=self.n_points,
            pafs_stride=self.pafs_stride,
            max_edge_length_ratio=self.max_edge_length_ratio,
            dist_penalty_weight=self.dist_penalty_weight,
        )
        return match_candidates_batch(scores)

    def group_batch(
        self,
        peaks: torch.Tensor,
        peak_vals: torch.Tensor,
        dst_for_src: torch.Tensor,
        match_scores: torch.Tensor,
        max_instances: Optional[int] = None,
    ) -> Dict[str, torch.Tensor]:
        """Greedy assembly of a whole batch (:func:`group_instances_batch`)."""
        return group_instances_batch(
            peaks,
            peak_vals,
            dst_for_src,
            match_scores,
            edge_inds_tuple=tuple(self.edge_inds),
            sorted_edge_inds=self.sorted_edge_inds,
            min_line_scores=float(self.min_line_scores),
            min_instance_peaks=self.resolved_min_instance_peaks(),
            max_instances=max_instances,
        )

    def group_sample(
        self,
        peaks: np.ndarray,
        peak_vals: np.ndarray,
        dst_for_src: np.ndarray,
        match_scores: np.ndarray,
        match_valid: np.ndarray,
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Host assembly of one sample from its matches: each edge's valid
        connections scoring at least ``min_line_scores``, in source-peak
        order, through :func:`assign_connections_to_instances` and
        :func:`make_predicted_instances`."""
        connections: Dict[int, List[Tuple[int, int, float]]] = {}
        E, K = dst_for_src.shape
        for e in range(E):
            conns = []
            for src_peak in range(K):
                if not match_valid[e, src_peak]:
                    continue
                score = float(match_scores[e, src_peak])
                if score < self.min_line_scores:
                    continue
                conns.append((src_peak, int(dst_for_src[e, src_peak]), score))
            connections[e] = conns
        assignments = assign_connections_to_instances(
            connections, self.edge_inds, self.sorted_edge_inds,
            min_instance_peaks=self.min_instance_peaks, n_nodes=len(self.part_names),
        )
        return make_predicted_instances(peaks, peak_vals, connections, assignments, self.edge_inds)

    def predict(self, pafs: torch.Tensor, peaks: torch.Tensor, peak_vals: torch.Tensor,
                peak_mask: torch.Tensor) -> List[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
        """Score and match a batch on its device, then assemble each sample
        on the host: (instances, peak scores, instance scores) a sample.
        ``pafs`` (S, H', W', 2 * n_edges), ``peaks`` (S, n_nodes, K, 2),
        ``peak_vals`` and ``peak_mask`` (S, n_nodes, K)."""
        dst_for_src, match_scores, match_valid = self.score_and_match(pafs, peaks)
        peaks, peak_vals = peaks.cpu().numpy(), peak_vals.cpu().numpy()
        dst_for_src, match_scores = dst_for_src.cpu().numpy(), match_scores.cpu().numpy()
        match_valid = match_valid.cpu().numpy()
        return [self.group_sample(peaks[s], peak_vals[s], dst_for_src[s], match_scores[s], match_valid[s])
                for s in range(peaks.shape[0])]

"""Batched linear assignment (port of :mod:`sleap_tpu.ops.lap`).

Exact minimum-cost assignment of many small square cost matrices at once,
with the JAX solver's tie-breaks, so both packages pick the same
``col4row`` (bottom-up assembly depends on it, not only on the optimum):

- n <= 12: dynamic programming over column subsets (Held-Karp), after the
  row-then-column min reduction, taking the first minimum at every step.
- n > 12: the shortest-augmenting-path solver (scipy's ``_lsap`` family),
  whose column pick prefers unassigned columns on ties. The JAX version is a
  ``vmap`` over ``while_loop``s; here every matrix steps in one batched,
  masked loop until all are done, or, while ``torch.export`` traces, for
  the fixed number of steps that bounds every matrix.

Plain tensor code on either device: the JAX solver is XLA, not Pallas.
Padding contract: callers give forbidden entries ``PAD_COST``, not inf/NaN.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

# Forbidden-entry cost (the JAX package's): small enough that float32 dual
# updates keep the real costs ordered.
PAD_COST = 1e3

# Largest n solved by the subset DP (2^n states per matrix).
_MAX_DP_N = 12


def _solve_lap_dp(cost: torch.Tensor) -> torch.Tensor:
    """col4row of (B, n, n) float32 costs by DP over column subsets."""
    B, n, _ = cost.shape
    dev = cost.device
    cost = cost - cost.amin(dim=2, keepdim=True)
    cost = cost - cost.amin(dim=1, keepdim=True)

    n_sub = 1 << n
    subsets = torch.arange(n_sub, device=dev)
    cols = torch.arange(n, device=dev)
    has_bit = ((subsets[:, None] >> cols[None, :]) & 1) == 1  # (2^n, n)
    prev_idx = subsets[:, None] ^ (1 << cols)[None, :]  # S \ {j} where set
    dp = torch.where(subsets == 0, 0.0, float("inf")).to(torch.float32).expand(B, n_sub)
    args = []
    for i in range(n):
        cand = dp[:, prev_idx] + cost[:, i, None, :]  # (B, 2^n, n)
        cand = torch.where(has_bit, cand, float("inf"))
        args.append(cand.argmin(dim=2))  # first minimum, as jnp.argmin
        dp = cand.amin(dim=2)

    col4row = torch.empty((B, n), dtype=torch.long, device=dev)
    state = torch.full((B,), n_sub - 1, dtype=torch.long, device=dev)
    for i in range(n - 1, -1, -1):
        j = args[i].gather(1, state[:, None])[:, 0]
        col4row[:, i] = j
        state = state - (1 << j)
    return col4row


def _first_true(mask: torch.Tensor) -> torch.Tensor:
    """Index of the first True along the last axis (0 if none)."""
    return mask.to(torch.uint8).argmax(dim=-1)


def _solve_lap_jv(cost: torch.Tensor, bounded: bool = False) -> torch.Tensor:
    """col4row of (B, n, n) float32 costs by shortest augmenting paths.

    Eagerly each loop runs until every matrix is done. ``bounded`` runs each
    a fixed number of masked steps instead, with no read of the data on the
    host, which ``torch.export`` can trace: at row r, r columns are taken,
    so the Dijkstra scan meets a free column within r + 1 steps and the
    path it augments has at most r + 1 columns. A matrix that is done keeps
    its state through the extra steps, so both forms give the same result.
    """
    B, n, _ = cost.shape
    dev = cost.device
    inf = float("inf")
    bi = torch.arange(B, device=dev)
    cols = torch.arange(n, device=dev)
    u = torch.zeros((B, n), dtype=torch.float32, device=dev)
    v = torch.zeros((B, n), dtype=torch.float32, device=dev)
    row4col = torch.full((B, n), -1, dtype=torch.long, device=dev)
    col4row = torch.full((B, n), -1, dtype=torch.long, device=dev)

    def steps(r: int, not_done):
        """Step numbers of a loop at row r: r + 1 when bounded, else until
        ``not_done()`` is false."""
        if bounded:
            yield from range(r + 1)
        else:
            while not_done():
                yield

    for cur_row in range(n):
        i = torch.full((B,), cur_row, dtype=torch.long, device=dev)
        minval = torch.zeros(B, dtype=torch.float32, device=dev)
        sr = torch.zeros((B, n), dtype=torch.bool, device=dev)
        sc = torch.zeros((B, n), dtype=torch.bool, device=dev)
        spc = torch.full((B, n), inf, dtype=torch.float32, device=dev)
        path = torch.full((B, n), -1, dtype=torch.long, device=dev)
        sink = torch.full((B,), -1, dtype=torch.long, device=dev)
        # Dijkstra over columns; matrices that found their sink keep state.
        for _ in steps(cur_row, lambda: bool((sink < 0).any())):
            active = sink < 0
            act = active[:, None]
            sr = sr | (act & (cols[None, :] == i[:, None]))
            r = minval[:, None] + cost[bi, i] - u[bi, i][:, None] - v
            better = (r < spc) & ~sc & act
            spc = torch.where(better, r, spc)
            path = torch.where(better, i[:, None], path)
            # Min shortest-path cost among unscanned columns; ties prefer
            # unassigned columns (the scipy tie-break).
            masked = torch.where(sc, inf, spc)
            lowest = masked.amin(dim=1, keepdim=True)
            cand = (masked <= lowest) & ~sc
            free_cand = cand & (row4col < 0)
            j = torch.where(free_cand.any(dim=1), _first_true(free_cand), _first_true(cand))
            minval = torch.where(active, masked[bi, j], minval)
            sc = sc | (act & (cols[None, :] == j[:, None]))
            owner = row4col[bi, j]
            is_free = owner < 0
            sink = torch.where(active & is_free, j, sink)
            i = torch.where(active & ~is_free, owner, i)

        # Dual updates (scipy _lsap semantics).
        u[:, cur_row] += minval
        other = sr & (cols[None, :] != cur_row)
        spc_at_col4row = spc.gather(1, col4row.clamp(0, n - 1))
        u = torch.where(other, u + minval[:, None] - spc_at_col4row, u)
        v = torch.where(sc, v - (minval[:, None] - spc), v)

        # Augment along the alternating path ending at each sink; matrices
        # whose path is done write their own entries back.
        j = sink
        done = torch.zeros(B, dtype=torch.bool, device=dev)
        for _ in steps(cur_row, lambda: not bool(done.all())):
            act = ~done
            jc = j.clamp(0, n - 1)
            i = path[bi, jc]
            ic = i.clamp(0, n - 1)
            next_j = col4row[bi, ic]
            row4col = row4col.scatter(
                1, jc[:, None], torch.where(act, i, row4col[bi, jc])[:, None])
            col4row = col4row.scatter(
                1, ic[:, None], torch.where(act, jc, col4row[bi, ic])[:, None])
            done = done | (act & (i == cur_row))
            j = torch.where(act, next_j, j)
    return col4row


def solve_lap(cost: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact minimum-cost square assignment of each matrix in a batch.

    Args:
        cost: (..., n, n) float costs; use ``PAD_COST``, not inf/NaN, for
            forbidden entries.

    Returns:
        (col4row, row4col): int64 (..., n); ``col4row[..., i]`` is the column
        assigned to row i.
    """
    n = cost.shape[-1]
    lead = cost.shape[:-2]
    flat = cost.reshape(-1, n, n).to(torch.float32)
    if flat.shape[0] == 0 or n == 0:
        col4row = torch.zeros(flat.shape[:2], dtype=torch.long, device=cost.device)
    elif n <= _MAX_DP_N:
        col4row = _solve_lap_dp(flat)
    else:
        col4row = _solve_lap_jv(flat, bounded=torch.compiler.is_exporting())
    row4col = torch.empty_like(col4row).scatter_(
        1, col4row, torch.arange(n, device=cost.device).expand_as(col4row)
    )
    return col4row.reshape(*lead, n), row4col.reshape(*lead, n)


# solve_lap takes a batch already: the JAX package's vmap of its solver.
batched_solve_lap = solve_lap


def prepare_cost(
    cost: torch.Tensor,
    row_mask: Optional[torch.Tensor] = None,
    col_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """NaN and masked-out entries -> ``PAD_COST``; masks are (..., n)."""
    cost = torch.where(torch.isnan(cost), PAD_COST, cost)
    if row_mask is not None:
        cost = torch.where(row_mask[..., :, None], cost, PAD_COST)
    if col_mask is not None:
        cost = torch.where(col_mask[..., None, :], cost, PAD_COST)
    return cost


def assignment_is_valid(
    cost: torch.Tensor, col4row: torch.Tensor, threshold: float = PAD_COST / 2
) -> torch.Tensor:
    """(..., n) bool: the row's assignment used a real (non-padded) entry."""
    n = cost.shape[-1]
    picked = cost.gather(-1, col4row.clamp(0, n - 1)[..., None])[..., 0]
    return (col4row >= 0) & (picked < threshold)

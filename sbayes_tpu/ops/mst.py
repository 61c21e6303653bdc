"""Jittable minimum-spanning-tree edge costs via masked Prim's algorithm.

The geo-prior aggregates edge costs along the MST of the cost submatrix of a
cluster (reference: sbayes/model/prior.py:950-962 ``compute_mst_distances``
using scipy.sparse.csgraph). scipy's MST is not jittable; inside ``jit`` we
run a fixed-iteration Prim's algorithm with inf-masking over the full
(N, N) cost matrix and a boolean cluster mask — O(N^2) per cluster, which is
cheap for realistic cluster sizes and fully fuses into the step kernel.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

HIGHEST = jax.lax.Precision.HIGHEST  # as sbayes_tpu.model.math.HIGHEST

BIG = jnp.inf


def cluster_mst_edge_costs(cost, mask):
    """Edge costs of the MST over the masked subgraph of a dense cost matrix.

    Args:
        cost: (N, N) symmetric cost matrix (finite entries).
        mask: (N,) boolean cluster membership.
    Returns:
        (N-1,) array whose first (m-1) nonpad entries are the MST edge costs
        of the m masked nodes; remaining entries are 0. A cluster of size
        <= 1 yields all zeros (matching the reference's fallback).
    """
    n = cost.shape[0]
    dtype = cost.dtype

    start = jnp.argmax(mask)  # first member (mask must have >= 1 True for meaningful output)
    cand0 = mask & (jnp.arange(n) != start)
    d0 = jnp.where(cand0, cost[start], BIG)
    # A cluster of m members needs exactly m-1 Prim iterations; iterating
    # to the while-condition (instead of a fixed n-1 fori) exits as soon
    # as the tree is complete — under vmap, at the batch-max cluster
    # size. Typical clusters are far smaller than N, so this cuts the
    # kernel's sequential depth proportionally.
    m_edges = jnp.maximum(mask.sum().astype(jnp.int32) - 1, 0)

    def cond_fn(carry):
        _, _, _, count, i = carry
        return (i < n - 1) & (count < m_edges)

    def body(carry):
        cand, d, edges, count, i = carry
        dm = jnp.where(cand, d, BIG)
        j = jnp.argmin(dm)
        w = dm[j]
        valid = jnp.isfinite(w)
        edges = edges.at[i].set(jnp.where(valid, w, 0.0).astype(dtype))
        count = count + valid.astype(jnp.int32)
        # Remove j from candidates and relax distances through j.
        cand = cand & (jnp.arange(n) != j) & jnp.full((n,), valid)
        d = jnp.where(cand, jnp.minimum(d, cost[j]), d)
        return cand, d, edges, count, i + 1

    _, _, edges, count, _ = lax.while_loop(
        cond_fn, body,
        (cand0, d0, jnp.zeros(n - 1, dtype), jnp.int32(0), jnp.int32(0)),
    )
    return edges, count


def cluster_mst_stats_prim(cost, mask):
    """(total, count, max_edge) of the masked MST — matmul row-select Prim.

    Same early-exit masked Prim as :func:`cluster_mst_edge_costs`, with the
    two per-iteration lowering hazards removed for the vmapped-ensemble hot
    path (the carried geo-aggregate update in every cluster operator):

    * ``cost[j]`` with a traced per-chain ``j`` lowers to a batched row
      GATHER. Here the row is selected as ``one_hot(j) @ cost``: under
      ``vmap`` a (B, N) x (N, N) matmul. The full cost matrix is re-read
      per iteration, so this
      form is only a win while (N, N) is small enough to stay resident —
      the caller gates on N (posterior._mst_triple).
    * the (N-1,) edge array (scatter per iteration) is collapsed into the
      three scalar accumulators the geo prior actually consumes.

    Semantics match cluster_mst_edge_costs + sum/count/max exactly:
    clusters of size <= 1 yield (0, 0, 0); unreachable members (inf cut)
    stop contributing edges, matching the masked-scipy fallback.
    """
    n = cost.shape[0]
    dtype = cost.dtype
    iota = jnp.arange(n)

    start = jnp.argmax(mask)
    cand0 = mask & (iota != start)
    # precision=HIGHEST: a reduced-precision matmul (bf16 passes, or TF32
    # on a GPU) would round the selected cost values (the one-hot operand
    # is exact either way); full f32 returns the row exactly for a 0/1
    # selector.
    row0 = jnp.matmul(jax.nn.one_hot(start, n, dtype=dtype), cost, precision=HIGHEST)
    d0 = jnp.where(cand0, row0, BIG)
    m_edges = jnp.maximum(mask.sum().astype(jnp.int32) - 1, 0)

    def cond_fn(carry):
        _, _, _, _, count, i = carry
        return (i < n - 1) & (count < m_edges)

    def body(carry):
        cand, d, total, max_e, count, i = carry
        dm = jnp.where(cand, d, BIG)
        w = dm.min()
        j = dm.argmin()
        valid = jnp.isfinite(w)
        total = total + jnp.where(valid, w, 0.0)
        max_e = jnp.maximum(max_e, jnp.where(valid, w, 0.0))
        count = count + valid.astype(jnp.int32)
        cand = cand & (iota != j) & jnp.full((n,), valid)
        row_j = jnp.matmul(jax.nn.one_hot(j, n, dtype=dtype), cost, precision=HIGHEST)
        d = jnp.where(cand, jnp.minimum(d, row_j), d)
        return cand, d, total, max_e, count, i + 1

    z = jnp.zeros((), dtype)
    _, _, total, max_e, count, _ = lax.while_loop(
        cond_fn, body,
        (cand0, d0, z, z, jnp.int32(0), jnp.int32(0)),
    )
    return total, count.astype(dtype), max_e


def mst_aggregate(cost, mask, aggregation: str):
    """Aggregate MST edge costs of a cluster: 'mean' | 'sum' | 'max'.

    Matches the reference aggregation semantics (prior.py:710-714, 793-794):
    a single-member (or empty) cluster aggregates to 0.
    """
    edges, count = cluster_mst_edge_costs(cost, mask)
    total = edges.sum()
    if aggregation == "sum":
        return total
    if aggregation == "mean":
        return total / jnp.maximum(count, 1).astype(cost.dtype)
    if aggregation == "max":
        return edges.max()
    raise ValueError(f"Unknown aggregation '{aggregation}'")

"""Log-depth MST aggregates via vectorized Boruvka.

``ops/mst.py``'s masked Prim needs N-1 *sequential* iterations of tiny
(N,) vector work — latency-bound, and a candidate for the dominant cost
of the cost_based geo prior. Boruvka contracts the graph in
ceil(log2(N)) rounds of dense (N, N) reductions: every round each component picks its minimum outgoing edge
(under a consistent total order), chosen edges are accumulated, and
components merge by pointer jumping.

Consistent total order on edges: lexicographic ``(w, pid)`` with
``pid = min(i,j)*N + max(i,j)``. Per-row ``argmin`` (first minimal
index) is exactly the row-restriction of this order (for fixed i every
j < i edge has a smaller pid than every j' > i edge, and pid increases
with j on both sides), so the per-component two-stage min (weight, then
pid among weight-ties) selects the true order-minimal outgoing edge.
Under a total order the chosen-edge functional graph on components has
only 2-cycles (the classic Boruvka invariant), so a single
cycle-break + pointer jumping contracts it exactly.

Only the MST *aggregates* (total cost, edge count, max edge) are
produced — all geo-prior consumers need exactly these
(model/posterior.py ``skeleton_triple`` / ``_skeleton_aggregate``);
the Prim edge-list kernel remains for oracle cross-checks.

Reference semantics matched: sbayes/model/prior.py:950-962
``compute_mst_distances`` (scipy minimum_spanning_tree on the masked
cost submatrix); degenerate clusters (size <= 1) aggregate to zeros.
"""
from __future__ import annotations

import math

import jax.numpy as jnp
from jax import lax

INT_BIG = jnp.iinfo(jnp.int32).max


def cluster_mst_stats(cost, mask):
    """(total, n_edges, max_edge) of the MST over the masked subgraph.

    Args:
        cost: (N, N) symmetric cost matrix (finite entries).
        mask: (N,) boolean cluster membership.
    Returns:
        Tuple of three f32 scalars; a cluster of size <= 1 yields zeros
        (matching the reference fallback and ``ops/mst.py``).
    """
    n = cost.shape[0]
    dtype = cost.dtype
    idx = jnp.arange(n, dtype=jnp.int32)
    valid = mask[:, None] & mask[None, :] & (idx[:, None] != idx[None, :])
    n_rounds = max(1, math.ceil(math.log2(n)))

    def one_round(carry, _):
        lab, total, count, maxe = carry
        diff = lab[:, None] != lab[None, :]
        w = jnp.where(valid & diff, cost, jnp.inf)          # (N, N)
        bj = jnp.argmin(w, axis=1).astype(jnp.int32)        # smallest-j ties
        bw = jnp.take_along_axis(w, bj[:, None], 1)[:, 0]   # (N,)
        pid = jnp.minimum(idx, bj) * n + jnp.maximum(idx, bj)

        # Per-label lexicographic (bw, pid) minimum over member nodes.
        oh = lab[None, :] == idx[:, None]                   # (labels, N)
        cw = jnp.where(oh, bw[None, :], jnp.inf).min(1)     # (N,) per label
        tie = oh & (bw[None, :] == cw[:, None])
        cpid = jnp.where(tie, pid[None, :], INT_BIG).min(1)
        ci = jnp.argmax(tie & (pid[None, :] == cpid[:, None]), axis=1)
        l2 = lab[bj[ci]]                                    # partner label
        has = jnp.isfinite(cw)

        # An edge chosen from both sides is counted half from each.
        mutual = has & (l2[l2] == idx) & (cpid[l2] == cpid)
        f = jnp.where(mutual, 0.5, 1.0).astype(dtype)
        cw0 = jnp.where(has, cw, 0.0).astype(dtype)
        total = total + (cw0 * f).sum()
        count = count + jnp.where(has, f, 0.0).sum()
        maxe = jnp.maximum(maxe, cw0.max())

        # Contract: components point to their partner; 2-cycles root at
        # the smaller label; pointer jumping canonicalizes.
        p = jnp.where(has, l2, idx)
        p = jnp.where((p[p] == idx) & (idx < p), idx, p)
        for _ in range(n_rounds):
            p = p[p]
        return (p[lab], total, count, maxe), None

    (lab, total, count, maxe), _ = lax.scan(
        one_round,
        (idx, jnp.zeros((), dtype), jnp.zeros((), dtype), jnp.zeros((), dtype)),
        None,
        length=n_rounds,
    )
    return total, count, maxe

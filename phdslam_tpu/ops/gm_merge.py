"""Greedy moment-matched Gaussian-mixture merge under jit.

The plain reference for ``phdUpdateMergeKernel`` (phdfilter.cu:2707-2898) and
the host-side ``reduceGaussianMixture`` (gm_reduce.cpp:57-134). Both reference
implementations run the same algorithm:

  repeat until no candidates remain:
    1. pick the unmerged component with the largest weight
    2. gather every unmerged component within ``min_separation``
       (Mahalanobis with averaged covariance, or Hellinger)
    3. emit their moment-matched merge (weight sum, weight-averaged mean,
       covariance + spread term), symmetrized
    4. mark them merged

The reference's data-dependent ``while(true)`` becomes a bounded
``lax.while_loop`` (at most ``out_cap`` emitted clusters), with candidate
validity expressed as masks instead of stream compaction — no dynamic shapes
ever reach XLA. The per-iteration work (argmax + N distance evaluations +
masked moment accumulation) is vectorized over the lanes, and the whole
operation vmaps over the particle axis. ops/pallas_merge.py runs the same
loop as one GPU kernel; :func:`merge_batch_dispatch_packed` chooses.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .math import hellinger2, mahalanobis2, sym


def gm_merge(mean, cov, weight, active, min_separation, out_cap,
             distance_metric=0):
    """Merge one Gaussian mixture.

    Args:
      mean:   [N, D]
      cov:    [N, D, D]
      weight: [N] linear weights (> 0 for live candidates)
      active: [N] bool — candidates that participate
      min_separation: scalar distance threshold
      out_cap: static int, max merged components to emit
      distance_metric: 0 = Mahalanobis (squared, averaged cov), 1 = Hellinger

    Returns:
      (out_mean [out_cap, D], out_cov [out_cap, D, D], out_weight [out_cap],
       n_merged, n_dropped) — empty slots have weight 0; ``n_dropped`` counts
       clusters that could not be emitted because ``out_cap`` was reached
       (the reference has no cap; report it so capacity pressure is visible).
    """
    N, D = mean.shape
    dtype = mean.dtype
    active = active & (weight > 0)

    # Force materialization of the candidate arrays before the loop: without
    # this barrier XLA may fuse their (expensive) producer chain — the whole
    # EKF pre-update — into every while_loop iteration (loop-invariant
    # inputs must be loop constants, not fused recomputations).
    mean, cov, weight, active = jax.lax.optimization_barrier(
        (mean, cov, weight, active))

    out_mean = jnp.zeros((out_cap, D), dtype=dtype)
    out_cov = jnp.broadcast_to(jnp.eye(D, dtype=dtype), (out_cap, D, D))
    out_weight = jnp.zeros((out_cap,), dtype=dtype)

    def cond(carry):
        unmerged, _, _, _, count = carry
        return jnp.any(unmerged) & (count < out_cap)

    def body(carry):
        unmerged, o_mean, o_cov, o_w, count = carry
        w_act = jnp.where(unmerged, weight, -jnp.inf)
        imax = jnp.argmax(w_act)
        max_mean = mean[imax]
        max_cov = cov[imax]

        if distance_metric == 0:
            dist = mahalanobis2(max_mean[None], max_cov[None], mean, cov)
        else:
            dist = hellinger2(max_mean[None], max_cov[None], mean, cov)
        sel = unmerged & (dist < min_separation)
        # the principal always merges with itself (distance 0)
        sel = sel | (jnp.arange(N) == imax)
        sel = sel & unmerged

        selw = jnp.where(sel, weight, 0.0)
        W = jnp.sum(selw)
        W_safe = jnp.maximum(W, 1e-30)
        mu = jnp.einsum("n,nd->d", selw, mean) / W_safe
        diff = mu[None, :] - mean                           # [N, D]
        spread = cov + diff[:, :, None] * diff[:, None, :]  # [N, D, D]
        cov_m = jnp.einsum("n,nij->ij", selw, spread) / W_safe
        cov_m = sym(cov_m)

        o_mean = o_mean.at[count].set(mu)
        o_cov = o_cov.at[count].set(cov_m)
        o_w = o_w.at[count].set(W)
        return (unmerged & ~sel, o_mean, o_cov, o_w, count + 1)

    unmerged0 = active
    carry = (unmerged0, out_mean, out_cov, out_weight,
             jnp.zeros((), dtype=jnp.int32))
    unmerged, out_mean, out_cov, out_weight, count = jax.lax.while_loop(
        cond, body, carry)
    n_dropped = jnp.sum(unmerged.astype(jnp.int32))
    return out_mean, out_cov, out_weight, count, n_dropped


def gm_merge_batch(mean, cov, weight, active, min_separation, out_cap,
                   distance_metric=0):
    """vmap of :func:`gm_merge` over a leading particle axis."""
    fn = lambda m, c, w, a: gm_merge(m, c, w, a, min_separation, out_cap,
                                     distance_metric)
    return jax.vmap(fn)(mean, cov, weight, active)


def merge_route(cfg):
    """Which merge implementation ``cfg.pallas_merge`` selects here:
    ``"kernel"`` (the Pallas kernel compiled for a CUDA GPU), ``"interpret"``
    (the same kernel in interpret mode, for CPU tests) or ``"xla"`` (the
    while_loop reference). 0 = XLA, 1 = the kernel on a GPU and XLA
    elsewhere, 2 = interpret."""
    from .pallas_merge import kernel_platform_ok
    if cfg.pallas_merge == 2:
        return "interpret"
    if cfg.pallas_merge == 1 and kernel_platform_ok():
        return "kernel"
    return "xla"


def switch_widths(n):
    """Static lane widths for an exact live-prefix width switch over a
    weight-sorted axis of length ``n``: the powers of two from n/4 up to
    (not including) n, then n itself. A lax.switch on the live count picks
    the narrowest width that holds every live lane, so the sliced-off tail
    is all-inactive and the result is exact."""
    widths = []
    w = 1 << max(0, int(n) // 4 - 1).bit_length()
    while w < n:
        widths.append(w)
        w *= 2
    return widths + [int(n)]


def width_switch(n_live, widths, make_branch, *operands):
    """lax.switch over ``make_branch(w)`` for w in ``widths`` on the
    narrowest width holding ``n_live`` (a traced scalar)."""
    if len(widths) == 1:
        return make_branch(widths[0])(*operands)
    sel = sum((n_live > w).astype(jnp.int32) for w in widths[:-1])
    return jax.lax.switch(sel, [make_branch(w) for w in widths], *operands)


def pack_planes(mean, cov, weight, active):
    """(mean [P, N, D], cov [P, N, D, D], weight, active) -> packed SoA
    planes [P, 2 + D + D(D+1)/2, N]: w, act, means, upper-triangle covs.
    Inverse of :func:`unpack_planes`."""
    D = mean.shape[-1]
    planes = [weight, active.astype(weight.dtype)]
    planes += [mean[..., i] for i in range(D)]
    planes += [cov[..., a, b] for a in range(D) for b in range(a, D)]
    return jnp.stack(planes, axis=-2)


def merge_batch_dispatch(mean, cov, weight, active, cfg, out_cap,
                         sorted_prefix=False):
    """Batch merge (mean [P, N, D], ...) routed by :func:`merge_route`;
    see :func:`merge_batch_dispatch_packed`."""
    if merge_route(cfg) == "xla":
        return gm_merge_batch(mean, cov, weight, active, cfg.min_separation,
                              out_cap, cfg.distance_metric)
    return merge_batch_dispatch_packed(
        pack_planes(mean, cov, weight, active), mean.shape[-1], cfg, out_cap,
        sorted_prefix)


def unpack_planes(packed, D):
    """Planes [P, C, N] -> (mean [P, N, D], cov [P, N, D, D], weight,
    active). Inverse of :func:`pack_planes`."""
    weight = packed[:, 0]
    active = packed[:, 1] > 0.5
    mean = jnp.stack([packed[:, 2 + i] for i in range(D)], axis=-1)
    full = [[None] * D for _ in range(D)]
    i = 2 + D
    for a in range(D):
        for b in range(a, D):
            full[a][b] = full[b][a] = packed[:, i]
            i += 1
    cov = jnp.stack([jnp.stack(row, axis=-1) for row in full], axis=-2)
    return mean, cov, weight, active


def merge_batch_dispatch_packed(packed, D, cfg, out_cap,
                                sorted_prefix=False):
    """Batch merge on packed SoA planes [P, 2 + D + D(D+1)/2, N].

    The Pallas kernel (ops/pallas_merge.py) runs when :func:`merge_route`
    selects it and the metric is implemented there (Mahalanobis for D =
    2, 3, 4; Hellinger for D = 2); otherwise the XLA while_loop runs.

    ``sorted_prefix``: the caller guarantees every particle's active lanes
    are a weight-DESCENDING prefix (true for all the top-cap-compacted
    candidate sets). The kernel then picks principals with one cumsum, and
    the dispatch lax.switches between narrower static widths on the
    batch's max live count (:func:`switch_widths`) — exact, and it cuts
    the per-cluster lane sweep when live lanes fill a fraction of the cap.
    """
    route = merge_route(cfg)
    metric = cfg.distance_metric
    if route == "xla" or not (metric == 0 or D == 2):
        mean, cov, weight, active = unpack_planes(packed, D)
        return gm_merge_batch(mean, cov, weight, active, cfg.min_separation,
                              out_cap, metric)
    from .pallas_merge import gm_merge_pallas

    def make_branch(w):
        def branch(pk):
            return gm_merge_pallas(
                pk[:, :, :w], D, float(cfg.min_separation), out_cap,
                metric=metric, sorted_w=sorted_prefix,
                r_par=max(1, cfg.merge_r_par),
                interpret=route == "interpret")
        return branch

    N = packed.shape[-1]
    if not sorted_prefix:
        return make_branch(N)(packed)
    n_live = jnp.max(jnp.sum(
        ((packed[:, 1] > 0.5) & (packed[:, 0] > 0)).astype(jnp.int32),
        axis=1))
    return width_switch(n_live, switch_widths(N), make_branch, packed)


def select_live_topT(grid, thr, T):
    """Heaviest-T live detection lanes per measurement (single particle).

    ``grid`` [M, K] >= 0 (invalid lanes zeroed), ``thr`` [M] > 0 per
    measurement: live = grid >= thr[:, None]. ONE 2-operand payload sort
    along K — key = -grid on live lanes (sentinel +1 on dead), payload =
    feature index — yields the TRUE heaviest T live lanes per measurement
    (stable: ties keep index order, like lax.top_k).

    The sort keeps the heaviest T of ALL live lanes, not just of the
    first live lanes in index order.

    Returns (vals [M, T], idx [M, T] int32 feature indices,
    n_live scalar int32, n_kept scalar int32).
    """
    M, K = grid.shape
    live = grid >= thr[:, None]
    neg = jnp.where(live, -grid, 1.0)
    iota = jnp.broadcast_to(jnp.arange(K, dtype=jnp.int32)[None, :], (M, K))
    neg_s, idx_s = jax.lax.sort((neg, iota), num_keys=1, dimension=-1)
    vals = jnp.maximum(-neg_s[:, :T], 0.0)
    idx = idx_s[:, :T]
    count = jnp.sum(live.astype(jnp.int32), axis=-1)    # [M] live lanes
    n_live = jnp.sum(count)
    n_kept = jnp.sum(jnp.minimum(count, T))
    return vals, idx, n_live, n_kept


def topcap_sort(red_w, red_act, red_flat, cap):
    """Global top-``cap``-by-weight lane selection via ONE 2-operand
    payload sort carrying lane ids (single particle).

    Stable ascending sort on -w ties by index exactly like ``lax.top_k``,
    but partitions under SPMD along the particle axis and carries the id
    payload for free.

    Returns (idx [cap] from red_flat, cand_w [cap], sel_act [cap] bool,
    n_dropped_live scalar).
    """
    live = red_act & (red_w > 0)
    neg_w = jnp.where(live, -red_w, 1.0)
    neg_s, idx = jax.lax.sort((neg_w, red_flat), num_keys=1)
    cand_w = jnp.maximum(-neg_s[:cap], 0.0)
    sel_act = neg_s[:cap] < 0
    n_live = jnp.sum(live.astype(jnp.int32))
    return idx[:cap], cand_w, sel_act, jnp.maximum(n_live - cap, 0)


def topk_compact_indices(weight, active, cap):
    """Scalar-only top-``cap``-by-weight lane selection.

    The fast compaction path: run ``top_k`` over the [N] candidate *weights*
    alone and let the caller gather means/covariances piecewise from their
    small source tables — the O(N D^2) candidate covariance array is never
    materialized (unlike :func:`compact_candidates`).

    Returns (idx [cap], values [cap], sel_act [cap] bool, n_dropped_live).
    """
    live = active & (weight > 0)
    w_act = jnp.where(live, weight, -1.0)
    vals, idx = jax.lax.top_k(w_act, cap)
    sel_act = vals > 0
    n_live = jnp.sum(live.astype(jnp.int32))
    n_dropped = jnp.maximum(n_live - cap, 0)
    return idx, jnp.where(sel_act, vals, 0.0), sel_act, n_dropped


def compact_candidates(mean, cov, weight, active, cap):
    """Top-``cap``-by-weight compaction of a candidate set (single particle).

    The PHD update materializes K*(M+1)+M candidate lanes but only a few
    hundred are active at reference weight thresholds (SURVEY.md §7.3
    capacity budgeting). Shrinking the merge input keeps the greedy loop's
    per-iteration distance sweep - and the XLA program - small.

    Returns (mean[cap, D], cov, weight, active, n_dropped_live).
    """
    N, D = mean.shape
    if cap <= 0 or cap >= N:
        return mean, cov, weight, active, jnp.zeros((), jnp.int32)
    w_act = jnp.where(active, weight, -1.0)
    _, idx = jax.lax.top_k(w_act, cap)
    sel_act = active[idx] & (weight[idx] > 0)
    eye = jnp.eye(D, dtype=mean.dtype)
    out_mean = jnp.where(sel_act[:, None], mean[idx], 0.0)
    out_cov = jnp.where(sel_act[:, None, None], cov[idx], eye)
    out_w = jnp.where(sel_act, weight[idx], 0.0)
    n_live = jnp.sum((active & (weight > 0)).astype(jnp.int32))
    n_dropped = jnp.maximum(n_live - cap, 0)
    return out_mean, out_cov, out_w, sel_act, n_dropped

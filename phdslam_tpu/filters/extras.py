"""Auxiliary filter estimators: EAP expected map, MC map variance,
single-feature particle weighting.

Reference specs:
* EAP expected map — weight-scaled concatenation of all particle maps reduced
  by GM merge (computeExpectedMap, /root/reference/src/main.cpp:290-316;
  GPU pairwise version phdfilter.cu:3779-3876; matlab/computeExpectedMap.m).
* MC map variance — phdVarianceKernel (phdfilter.cu:2643-2705): draw one
  sample from each updated component, evaluate the component at it; sum
  ``val`` for non-detection terms and ``val*(1-val)`` for detection/birth
  terms over nSamples draws. NB the reference feeds LOG densities into the
  ``val*(1-val)`` form (sampleAndEvalGaussian returns evalGaussian's log
  value, device_math.cuh:600-605) — a unit bug of the same class as the
  evalGaussian sign bug; we use linear-domain values.
* Single-feature (RB) particle weighting — scheme 2, host-side
  (phdfilter.cu:3599-3661): locate the (measurement, feature) pre-update
  term with the highest single-object likelihood, evaluate the predicted and
  updated GMs at its updated mean, and scale the particle weight by
  ``a * v_predict / (b * v_update)``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..config import SlamConfig
from ..ops.gm_merge import gm_merge
from ..ops.math import gaussian_logpdf, safe_log
from ..types import GMState


def eap_expected_map_flat(gm: GMState, log_weight, cfg: SlamConfig,
                          out_cap=None):
    """Expected a-posteriori map, FLAT form: merge the particle-weight-scaled
    concatenation of all particles' maps in one greedy pass
    (computeExpectedMap, main.cpp:363-379 — the reference's CPU reduction).

    O(P*K) merge lanes: fine at small P, unusable at 10k particles (10.5M
    lanes at P=10240/K=1024, and under NamedSharding the flatten
    all-gathers the whole map state). Prefer :func:`eap_expected_map`.
    """
    P, K, D = gm.mean.shape
    out_cap = out_cap or K
    w_scale = jnp.exp(log_weight)[:, None] * gm.weight        # [P, K]
    flat_mean = gm.mean.reshape(P * K, D)
    flat_cov = gm.cov.reshape(P * K, D, D)
    flat_w = w_scale.reshape(P * K)
    active = flat_w > 0
    eye = jnp.eye(D, dtype=flat_mean.dtype)
    flat_cov = jnp.where(active[:, None, None], flat_cov, eye)
    mean, cov, weight, _, _ = gm_merge(
        flat_mean, flat_cov, flat_w, active, cfg.min_separation, out_cap,
        cfg.distance_metric)
    return mean, cov, weight


def _sort_lanes_desc(mean, cov, w):
    """Payload-sort merge lanes weight-descending per batch row.

    One variadic lax.sort carrying the D + D(D+1)/2 + 1 SoA planes.
    Enables the merge kernel's sorted-principal mode and the width
    switcher.
    """
    B, N, D = mean.shape
    planes = [mean[..., d] for d in range(D)]
    for a in range(D):
        for b in range(a, D):
            planes.append(cov[..., a, b])
    out = jax.lax.sort((-w,) + tuple(planes), num_keys=1, dimension=-1)
    w_s = jnp.maximum(-out[0], 0.0)
    mean_s = jnp.stack(out[1:1 + D], axis=-1)
    full = [[None] * D for _ in range(D)]
    i = 1 + D
    for a in range(D):
        for b in range(a, D):
            full[a][b] = full[b][a] = out[i]
            i += 1
    cov_s = jnp.stack([jnp.stack(row, axis=-1) for row in full], axis=-2)
    return mean_s, cov_s, w_s


def eap_expected_map(gm: GMState, log_weight, cfg: SlamConfig,
                     out_cap=None, return_dropped: bool = False):
    """Expected a-posteriori map via log2(P)-depth pairwise tree merges —
    the reference's device-side pairwise reduction (phdfilter.cu:3828-3863:
    repeatedly merge map pairs until one remains), batched so every level
    is ONE batch-level merge over P/2 particle pairs.

    Each level reshapes [Pl, K] -> [Pl/2, 2K] and merges each pair's 2K
    lanes back to ``cfg.eap_tree_cap`` (default K) clusters; each level's
    lanes are weight-sorted first so the merge kernel runs in
    sorted-principal mode with width switching. Under NamedSharding the
    early levels pair within-shard particles; only the last
    log2(n_devices) levels move one map per device — O(K D^2 log N) bytes
    instead of the flat form's full-state all-gather.

    Unlike the reference's ragged tree, fixed-capacity levels can drop
    lowest-weight mass when a pair's merged live count exceeds the
    intermediate cap; ``return_dropped=True`` returns the summed dropped
    cluster count as a diagnostic 4th output.

    Returns (mean[out_cap, D], cov, weight[, n_dropped]).
    """
    from ..ops.gm_merge import merge_batch_dispatch

    P, K, D = gm.mean.shape
    out_cap = out_cap or K
    if P <= 2:
        mean, cov, w = eap_expected_map_flat(gm, log_weight, cfg, out_cap)
        if return_dropped:
            return mean, cov, w, jnp.zeros((), jnp.int32)
        return mean, cov, w

    eye = jnp.eye(D, dtype=gm.mean.dtype)
    w = jnp.exp(log_weight)[:, None] * gm.weight              # [P, K]
    act = w > 0
    mean = jnp.where(act[..., None], gm.mean, 0.0)
    cov = jnp.where(act[..., None, None], gm.cov, eye)
    w = jnp.where(act, w, 0.0)

    mid_cap = cfg.eap_tree_cap or K
    L = K
    n_dropped = jnp.zeros((), jnp.int32)
    while mean.shape[0] > 1:
        Pl = mean.shape[0]
        if Pl % 2:                                   # pad one empty map
            pad = lambda x, v: jnp.concatenate(
                [x, jnp.full((1,) + x.shape[1:], v, x.dtype)], axis=0)
            mean, w = pad(mean, 0.0), pad(w, 0.0)
            cov = jnp.concatenate(
                [cov, jnp.broadcast_to(eye, (1, L, D, D))], axis=0)
            Pl += 1
        mean = mean.reshape(Pl // 2, 2 * L, D)
        cov = cov.reshape(Pl // 2, 2 * L, D, D)
        w = w.reshape(Pl // 2, 2 * L)
        mean, cov, w = _sort_lanes_desc(mean, cov, w)
        cap = out_cap if Pl == 2 else mid_cap
        mean, cov, w, _, drop = merge_batch_dispatch(
            mean, cov, w, w > 0, cfg, cap, sorted_prefix=True)
        n_dropped = n_dropped + jnp.sum(drop).astype(jnp.int32)
        L = cap
    if return_dropped:
        return mean[0], cov[0], w[0], n_dropped
    return mean[0], cov[0], w[0]


def map_variance(gm: GMState, n_nondetect, key, cfg: SlamConfig):
    """MC map-variance estimate per particle (phdVarianceKernel).

    ``gm`` holds the post-update components; the first ``n_nondetect`` slots
    per particle are treated as non-detection terms (``+val``), the rest as
    detection/birth terms (``+val*(1-val)``), averaged over cfg.n_samples
    draws. Returns [P].
    """
    P, K, D = gm.mean.shape
    S = cfg.n_samples
    eps = jax.random.normal(key, (P, K, S, D), gm.mean.dtype)
    L = jnp.linalg.cholesky(gm.cov + 1e-9 * jnp.eye(D, dtype=gm.mean.dtype))
    x = gm.mean[:, :, None, :] + jnp.einsum("pkij,pksj->pksi", L, eps)
    logpdf = gaussian_logpdf(x, gm.mean[:, :, None, :],
                             gm.cov[:, :, None, :, :])
    val = gm.weight[:, :, None] * jnp.exp(logpdf)             # [P, K, S]
    is_nd = (jnp.arange(K) < n_nondetect)[None, :, None]
    live = (gm.weight > 0)[:, :, None]
    contrib = jnp.where(is_nd, val, val * (1.0 - val))
    return jnp.sum(jnp.where(live, contrib, 0.0), axis=(1, 2)) / S


def mc_variance_candidates(mean, cov, weight, n_nondetect, n_samples, key):
    """Single-particle MC variance over the pre-merge update candidate array
    (layout [K nondetect | M*K detections | M births], phdVarianceKernel).

    Accumulates over samples with a fori_loop to keep memory at O(N*D) per
    iteration instead of O(N*S*D).
    """
    N, D = mean.shape
    L = jnp.linalg.cholesky(cov + 1e-9 * jnp.eye(D, dtype=mean.dtype))
    live = weight > 0
    is_nd = jnp.arange(N) < n_nondetect

    def body(s, acc):
        eps = jax.random.normal(jax.random.fold_in(key, s), (N, D),
                                mean.dtype)
        x = mean + jnp.einsum("nij,nj->ni", L, eps)
        val = weight * jnp.exp(gaussian_logpdf(x, mean, cov))
        contrib = jnp.where(is_nd, val, val * (1.0 - val))
        return acc + jnp.sum(jnp.where(live, contrib, 0.0))

    total = jax.lax.fori_loop(0, n_samples, body, jnp.zeros((), mean.dtype))
    return total / n_samples


def mc_variance_packed(packed, is_nd, n_samples, key):
    """Batch MC variance over the fast path's SELECTED candidate lanes
    (packed SoA planes [P, 7, N]: w, act, mean0, mean1, c00, c01, c11 —
    the D=2 layout of filters/phd._finish_candidates_packed).

    Same estimator as :func:`mc_variance_candidates` (phdVarianceKernel,
    phdfilter.cu:2643-2705) restricted to the top-cap selected lanes —
    the sub-threshold tail it omits carries negligible weight by
    construction. Exactness trick: a point sampled as x = m + L eps and
    evaluated under the SAME Gaussian has Mahalanobis distance
    (L eps)' (L L')^{-1} (L eps) = |eps|^2, so neither the Cholesky nor
    the inverse is ever formed — only det for the normalizer.

    ``is_nd`` [P, N]: persistent (non-detection) lanes contribute ``val``,
    detection/birth lanes ``val * (1 - val)``. Returns [P].
    """
    w = packed[:, 0]
    live = (packed[:, 1] > 0.5) & (w > 0)
    c00, c01, c11 = packed[:, 4], packed[:, 5], packed[:, 6]
    det = jnp.maximum(c00 * c11 - c01 * c01, 1e-30)
    pref = w / (2.0 * jnp.pi * jnp.sqrt(det))          # w * N(m; m, P)

    def body(s, acc):
        eps = jax.random.normal(jax.random.fold_in(key, s),
                                (2,) + w.shape, w.dtype)
        val = pref * jnp.exp(-0.5 * (eps[0] ** 2 + eps[1] ** 2))
        contrib = jnp.where(is_nd, val, val * (1.0 - val))
        return acc + jnp.sum(jnp.where(live, contrib, 0.0), axis=-1)

    total = jax.lax.fori_loop(0, n_samples, body,
                              jnp.zeros(w.shape[0], w.dtype))
    return total / n_samples


def eval_gm(gm_mean, gm_cov, gm_weight, x):
    """v(x) = sum_j w_j N(x; m_j, P_j), linear domain (evalGaussianMixture —
    without its +0.5 exponent sign bug, device_math.cuh:153-179)."""
    logpdf = gaussian_logpdf(x[None, :], gm_mean, gm_cov)
    val = gm_weight * jnp.exp(logpdf)
    return jnp.sum(jnp.where(gm_weight > 0, val, 0.0))


def single_feature_dlogw_point(max_like, x_star, m_valid,
                               pred_mean, pred_cov, pred_w,
                               upd_mean, upd_cov, upd_w, cfg: SlamConfig):
    """Scheme-2 weight increment from the located argmax point
    (phdfilter.cu:3599-3661, the part after the max-likelihood search):
    evaluate the predicted and merged-updated GMs at ``x_star`` and scale
    by the single-feature RB factor.

    ``max_like``: the max single-object likelihood (linear); ``x_star``
    [D]: its updated mean; ``m_valid``: count of measurements with at
    least one geometrically valid detection lane.
    """
    cn_predict = jnp.sum(pred_w)
    cn_update = jnp.sum(upd_w)
    v_predict = eval_gm(pred_mean, pred_cov, pred_w, x_star)
    v_update = eval_gm(upd_mean, upd_cov, upd_w, x_star)

    cd = cfg.clutter_density
    a = (1.0 - cfg.pd) * cd * m_valid \
        + cfg.pd * m_valid * ((m_valid - 1.0) * cd * max_like)
    b = jnp.exp(cn_update - cn_predict - cfg.clutter_rate)
    factor = (a * v_predict) / jnp.maximum(b * v_update, 1e-30)
    return safe_log(factor)


def single_feature_dlogw(log_like, mean_det, det_valid,
                         pred_mean, pred_cov, pred_w,
                         upd_mean, upd_cov, upd_w, cfg: SlamConfig):
    """Scheme-2 weight increment for one particle (phdfilter.cu:3599-3661),
    grid form: the argmax search runs over the FULL [M, K] single-object
    likelihood grid (the slow path's materialization; the fast path finds
    the argmax on its selected lanes and calls
    :func:`single_feature_dlogw_point` directly).

    log_like[M, K]: single-object log likelihoods from the pre-update;
    mean_det[M, K, D]: updated means; pred_*: predicted map; upd_*: merged
    updated map.
    """
    M = jnp.sum(jnp.any(det_valid, axis=1).astype(log_like.dtype))
    ll = jnp.where(det_valid, log_like, -jnp.inf)
    flat = jnp.argmax(ll)
    max_like = jnp.exp(jnp.max(ll))
    x_star = mean_det.reshape(-1, mean_det.shape[-1])[flat]
    return single_feature_dlogw_point(
        max_like, x_star, M, pred_mean, pred_cov, pred_w,
        upd_mean, upd_cov, upd_w, cfg)

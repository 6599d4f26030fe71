"""Rao-Blackwellized GM-PHD SLAM filter — the core.

Functional re-design of the reference filter engine
(/root/reference/src/phdfilter.cu): one pure, jit-able ``step`` that runs
vehicle prediction, map prediction, the GM-PHD measurement update, state
extraction and resampling on device-resident fixed-capacity state
(SURVEY.md §7.1). The per-particle update is written as a single-particle
function and vmapped over the particle axis (reference parallelism P1/P2/P3,
SURVEY.md §2.4), which XLA fuses into large batched ops.

Reference call-stack parity (SURVEY.md §3.3 ``phdUpdateSynth``):
  concat maps            -> fixed-capacity [P, K] arrays (no concat needed)
  computeInRangeKernel   -> models.measurement.classify_in_range (masks)
  host birth loop        -> models.measurement.birth_mean_cov (batched)
  preUpdateSynthKernel   -> ops.ekf.ekf_preupdate / ekf_detection_terms
  phdUpdateKernel        -> _update_single (normalizers, weights, prune mask)
  pruneMap + merge       -> ops.gm_merge.gm_merge (bounded while_loop)
  re-attach out-of-range -> masked top-K compaction
  logSumExp normalize    -> jnp over the particle axis (psum when sharded)
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..config import SlamConfig
from ..models import feature_motion, measurement, vehicle
from ..ops import ekf
from ..ops.gather import take_cols
from ..ops.gm_merge import (compact_candidates, gm_merge, switch_widths,
                             width_switch)
from ..ops.math import LOG0, logsumexp, safe_log
from ..ops.resample import effective_sample_ratio, systematic_ancestors
from ..types import FilterState, GMState


class StepOutputs(NamedTuple):
    expected_pose: jax.Array      # [6]
    map_mean: jax.Array           # [K, D] MAP-particle map (argmax weight)
    map_cov: jax.Array            # [K, D, D]
    map_weight: jax.Array         # [K]
    n_eff: jax.Array              # scalar normalized nEff
    resampled: jax.Array          # bool scalar
    overflow: jax.Array           # merged clusters dropped by capacity
    log_weight: jax.Array         # [P] particle log weights (post-step)
    poses: jax.Array              # [P, 6] particle poses (post-step)
    resample_idx: jax.Array       # [P] ancestor indices
    cardinality: jax.Array        # [C+1] MAP particle's log cardinality
                                  # (zeros-shaped [1] for PHD runs)


# ----------------------------------------------------------------------------
# Prediction
# ----------------------------------------------------------------------------

def predict(state: FilterState, control, dt, cfg: SlamConfig,
            key) -> FilterState:
    """Vehicle + map prediction (phdPredict, phdfilter.cu:1080-1257).

    The reference host loop calls phdPredict ``subdividePredict`` times with
    dt/subdividePredict each (main.cpp:1244-1250, phdfilter.cu:808).
    """
    pose = state.pose
    sub = max(1, cfg.subdivide_predict)
    dt_sub = dt / sub
    for i in range(sub):
        k = jax.random.fold_in(key, i)
        if cfg.motion_type == 0:  # CV_MOTION
            # host noise uses 3x the configured accel stds (phdfilter.cu:1113-1117)
            noise_std = (3.0 * cfg.ax, 3.0 * cfg.ay, 3.0 * cfg.ayaw)
            pose = vehicle.cv_predict(pose, noise_std, dt_sub, k)
        else:  # ACKERMAN_MOTION
            geom = (cfg.l, cfg.h, cfg.a, cfg.b)
            noise_std = (cfg.std_encoder, cfg.std_alpha)
            pose = vehicle.ackerman_predict(pose, control, geom, noise_std,
                                            dt_sub, k)

    state = state.replace(pose=pose)

    # map (feature) prediction for dynamic/mixed models
    # (predictMapMixed, phdfilter.cu:965-1035)
    if cfg.feature_model in (1, 2):
        dyn = state.map_dynamic
        (m_new, c_new, w_new), _jump = feature_motion.mixed_model_predict(
            dyn.mean, dyn.cov, dyn.weight, cfg, dt)
        # the reference computes jump copies but leaves their static-map
        # injection commented out (phdfilter.cu:1009-1014); match that.
        state = state.replace(
            map_dynamic=GMState(mean=m_new, cov=c_new, weight=w_new))
    return state


# ----------------------------------------------------------------------------
# Per-particle GM-PHD measurement update
# ----------------------------------------------------------------------------

def _update_single_pre(pose, mean, cov, weight, z, z_mask,
                       cfg: SlamConfig, key=None, force_full=False):
    """Pre-merge half of the single-particle GM-PHD update
    (phdUpdateKernel, phdfilter.cu:2083-2321): in-range partition, EKF
    pre-update, normalizers, weights and the compacted merge-candidate set.

    Returns a dict consumed by :func:`_update_single_post` (the merge runs
    between the halves so the batched path can hoist it out of vmap).
    """
    K, D = mean.shape
    M = z.shape[0]
    dtype = mean.dtype

    cls = measurement.classify_in_range(pose, mean, weight, cfg)
    in_m = cls == measurement.IN_RANGE
    near_m = cls == measurement.NEARLY_IN_RANGE
    out_m = (cls == measurement.OUT_OF_RANGE) & (weight > 0)

    # slow path: full candidate materialization (needed when downstream
    # consumers want the whole [K + M*K + M] lane grid — only the MC
    # variance estimator; scheme-2 reweighting runs on the fast path's
    # selected lanes since round 3)
    slow = (cfg.compute_variance and key is not None) or force_full
    cap = cfg.merge_candidate_cap
    # the fast path needs an active compaction cap (it selects `cap` lanes)
    use_fast = (not slow) and 0 < cap < (K + M * K + M)

    pre = ekf.ekf_preupdate(pose, mean, cov, cfg)
    det_valid = z_mask[:, None] & in_m[None, :]
    if not use_fast:
        mean_det, logw_part, log_like = ekf.ekf_detection_terms(
            pre, mean, weight, z, cfg)
        logw_part = jnp.where(det_valid, logw_part, LOG0)

        # per-measurement normalizer: sum exp(partial) + clutterDensity
        # + birthWeight (phdfilter.cu:2190-2223)
        log_cd = jnp.full((M, 1), safe_log(cfg.clutter_density), dtype=dtype)
        log_bw = jnp.full((M, 1), safe_log(cfg.birth_weight), dtype=dtype)
        all_logw = jnp.concatenate([logw_part, log_cd, log_bw], axis=1)
        mmax = jnp.max(all_logw, axis=1, keepdims=True)
        log_norm = jnp.squeeze(mmax, 1) + jnp.log(
            jnp.sum(jnp.exp(all_logw - mmax), axis=1))          # [M]
        # detection terms, normalized (phdfilter.cu:2290-2299)
        w_det = jnp.where(det_valid,
                          jnp.exp(logw_part - log_norm[:, None]), 0.0)
        w_birth = jnp.where(
            z_mask, jnp.exp(safe_log(cfg.birth_weight) - log_norm), 0.0)
    else:
        # linear-domain normalizer — the reference's own arithmetic
        # (phdUpdateKernel sums exp(w_partial) linearly, :2190-2223) at one
        # transcendental per [M, K] lane
        mean_det = None
        log_like = None
        pdw = ekf.ekf_detection_linear(pre, weight, z)
        pdw = jnp.where(det_valid, pdw, 0.0)
        # materialize once: pdw feeds the normalizer, the top-T sweeps and
        # the live-lane count; without the barrier XLA may rematerialize
        # the exp chain into each consumer
        pdw = jax.lax.optimization_barrier(pdw)
        norm = jnp.sum(pdw, axis=1) + cfg.clutter_density \
            + cfg.birth_weight                                  # [M]
        log_norm = jnp.log(norm)
        # the normalized [M, K] detection grid w_det = pdw / norm is never
        # materialized on the fast path: per-measurement order equals pdw's
        # (norm is a per-measurement constant), so selection, thresholding
        # and sums all run on pdw and only survivors are normalized
        w_det = None
        w_birth = jnp.where(z_mask, cfg.birth_weight / norm, 0.0)

    # non-detection terms (linear weights, phdfilter.cu:2136-2141)
    w_nd = jnp.where(in_m, weight * (1.0 - pre.pd), 0.0)
    # birth terms (phdfilter.cu:2250-2253, 2290-2299)
    b_mean, b_cov = measurement.birth_mean_cov(pose, z, cfg)
    if D == 4:
        b_mean, b_cov = measurement.birth_mean_cov_4d(pose, z, cfg)

    n_valid_z = jnp.sum(z_mask.astype(dtype))

    # particle weighting (phdfilter.cu:2256-2305)
    if cfg.particle_weighting == 0:
        # cluster-process: sum log normalizers - predicted cardinality,
        # where the predicted cardinality includes pd-scaled persistent
        # weights and one birthWeight per measurement (:2186, 2260-2263)
        card_pred = jnp.sum(jnp.where(in_m, pre.pd * weight, 0.0)) \
            + n_valid_z * cfg.birth_weight
        dlog_w = jnp.sum(jnp.where(z_mask, log_norm, 0.0)) - card_pred
    else:
        # Vo empty-map weighting (:2264-2280)
        cn_predict = jnp.sum(jnp.where(in_m, weight, 0.0))
        if w_det is not None:
            cn_det = jnp.sum(w_det)
        else:
            cn_det = jnp.sum(jnp.sum(pdw, axis=1) / norm)
        cn_update = jnp.sum(w_nd) + cn_det + jnp.sum(w_birth)
        dlog_w = n_valid_z * cfg.clutter_density + cn_update - cn_predict \
            - cfg.clutter_rate

    # prune flags (weight < minFeatureWeight, phdfilter.cu:2307-2319);
    # nearly-in-range features are never pruned (flags reset before merge,
    # phdfilter.cu:3271-3273)
    min_fw = cfg.min_feature_weight
    act_a = (in_m & (w_nd >= min_fw)) | near_m
    w_a = jnp.where(in_m, w_nd, jnp.where(near_m, weight, 0.0))
    if w_det is None:
        # fast path: stage-1 selection thresholds pdw directly
        # (w_det >= min_fw <=> pdw >= min_fw * norm) and counts live lanes
        act_b = None
    else:
        act_b = det_valid & (w_det >= min_fw)
    act_c = z_mask & (w_birth >= min_fw)

    # merge candidate set: lane layout [K persistent | M*K detections | M births]
    eye = jnp.eye(D, dtype=dtype)
    N = K + M * K + M
    if use_fast:
        # FAST PATH: top-k over candidate *weights* only, then a row
        # gather from small per-feature tables. Neither the
        # [N, D, D] candidate covariance (detection cov is shared per
        # feature, phdfilter.cu:1890-1894) nor the [M, K, D] mean grid is
        # ever materialized.
        from ..ops.gm_merge import topk_compact_indices
        T = cfg.detection_topk
        if 0 < T < K:
            # stage 1: the heaviest T LIVE detection lanes per measurement,
            # on the UNNORMALIZED pdw grid — w_det >= min_fw <=> pdw >=
            # min_fw * norm, and norm is a per-measurement constant so pdw
            # order == w_det order; one payload sort (select_live_topT)
            from ..ops.gm_merge import select_live_topT, topcap_sort
            vals_d, idx_d, n_live_d, n_kept_d = select_live_topT(
                pdw, min_fw * norm, T)
            flat_d = K + jnp.arange(M, dtype=jnp.int32)[:, None] * K + idx_d
            w_sel = jnp.where(vals_d > 0, vals_d / norm[:, None], 0.0)
            act_sel = vals_d > 0
            n_extra = n_live_d - n_kept_d
            red_w = jnp.concatenate([w_a, w_sel.reshape(M * T), w_birth],
                                    axis=0)
            red_act = jnp.concatenate([act_a, act_sel.reshape(M * T), act_c],
                                      axis=0)
            red_flat = jnp.concatenate(
                [jnp.arange(K, dtype=jnp.int32),
                 flat_d.reshape(M * T),
                 K + M * K + jnp.arange(M, dtype=jnp.int32)], axis=0)
            # stage 2: global top-cap by weight (one payload sort)
            idx, cand_w, sel_act, n_drop = topcap_sort(
                red_w, red_act, red_flat, cap)
            n_compact = n_drop + n_extra
            if cfg.particle_weighting == 2:
                # scheme-2 argmax over the SELECTED lanes: like = pdw /
                # (pd * w), pd == cfg.pd on every live lane (pdw > 0 =>
                # in FOV). The reference searches the full grid
                # (phdfilter.cu:3599-3625); restricting to the top-T
                # detection set only misses the argmax when a heavier
                # single-object likelihood hides in a sub-top-T pdw lane.
                w_k = jnp.take(weight, idx_d)                    # [M, T]
                like = jnp.where(
                    vals_d > 0,
                    vals_d / jnp.maximum(cfg.pd * w_k, 1e-30), 0.0)
                fl = jnp.argmax(like.reshape(-1))
                s2 = dict(
                    max_like=like.reshape(-1)[fl],
                    x_star=ekf.ekf_detection_means_at(
                        pre, mean, z, (fl // T)[None],
                        idx_d.reshape(-1)[fl][None])[0],
                    m_valid=n_valid_z * jnp.any(in_m).astype(dtype))
            else:
                s2 = None
        else:
            w_det_full = pdw / norm[:, None]
            act_b_full = det_valid & (w_det_full >= min_fw)
            cand_w = jnp.concatenate(
                [w_a, w_det_full.reshape(M * K), w_birth], axis=0)
            cand_act = jnp.concatenate(
                [act_a, act_b_full.reshape(M * K), act_c], axis=0)
            idx, cand_w, sel_act, n_compact = topk_compact_indices(
                cand_w, cand_act, cap)
            if cfg.particle_weighting == 2:
                like_g = jnp.where(
                    det_valid & (weight[None, :] > 0),
                    pdw / jnp.maximum(cfg.pd * weight[None, :], 1e-30),
                    0.0)
                fl = jnp.argmax(like_g.reshape(-1))
                s2 = dict(
                    max_like=like_g.reshape(-1)[fl],
                    x_star=ekf.ekf_detection_means_at(
                        pre, mean, z, (fl // K)[None], (fl % K)[None])[0],
                    m_valid=n_valid_z * jnp.any(in_m).astype(dtype))
            else:
                s2 = None
        # the row gather itself is DEFERRED to the caller
        # (_finish_candidates / _finish_candidates_packed), so the batched
        # path can narrow it to the live candidate prefix first
        k_eff, m_eff, is_p, is_d = ekf.candidate_gather_indices(
            idx, K, M, True)
        t_k, t_m = ekf.candidate_tables_T(mean, cov, pre, z, b_mean, b_cov)
        gather = dict(k_eff=k_eff, m_eff=m_eff, is_p=is_p, is_d=is_d,
                      sel_act=sel_act, cand_w=cand_w, t_k=t_k, t_m=t_m)
        pre_out = dict(cand=None, gather=gather, dlog_w=dlog_w, out_m=out_m,
                       n_compact=n_compact, variance=None, log_like=None,
                       mean_det=None, det_valid=None, s2=s2)
        return pre_out
    else:
        cand_mean = jnp.concatenate(
            [mean, mean_det.reshape(M * K, D), b_mean], axis=0)
        cand_cov = jnp.concatenate(
            [cov,
             jnp.broadcast_to(pre.cov_upd[None],
                              (M, K, D, D)).reshape(M * K, D, D),
             b_cov], axis=0)
        cand_w = jnp.concatenate([w_a, w_det.reshape(M * K), w_birth], axis=0)
        cand_act = jnp.concatenate([act_a, act_b.reshape(M * K), act_c],
                                   axis=0)

        # sanitize inactive candidates: masked lanes can hold non-finite
        # values (e.g. births from padded zero measurements) and 0 * NaN
        # would poison the merge's masked reductions
        cand_mean = jnp.where(cand_act[:, None], cand_mean, 0.0)
        cand_cov = jnp.where(cand_act[:, None, None], cand_cov, eye)
        cand_w = jnp.where(cand_act, cand_w, 0.0)

        variance = None
        if cfg.compute_variance and key is not None:
            from .extras import mc_variance_candidates
            variance = mc_variance_candidates(
                cand_mean, cand_cov, cand_w, K, cfg.n_samples, key)

        cand_mean, cand_cov, cand_w, cand_act, n_compact = compact_candidates(
            cand_mean, cand_cov, cand_w, cand_act, cap)

    # mean_det/log_like/det_valid grids are only consumed by the scheme-2
    # reweighting in _update_single_post; drop them otherwise so the vmap
    # never materializes them as outputs
    keep_grids = cfg.particle_weighting == 2
    pre_out = dict(cand=(cand_mean, cand_cov, cand_w, cand_act),
                   gather=None,
                   dlog_w=dlog_w, out_m=out_m, n_compact=n_compact,
                   variance=variance,
                   log_like=log_like if keep_grids else None,
                   mean_det=mean_det if keep_grids else None,
                   det_valid=det_valid if keep_grids else None, s2=None)
    return pre_out


def _finish_gather_planes(pre_out, D, has_birth=True):
    """Complete a deferred candidate gather (fast path) in PLANE form:
    fetch the selected table rows ([C, cap] transposed layout) and return
    (mean_planes, cov_planes, cand_w, sel_act)."""
    g = pre_out["gather"]
    r_k = take_cols(g["k_eff"], g["t_k"])
    r_m = take_cols(g["m_eff"], g["t_m"])
    mean_pl, cov_pl = ekf.combine_selected_planes(
        r_k, r_m, g["is_p"], g["is_d"], g["sel_act"], D, has_birth)
    return mean_pl, cov_pl, g["cand_w"], g["sel_act"]


def _finish_candidates(pre_out, D, has_birth=True):
    """Array-form completion of a deferred gather: (cand_mean [..., cap, D],
    cand_cov [..., cap, D, D], cand_w, cand_act)."""
    mean_pl, cov_pl, cand_w, sel_act = _finish_gather_planes(
        pre_out, D, has_birth)
    cand_mean = jnp.stack(mean_pl, axis=-1)
    full = [[None] * D for _ in range(D)]
    i = 0
    for a in range(D):
        for b in range(a, D):
            full[a][b] = full[b][a] = cov_pl[i]
            i += 1
    cand_cov = jnp.stack([jnp.stack(row, axis=-1) for row in full], axis=-2)
    return cand_mean, cand_cov, cand_w, sel_act


def _finish_candidates_packed(pre_out, D, has_birth=True):
    """Packed completion of a deferred gather: SoA planes [P, C, cap]
    (w, act, means, upper-triangle covs) ready for
    ops.gm_merge.merge_batch_dispatch_packed."""
    mean_pl, cov_pl, cand_w, sel_act = _finish_gather_planes(
        pre_out, D, has_birth)
    planes = [cand_w, sel_act.astype(cand_w.dtype)] + mean_pl + cov_pl
    return jnp.stack(planes, axis=-2)


def _post_compact_batched(mg, pre, mean, cov, weight, cfg: SlamConfig):
    """Batch-level post-merge half: re-attach out-of-range features and
    compact to capacity with ONE [P, 2K] payload sort + a column gather
    of the merged and original planes. Scheme-2 reweighting and the same
    overflow accounting run on the gathered planes. Returns (new_mean,
    new_cov, new_w, dlog_w, overflow).
    """
    P, K, D = mean.shape
    dtype = mean.dtype
    mg_mean, mg_cov, mg_w, n_merged, n_dropped = mg
    out_m = pre["out_m"]

    def compact_at(w_sl):
        """Sort + gather over the [:, :w_sl] prefixes of BOTH inputs —
        exact when every merged cluster (emission order = a prefix) and
        every live map lane (weight-sorted prefix) fits in w_sl."""
        aw = jnp.concatenate(
            [mg_w[:, :w_sl],
             jnp.where(out_m[:, :w_sl], weight[:, :w_sl], 0.0)], axis=1)
        n_all = aw.shape[1]
        n_out = min(K, n_all)
        iota = jnp.broadcast_to(jnp.arange(n_all, dtype=jnp.int32)[None],
                                (P, n_all))
        neg_s, order = jax.lax.sort((-aw, iota), num_keys=1, dimension=-1)
        nw = jnp.maximum(-neg_s[:, :n_out], 0.0)
        order = order[:, :n_out]
        rows = [jnp.concatenate([mg_mean[:, :w_sl, i], mean[:, :w_sl, i]],
                                axis=1) for i in range(D)]
        rows += [jnp.concatenate(
            [mg_cov[:, :w_sl, a, b], cov[:, :w_sl, a, b]], axis=1)
            for a in range(D) for b in range(a, D)]
        tab = jnp.stack(rows, axis=1)               # [P, C, 2*w_sl]
        got = take_cols(order, tab)
        if n_out < K:
            nw = jnp.pad(nw, ((0, 0), (0, K - n_out)))
            got = jnp.pad(got, ((0, 0), (0, 0), (0, K - n_out)))
        live_cnt = jnp.sum((aw > 0).astype(jnp.int32), axis=1)
        return nw, got, live_cnt

    # post-width switching: merged clusters occupy an emission-order
    # prefix of mg and live map lanes a weight-sorted prefix, so the
    # [P, 2K] sort + gather shrink to the live extent
    pwidths = [K]
    if D == 2 and K >= 256 and cfg.feature_width_switch:
        pwidths = switch_widths(K)
    n_req = jnp.maximum(
        jnp.max(n_merged),
        jnp.max(jnp.sum((weight > 0).astype(jnp.int32), axis=1)))
    new_w, got, total_live = width_switch(
        n_req, pwidths, lambda w: (lambda: compact_at(w)))

    empty = new_w <= 0
    mean_pl = [jnp.where(empty, 0.0, got[:, i]) for i in range(D)]
    new_mean = jnp.stack(mean_pl, axis=-1)
    full = [[None] * D for _ in range(D)]
    i = D
    for a in range(D):
        for b in range(a, D):
            cp = jnp.where(empty, 1.0 if a == b else 0.0, got[:, i])
            full[a][b] = full[b][a] = cp
            i += 1
    new_cov = jnp.stack([jnp.stack(row, axis=-1) for row in full], axis=-2)
    new_w = jnp.where(empty, 0.0, new_w)

    overflow = jnp.maximum(total_live - K, 0) + n_dropped \
        + pre["n_compact"]

    dlog_w = pre["dlog_w"]
    if cfg.particle_weighting == 2 and pre.get("s2") is not None:
        from .extras import single_feature_dlogw_point
        s2 = pre["s2"]
        dlog_w = jax.vmap(
            lambda ml, xs, mv, m, c, w, nm, nc, nw: single_feature_dlogw_point(
                ml, xs, mv, m, c, w, nm, nc, nw, cfg))(
            s2["max_like"], s2["x_star"], s2["m_valid"],
            mean, cov, weight, new_mean, new_cov, new_w)
    return new_mean, new_cov, new_w, dlog_w, overflow


def _update_single_post(mg, pre_out, mean, cov, weight, cfg: SlamConfig):
    """Post-merge half of the per-particle update: re-attach out-of-range
    features, compact to capacity, and (scheme 2) reweight."""
    K, D = mean.shape
    dtype = mean.dtype
    mg_mean, mg_cov, mg_w, n_merged, n_dropped = mg
    n_dropped = n_dropped + pre_out["n_compact"]
    out_m = pre_out["out_m"]
    dlog_w = pre_out["dlog_w"]

    # recombine with untouched out-of-range features (phdfilter.cu:3311-3318)
    all_mean = jnp.concatenate([mg_mean, mean], axis=0)
    all_cov = jnp.concatenate([mg_cov, cov], axis=0)
    all_w = jnp.concatenate([mg_w, jnp.where(out_m, weight, 0.0)], axis=0)

    # top-K compaction by weight (overflow -> lowest-weight drop; the
    # reference has no capacity, so surface overflow for diagnostics).
    # 2-operand payload sort instead of lax.top_k: TopK lowers to a
    # custom-call the SPMD partitioner cannot split along the (sharded)
    # particle axis, while a variadic sort along the lane axis partitions
    # trivially. Stable ascending sort on -w ties by index like top_k.
    n_all = all_w.shape[0]
    neg_s, order = jax.lax.sort(
        (-all_w, jnp.arange(n_all, dtype=jnp.int32)), num_keys=1)
    new_w = jnp.maximum(-neg_s[:K], 0.0)
    order = order[:K]
    new_mean = all_mean[order]
    new_cov = all_cov[order]
    # restore identity covariance on empty slots
    empty = new_w <= 0
    new_cov = jnp.where(empty[:, None, None], jnp.eye(D, dtype=dtype), new_cov)
    new_mean = jnp.where(empty[:, None], 0.0, new_mean)
    new_w = jnp.where(empty, 0.0, new_w)

    total_live = jnp.sum((all_w > 0).astype(jnp.int32))
    overflow = jnp.maximum(total_live - K, 0) + n_dropped

    if cfg.particle_weighting == 2:
        # RB single-feature weighting runs on the post-merge map
        # (phdfilter.cu:3599-3661); the fast path located the argmax on
        # its selected lanes (pre_out["s2"]), the slow path searches the
        # full grids here
        if pre_out.get("s2") is not None:
            from .extras import single_feature_dlogw_point
            s2 = pre_out["s2"]
            dlog_w = single_feature_dlogw_point(
                s2["max_like"], s2["x_star"], s2["m_valid"],
                mean, cov, weight, new_mean, new_cov, new_w, cfg)
        else:
            from .extras import single_feature_dlogw
            dlog_w = single_feature_dlogw(
                pre_out["log_like"], pre_out["mean_det"],
                pre_out["det_valid"],
                mean, cov, weight, new_mean, new_cov, new_w, cfg)

    if pre_out["variance"] is not None:
        return new_mean, new_cov, new_w, dlog_w, overflow, \
            pre_out["variance"]
    return new_mean, new_cov, new_w, dlog_w, overflow


def _update_single(pose, mean, cov, weight, z, z_mask, cfg: SlamConfig,
                   key=None):
    """Single-particle GM-PHD update — the full reference composition
    (pre -> merge -> post). Returns (new_mean, new_cov, new_weight, dlog_w,
    overflow[, variance])."""
    pre_out = _update_single_pre(pose, mean, cov, weight, z, z_mask, cfg,
                                 key)
    cand = (pre_out["cand"] if pre_out["gather"] is None
            else _finish_candidates(pre_out, mean.shape[1]))
    mg = gm_merge(*cand, cfg.min_separation, mean.shape[0],
                  cfg.distance_metric)
    return _update_single_post(mg, pre_out, mean, cov, weight, cfg)


_LANE_KEYS = ("k_eff", "m_eff", "is_p", "is_d", "sel_act", "cand_w")


def _gather_prefix(gather, w):
    """A deferred-gather dict narrowed to its first ``w`` candidate lanes
    (the per-feature source tables stay whole)."""
    return {k: (v[:, :w] if k in _LANE_KEYS else v)
            for k, v in gather.items()}


def gather_merge_width_switched(gather, D, cfg, out_cap, has_birth=True,
                                sorted_prefix=True):
    """Candidate-width-switched gather + combine + merge on a deferred-
    gather dict (shared by the PHD, CPHD and mixed pipelines): live
    candidates occupy the stage-2 weight-sorted prefix, so everything
    downstream of stage 2 can run on the [:, :cap'] slice, lax.switched on
    the batch's max live candidate count — exact (sliced lanes are all
    inactive)."""
    from ..ops.gm_merge import merge_batch_dispatch_packed

    def make_branch(w):
        def branch(g):
            packed = _finish_candidates_packed(
                {"gather": _gather_prefix(g, w)}, D, has_birth=has_birth)
            return merge_batch_dispatch_packed(packed, D, cfg, out_cap,
                                               sorted_prefix=sorted_prefix)
        return branch

    cap = gather["cand_w"].shape[-1]
    cwidths = [cap]
    if sorted_prefix and cap >= 256 and cfg.feature_width_switch:
        cwidths = switch_widths(cap)
    n_live_c = jnp.max(jnp.sum(
        (gather["sel_act"] & (gather["cand_w"] > 0)).astype(jnp.int32),
        axis=1))
    return width_switch(n_live_c, cwidths, make_branch, gather)


def _pre_merge_phase(pose, mean, cov, weight, z, z_mask,
                     cfg: SlamConfig, out_cap, keys=None):
    """Fast-path per-particle pre half + batch gather and merge at the
    GIVEN feature width (mean [P, K', D] may be a live-prefix slice of the
    map — see :func:`_batched_update`'s feature-width switching). Returns
    (mg, bits, variance) where ``bits`` carries the width-independent
    post-half inputs (out_m padded by the caller, dlog_w, n_compact, s2).
    """
    K = mean.shape[-2]
    D = mean.shape[-1]
    M = z.shape[0]
    cap = cfg.merge_candidate_cap
    with_var = cfg.compute_variance and keys is not None

    pre = jax.vmap(lambda p, m, c, w: _update_single_pre(
        p, m, c, w, z, z_mask, cfg))(pose, mean, cov, weight)
    # prefix-sortedness holds only when a compaction actually ran: with
    # cap >= the full lane count, compact_candidates returns the ORIGINAL
    # (unsorted) lane layout
    sorted_prefix = 0 < cap < (K + M * K + M)
    variance = None
    if not with_var:
        mg = gather_merge_width_switched(pre["gather"], D, cfg, out_cap,
                                         sorted_prefix=sorted_prefix)
    else:
        from ..ops.gm_merge import merge_batch_dispatch_packed
        packed = _finish_candidates_packed(pre, D)
        mg = merge_batch_dispatch_packed(packed, D, cfg, out_cap,
                                         sorted_prefix=sorted_prefix)
        # fast-path MC variance over the SELECTED lanes (the reference
        # runs phdVarianceKernel on the full pre-merge candidate array,
        # :3585-3597). The tail this misses is usually sub-threshold
        # weight, but NOT by construction: when live candidates exceed
        # merge_candidate_cap the stage-2 cap also drops above-
        # min_feature_weight lanes (visible as a non-zero n_compact/
        # overflow count) and the estimate then under-counts that dropped
        # mass relative to the reference's full-array form. Configs that
        # need the exact full-grid estimator under cap pressure can
        # disable the cap (merge_candidate_cap=0).
        from .extras import mc_variance_packed
        variance = mc_variance_packed(
            packed, pre["gather"]["is_p"], cfg.n_samples, keys[0])

    bits = dict(out_m=pre["out_m"], dlog_w=pre["dlog_w"],
                n_compact=pre["n_compact"], s2=pre.get("s2"))
    return mg, bits, variance


def _batched_update(pose, mean, cov, weight, z, z_mask, cfg: SlamConfig,
                    keys=None):
    """All-particle update with the merge and the candidate gather hoisted
    OUT of the vmap, so the merge sees the whole batch at once.

    Feature-width switching: the map's live lanes always occupy a
    weight-sorted prefix (the post-half compaction sorts, prediction
    preserves zeros), and a zero-weight lane contributes EXACTLY nothing
    to any normalizer, candidate or weight — so the whole pre-half +
    merge can run on the [:, :K'] live prefix, lax.switched on the
    batch's max live count, bit-exactly. The post half runs at full K
    (merge out_cap stays K), so output capacity semantics are unchanged.
    Everything that scales with K (classify, EKF pre-update, the [M, K]
    detection grid, candidate tables) shrinks to the live fraction.
    """
    K = mean.shape[-2]
    D = mean.shape[-1]
    M = z.shape[0]
    cap = cfg.merge_candidate_cap
    with_var = cfg.compute_variance and keys is not None
    # the packed-plane variance estimator covers the D=2 fast path; other
    # shapes fall back to the per-particle full-grid estimator
    slow = with_var and not (0 < cap < (K + M * K + M) and D == 2)
    use_fast = (not slow) and 0 < cap < (K + M * K + M)

    if slow or not use_fast:
        if slow:
            pre = jax.vmap(lambda p, m, c, w, k: _update_single_pre(
                p, m, c, w, z, z_mask, cfg, k))(pose, mean, cov, weight,
                                                keys)
        else:
            pre = jax.vmap(lambda p, m, c, w: _update_single_pre(
                p, m, c, w, z, z_mask, cfg))(pose, mean, cov, weight)
        from ..ops.gm_merge import merge_batch_dispatch
        n_full = K + M * K + M
        cm, cc, cw, ca = pre["cand"]
        mg = merge_batch_dispatch(cm, cc, cw, ca, cfg, K,
                                  sorted_prefix=0 < cap < n_full)
        return jax.vmap(
            lambda mg_t, pre_t, m, c, w: _update_single_post(
                mg_t, pre_t, m, c, w, cfg)
        )(mg, pre, mean, cov, weight)

    if with_var:
        mg, bits, variance = _pre_merge_phase(
            pose, mean, cov, weight, z, z_mask, cfg, out_cap=K, keys=keys)
    else:
        widths = [K]
        if D == 2 and K >= 256 and cfg.feature_width_switch:
            widths = [w for w in switch_widths(K)
                      if w > cfg.detection_topk]

        def make_branch(w):
            def branch(p_, m_, c_, w_):
                mg_, bits_, _ = _pre_merge_phase(
                    p_, m_[:, :w], c_[:, :w], w_[:, :w], z, z_mask, cfg,
                    out_cap=K)
                if w != K:
                    bits_["out_m"] = jnp.pad(
                        bits_["out_m"], ((0, 0), (0, K - w)))
                return mg_, bits_
            return branch

        n_live = jnp.max(jnp.sum((weight > 0).astype(jnp.int32), axis=1))
        mg, bits = width_switch(n_live, widths, make_branch,
                                pose, mean, cov, weight)

    # batch-level post half at FULL width: one payload sort + gather
    out = _post_compact_batched(mg, bits, mean, cov, weight, cfg)
    if with_var:
        return out + (variance,)
    return out


def update(state: FilterState, z, z_mask, cfg: SlamConfig, key=None):
    """Measurement update over all particles (phdUpdateSynth, :3336-3761)."""
    if cfg.feature_model == 0:
        gm = state.map_static
    elif cfg.feature_model == 1:
        gm = state.map_dynamic
    else:
        from .mixed import mixed_update
        return mixed_update(state, z, z_mask, cfg)

    with_var = cfg.compute_variance and key is not None
    keys = (jax.random.split(key, state.pose.shape[0]) if with_var else None)
    upd = _batched_update(state.pose, gm.mean, gm.cov, gm.weight, z, z_mask,
                          cfg, keys)
    if with_var:
        new_mean, new_cov, new_w, dlog_w, overflow, variance = upd
    else:
        new_mean, new_cov, new_w, dlog_w, overflow = upd
        variance = state.variance

    log_w = state.log_weight + dlog_w
    log_w = log_w - logsumexp(log_w, axis=0)  # (phdfilter.cu:3748-3755)

    new_gm = GMState(mean=new_mean, cov=new_cov, weight=new_w)
    if cfg.feature_model == 0:
        state = state.replace(map_static=new_gm, log_weight=log_w,
                              variance=variance)
    else:
        state = state.replace(map_dynamic=new_gm, log_weight=log_w,
                              variance=variance)
    return state, jnp.max(overflow)


# ----------------------------------------------------------------------------
# Extraction + resampling
# ----------------------------------------------------------------------------

def extract(state: FilterState, cfg: SlamConfig):
    """Expected pose + MAP map (recoverSlamState, main.cpp:318-451)."""
    w = jnp.exp(state.log_weight)
    expected_pose = jnp.einsum("p,pd->d", w, state.pose)
    # mixed model (2) reports the static map here; the dynamic map is
    # available from the state for the log writer
    gm = state.map_dynamic if cfg.feature_model == 1 else state.map_static
    if cfg.map_estimate & 2 and not (cfg.map_estimate & 1):
        # EAP expected map (mapEstimate bit 1, main.cpp:363-379): merge the
        # particle-weight-scaled concatenation of all maps. The reference
        # extracts every step (main.cpp:1274); cfg.eap_every > 1 amortizes
        # the pairwise tree by running it every N steps with the cheap MAP
        # extraction in between (both produce [K]-capacity maps).
        from .extras import eap_expected_map

        def _eap(st):
            return eap_expected_map(
                (st.map_dynamic if cfg.feature_model == 1
                 else st.map_static), st.log_weight, cfg)

        def _map(st):
            g = (st.map_dynamic if cfg.feature_model == 1
                 else st.map_static)
            return _map_particle(g, st.log_weight)

        if cfg.eap_every > 1:
            mean, cov, weight = jax.lax.cond(
                state.step % cfg.eap_every == 0, _eap, _map, state)
        else:
            mean, cov, weight = _eap(state)
        return expected_pose, (mean, cov, weight)
    # MAP map = argmax-weight particle's map (mapEstimate bit 0, :344-361)
    return expected_pose, _map_particle(gm, state.log_weight)


def _map_particle(gm: GMState, log_weight):
    """(mean, cov, weight) of the highest-weight particle's map."""
    i = jnp.argmax(log_weight)
    return (jnp.take(gm.mean, i, axis=0), jnp.take(gm.cov, i, axis=0),
            jnp.take(gm.weight, i, axis=0))


def _gather_particles(state: FilterState, idx) -> FilterState:
    """Gather full per-particle state along the particle axis (copy_particles,
    slamtypes.h:313-333)."""
    take = lambda x: jnp.take(x, idx, axis=0)
    return state.replace(
        pose=take(state.pose),
        log_weight=take(state.log_weight),
        map_static=jax.tree.map(take, state.map_static),
        map_dynamic=jax.tree.map(take, state.map_dynamic),
        variance=take(state.variance),
        cardinality=(None if state.cardinality is None
                     else take(state.cardinality)),
        prev_z=(None if state.prev_z is None else take(state.prev_z)),
    )


def maybe_resample(state: FilterState, has_measurements, cfg: SlamConfig,
                   key, mesh=None):
    """Resample when nEff/N <= threshold and this step had measurements
    (main.cpp:1281-1297)."""
    P = state.pose.shape[0]
    n_eff = effective_sample_ratio(state.log_weight)
    do_resample = (n_eff <= cfg.resample_threshold) & has_measurements

    ancestors = systematic_ancestors(state.log_weight, key, P)
    identity = jnp.arange(P, dtype=jnp.int32)

    # the gather only runs on resample steps: under jit+NamedSharding the
    # cross-particle gather lowers to an all-gather of the ENTIRE map state,
    # and even on one card it moves the whole map state through device
    # memory — lax.cond skips it when nEff is healthy.
    # On a particle mesh the gather itself routes through the neighbor
    # migration (parallel/migrate.py): bytes ∝ migrated rows, not map size.
    def _do(st):
        if mesh is not None and getattr(cfg, "neighbor_migration", 1):
            from ..parallel.migrate import gather_particles_sharded
            st = gather_particles_sharded(st, ancestors, mesh, cfg)
        else:
            st = _gather_particles(st, ancestors)
        return st.replace(
            log_weight=jnp.full((P,), -jnp.log(float(P)),
                                dtype=st.log_weight.dtype),
            resample_idx=ancestors)

    def _skip(st):
        return st.replace(resample_idx=identity)

    state = jax.lax.cond(do_resample, _do, _skip, state)
    return state, n_eff, do_resample


# ----------------------------------------------------------------------------
# Full step
# ----------------------------------------------------------------------------

def phd_step(state: FilterState, z, z_mask, control, dt, do_predict,
             cfg: SlamConfig, mesh=None):
    """One full filter step: predict -> update -> extract -> resample.

    Mirrors the per-step body of run_synth (main.cpp:1178-1312). ``z`` is
    padded to [M_max, 2] with ``z_mask`` marking real measurements;
    ``do_predict`` gates vehicle prediction (step 0 has no motion).

    ``cfg.filter_type == 1`` selects the CPHD measurement update
    (filters/cphd.py, functional spec §3.5 of SURVEY.md).

    ``mesh``: the particle mesh when running sharded (bound by
    parallel.sharding.make_sharded_step_fn) — routes the resampling
    migration through the neighbor exchange (parallel/migrate.py).
    """
    key = jax.random.fold_in(state.rng, state.step)
    k_pred, k_res, k_var = jax.random.split(key, 3)

    # particle "shotgunning" (nPredictParticles, phdfilter.cu:1185-1238):
    # each particle spawns k prior duplicates that receive independent
    # prediction noise, weights - log k. The reference lets the expanded set
    # persist until a resampling contracts it (main.cpp:1281-1297,
    # n_particles > 5x target); here - to keep shapes static - the set is
    # ALWAYS contracted back to P by the end-of-step resampler.
    k_shot = max(1, cfg.n_predict_particles)
    P_base = state.pose.shape[0]
    if k_shot > 1:
        rep = lambda x: jnp.repeat(x, k_shot, axis=0)
        state = state.replace(
            pose=rep(state.pose),
            log_weight=rep(state.log_weight) - jnp.log(float(k_shot)),
            map_static=jax.tree.map(rep, state.map_static),
            map_dynamic=jax.tree.map(rep, state.map_dynamic),
            variance=rep(state.variance),
            resample_idx=jnp.arange(P_base * k_shot, dtype=jnp.int32),
            cardinality=(None if state.cardinality is None
                         else rep(state.cardinality)),
            prev_z=(None if state.prev_z is None else rep(state.prev_z)))

    predicted = predict(state, control, dt, cfg, k_pred)
    state = jax.tree.map(
        lambda a, b: jnp.where(do_predict, a, b), predicted, state)

    # lax.cond (not jnp.where over both branches): the reference skips the
    # update call entirely on measurement-less steps (main.cpp:1270-1271);
    # a where-select would execute the full update every step — wasteful
    # on control-dense / measurement-sparse schedules
    has_z = jnp.any(z_mask)

    def _do_update(st):
        if cfg.filter_type == 1:
            from .cphd import cphd_constants, cphd_update
            consts = cphd_constants(cfg, st.pose.dtype)
            upd, ovf = cphd_update(st, z, z_mask, consts, cfg)
        else:
            upd, ovf = update(st, z, z_mask, cfg, k_var)
        return upd, jnp.asarray(ovf, jnp.int32)

    def _skip_update(st):
        return st, jnp.zeros((), jnp.int32)

    state, overflow = jax.lax.cond(has_z, _do_update, _skip_update, state)

    expected_pose, (mm, mc, mw) = extract(state, cfg)
    if k_shot > 1:
        # forced contraction P*k -> P (resampleParticles(particles,
        # config.n_particles), main.cpp:1290)
        n_eff = effective_sample_ratio(state.log_weight)
        ancestors = systematic_ancestors(state.log_weight, k_res, P_base)
        state = _gather_particles(state, ancestors)
        state = state.replace(
            log_weight=jnp.full((P_base,), -jnp.log(float(P_base)),
                                state.log_weight.dtype),
            resample_idx=ancestors)
        resampled = jnp.asarray(True)
    else:
        state, n_eff, resampled = maybe_resample(state, has_z, cfg, k_res,
                                                 mesh=mesh)
    state = state.replace(step=state.step + 1)

    # cn_estimate = MAP particle's cardinality (recoverSlamState,
    # main.cpp:344-361)
    if state.cardinality is not None:
        cn = jnp.take(state.cardinality, jnp.argmax(state.log_weight),
                      axis=0)
    else:
        cn = jnp.zeros((1,), state.pose.dtype)
    out = StepOutputs(expected_pose=expected_pose, map_mean=mm, map_cov=mc,
                      map_weight=mw, n_eff=n_eff, resampled=resampled,
                      overflow=overflow, log_weight=state.log_weight,
                      poses=state.pose, resample_idx=state.resample_idx,
                      cardinality=cn)
    return state, out


def make_step_fn(cfg: SlamConfig, donate: bool = True):
    """Build the jitted step function for a config."""
    fn = functools.partial(phd_step, cfg=cfg)
    if donate:
        return jax.jit(fn, donate_argnums=(0,))
    return jax.jit(fn)

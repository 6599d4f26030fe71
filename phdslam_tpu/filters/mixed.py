"""Joint static+dynamic (jump-Markov mixed) GM-PHD measurement update.

Rebuild of ``phdUpdateKernelMixed`` (/root/reference/src/
phdfilter.cu:2323-2635) and its orchestration in ``phdUpdateSynth``
(:3412-3461, merge/copy-back :3703-3726): the per-measurement normalizer sums
detection terms over BOTH the 2D static and 4D dynamic maps plus clutter and
one birth weight per map (two when measurements are unlabeled, one when
labeled — the mismatching map's birth has weight 0, computeBirth :238-241,
:296-299).

Reference quirks NOT replicated (SURVEY.md §7.3):
* the predicted-cardinality accumulation indexes particle 0's weights
  (``features_predict_static[feature_idx]`` without ``predict_offset``,
  :2412-2413); we use the current particle's weights.
* ``~is_static`` bitwise-not on a bool (:2515) — harmless there, meaningless
  here.

Out-of-range handling (mergeAndCopyMaps :3311-3318, :3714-3719): static
out-of-range features are re-attached untouched; dynamic out-of-range
features are dropped.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..config import SlamConfig
from ..models import measurement
from ..ops import ekf
from ..ops.gm_merge import compact_candidates, gm_merge
from ..ops.math import LOG0, logsumexp, safe_log
from ..types import FilterState, GMState

STATIC_MEASUREMENT = 0
DYNAMIC_MEASUREMENT = 1


def _classify(pose, mean, weight, cfg):
    cls = measurement.classify_in_range(pose, mean, weight, cfg)
    return (cls == measurement.IN_RANGE,
            cls == measurement.NEARLY_IN_RANGE,
            (cls == measurement.OUT_OF_RANGE) & (weight > 0))


def _merge_map(mean, cov, weight, mean_det, cov_upd, w_det, det_valid,
               w_nd, in_m, near_m, out_keep, b_mean, b_cov, w_birth,
               birth_valid, cfg, K, cap=None):
    """Prune + merge + recombine for one map (shared by static/dynamic)."""
    M = w_det.shape[0]
    D = mean.shape[-1]
    dtype = mean.dtype
    min_fw = cfg.min_feature_weight

    act_a = (in_m & (w_nd >= min_fw)) | near_m
    w_a = jnp.where(in_m, w_nd, jnp.where(near_m, weight, 0.0))
    act_b = det_valid & (w_det >= min_fw)
    act_c = birth_valid & (w_birth >= min_fw)

    cand_mean = jnp.concatenate(
        [mean, mean_det.reshape(M * K, D), b_mean], axis=0)
    cand_cov = jnp.concatenate(
        [cov, jnp.broadcast_to(cov_upd[None], (M, K, D, D)).reshape(
            M * K, D, D), b_cov], axis=0)
    cand_w = jnp.concatenate([w_a, w_det.reshape(M * K), w_birth], axis=0)
    cand_act = jnp.concatenate([act_a, act_b.reshape(M * K), act_c], axis=0)

    eye = jnp.eye(D, dtype=dtype)
    cand_mean = jnp.where(cand_act[:, None], cand_mean, 0.0)
    cand_cov = jnp.where(cand_act[:, None, None], cand_cov, eye)
    cand_w = jnp.where(cand_act, cand_w, 0.0)

    cand_mean, cand_cov, cand_w, cand_act, n_compact = compact_candidates(
        cand_mean, cand_cov, cand_w, cand_act,
        cfg.merge_candidate_cap if cap is None else cap)
    mg_mean, mg_cov, mg_w, _, n_dropped = gm_merge(
        cand_mean, cand_cov, cand_w, cand_act, cfg.min_separation, K,
        cfg.distance_metric)
    n_dropped = n_dropped + n_compact

    all_mean = jnp.concatenate([mg_mean, mean], axis=0)
    all_cov = jnp.concatenate([mg_cov, cov], axis=0)
    all_w = jnp.concatenate([mg_w, jnp.where(out_keep, weight, 0.0)], axis=0)

    _, order = jax.lax.top_k(all_w, K)
    new_mean = all_mean[order]
    new_cov = all_cov[order]
    new_w = all_w[order]
    empty = new_w <= 0
    new_cov = jnp.where(empty[:, None, None], eye, new_cov)
    new_mean = jnp.where(empty[:, None], 0.0, new_mean)
    new_w = jnp.where(empty, 0.0, new_w)
    overflow = jnp.maximum(
        jnp.sum((all_w > 0).astype(jnp.int32)) - K, 0) + n_dropped
    return new_mean, new_cov, new_w, overflow


def _update_mixed_single(pose, mean_s, cov_s, w_s, mean_d, cov_d, w_d,
                         z, z_label, z_mask, cfg: SlamConfig, prev_z=None):
    """Single-particle mixed update. Returns new static map, new dynamic map,
    dlog_w, overflow."""
    Ks = mean_s.shape[0]
    Kd = mean_d.shape[0]
    M = z.shape[0]
    dtype = mean_s.dtype

    in_s, near_s, out_s = _classify(pose, mean_s, w_s, cfg)
    in_d, near_d, out_d = _classify(pose, mean_d, w_d, cfg)

    pre_s = ekf.ekf_preupdate(pose, mean_s, cov_s, cfg)
    pre_d = ekf.ekf_preupdate(pose, mean_d, cov_d, cfg)
    mdet_s, lw_s, _ = ekf.ekf_detection_terms(pre_s, mean_s, w_s, z, cfg)
    mdet_d, lw_d, _ = ekf.ekf_detection_terms(pre_d, mean_d, w_d, z, cfg)

    dv_s = z_mask[:, None] & in_s[None, :]
    dv_d = z_mask[:, None] & in_d[None, :]
    lw_s = jnp.where(dv_s, lw_s, LOG0)
    lw_d = jnp.where(dv_d, lw_d, LOG0)

    # birth weights per measurement/label (computeBirth :238-241, :296-299)
    if cfg.labeled_measurements:
        bw_s = jnp.where(z_label == STATIC_MEASUREMENT, cfg.birth_weight, 0.0)
        bw_d = jnp.where(z_label == DYNAMIC_MEASUREMENT, cfg.birth_weight, 0.0)
        n_birth_terms = 1.0
    else:
        bw_s = jnp.full((M,), cfg.birth_weight, dtype=dtype)
        bw_d = jnp.full((M,), cfg.birth_weight, dtype=dtype)
        n_birth_terms = 2.0

    # per-measurement normalizer: sum of static+dynamic detections + clutter
    # + birth weight(s) (:2480-2505)
    log_terms = jnp.concatenate([
        lw_s, lw_d,
        jnp.full((M, 1), safe_log(cfg.clutter_density), dtype=dtype),
        jnp.full((M, 1),
                 safe_log(cfg.birth_weight) + jnp.log(n_birth_terms),
                 dtype=dtype)], axis=1)
    mmax = jnp.max(log_terms, axis=1, keepdims=True)
    log_norm = jnp.squeeze(mmax, 1) + jnp.log(
        jnp.sum(jnp.exp(log_terms - mmax), axis=1))               # [M]

    w_nd_s = jnp.where(in_s, w_s * (1.0 - pre_s.pd), 0.0)
    w_nd_d = jnp.where(in_d, w_d * (1.0 - pre_d.pd), 0.0)
    wdet_s = jnp.where(dv_s, jnp.exp(lw_s - log_norm[:, None]), 0.0)
    wdet_d = jnp.where(dv_d, jnp.exp(lw_d - log_norm[:, None]), 0.0)

    b_mean_s, b_cov_s = measurement.birth_mean_cov(pose, z, cfg)
    b_mean_d, b_cov_d = measurement.birth_mean_cov_4d(pose, z, cfg)
    if prev_z is not None:
        b_mean_d = measurement.seed_birth_velocity(b_mean_d, prev_z,
                                                   z_mask, cfg)
    wb_s = jnp.where(z_mask, jnp.exp(safe_log(bw_s) - log_norm), 0.0)
    wb_d = jnp.where(z_mask, jnp.exp(safe_log(bw_d) - log_norm), 0.0)

    n_valid_z = jnp.sum(z_mask.astype(dtype))

    if cfg.particle_weighting == 0:
        # cluster-process (:2448-2456, 2548-2556): predicted cardinality is
        # pd-scaled persistent weights only (no birth terms, unlike the
        # static-only kernel)
        card_pred = jnp.sum(jnp.where(in_s, pre_s.pd * w_s, 0.0)) \
            + jnp.sum(jnp.where(in_d, pre_d.pd * w_d, 0.0))
        dlog_w = jnp.sum(jnp.where(z_mask, log_norm, 0.0)) - card_pred
    else:
        # Vo empty-map (:2558-2582)
        cn_predict = jnp.sum(jnp.where(in_s, w_s, 0.0)) \
            + jnp.sum(jnp.where(in_d, w_d, 0.0)) \
            + n_valid_z * cfg.birth_weight
        cn_update = jnp.sum(w_nd_s) + jnp.sum(wdet_s) + jnp.sum(wb_s) \
            + jnp.sum(w_nd_d) + jnp.sum(wdet_d) + jnp.sum(wb_d)
        dlog_w = n_valid_z * cfg.clutter_density + cn_update - cn_predict \
            - cfg.clutter_rate

    new_s = _merge_map(mean_s, cov_s, w_s, mdet_s, pre_s.cov_upd, wdet_s,
                       dv_s, w_nd_s, in_s, near_s, out_s, b_mean_s, b_cov_s,
                       wb_s, z_mask & (bw_s > 0), cfg, Ks)
    # dynamic out-of-range features are killed (:3714-3719): out_keep = False
    new_d = _merge_map(mean_d, cov_d, w_d, mdet_d, pre_d.cov_upd, wdet_d,
                       dv_d, w_nd_d, in_d, near_d,
                       jnp.zeros_like(out_d), b_mean_d, b_cov_d,
                       wb_d, z_mask & (bw_d > 0), cfg, Kd,
                       cap=getattr(cfg, "merge_candidate_cap_dynamic", 0)
                       or None)

    overflow = new_s[3] + new_d[3]
    return new_s[:3], new_d[:3], dlog_w, overflow


def _birth_weights(z_label, M, cfg, dtype):
    """Per-measurement birth weights for each map + the normalizer's birth
    contribution (computeBirth :238-241, :296-299): labeled measurements
    birth only into the matching map (one birth term); unlabeled birth into
    both (two terms)."""
    if cfg.labeled_measurements:
        bw_s = jnp.where(z_label == STATIC_MEASUREMENT,
                         cfg.birth_weight, 0.0).astype(dtype)
        bw_d = jnp.where(z_label == DYNAMIC_MEASUREMENT,
                         cfg.birth_weight, 0.0).astype(dtype)
        birth_norm = cfg.birth_weight
    else:
        bw_s = jnp.full((M,), cfg.birth_weight, dtype=dtype)
        bw_d = jnp.full((M,), cfg.birth_weight, dtype=dtype)
        birth_norm = 2.0 * cfg.birth_weight
    return bw_s, bw_d, birth_norm


def _fast_select(pdw, dv, norm, w_a, act_a, w_birth, act_c, K, M, T, cap,
                 min_fw):
    """Two-stage candidate selection for one map (the static filter's fast
    pipeline, filters/phd.py::_update_single_pre stage 1+2): heaviest-T
    live detection lanes per measurement on the UNNORMALIZED grid, then one
    global top-cap payload sort. Returns the deferred-gather index set."""
    from ..ops.gm_merge import (select_live_topT, topcap_sort,
                                topk_compact_indices)
    if 0 < T < K:
        vals_d, idx_d, n_live_d, n_kept_d = select_live_topT(
            pdw, min_fw * norm, T)
        flat_d = K + jnp.arange(M, dtype=jnp.int32)[:, None] * K + idx_d
        w_sel = jnp.where(vals_d > 0, vals_d / norm[:, None], 0.0)
        act_sel = vals_d > 0
        n_extra = n_live_d - n_kept_d
        red_w = jnp.concatenate([w_a, w_sel.reshape(M * T), w_birth], axis=0)
        red_act = jnp.concatenate([act_a, act_sel.reshape(M * T), act_c],
                                  axis=0)
        red_flat = jnp.concatenate(
            [jnp.arange(K, dtype=jnp.int32),
             flat_d.reshape(M * T),
             K + M * K + jnp.arange(M, dtype=jnp.int32)], axis=0)
        idx, cand_w, sel_act, n_drop = topcap_sort(red_w, red_act, red_flat,
                                                   cap)
        return idx, cand_w, sel_act, n_drop + n_extra
    w_det_full = pdw / norm[:, None]
    act_b_full = dv & (w_det_full >= min_fw)
    cand_w = jnp.concatenate([w_a, w_det_full.reshape(M * K), w_birth],
                             axis=0)
    cand_act = jnp.concatenate([act_a, act_b_full.reshape(M * K), act_c],
                               axis=0)
    idx, cand_w, sel_act, n_compact = topk_compact_indices(cand_w, cand_act,
                                                           cap)
    return idx, cand_w, sel_act, n_compact


def _update_mixed_pre(pose, mean_s, cov_s, w_s, mean_d, cov_d, w_d,
                      z, z_label, z_mask, cfg: SlamConfig, prev_z=None):
    """Fast-path pre half of the mixed update (single particle, vmapped).

    Mirrors the static filter's deferred-gather pipeline
    (filters/phd.py::_update_single_pre fast path) with the JOINT
    per-measurement normalizer of phdUpdateKernelMixed
    (phdfilter.cu:2480-2505): norm[m] sums detection terms over BOTH maps
    plus clutter and the label-gated birth weight(s). Neither [M, K]
    normalized grid nor any [N, D, D] candidate array is materialized —
    the merges and row gathers run at batch level."""
    Ks = mean_s.shape[0]
    Kd = mean_d.shape[0]
    M = z.shape[0]
    dtype = mean_s.dtype
    min_fw = cfg.min_feature_weight
    cap = cfg.merge_candidate_cap
    T = cfg.detection_topk

    in_s, near_s, out_s = _classify(pose, mean_s, w_s, cfg)
    in_d, near_d, out_d = _classify(pose, mean_d, w_d, cfg)

    pre_s = ekf.ekf_preupdate(pose, mean_s, cov_s, cfg)
    pre_d = ekf.ekf_preupdate(pose, mean_d, cov_d, cfg)

    dv_s = z_mask[:, None] & in_s[None, :]
    dv_d = z_mask[:, None] & in_d[None, :]
    pdw_s = jnp.where(dv_s, ekf.ekf_detection_linear(pre_s, w_s, z), 0.0)
    pdw_d = jnp.where(dv_d, ekf.ekf_detection_linear(pre_d, w_d, z), 0.0)
    # materialize once: both grids feed the normalizer, top-T sweeps
    # and cardinality sums (see the static path's barrier note)
    pdw_s, pdw_d = jax.lax.optimization_barrier((pdw_s, pdw_d))
    sum_s = jnp.sum(pdw_s, axis=1)
    sum_d = jnp.sum(pdw_d, axis=1)

    bw_s, bw_d, birth_norm = _birth_weights(z_label, M, cfg, dtype)

    norm = sum_s + sum_d + cfg.clutter_density + birth_norm      # [M]
    log_norm = jnp.log(norm)

    w_nd_s = jnp.where(in_s, w_s * (1.0 - pre_s.pd), 0.0)
    w_nd_d = jnp.where(in_d, w_d * (1.0 - pre_d.pd), 0.0)
    wb_s = jnp.where(z_mask, bw_s / norm, 0.0)
    wb_d = jnp.where(z_mask, bw_d / norm, 0.0)

    n_valid_z = jnp.sum(z_mask.astype(dtype))
    if cfg.particle_weighting == 0:
        # cluster-process (:2448-2456, 2548-2556): predicted cardinality is
        # pd-scaled persistent weights only (no birth terms)
        card_pred = jnp.sum(jnp.where(in_s, pre_s.pd * w_s, 0.0)) \
            + jnp.sum(jnp.where(in_d, pre_d.pd * w_d, 0.0))
        dlog_w = jnp.sum(jnp.where(z_mask, log_norm, 0.0)) - card_pred
    else:
        # Vo empty-map (:2558-2582); detection sums fold the pdw row sums
        cn_predict = jnp.sum(jnp.where(in_s, w_s, 0.0)) \
            + jnp.sum(jnp.where(in_d, w_d, 0.0)) \
            + n_valid_z * cfg.birth_weight
        cn_update = jnp.sum(w_nd_s) + jnp.sum(w_nd_d) \
            + jnp.sum(jnp.where(z_mask, (sum_s + sum_d) / norm, 0.0)) \
            + jnp.sum(wb_s) + jnp.sum(wb_d)
        dlog_w = n_valid_z * cfg.clutter_density + cn_update - cn_predict \
            - cfg.clutter_rate

    act_a_s = (in_s & (w_nd_s >= min_fw)) | near_s
    w_a_s = jnp.where(in_s, w_nd_s, jnp.where(near_s, w_s, 0.0))
    act_a_d = (in_d & (w_nd_d >= min_fw)) | near_d
    w_a_d = jnp.where(in_d, w_nd_d, jnp.where(near_d, w_d, 0.0))
    act_c_s = z_mask & (wb_s >= min_fw) & (bw_s > 0)
    act_c_d = z_mask & (wb_d >= min_fw) & (bw_d > 0)

    b_mean_s, b_cov_s = measurement.birth_mean_cov(pose, z, cfg)
    b_mean_d, b_cov_d = measurement.birth_mean_cov_4d(pose, z, cfg)
    if prev_z is not None:
        b_mean_d = measurement.seed_birth_velocity(b_mean_d, prev_z,
                                                   z_mask, cfg)

    def gather_for(pdw, dv, w_a, act_a, wb, act_c, mean, cov, pre,
                   b_mean, b_cov, K, cap_m):
        idx, cand_w, sel_act, n_compact = _fast_select(
            pdw, dv, norm, w_a, act_a, wb, act_c, K, M, T, cap_m, min_fw)
        k_eff, m_eff, is_p, is_d = ekf.candidate_gather_indices(
            idx, K, M, True)
        t_k, t_m = ekf.candidate_tables_T(mean, cov, pre, z, b_mean, b_cov)
        return dict(k_eff=k_eff, m_eff=m_eff, is_p=is_p, is_d=is_d,
                    sel_act=sel_act, cand_w=cand_w, t_k=t_k, t_m=t_m), \
            n_compact

    cap_d = getattr(cfg, "merge_candidate_cap_dynamic", 0) or cap
    g_s, nc_s = gather_for(pdw_s, dv_s, w_a_s, act_a_s, wb_s,
                           act_c_s, mean_s, cov_s, pre_s, b_mean_s,
                           b_cov_s, Ks, cap)
    g_d, nc_d = gather_for(pdw_d, dv_d, w_a_d, act_a_d, wb_d,
                           act_c_d, mean_d, cov_d, pre_d, b_mean_d,
                           b_cov_d, Kd, cap_d)

    return dict(g_s=g_s, g_d=g_d, dlog_w=dlog_w, out_s=out_s,
                nc_s=nc_s, nc_d=nc_d)


def _post_pre_out(dlog_w, out_m, n_compact):
    """pre_out dict for filters.phd._update_single_post (fast-path form)."""
    return dict(cand=None, gather=None, dlog_w=dlog_w, out_m=out_m,
                n_compact=n_compact, variance=None, log_like=None,
                mean_det=None, det_valid=None)


def _batched_mixed_update(pose, gs, gd, z, z_label, z_mask,
                          cfg: SlamConfig, prev_z=None):
    """All-particle mixed update with both merges, candidate gathers and
    selection sorts hoisted OUT of the vmap (the static path's
    _batched_update structure) — the 2D static and 4D dynamic maps each get
    one batch-level merge (phdfilter.cu:2323-2635 is a first-class kernel
    in the reference; this is its main path here too)."""
    Ks = gs.mean.shape[-2]
    Kd = gd.mean.shape[-2]
    pz_args = () if prev_z is None else (prev_z,)
    pre = jax.vmap(
        lambda p, ms, cs, ws, md, cd, wd, *pz: _update_mixed_pre(
            p, ms, cs, ws, md, cd, wd, z, z_label, z_mask, cfg,
            prev_z=pz[0] if pz else None)
    )(pose, gs.mean, gs.cov, gs.weight, gd.mean, gd.cov, gd.weight,
      *pz_args)

    # topcap_sort emits a weight-descending live prefix for both maps;
    # gather + combine + merge run candidate-width switched on it
    # (filters/phd.py::gather_merge_width_switched)
    from .phd import gather_merge_width_switched
    mg_s = gather_merge_width_switched(pre["g_s"], 2, cfg, Ks)
    mg_d = gather_merge_width_switched(pre["g_d"], 4, cfg, Kd)

    # batch-level post halves (one payload sort + gather per map; see
    # filters/phd.py)
    from .phd import _post_compact_batched
    bits_s = dict(out_m=pre["out_s"], dlog_w=pre["dlog_w"],
                  n_compact=pre["nc_s"], s2=None)
    sm, sc, sw, dlog_w, ovf_s = _post_compact_batched(
        mg_s, bits_s, gs.mean, gs.cov, gs.weight, cfg)
    # dynamic out-of-range features are killed (:3714-3719)
    bits_d = dict(out_m=jnp.zeros(gd.weight.shape, bool),
                  dlog_w=jnp.zeros(gd.weight.shape[:1], gd.mean.dtype),
                  n_compact=pre["nc_d"], s2=None)
    dm, dc, dw, _, ovf_d = _post_compact_batched(
        mg_d, bits_d, gd.mean, gd.cov, gd.weight, cfg)
    return (sm, sc, sw), (dm, dc, dw), dlog_w, ovf_s + ovf_d


def mixed_update(state: FilterState, z, z_mask, cfg: SlamConfig,
                 z_label=None):
    """Mixed-model measurement update over all particles.

    Routes to the batch-hoisted fast pipeline (two-stage selection +
    batch 2D/4D merges) when eligible; the reference-shaped per-particle
    route remains for full-materialization configs (scheme 2, variance)
    and as the equivalence oracle (tests/test_mixed_dynamic.py)."""
    if z_label is None:
        z_label = jnp.zeros(z.shape[:-1], jnp.int32)
    gs, gd = state.map_static, state.map_dynamic
    Ks, Kd = gs.mean.shape[-2], gd.mean.shape[-2]
    M = z.shape[0]
    cap = cfg.merge_candidate_cap
    use_fast = (cfg.particle_weighting in (0, 1) and not cfg.compute_variance
                and 0 < cap < min(Ks + M * Ks + M, Kd + M * Kd + M)
                and getattr(cfg, "mixed_fast_path", 1))
    prev_z = state.prev_z if getattr(cfg, "birth_velocity_init", 0) \
        else None
    if use_fast:
        upd = _batched_mixed_update(state.pose, gs, gd, z, z_label, z_mask,
                                    cfg, prev_z=prev_z)
    else:
        pz_args = () if prev_z is None else (prev_z,)
        upd = jax.vmap(
            lambda p, ms, cs, ws, md, cd, wd, *pz: _update_mixed_single(
                p, ms, cs, ws, md, cd, wd, z, z_label, z_mask, cfg,
                prev_z=pz[0] if pz else None)
        )(state.pose, gs.mean, gs.cov, gs.weight, gd.mean, gd.cov,
          gd.weight, *pz_args)
    (sm, sc, sw), (dm, dc, dw), dlog_w, overflow = upd

    log_w = state.log_weight + dlog_w
    log_w = log_w - logsumexp(log_w, axis=0)
    state = state.replace(
        map_static=GMState(mean=sm, cov=sc, weight=sw),
        map_dynamic=GMState(mean=dm, cov=dc, weight=dw),
        log_weight=log_w)
    if state.prev_z is not None:
        # record this scan's world positions per particle for the next
        # step's two-scan velocity pairing (padded to the state's M slot)
        bpos = jax.vmap(
            lambda p: measurement.birth_mean_cov(p, z, cfg)[0])(state.pose)
        new_prev = jnp.zeros_like(state.prev_z)
        M_ = z.shape[0]
        new_prev = new_prev.at[:, :M_, :2].set(bpos)
        new_prev = new_prev.at[:, :M_, 2].set(
            jnp.broadcast_to(z_mask.astype(new_prev.dtype)[None],
                             (bpos.shape[0], M_)))
        state = state.replace(prev_z=new_prev)
    return state, jnp.max(overflow)

"""Cardinalized PHD (CPHD) SLAM filter — Vo's analytic CPHD recursion.

Rebuild of the reference's CPHD pipeline, which lives in
/root/reference/src/phdfilter.cu.bak (the live revision of that code path;
the copy in phdfilter.cu:701-1822 is commented out — SURVEY.md §2.1/§3.5):

  cphdConstantsKernel     (.bak:369-415)  -> :func:`cphd_constants`
  cardinalityPredictKernel(.bak:518-545)  -> :func:`cardinality_predict`
  birthsKernel/addBirths  (.bak:737-900)  -> :func:`add_births` (from the
                                             PREVIOUS scan's measurements,
                                             binomial birth cardinality)
  cphdPreUpdateKernel     (.bak:1058-1191)-> reuses ops.ekf pre-update
  computeEsfKernel        (.bak:1194-1278)-> :func:`log_esf` / :func:`log_esf_omit`
  computePsiKernel        (.bak:1286-1434)-> :func:`psi_terms`
  cphdUpdateKernel        (.bak:1436-1479)-> weight scaling in
                                             :func:`_cphd_update_single`
  particle weight = <Psi0, cn_predict>    (.bak:2665-2668)
  predicted in-range cardinality ~ Poisson(sum w) (.bak:2473-2497)

Reference quirks NOT replicated (same class as SURVEY.md §7.3):
* computePsiKernel's psi1d inner product exponentiates ``val - max_val0``
  with a stale ``max_val0`` instead of its own ``max_val1`` (.bak:1420);
  we use a consistent logsumexp.
* The double particle-weight normalization (.bak:2719-2737) is a no-op and
  collapses to one normalization.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax.scipy.special import gammaln

from ..config import SlamConfig
from ..models import measurement
from ..ops import ekf
from ..ops.gm_merge import compact_candidates
from ..ops.math import (LOG0, logsumexp, masked_logsumexp, safe_log,
                        wrap_angle)
from ..types import FilterState, GMState


# ----------------------------------------------------------------------------
# Constants (cphdConstantsKernel / initCphdConstants, .bak:369-449)
# ----------------------------------------------------------------------------

class CphdConstants(NamedTuple):
    log_factorial: jax.Array   # [C+1] log n!
    log_binom: jax.Array       # [C+1, C+1] log C(n, k) (LOG0 where k > n)
    log_cn_clutter: jax.Array  # [C+1] log Poisson(clutterRate) pmf


def cphd_constants(cfg: SlamConfig, dtype=jnp.float32) -> CphdConstants:
    C = cfg.max_cardinality
    n = jnp.arange(C + 1, dtype=dtype)
    log_fact = gammaln(n + 1.0)
    nn = n[:, None]
    kk = n[None, :]
    log_binom = jnp.where(
        kk <= nn, gammaln(nn + 1.0) - gammaln(kk + 1.0) - gammaln(nn - kk + 1.0),
        LOG0)
    log_cn_clutter = (n * safe_log(cfg.clutter_rate) - cfg.clutter_rate
                      - log_fact)
    return CphdConstants(log_factorial=log_fact.astype(dtype),
                         log_binom=log_binom.astype(dtype),
                         log_cn_clutter=log_cn_clutter.astype(dtype))


# ----------------------------------------------------------------------------
# Cardinality prediction (cardinalityPredictKernel, .bak:518-545)
# ----------------------------------------------------------------------------

def cardinality_predict(log_cn, log_cn_birth):
    """Log-domain convolution: cn_pred[n] = logsum_j cn_birth[n-j] + cn[j]."""
    C1 = log_cn.shape[-1]
    j = jnp.arange(C1)
    n = jnp.arange(C1)
    diff = n[:, None] - j[None, :]                     # [n, j]
    birth_term = jnp.where(diff >= 0,
                           log_cn_birth[jnp.maximum(diff, 0)], LOG0)
    return masked_logsumexp(birth_term + log_cn[None, :], diff >= 0, axis=-1)


def cardinality_predict_batch(log_cn, log_cn_birth):
    """Batched cardinality convolution as a linear-domain Toeplitz MATMUL.

    cn_pred = cn (x) cn_birth: subtract each particle's max, exp to linear,
    one [P, C+1] x [C+1, C+1] dot against the shared birth Toeplitz matrix,
    log back. Numerically equivalent to the per-particle logsumexp in f32
    — exp(x - max) underflows at the same ~-88 relative magnitude where
    logsumexp terms vanish — without the elementwise form's
    [P, C+1, C+1] grids.
    """
    C1 = log_cn.shape[-1]
    mx = jnp.max(log_cn, axis=-1, keepdims=True)       # [P, 1]
    lin = jnp.exp(log_cn - mx)                         # [P, C+1]
    bmax = jnp.max(log_cn_birth)
    diff = jnp.arange(C1)[None, :] - jnp.arange(C1)[:, None]   # T[j, n]
    T = jnp.where(diff >= 0,
                  jnp.exp(log_cn_birth[jnp.maximum(diff, 0)] - bmax), 0.0)
    return safe_log(lin @ T) + mx + bmax


def binomial_birth_cardinality(n_births, birth_weight, max_cardinality,
                               dtype=jnp.float32):
    """log B(k; n, p) with n = number of birth measurements, p = birthWeight
    (birthsKernel, .bak:776-791). ``n_births`` may be a traced integer."""
    k = jnp.arange(max_cardinality + 1, dtype=dtype)
    n = jnp.asarray(n_births, dtype=dtype)
    log_p = safe_log(birth_weight)
    log_q = safe_log(1.0 - birth_weight)
    log_c = gammaln(n + 1.0) - gammaln(k + 1.0) - gammaln(
        jnp.maximum(n - k, 0.0) + 1.0)
    return jnp.where(k <= n, log_c + k * log_p + (n - k) * log_q, LOG0)


# ----------------------------------------------------------------------------
# Elementary symmetric functions (computeEsfKernel, .bak:1194-1278)
# ----------------------------------------------------------------------------

def _esf_scan_body(e, inp):
    """One ESF recursion step e_k += lambda_m * e_{k-1} (log domain)."""
    ll, m = inp
    ll = jnp.where(m, ll, LOG0)
    shifted = jnp.concatenate(
        [jnp.full((1,), LOG0, dtype=e.dtype), e[:-1]])
    e_new = jnp.logaddexp(e, ll + shifted)
    return e_new, e_new


def _esf_identity(M, dtype):
    e0 = jnp.full((M + 1,), LOG0, dtype=dtype)
    return e0.at[0].set(0.0)


def log_esf(log_lambda, lam_mask):
    """Log-domain ESF coefficients e_0..e_M of {exp(log_lambda[m])}.

    Recursion e_k += lambda_m * e_{k-1} per measurement (the reference's
    per-m shared-memory loop, .bak:1233-1246), as a lax.scan. Masked-out
    measurements contribute lambda = 0 (identity step).
    """
    M = log_lambda.shape[-1]
    e0 = _esf_identity(M, log_lambda.dtype)
    e, _ = jax.lax.scan(_esf_scan_body, e0, (log_lambda, lam_mask))
    return e


def log_esf_prefix_suffix(log_lambda, lam_mask):
    """Prefix/suffix ESF decomposition: pref[m] = ESF({0..m-1}),
    suf[m] = ESF({m+1..M-1}) — the two M-step scans shared by
    :func:`log_esf_omit` and the fused ip1d correlation in
    :func:`psi_terms` (pref_suf route)."""
    M = log_lambda.shape[-1]
    e0 = _esf_identity(M, log_lambda.dtype)
    _, pref_raw = jax.lax.scan(_esf_scan_body, e0, (log_lambda, lam_mask))
    pref = jnp.concatenate([e0[None], pref_raw[:-1]], axis=0)   # [M, M+1]
    _, suf_raw = jax.lax.scan(_esf_scan_body, e0, (log_lambda, lam_mask),
                              reverse=True)
    suf = jnp.concatenate([suf_raw[1:], e0[None]], axis=0)      # [M, M+1]
    return pref, suf


def log_esf_omit(log_lambda, lam_mask):
    """ESF with each measurement omitted: esfd[m, k] = e_k({lambda_n : n!=m}).

    Prefix/suffix decomposition: esfd[m] is the log-domain polynomial
    product of ESF({0..m-1}) and ESF({m+1..M-1}) — two M-step scans plus
    one fully PARALLEL masked-logsumexp contraction. The reference's esfd
    pass (.bak:1249-1277) instead subtracts the omitted root back out of
    the full ESF per measurement; our round-2 form re-ran the additive
    recursion per omitted m (a vmapped scan with [P, M, M+1] state). This
    form
    keeps the recursion's numerical stability (additions only, unlike the
    reference's cancellation-prone subtraction) at O(M^2) parallel lanes.
    """
    M = log_lambda.shape[-1]
    pref, suf = log_esf_prefix_suffix(log_lambda, lam_mask)

    # esfd[m, k] = logsum_i pref[m, i] + suf[m, k - i],  k in 0..M-1 —
    # computed as a max-subtracted LINEAR convolution (one shifted-suffix
    # build + one batched matvec) instead of a masked logsumexp over the
    # [M, M, M+1] sum tensor (~6 elementwise passes).
    #
    # Numerical caveat (advisor, round 3): the max is shared PER ROW (one
    # pmax+smax per m), not per output order k. An output k whose dominant
    # term pref[i]+suf[k-i] sits more than ~88 nats below pmax[m]+smax[m]
    # underflows to LOG0 here where a per-output logsumexp would stay
    # finite. Equivalence is therefore per dominant row term; outputs that
    # far down are ~e^-88 RELATIVE to the row's peak ESF order, and psi1d's
    # inner products (which weight esfd by comparably-scaled factors and
    # sum over k) are insensitive to them — pinned by
    # tests/test_cphd.py::test_log_esf_omit_wide_dynamic_range.
    pmax = jnp.max(pref, axis=-1, keepdims=True)                # [M, 1]
    smax = jnp.max(suf, axis=-1, keepdims=True)
    pl = jnp.exp(pref - pmax)
    sl = jnp.exp(suf - smax)
    ki = jnp.arange(M)[:, None] - jnp.arange(M + 1)[None, :]    # [k, i]
    shifted = jnp.where(ki >= 0, sl[:, jnp.clip(ki, 0, M)], 0.0)
    esfd_lin = jnp.einsum("mki,mi->mk", shifted, pl)            # [M, M]
    return safe_log(esfd_lin) + pmax + smax


# ----------------------------------------------------------------------------
# Psi terms (computePsiKernel, .bak:1286-1434)
# ----------------------------------------------------------------------------

def psi_terms(consts: CphdConstants, log_esf_full, log_esfd, log_cn_predict,
              log_ip_qdw, log_wsum, n_measure, z_mask, pref_suf=None):
    """Compute Vo's Psi0/Psi1 terms and their inner products with the
    predicted cardinality.

    Args:
      log_esf_full: [M+1] ESF of all measurements
      log_esfd:     [M, M] ESF with measurement m omitted
      log_cn_predict: [C+1]
      log_ip_qdw:   scalar log <q_d, w>
      log_wsum:     scalar log <1, w>
      n_measure:    traced int — number of valid measurements
      z_mask:       [M]

    Returns (log_psi0[C+1], log_ip_psi0, log_ip_psi1, log_ip_psi1d[M]).
    """
    C1 = consts.log_factorial.shape[0]
    Mp1 = log_esf_full.shape[0]
    dtype = log_esf_full.dtype
    n = jnp.arange(C1, dtype=dtype)[:, None]           # cardinality value
    j = jnp.arange(Mp1, dtype=dtype)[None, :]          # ESF order
    ji = jnp.arange(Mp1)
    nm = jnp.asarray(n_measure, dtype=dtype)

    # aux(n, j) = (M-j)! + cn_clutter[M-j] + esf[j] - n*log_wsum (.bak:1352-1355)
    mj = jnp.clip((nm - j).astype(jnp.int32), 0, C1 - 1)   # M - j index
    aux = (consts.log_factorial[mj] + consts.log_cn_clutter[mj]
           + log_esf_full[None, :] - n * log_wsum)

    valid_j = (j <= jnp.minimum(n, nm))                # j <= min(n, M)

    # log P(n, j) = log C(n, j) + log j!
    def log_perm(order):
        # order: [1, Mp1] float; gather log C(n, order) from the binom table
        oi = jnp.clip(order.astype(jnp.int32), 0, C1 - 1)
        return (consts.log_binom[jnp.arange(C1)[:, None], oi]
                + consts.log_factorial[oi])

    p0 = log_perm(j)                                    # [C+1, M+1]
    tmp0 = aux + p0 + (n - j) * log_ip_qdw
    log_psi0 = masked_logsumexp(tmp0, valid_j, axis=-1)

    p1 = log_perm(j + 1.0)
    tmp1 = aux + p1 + (n - (j + 1.0)) * log_ip_qdw
    valid_j1 = valid_j & ((j + 1.0) <= n)
    log_psi1 = masked_logsumexp(tmp1, valid_j1, axis=-1)

    log_ip_psi0 = logsumexp(log_psi0 + log_cn_predict, axis=-1)
    log_ip_psi1 = logsumexp(log_psi1 + log_cn_predict, axis=-1)

    # psi1 detection terms per measurement (.bak:1399-1426).
    #
    # The per-omitted-measurement inner product is SEPARABLE: with
    #   G(n, j) = (M-1-j)! + cn_clutter[M-1-j] - n*log_wsum
    #             + P(n, j+1) + (n-j-1)*log_ip_qdw
    # (everything in tmpd except the esfd term — independent of m), and the
    # validity region (j <= min(n, nm-1)) & (j+1 <= n) factoring into a
    # per-j condition (j <= nm-1) and a per-(n, j) condition (n >= j+1),
    #   ip1d[m] = logsum_{n,j} [esfd[m, j] + G(n, j) + cn_predict(n)]
    #           = logsum_j [esfd[m, j] + H(j)],
    #   H(j)    = logsum_{n >= j+1} [G(n, j) + cn_predict(n)].
    # H is one [C+1, M] grid shared by ALL measurements; the naive form
    # (the reference's computePsiKernel re-run per omitted z, and our
    # round-2 vmap) builds [M, C+1, M]. Exact reassociation, not an
    # approximation.
    M = z_mask.shape[0]
    jd = jnp.arange(M, dtype=dtype)[None, :]            # [1, M]
    mjd = jnp.clip((nm - jd - 1.0).astype(jnp.int32), 0, C1 - 1)
    g = (consts.log_factorial[mjd] + consts.log_cn_clutter[mjd]
         - n * log_wsum + log_perm(jd + 1.0)
         + (n - (jd + 1.0)) * log_ip_qdw)               # [C+1, M]
    h = masked_logsumexp(g + log_cn_predict[:, None],
                         (jd + 1.0) <= n, axis=0)       # [M]
    valid_jd = jd[0] <= nm - 1.0                        # [M]
    if pref_suf is not None:
        # FUSED ip1d: the esfd grid is only ever consumed through this
        # inner product, and the convolution + inner product reassociate:
        #   ip1d[m] = logsum_j esfd[m, j] + H_j
        #           = logsum_i pref[m, i] + logsum_d suf[m, d] + H_{i+d}
        # i.e. ONE per-particle [M+1, M+1] Toeplitz-of-H matmul against
        # the suffix rows instead of materializing the [M, M, M+1]
        # convolution tensor. Max-subtracted linear domain; same
        # shared-per-row-max underflow class as log_esf_omit (see its
        # docstring caveat).
        pref, suf = pref_suf                            # [M, M+1] each
        hm = jnp.where(valid_jd, h, LOG0)
        hmax = jnp.max(hm)
        h_lin = jnp.exp(hm - hmax)                      # [M]
        Mp1_ = pref.shape[1]
        idx = jnp.arange(Mp1_)[:, None] + jnp.arange(Mp1_)[None, :]
        Hmat = jnp.where(idx <= M - 1,
                         h_lin[jnp.clip(idx, 0, M - 1)], 0.0)
        pmax = jnp.max(pref, axis=-1, keepdims=True)    # [M, 1]
        smax = jnp.max(suf, axis=-1, keepdims=True)
        G = jnp.exp(suf - smax) @ Hmat                  # [M, M+1]
        lin = jnp.sum(jnp.exp(pref - pmax) * G, axis=-1)
        log_ip_psi1d = safe_log(lin) + pmax[:, 0] + smax[:, 0] + hmax
    else:
        log_ip_psi1d = masked_logsumexp(
            log_esfd + h[None, :], valid_jd[None, :], axis=-1)  # [M]
    log_ip_psi1d = jnp.where(z_mask, log_ip_psi1d, LOG0)
    return log_psi0, log_ip_psi0, log_ip_psi1, log_ip_psi1d


# ----------------------------------------------------------------------------
# Per-particle CPHD update
# ----------------------------------------------------------------------------

def _cphd_update_single(pose, mean, cov, weight, z, z_mask, consts,
                        cfg: SlamConfig):
    """Single-particle CPHD measurement update.

    Follows the .bak pipeline §3.5; returns
    (new_mean, new_cov, new_weight, log_cn_update, dlog_w, overflow)."""
    K, D = mean.shape
    M = z.shape[0]
    dtype = mean.dtype

    cls = measurement.classify_in_range(pose, mean, weight, cfg)
    in_m = cls == measurement.IN_RANGE
    near_m = cls == measurement.NEARLY_IN_RANGE
    out_m = (cls == measurement.OUT_OF_RANGE) & (weight > 0)

    cap = cfg.merge_candidate_cap
    use_fast = 0 < cap < (K + M * K)

    pre = ekf.ekf_preupdate(pose, mean, cov, cfg)
    det_valid = z_mask[:, None] & in_m[None, :]
    logw_part, _ = ekf.ekf_detection_logw(pre, weight, z, cfg)
    logw_part = jnp.where(det_valid, logw_part, LOG0)   # [M, K]

    # compatibleZ (.bak:1567, :1695): a measurement is "compatible" when
    # any in-range feature sits within gate_threshold measurement-space
    # Mahalanobis distance — gated births (cfg.gate_births) birth only
    # from incompatible measurements
    if cfg.gate_births:
        ir_g = z[:, None, 0] - pre.r[None, :]
        ib_g = wrap_angle(z[:, None, 1] - pre.bearing[None, :])
        dist_g = (pre.si00[None, :] * ir_g * ir_g
                  + 2.0 * pre.si01[None, :] * ir_g * ib_g
                  + pre.si11[None, :] * ib_g * ib_g)
        compat = jnp.any(det_valid & (dist_g < cfg.gate_threshold), axis=1)
    else:
        compat = jnp.zeros((M,), bool)

    # qdw = log(1-pd) + log w (per in-range feature, .bak:1184-1188)
    log_qdw = jnp.where(in_m, safe_log(1.0 - pre.pd) + safe_log(weight), LOG0)
    log_ip_qdw = masked_logsumexp(log_qdw, in_m, axis=-1)
    log_wsum = safe_log(jnp.sum(jnp.where(in_m, weight, 0.0)))

    # lambda_m = log sum_j w_partial[j, m] + log kappa_rate - log kappa_density
    # (.bak:1206-1221)
    log_lambda = masked_logsumexp(logw_part, det_valid, axis=-1) \
        + safe_log(cfg.clutter_rate) - safe_log(cfg.clutter_density)
    log_lambda = jnp.where(z_mask, log_lambda, LOG0)

    esf_full = log_esf(log_lambda, z_mask)              # [M+1]
    # the [M, M] omitted-ESF grid never materializes: psi_terms consumes
    # it only through the ip1d inner product, fused into one Toeplitz
    # matmul from the prefix/suffix scans (pref_suf route)
    pref_suf = log_esf_prefix_suffix(log_lambda, z_mask)

    # predicted in-range cardinality ~ Poisson(sum w) (.bak:2473-2497)
    C1 = consts.log_factorial.shape[0]
    ncard = jnp.arange(C1, dtype=dtype)
    w_sum = jnp.sum(jnp.where(in_m, weight, 0.0))
    log_cn_predict = (ncard * safe_log(w_sum) - w_sum - consts.log_factorial)

    n_measure = jnp.sum(z_mask.astype(jnp.int32))
    log_psi0, ip0, ip1, ip1d = psi_terms(
        consts, esf_full, None, log_cn_predict, log_ip_qdw, log_wsum,
        n_measure, z_mask, pref_suf=pref_suf)

    # updated cardinality (.bak:1430-1432)
    log_cn_update = log_cn_predict + log_psi0 - ip0
    log_cn_update = log_cn_update - logsumexp(log_cn_update, axis=-1)

    # GM weight update (cphdUpdateKernel, .bak:1436-1479)
    # detections: w = exp(w_partial + psi1d(z) - ip0 + log kr - log kd)
    w_det = jnp.where(
        det_valid,
        jnp.exp(logw_part + ip1d[:, None] - ip0
                + safe_log(cfg.clutter_rate)
                - safe_log(cfg.clutter_density)),
        0.0)
    # non-detections: w = exp(log w + ip1 - ip0 + log(1 - pd))
    # NB: the reference uses the configured pd here, not the per-feature
    # FOV-gated pd (.bak:1468-1471)
    w_nd = jnp.where(in_m, weight * jnp.exp(ip1 - ip0) * (1.0 - cfg.pd), 0.0)

    # particle weight increment = <Psi0, cn_predict> (.bak:2665-2668)
    dlog_w = ip0

    # prune + merge + recombine — same structure as the PHD path
    min_fw = cfg.min_feature_weight
    act_a = (in_m & (w_nd >= min_fw)) | near_m
    w_a = jnp.where(in_m, w_nd, jnp.where(near_m, weight, 0.0))

    T = cfg.detection_topk
    if use_fast and 0 < T < K:
        # two-stage selection + deferred row gather, exactly as the PHD
        # fast path (see ops.gm_merge.select_live_topT / topcap_sort):
        # heaviest-T live detection lanes per measurement, then one global
        # top-cap payload sort carrying full-lane ids.
        from ..ops.gm_merge import select_live_topT, topcap_sort
        wd = jnp.where(det_valid, w_det, 0.0)
        vals_d, idx_d, n_live_d, n_kept_d = select_live_topT(
            wd, jnp.full((M,), min_fw, dtype=dtype), T)
        act_sel = vals_d > 0
        flat_d = K + jnp.arange(M, dtype=jnp.int32)[:, None] * K + idx_d
        red_w = jnp.concatenate([w_a, jnp.where(act_sel, vals_d, 0.0)
                                 .reshape(M * T)], axis=0)
        red_act = jnp.concatenate([act_a, act_sel.reshape(M * T)], axis=0)
        red_flat = jnp.concatenate(
            [jnp.arange(K, dtype=jnp.int32), flat_d.reshape(M * T)], axis=0)
        idx, cand_w, cand_act, n_drop = topcap_sort(
            red_w, red_act, red_flat, cap)
        n_compact = n_drop + (n_live_d - n_kept_d)
    elif use_fast:
        # scalar top-k lane selection (see ops.ekf; avoids materializing
        # the [M*K] detection mean/cov grids)
        from ..ops.gm_merge import topk_compact_indices
        act_b = det_valid & (w_det >= min_fw)
        cand_w = jnp.concatenate([w_a, w_det.reshape(M * K)], axis=0)
        cand_act = jnp.concatenate([act_a, act_b.reshape(M * K)], axis=0)
        idx, cand_w, cand_act, n_compact = topk_compact_indices(
            cand_w, cand_act, cap)
    else:
        act_b = det_valid & (w_det >= min_fw)
        mean_det = ekf.ekf_detection_means(pre, mean, z)
        cand_w = jnp.concatenate([w_a, w_det.reshape(M * K)], axis=0)
        cand_act = jnp.concatenate([act_a, act_b.reshape(M * K)], axis=0)
        cand_mean = jnp.concatenate([mean, mean_det.reshape(M * K, D)],
                                    axis=0)
        cand_cov = jnp.concatenate(
            [cov,
             jnp.broadcast_to(pre.cov_upd[None],
                              (M, K, D, D)).reshape(M * K, D, D)],
            axis=0)
        eye = jnp.eye(D, dtype=dtype)
        cand_mean = jnp.where(cand_act[:, None], cand_mean, 0.0)
        cand_cov = jnp.where(cand_act[:, None, None], cand_cov, eye)
        cand_w = jnp.where(cand_act, cand_w, 0.0)
        cand_mean, cand_cov, cand_w, cand_act, n_compact = compact_candidates(
            cand_mean, cand_cov, cand_w, cand_act, cap)
        return dict(cand=(cand_mean, cand_cov, cand_w, cand_act),
                    gather=None, log_cn=log_cn_update, dlog_w=dlog_w,
                    out_m=out_m, n_compact=n_compact, compat=compat)
    # fast paths: DEFER the row gather to batch level (packed-plane
    # combine, exactly as filters/phd.py); lane layout here is [K | M*K],
    # no birth lanes
    k_eff, m_eff, is_p, is_d = ekf.candidate_gather_indices(
        idx, K, M, False)
    t_k, t_m = ekf.candidate_tables_T(mean, cov, pre, z)
    gather = dict(k_eff=k_eff, m_eff=m_eff, is_p=is_p, is_d=is_d,
                  sel_act=cand_act, cand_w=cand_w, t_k=t_k, t_m=t_m)
    return dict(cand=None, gather=gather, log_cn=log_cn_update,
                dlog_w=dlog_w, out_m=out_m, n_compact=n_compact,
                compat=compat)


def _cphd_update_single_post(mg, pre_out, mean, cov, weight,
                             cfg: SlamConfig):
    """Post-merge half: re-attach out-of-range features and compact."""
    K, D = mean.shape
    eye = jnp.eye(D, dtype=mean.dtype)
    mg_mean, mg_cov, mg_w, _, n_dropped = mg
    n_dropped = n_dropped + pre_out["n_compact"]
    out_m = pre_out["out_m"]

    all_mean = jnp.concatenate([mg_mean, mean], axis=0)
    all_cov = jnp.concatenate([mg_cov, cov], axis=0)
    all_w = jnp.concatenate([mg_w, jnp.where(out_m, weight, 0.0)], axis=0)

    new_w, order = jax.lax.top_k(all_w, K)
    new_mean = all_mean[order]
    new_cov = all_cov[order]
    empty = new_w <= 0
    new_cov = jnp.where(empty[:, None, None], eye, new_cov)
    new_mean = jnp.where(empty[:, None], 0.0, new_mean)
    new_w = jnp.where(empty, 0.0, new_w)

    total_live = jnp.sum((all_w > 0).astype(jnp.int32))
    overflow = jnp.maximum(total_live - K, 0) + n_dropped
    return new_mean, new_cov, new_w, pre_out["log_cn"], pre_out["dlog_w"], \
        overflow


def add_births(gm: GMState, pose, z, z_mask, cfg: SlamConfig,
               allowed=None):
    """Append birth Gaussians for each measurement (addBirths, .bak:794-900).

    Weight = birthWeight each (linear); lowest-weight components are dropped
    if capacity is exceeded. ``allowed`` [P, M] bool optionally gates births
    per particle (gated births, birthsKernel .bak:750: only measurements
    with no compatible existing feature birth). Returns
    (GMState, overflow_count[P]).
    """
    P, K, D = gm.mean.shape
    birth_fn = (measurement.birth_mean_cov if D == 2
                else measurement.birth_mean_cov_4d)
    b_mean, b_cov = jax.vmap(lambda p: birth_fn(p, z, cfg))(pose)  # [P,M,D]
    M = z.shape[0]
    dtype = gm.mean.dtype
    b_w = jnp.where(z_mask, cfg.birth_weight, 0.0).astype(dtype)
    b_w = jnp.broadcast_to(b_w, (P, M))
    if allowed is not None:
        b_w = jnp.where(allowed, b_w, 0.0)
    eye = jnp.eye(D, dtype=dtype)
    b_mean = jnp.where(z_mask[None, :, None], b_mean, 0.0)
    b_cov = jnp.where(z_mask[None, :, None, None], b_cov, eye)

    all_w = jnp.concatenate([gm.weight, b_w], axis=1)
    # top-K compaction via ONE variadic payload sort carrying the
    # D + D(D+1)/2 SoA planes (no separate row gather). Stable descending
    # sort ties by original index like lax.top_k.
    planes = []
    for d in range(D):
        planes.append(jnp.concatenate([gm.mean[..., d], b_mean[..., d]],
                                      axis=1))
    for a in range(D):
        for b in range(a, D):
            planes.append(jnp.concatenate([gm.cov[..., a, b],
                                           b_cov[..., a, b]], axis=1))
    out = jax.lax.sort((-all_w,) + tuple(planes), num_keys=1, dimension=-1)
    new_w = jnp.maximum(-out[0][:, :K], 0.0)
    mean_pl = [p[:, :K] for p in out[1:1 + D]]
    new_mean = jnp.stack(mean_pl, axis=-1)
    full = [[None] * D for _ in range(D)]
    i = 1 + D
    for a in range(D):
        for b in range(a, D):
            full[a][b] = full[b][a] = out[i][:, :K]
            i += 1
    new_cov = jnp.stack([jnp.stack(row, axis=-1) for row in full], axis=-2)
    empty = new_w <= 0
    new_cov = jnp.where(empty[:, :, None, None], eye, new_cov)
    new_mean = jnp.where(empty[:, :, None], 0.0, new_mean)
    new_w = jnp.where(empty, 0.0, new_w)
    overflow = jnp.maximum(
        jnp.sum((all_w > 0).astype(jnp.int32), axis=1) - K, 0)
    return GMState(mean=new_mean, cov=new_cov, weight=new_w), overflow


def cphd_update(state: FilterState, z, z_mask, consts, cfg: SlamConfig):
    """CPHD measurement update over all particles + birth injection for the
    next scan + cardinality convolution with the binomial birth cardinality."""
    from ..ops.gm_merge import merge_batch_dispatch
    gm = state.map_static
    K_, M_ = gm.mean.shape[-2], z.shape[0]
    D_ = gm.mean.shape[-1]

    pre = jax.vmap(
        lambda p, m, c, w: _cphd_update_single(p, m, c, w, z, z_mask,
                                               consts, cfg)
    )(state.pose, gm.mean, gm.cov, gm.weight)
    sorted_prefix = 0 < cfg.merge_candidate_cap < K_ + M_ * K_
    if pre["gather"] is not None:
        # deferred gather + packed-plane merge (see filters/phd.py),
        # with the candidate-width switch: live candidates occupy the
        # stage-2 weight-sorted prefix, so the gather + combine + merge
        # run on the [:, :cap'] slice
        from .phd import (_post_compact_batched,
                          gather_merge_width_switched)
        mg = gather_merge_width_switched(pre["gather"], D_, cfg, K_,
                                         has_birth=False,
                                         sorted_prefix=sorted_prefix)
        # batch-level post half (one payload sort + gather, as the PHD
        # path's _post_compact_batched)
        bits = dict(out_m=pre["out_m"], dlog_w=pre["dlog_w"],
                    n_compact=pre["n_compact"], s2=None)
        new_mean, new_cov, new_w, dlog_w, overflow = _post_compact_batched(
            mg, bits, gm.mean, gm.cov, gm.weight, cfg)
        log_cn = pre["log_cn"]
    else:
        mg = merge_batch_dispatch(*pre["cand"], cfg, K_,
                                  sorted_prefix=sorted_prefix)
        upd = jax.vmap(
            lambda mg_t, pre_t, m, c, w: _cphd_update_single_post(
                mg_t, pre_t, m, c, w, cfg)
        )(mg, pre, gm.mean, gm.cov, gm.weight)
        new_mean, new_cov, new_w, log_cn, dlog_w, overflow = upd

    log_w = state.log_weight + dlog_w
    log_w = log_w - logsumexp(log_w, axis=0)

    new_gm = GMState(mean=new_mean, cov=new_cov, weight=new_w)

    # births from the CURRENT measurements feed the next update — equivalent
    # to the reference's addBirths(ZPrev) at the start of the next iteration
    # (.bak:68, :794), since static features are not motion-predicted.
    # gate_births: only measurements with no compatible feature birth
    # (compatibleZ from this scan's pre-update, .bak:810-816, :750)
    allowed = (z_mask[None, :] & ~pre["compat"]
               if cfg.gate_births else None)
    new_gm, b_overflow = add_births(new_gm, state.pose, z, z_mask, cfg,
                                    allowed=allowed)

    # cardinality prediction convolution for the next step (.bak:518-612).
    # Gated: binomial n = the per-particle UNGATED count (the reference's
    # kernel uses the total measurement count even when gating,
    # .bak:782-791 n = blockDim.x — inconsistent with the births it
    # actually adds; we use the gated count, consistent with them)
    if cfg.gate_births:
        n_births = jnp.sum(allowed.astype(jnp.int32), axis=1)      # [P]
        cn_birth = jax.vmap(lambda n: binomial_birth_cardinality(
            n, cfg.birth_weight, cfg.max_cardinality, log_cn.dtype))(n_births)
        log_cn = jax.vmap(cardinality_predict)(log_cn, cn_birth)
    else:
        n_births = jnp.sum(z_mask.astype(jnp.int32))
        cn_birth = binomial_birth_cardinality(
            n_births, cfg.birth_weight, cfg.max_cardinality, log_cn.dtype)
        log_cn = cardinality_predict_batch(log_cn, cn_birth)

    state = state.replace(map_static=new_gm, log_weight=log_w,
                          cardinality=log_cn)
    return state, jnp.max(overflow) + jnp.max(b_overflow)

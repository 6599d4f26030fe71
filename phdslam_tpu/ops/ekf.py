"""Batched EKF pre-update for range-bearing measurements.

Equivalent of the reference's per-(feature x measurement) EKF
pre-update kernels: ``preUpdateSynthKernel`` 2D (phdfilter.cu:1824-1925) and 4D
(:1927-2058), and the inline ``computePreUpdate`` 2D/4D (:301-521).

Key structural property preserved from the reference: the innovation
covariance S, Kalman gain K and Joseph-form updated covariance are computed
ONCE per feature (they do not depend on the measurement); only the updated
means and the partially-updated log-weights are per-(measurement, feature)
(phdfilter.cu:1890-1894). This keeps the memory footprint at
O(K * D^2 + M * K * D) instead of O(M * K * D^2).

Everything is batched over a leading feature axis K (and vmap-ed over
particles by the caller). The measurement matrix is H = [J | 0] where J is
the 2x2 range-bearing Jacobian wrt position, so one implementation covers
both the 2D (static) and 4D (dynamic) feature models.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from ..ops.math import safe_log, wrap_angle
from ..models.measurement import (detection_probability, measurement_jacobian,
                                  predict_measurement)


class PreUpdate(NamedTuple):
    """Per-feature EKF quantities (batched over K).

    2x2 quantities are carried BOTH as component planes (``s00``..``si11``,
    elementwise [K] vectors) and as assembled arrays
    (``S``/``S_inv``, kept for oracle tests and generic consumers; XLA
    dead-code-eliminates whichever form a caller doesn't touch).
    """
    r: jnp.ndarray          # [K] predicted range
    bearing: jnp.ndarray    # [K] predicted bearing
    pd: jnp.ndarray         # [K] detection probability
    S: jnp.ndarray          # [K, 2, 2] innovation covariance
    S_inv: jnp.ndarray      # [K, 2, 2]
    det_S: jnp.ndarray      # [K]
    gain: jnp.ndarray       # [K, D, 2] Kalman gain
    cov_upd: jnp.ndarray    # [K, D, D] Joseph-form updated covariance
    si00: jnp.ndarray       # [K] S^-1 component planes
    si01: jnp.ndarray
    si11: jnp.ndarray


def ekf_preupdate(pose, mean, cov, cfg) -> PreUpdate:
    """Compute measurement-independent EKF quantities for each feature.

    Everything runs as closed-form scalar arithmetic on [K] component
    planes, mirroring the reference's Maple-generated kernels
    (phdfilter.cu:335-364): elementwise planes fuse into one pass, where
    batched tiny-matrix ``dot_general``s and minor-dim transposes of
    [K, 2, 2] tiles would not. The Joseph-form covariance is built
    from symmetric terms (P - EP - (EP)^T + E P E^T + K R K^T with
    E = gain . H), which makes it symmetric by construction — no separate
    symmetrization pass.
    """
    dtype = mean.dtype
    D = mean.shape[-1]
    r, bearing, dx, dy, r2 = predict_measurement(pose, mean)
    pd = detection_probability(r, bearing, cfg).astype(dtype)

    # Clamp the range used in the Jacobians: empty GM slots sit at the origin
    # and can coincide with the vehicle, and masked lanes must stay NaN-free.
    r_safe = jnp.maximum(r, 1e-6)
    r2_safe = jnp.maximum(r2, 1e-12)
    # Jacobian component planes (phdfilter.cu:320-325)
    j00 = dx / r_safe
    j01 = dy / r_safe
    j10 = -dy / r2_safe
    j11 = dx / r2_safe

    vr = cfg.std_range ** 2
    vb = cfg.std_bearing ** 2

    # PHt = P H^T with H = [J | 0]: PHt[:, a, i] = P[a,0] J[i,0] + P[a,1] J[i,1]
    p_a0 = cov[..., :, 0]                                   # [K, D]
    p_a1 = cov[..., :, 1]
    pht0 = p_a0 * j00[..., None] + p_a1 * j01[..., None]    # [K, D] (i = 0)
    pht1 = p_a0 * j10[..., None] + p_a1 * j11[..., None]    # [K, D] (i = 1)

    # S = H PHt + R, symmetrized (ref enforces symmetry, :341-343)
    s00 = j00 * pht0[..., 0] + j01 * pht0[..., 1] + vr
    s11 = j10 * pht1[..., 0] + j11 * pht1[..., 1] + vb
    s01 = 0.5 * ((j00 * pht1[..., 0] + j01 * pht1[..., 1])
                 + (j10 * pht0[..., 0] + j11 * pht0[..., 1]))
    det_S = s00 * s11 - s01 * s01
    si00 = s11 / det_S
    si01 = -s01 / det_S
    si11 = s00 / det_S

    # gain = PHt S^-1 : columns g0, g1 [K, D]
    g0 = pht0 * si00[..., None] + pht1 * si01[..., None]
    g1 = pht0 * si01[..., None] + pht1 * si11[..., None]

    # Joseph form (phdfilter.cu:360-364). With E = gain.H (nonzero only in
    # state columns 0..1, E[:, a, b] = kh{b}[a]):
    #   cov_upd = P - EP - (EP)^T + E P E^T + gain R gain^T
    # P is symmetric, so (EP)^T is built by swapping broadcast roles — no
    # transpose op ever materializes.
    kh0 = g0 * j00[..., None] + g1 * j10[..., None]         # [K, D] (b = 0)
    kh1 = g0 * j01[..., None] + g1 * j11[..., None]         # [K, D] (b = 1)
    p_0c = p_a0                                             # row 0 == col 0
    p_1c = p_a1
    ep = kh0[..., :, None] * p_0c[..., None, :] \
        + kh1[..., :, None] * p_1c[..., None, :]            # [K, D, D]
    ept = kh0[..., None, :] * p_0c[..., :, None] \
        + kh1[..., None, :] * p_1c[..., :, None]
    p00 = cov[..., 0, 0][..., None, None]
    p01 = cov[..., 0, 1][..., None, None]
    p11 = cov[..., 1, 1][..., None, None]
    epe = (kh0[..., :, None] * kh0[..., None, :]) * p00 \
        + (kh0[..., :, None] * kh1[..., None, :]
           + kh1[..., :, None] * kh0[..., None, :]) * p01 \
        + (kh1[..., :, None] * kh1[..., None, :]) * p11
    grg = vr * (g0[..., :, None] * g0[..., None, :]) \
        + vb * (g1[..., :, None] * g1[..., None, :])
    cov_upd = cov - ep - ept + epe + grg

    # assembled forms (DCE'd when a caller only touches the planes)
    S = jnp.stack([jnp.stack([s00, s01], axis=-1),
                   jnp.stack([s01, s11], axis=-1)], axis=-2)
    S_inv = jnp.stack([jnp.stack([si00, si01], axis=-1),
                       jnp.stack([si01, si11], axis=-1)], axis=-2)
    gain = jnp.stack([g0, g1], axis=-1)                     # [K, D, 2]

    return PreUpdate(r=r, bearing=bearing, pd=pd, S=S, S_inv=S_inv,
                     det_S=det_S, gain=gain, cov_upd=cov_upd,
                     si00=si00, si01=si01, si11=si11)


def ekf_detection_logw(pre: PreUpdate, weight, z, cfg):
    """Per-(measurement, feature) partial log-weights only (no means).

    z: [M, 2] (range, bearing) padded measurements.
    Returns (log_w_partial[M, K], log_like[M, K]).

    log_w_partial = log(pd) + log(w) - 0.5 d'S^-1 d - log(2 pi)
                    - 0.5 log det S     (phdfilter.cu:1916-1922)

    The Mahalanobis form is expanded elementwise so XLA fuses the [M, K]
    innovation grid into the likelihood without materializing an [M, K, 2]
    tensor in HBM (the updated means — the only O(M K D) output — are
    produced separately, and the fast path computes them post-compaction
    for surviving lanes only).
    """
    innov_r = z[:, None, 0] - pre.r[None, :]                      # [M, K]
    innov_b = wrap_angle(z[:, None, 1] - pre.bearing[None, :])    # [M, K]

    dist = (pre.si00[None, :] * innov_r * innov_r
            + 2.0 * pre.si01[None, :] * innov_r * innov_b
            + pre.si11[None, :] * innov_b * innov_b)
    log_like = -0.5 * dist - jnp.log(2.0 * jnp.pi) \
        - 0.5 * safe_log(pre.det_S)[None, :]
    log_w_partial = safe_log(pre.pd)[None, :] + safe_log(weight)[None, :] \
        + log_like
    return log_w_partial, log_like


def ekf_detection_linear(pre: PreUpdate, weight, z):
    """Linear-domain detection terms: pd * w * N(z; h(x), S) per lane.

    Returns [M, K]. This matches the reference's normalizer arithmetic
    exactly — ``phdUpdateKernel`` sums ``exp(w_partial)`` linearly
    (phdfilter.cu:2190-2223) — and costs ONE transcendental per lane
    (the log-domain route needs exp + the logsumexp max pass).
    Lanes that underflow f32 contribute 0, as in the reference.
    """
    innov_r = z[:, None, 0] - pre.r[None, :]                      # [M, K]
    innov_b = wrap_angle(z[:, None, 1] - pre.bearing[None, :])    # [M, K]
    dist = (pre.si00[None, :] * innov_r * innov_r
            + 2.0 * pre.si01[None, :] * innov_r * innov_b
            + pre.si11[None, :] * innov_b * innov_b)
    # per-feature prefactor: pd * w / (2 pi sqrt(det S))
    pref = pre.pd * weight / (2.0 * jnp.pi
                              * jnp.sqrt(jnp.maximum(pre.det_S, 1e-30)))
    return pref[None, :] * jnp.exp(-0.5 * dist)


def ekf_detection_means(pre: PreUpdate, mean, z):
    """Full [M, K, D] grid of EKF-updated means (preUpdateSynthKernel's
    per-(measurement, feature) mean writes, phdfilter.cu:1898-1906)."""
    innov_r = z[:, None, 0] - pre.r[None, :]                      # [M, K]
    innov_b = wrap_angle(z[:, None, 1] - pre.bearing[None, :])    # [M, K]
    innov = jnp.stack([innov_r, innov_b], axis=-1)                # [M, K, 2]
    return mean[None] + jnp.einsum("...ij,m...j->m...i",
                                   pre.gain, innov)               # [M, K, D]


def ekf_detection_means_at(pre: PreUpdate, mean, z, m_src, k_src):
    """EKF-updated means for selected (measurement, feature) lane pairs only.

    m_src/k_src: [C] integer indices. Returns [C, D]. Used by the compacted
    fast path so the O(M K D) mean grid never hits HBM.
    """
    zr = z[m_src, 0]
    zb = z[m_src, 1]
    innov = jnp.stack([zr - pre.r[k_src],
                       wrap_angle(zb - pre.bearing[k_src])], axis=-1)  # [C,2]
    return mean[k_src] + jnp.einsum("cij,cj->ci", pre.gain[k_src], innov)


def candidate_gather_indices(idx, K, M, has_birth):
    """Decompose flat candidate-lane ids into source-row indices + masks.

    Lane layout: [K persistent | M*K detections | M births (optional)].
    Elementwise on any idx shape. Returns (k_eff in [0, K), m_eff in
    [0, M), is_p, is_d) — k_eff/m_eff are the rows to fetch from the
    per-particle K-table and M-table.
    """
    is_p = idx < K
    is_d = (idx >= K) & (idx < K + M * K)
    d_idx = jnp.clip(idx - K, 0, M * K - 1)
    k_src = d_idx % K
    m_src = d_idx // K
    p_idx = jnp.clip(idx, 0, K - 1)
    k_eff = jnp.where(is_d, k_src, p_idx)
    if has_birth:
        b_idx = jnp.clip(idx - K - M * K, 0, M - 1)
        m_eff = jnp.where(is_d, m_src, b_idx)
    else:
        m_eff = m_src
    return k_eff, m_eff, is_p, is_d


def candidate_tables(mean, cov, pre: PreUpdate, z, b_mean=None, b_cov=None):
    """Build the per-particle gather source tables.

    t_k [K, D + 2*D^2 + 2*D + 2]: mean | cov | cov_upd | gain | r | bearing.
    t_m [M, 2 (+ D + D^2)]: z | birth mean | birth cov (when births are in
    the lane layout), read with ops.gather.take_rows.
    """
    K, D = mean.shape
    M = z.shape[0]
    DD, G = D * D, D * 2
    t_k = jnp.concatenate(
        [mean, cov.reshape(K, DD), pre.cov_upd.reshape(K, DD),
         pre.gain.reshape(K, G), pre.r[:, None], pre.bearing[:, None]],
        axis=1)
    if b_mean is not None:
        t_m = jnp.concatenate([z, b_mean, b_cov.reshape(M, DD)], axis=1)
    else:
        t_m = z
    return t_k, t_m


def combine_selected(r_k, r_m, is_p, is_d, sel_act, D, has_birth):
    """Assemble candidate means/covariances from gathered table rows.

    Elementwise over the lane axis; works on [cap, cols] or batched
    [P, cap, cols] rows. Returns (cand_mean [..., cap, D],
    cand_cov [..., cap, D, D]) with empty lanes sanitized to (0, I).
    """
    DD, G = D * D, D * 2
    dtype = r_k.dtype
    lead = r_k.shape[:-1]

    o = 0
    mean_k = r_k[..., o:o + D]; o += D
    cov_k = r_k[..., o:o + DD].reshape(lead + (D, D)); o += DD
    cov_upd_k = r_k[..., o:o + DD].reshape(lead + (D, D)); o += DD
    gain_k = r_k[..., o:o + G].reshape(lead + (D, 2)); o += G
    range_k = r_k[..., o]; o += 1
    bearing_k = r_k[..., o]

    z_m = r_m[..., 0:2]
    innov_r = z_m[..., 0] - range_k
    innov_b = wrap_angle(z_m[..., 1] - bearing_k)
    # detection mean = mean_k + gain . innov (unrolled tiny contraction)
    mean_d = mean_k + gain_k[..., :, 0] * innov_r[..., None] \
        + gain_k[..., :, 1] * innov_b[..., None]

    if has_birth:
        b_mean_m = r_m[..., 2:2 + D]
        b_cov_m = r_m[..., 2 + D:2 + D + DD].reshape(lead + (D, D))
        sel_mean = jnp.where(is_p[..., None], mean_k,
                             jnp.where(is_d[..., None], mean_d, b_mean_m))
        sel_cov = jnp.where(is_p[..., None, None], cov_k,
                            jnp.where(is_d[..., None, None], cov_upd_k,
                                      b_cov_m))
    else:
        sel_mean = jnp.where(is_p[..., None], mean_k, mean_d)
        sel_cov = jnp.where(is_p[..., None, None], cov_k, cov_upd_k)

    # sanitize empty lanes (padded births can be non-finite; 0 * NaN would
    # poison the merge's masked reductions)
    eye = jnp.eye(D, dtype=dtype)
    cand_mean = jnp.where(sel_act[..., None], sel_mean, 0.0)
    cand_cov = jnp.where(sel_act[..., None, None], sel_cov, eye)
    return cand_mean, cand_cov


def candidate_tables_T(mean, cov, pre: PreUpdate, z, b_mean=None,
                       b_cov=None):
    """Transposed gather tables: t_k [Ck, K], t_m [Cm, M].

    Row order matches :func:`candidate_tables`'s column order (mean | cov
    row-major | cov_upd | gain row-major | r | bearing, and z | birth mean
    | birth cov). The transposed form keeps the feature axis MINOR so the
    gathered rows (ops.gather.take_cols) come back as [C, cap] planes, the
    layout the packed merge consumes.
    """
    K, D = mean.shape
    rows_k = [mean[:, i] for i in range(D)]
    rows_k += [cov[:, a, b] for a in range(D) for b in range(D)]
    rows_k += [pre.cov_upd[:, a, b] for a in range(D) for b in range(D)]
    rows_k += [pre.gain[:, i, j] for i in range(D) for j in range(2)]
    rows_k += [pre.r, pre.bearing]
    t_k = jnp.stack(rows_k, axis=0)
    rows_m = [z[:, 0], z[:, 1]]
    if b_mean is not None:
        rows_m += [b_mean[:, i] for i in range(D)]
        rows_m += [b_cov[:, a, b] for a in range(D) for b in range(D)]
    t_m = jnp.stack(rows_m, axis=0)
    return t_k, t_m


def combine_selected_planes(r_k, r_m, is_p, is_d, sel_act, D, has_birth):
    """Plane-form candidate assembly from TRANSPOSED gathered rows.

    r_k [..., Ck, cap], r_m [..., Cm, cap] (from candidate_tables_T +
    ops.gather.take_cols); masks [..., cap]. Returns (mean_planes: D
    arrays [..., cap], cov_planes: D*(D+1)/2 arrays [..., cap] in
    row-major upper-triangle order).
    """
    o_cov = D
    o_cov_upd = D + D * D
    o_gain = D + 2 * D * D
    o_r = D + 2 * D * D + 2 * D
    o_bear = o_r + 1

    take_k = lambda c: r_k[..., c, :]
    take_m = lambda c: r_m[..., c, :]

    innov_r = take_m(0) - take_k(o_r)
    innov_b = wrap_angle(take_m(1) - take_k(o_bear))

    mean_planes = []
    for i in range(D):
        mean_k = take_k(i)
        mean_d = mean_k + take_k(o_gain + 2 * i) * innov_r \
            + take_k(o_gain + 2 * i + 1) * innov_b
        if has_birth:
            mp = jnp.where(is_p, mean_k,
                           jnp.where(is_d, mean_d, take_m(2 + i)))
        else:
            mp = jnp.where(is_p, mean_k, mean_d)
        mean_planes.append(jnp.where(sel_act, mp, 0.0))

    cov_planes = []
    for a in range(D):
        for b in range(a, D):
            ck = take_k(o_cov + a * D + b)
            cu = take_k(o_cov_upd + a * D + b)
            if has_birth:
                cb_ = take_m(2 + D + a * D + b)
                cp = jnp.where(is_p, ck, jnp.where(is_d, cu, cb_))
            else:
                cp = jnp.where(is_p, ck, cu)
            cov_planes.append(
                jnp.where(sel_act, cp, 1.0 if a == b else 0.0))
    return mean_planes, cov_planes


def select_compact_candidates(idx, sel_act, mean, cov, pre: PreUpdate, z,
                              b_mean=None, b_cov=None):
    """Gather the surviving merge-candidate lanes' means/covariances
    (single particle).

    Lane layout: [K persistent | M*K detections | M births (optional)].
    ``idx``/``sel_act`` come from a scalar weight top-k
    (ops.gm_merge.topk_compact_indices). Returns (cand_mean [cap, D],
    cand_cov [cap, D, D]) with empty lanes sanitized to (0, I).

    All sources are small per-particle tables (K persistent rows, M
    measurement rows), and detection means are computed post-selection for
    the surviving lanes only, so neither the [M, K, D] mean grid nor any
    [N, D, D] candidate covariance is materialized.
    """
    K, D = mean.shape
    M = z.shape[0]
    has_birth = b_mean is not None
    k_eff, m_eff, is_p, is_d = candidate_gather_indices(idx, K, M, has_birth)
    t_k, t_m = candidate_tables(mean, cov, pre, z, b_mean, b_cov)
    from .gather import take_rows
    r_k = take_rows(k_eff, t_k)
    r_m = take_rows(m_eff, t_m)
    return combine_selected(r_k, r_m, is_p, is_d, sel_act, D, has_birth)


def ekf_detection_terms(pre: PreUpdate, mean, weight, z, cfg):
    """Per-(measurement, feature) updated means and partial log-weights.

    z: [M, 2] (range, bearing) padded measurements.
    Returns (mean_upd[M, K, D], log_w_partial[M, K], log_like[M, K]).
    """
    log_w_partial, log_like = ekf_detection_logw(pre, weight, z, cfg)
    mean_upd = ekf_detection_means(pre, mean, z)
    return mean_upd, log_w_partial, log_like

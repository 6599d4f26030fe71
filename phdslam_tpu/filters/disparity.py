"""Monocular SC-PHD SLAM in disparity space ("disparity pipeline").

Rebuild of the reference's single-cluster PHD monocular pipeline
(/root/reference/src/phdfilter.cu:3892-5216, driver main.cpp:1324-1440).
The reference's CPU SC-PHD (scphd_cpu.cpp) is an empty stub; the behavioral
spec is ``disparityUpdate`` (SURVEY.md §3.4):

  per-pose-particle maps are per-feature PARTICLE CLOUDS of 3D world points
  (ParticleMap, slamtypes.h:368-399). Each update:

  world->disparity transform     (:3974-4006)  -> :func:`world_to_disparity`
  fitGaussiansKernel             (:4133-4248)  -> :func:`fit_gaussians`
  separateDisparityFeatures      (:4385-4479)  -> in-range mask on fitted means
  births at disparityBirth prior (:4845-4873)  -> inline in the update
  preUpdateDisparityKernel       (:4306-4373)  -> linear EKF in (u, v, d)
  shared phdUpdateKernel         (:4928-4938)  -> same masked GM-PHD update
  phdUpdateMergeKernel           (:4977-4983)  -> ops.gm_merge
  sampleGaussiansKernel          (:4250-4304)  -> jax.random Cholesky sampling
  disparity->world transform     (:5131-5151)  -> :func:`disparity_to_world`
  recombine out-of-range clouds  (:5178-5191)  -> masked write-back
  weight += ; logSumExp norm     (:5207-5215)

State layout: fixed-capacity ``cloud[P, K, N, 3]`` world points with
``feat_weight[P, K]`` (0 = empty slot) replacing the reference's ragged
per-particle vectors; everything device-resident.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..config import SlamConfig
from ..ops.gm_merge import compact_candidates, gm_merge
from ..ops.math import LOG0, logsumexp, safe_log, sym, wrap_angle
from ..ops.resample import effective_sample_ratio, systematic_ancestors
from ..pytree import pytree_dataclass


# ----------------------------------------------------------------------------
# Camera geometry (transformCameraToWorld / transformWorldToCamera,
# phdfilter.cu:3894-3957)
# ----------------------------------------------------------------------------

def camera_rotation(roll, pitch, yaw):
    """R such that world = R @ camera (+ translation)."""
    cr, sr = jnp.cos(roll), jnp.sin(roll)
    cp, sp = jnp.cos(pitch), jnp.sin(pitch)
    cy, sy = jnp.cos(yaw), jnp.sin(yaw)
    r00 = cp * cy
    r01 = cr * sy + sr * sp * cy
    r02 = sr * sy - cr * sp * cy
    r10 = -cp * sy
    r11 = cr * cy - sr * sp * sy
    r12 = sr * cy + cr * sp * sy
    r20 = sp
    r21 = -sr * cp
    r22 = cr * cp
    return jnp.stack([
        jnp.stack([r00, r01, r02], axis=-1),
        jnp.stack([r10, r11, r12], axis=-1),
        jnp.stack([r20, r21, r22], axis=-1)], axis=-2)


def world_to_disparity(points, cam_pose, cfg: SlamConfig):
    """World xyz -> (u, v, d) (world_to_disparity_transform, :3974-4006).

    points[..., 3]; cam_pose[..., >=6] = (px,py,pz,roll,pitch,yaw,...).
    Returns uvd[..., 3].
    """
    R = camera_rotation(cam_pose[..., 3], cam_pose[..., 4], cam_pose[..., 5])
    t = cam_pose[..., :3]
    pc = jnp.einsum("...ji,...j->...i", R, points - t)  # R^T (p - t)
    zc = pc[..., 2]
    zc_safe = jnp.where(jnp.abs(zc) > 1e-6, zc,
                        jnp.where(zc < 0, -1e-6, 1e-6))
    u = cfg.u0 - cfg.fx * pc[..., 0] / zc_safe
    v = cfg.v0 - cfg.fy * pc[..., 1] / zc_safe
    d = -cfg.fx / zc_safe
    return jnp.stack([u, v, d], axis=-1)


def disparity_to_world(uvd, cam_pose, cfg: SlamConfig):
    """(u, v, d) -> world xyz (disparity_to_world_transform, :4024-4047)."""
    u, v, d = uvd[..., 0], uvd[..., 1], uvd[..., 2]
    d_safe = jnp.where(jnp.abs(d) > 1e-9, d, jnp.where(d < 0, -1e-9, 1e-9))
    xc = (u - cfg.u0) / d_safe
    yc = cfg.fx / cfg.fy * (v - cfg.v0) / d_safe
    zc = -cfg.fx / d_safe
    pc = jnp.stack([xc, yc, zc], axis=-1)
    R = camera_rotation(cam_pose[..., 3], cam_pose[..., 4], cam_pose[..., 5])
    return jnp.einsum("...ij,...j->...i", R, pc) + cam_pose[..., :3]


# ----------------------------------------------------------------------------
# State
# ----------------------------------------------------------------------------

@pytree_dataclass
class DisparityState:
    """DisparitySLAM equivalent (slamtypes.h:401-423), fixed capacity.

    cam_pose:    [P, 12] (px,py,pz,roll,pitch,yaw,vx,vy,vz,vroll,vpitch,vyaw)
    log_weight:  [P]
    cloud:       [P, K, N, 3] per-feature world-point clouds
    feat_weight: [P, K] linear feature weights (0 = empty slot)
    """
    cam_pose: jax.Array
    log_weight: jax.Array
    cloud: jax.Array
    feat_weight: jax.Array
    resample_idx: jax.Array
    rng: jax.Array
    step: jax.Array


def init_disparity_state(cfg: SlamConfig, key=None) -> DisparityState:
    """Initial particles with roll/yaw jitter ~N(0, 0.03) (main.cpp:1367-1371).

    NB the reference seeds pyaw from ppitch (a quirk of :1370); we jitter yaw
    around yaw0.
    """
    P = cfg.n_particles
    K = cfg.max_features
    N = cfg.particles_per_feature
    if key is None:
        key = jax.random.PRNGKey(cfg.seed)
    k_init, k_state = jax.random.split(key)
    pose0 = jnp.array([cfg.x0, cfg.y0, cfg.z0, cfg.roll0, cfg.pitch0,
                       cfg.yaw0, cfg.vx0, cfg.vy0, cfg.vz0, cfg.vroll0,
                       cfg.vpitch0, cfg.vyaw0], jnp.float32)
    pose = jnp.broadcast_to(pose0, (P, 12)).copy()
    jitter = 0.03 * jax.random.normal(k_init, (P, 2))
    pose = pose.at[:, 3].add(jitter[:, 0])
    pose = pose.at[:, 5].add(jitter[:, 1])
    return DisparityState(
        cam_pose=pose,
        log_weight=jnp.full((P,), -jnp.log(float(P)), jnp.float32),
        cloud=jnp.zeros((P, K, N, 3), jnp.float32),
        feat_weight=jnp.zeros((P, K), jnp.float32),
        resample_idx=jnp.arange(P, dtype=jnp.int32),
        rng=k_state,
        step=jnp.zeros((), jnp.int32),
    )


# ----------------------------------------------------------------------------
# Prediction (disparityPredict, phdfilter.cu:4520-4570)
# ----------------------------------------------------------------------------

def disparity_predict(state: DisparityState, dt, cfg: SlamConfig,
                      key) -> DisparityState:
    pose = state.cam_pose
    P = pose.shape[0]
    noise = jax.random.normal(key, (P, 6), pose.dtype) * jnp.array(
        [cfg.ax, cfg.ay, cfg.az, cfg.aroll, cfg.apitch, cfg.ayaw],
        pose.dtype)
    # camera-frame translation increment, rotated into world (:4542-4551)
    d_cam = dt * pose[:, 6:9] + 0.5 * noise[:, :3] * dt ** 2
    R = camera_rotation(pose[:, 3], pose[:, 4], pose[:, 5])
    d_world = jnp.einsum("pij,pj->pi", R, d_cam)
    new_xyz = pose[:, :3] + d_world
    new_ang = wrap_angle(
        pose[:, 3:6] + dt * pose[:, 9:12] + 0.5 * noise[:, 3:] * dt ** 2)
    new_vel = pose[:, 6:9] + dt * noise[:, :3]
    new_angvel = pose[:, 9:12] + dt * noise[:, 3:]
    return state.replace(cam_pose=jnp.concatenate(
        [new_xyz, new_ang, new_vel, new_angvel], axis=-1))


# ----------------------------------------------------------------------------
# Gaussian fit / sample (fitGaussiansKernel :4133-4248,
# sampleGaussiansKernel :4250-4304)
# ----------------------------------------------------------------------------

def fit_gaussians(uvd):
    """Moment-match a Gaussian3D to each feature cloud.

    uvd[..., N, 3] -> (mean[..., 3], cov[..., 3, 3]); covariance uses the
    1/(N-1) normalization of the reference.
    """
    N = uvd.shape[-2]
    mean = jnp.mean(uvd, axis=-2)
    d = uvd - mean[..., None, :]
    cov = jnp.einsum("...ni,...nj->...ij", d, d) / (N - 1)
    return mean, cov


def chol3(A):
    """Closed-form lower Cholesky for batched 3x3 SPD (:4272-4277)."""
    a = jnp.maximum(A[..., 0, 0], 1e-20)
    l11 = jnp.sqrt(a)
    l21 = A[..., 1, 0] / l11
    l31 = A[..., 2, 0] / l11
    l22 = jnp.sqrt(jnp.maximum(A[..., 1, 1] - l21 ** 2, 1e-20))
    l32 = (A[..., 2, 1] - l31 * l21) / l22
    l33 = jnp.sqrt(jnp.maximum(A[..., 2, 2] - l31 ** 2 - l32 ** 2, 1e-20))
    z = jnp.zeros_like(l11)
    return jnp.stack([
        jnp.stack([l11, z, z], axis=-1),
        jnp.stack([l21, l22, z], axis=-1),
        jnp.stack([l31, l32, l33], axis=-1)], axis=-2)


def sample_gaussians(mean, cov, n_samples, key):
    """Draw n_samples points from each Gaussian (mean[..., 3], cov[..., 3,3])."""
    L = chol3(cov)
    eps = jax.random.normal(key, mean.shape[:-1] + (n_samples, 3),
                            mean.dtype)
    return mean[..., None, :] + jnp.einsum("...ij,...nj->...ni", L, eps)


# ----------------------------------------------------------------------------
# Per-particle SC-PHD update
# ----------------------------------------------------------------------------

def _disparity_update_pre(cam_pose, cloud, feat_w, z, z_mask,
                          cfg: SlamConfig):
    """Pre-merge half of one particle's disparity update (fit + linear EKF
    + normalizers + compacted candidate set). The merge runs between the
    halves so the batched step can hoist it out of vmap and run one
    batch-level merge."""
    K, N, _ = cloud.shape
    M = z.shape[0]
    dtype = cloud.dtype

    # world -> disparity; fit Gaussians to clouds
    uvd = world_to_disparity(cloud, cam_pose[None, None, :], cfg)
    g_mean, g_cov = fit_gaussians(uvd)                  # [K, 3], [K, 3, 3]

    live = feat_w > 0
    # in-range on the fitted mean (is_inrange, :4108-4130)
    u, v, d = g_mean[..., 0], g_mean[..., 1], g_mean[..., 2]
    in_m = live & (u > 0) & (u <= cfg.image_width) & (v >= 0) \
        & (v <= cfg.image_height) & (d >= 0)
    out_m = live & ~in_m

    # sanitize dead/out lanes for linear algebra
    eye3 = jnp.eye(3, dtype=dtype)
    g_cov = jnp.where(in_m[:, None, None], sym(g_cov), eye3)
    g_mean = jnp.where(in_m[:, None], g_mean, 0.0)

    # linear EKF pre-update in (u, v, d) (preUpdateDisparityKernel :4306-4373)
    var_u = cfg.std_u ** 2
    var_v = cfg.std_v ** 2
    S = g_cov[:, :2, :2] + jnp.array([[var_u, 0.0], [0.0, var_v]], dtype)
    det_S = S[:, 0, 0] * S[:, 1, 1] - S[:, 0, 1] * S[:, 1, 0]
    S_inv = jnp.stack(
        [jnp.stack([S[:, 1, 1], -S[:, 0, 1]], axis=-1),
         jnp.stack([-S[:, 1, 0], S[:, 0, 0]], axis=-1)],
        axis=-2) / det_S[:, None, None]
    PHt = g_cov[:, :, :2]                               # H = [I2 | 0]
    gain = jnp.einsum("kij,kjl->kil", PHt, S_inv)       # [K, 3, 2]
    I3 = jnp.eye(3, dtype=dtype)
    IKH = I3 - jnp.pad(gain, ((0, 0), (0, 0), (0, 1)))
    R2 = jnp.array([[var_u, 0.0], [0.0, var_v]], dtype)
    cov_upd = jnp.einsum("kij,kjl,kml->kim", IKH, g_cov, IKH) \
        + jnp.einsum("kij,jl,kml->kim", gain, R2, gain)

    pd = jnp.where(in_m, cfg.pd, 0.0)
    innov = z[:, None, :] - g_mean[None, :, :2]         # [M, K, 2]
    mean_det = g_mean[None] + jnp.einsum(
        "kij,mkj->mki", gain, innov)                    # [M, K, 3]
    dist = jnp.einsum("mki,kij,mkj->mk", innov, S_inv, innov)
    logw_part = safe_log(pd)[None, :] + safe_log(feat_w)[None, :] \
        - 0.5 * dist - jnp.log(2.0 * jnp.pi) - 0.5 * safe_log(det_S)[None, :]
    det_valid = z_mask[:, None] & in_m[None, :]
    logw_part = jnp.where(det_valid, logw_part, LOG0)

    # clutter density over the image (main.cpp:1341-1343)
    clutter_density = cfg.clutter_rate / (cfg.image_width * cfg.image_height)

    log_cd = jnp.full((M, 1), safe_log(clutter_density), dtype=dtype)
    log_bw = jnp.full((M, 1), safe_log(cfg.birth_weight), dtype=dtype)
    all_logw = jnp.concatenate([logw_part, log_cd, log_bw], axis=1)
    mmax = jnp.max(all_logw, axis=1, keepdims=True)
    log_norm = jnp.squeeze(mmax, 1) + jnp.log(
        jnp.sum(jnp.exp(all_logw - mmax), axis=1))      # [M]

    w_nd = jnp.where(in_m, feat_w * (1.0 - pd), 0.0)
    w_det = jnp.where(det_valid, jnp.exp(logw_part - log_norm[:, None]), 0.0)

    # births at the disparity prior (:4845-4873)
    b_mean = jnp.concatenate(
        [z, jnp.full((M, 1), cfg.disparity_birth, dtype=dtype)], axis=-1)
    b_cov = jnp.zeros((M, 3, 3), dtype=dtype)
    b_cov = b_cov.at[:, 0, 0].set(var_u)
    b_cov = b_cov.at[:, 1, 1].set(var_v)
    b_cov = b_cov.at[:, 2, 2].set(cfg.std_d_birth ** 2)
    w_birth = jnp.where(z_mask,
                        jnp.exp(safe_log(cfg.birth_weight) - log_norm), 0.0)

    n_valid_z = jnp.sum(z_mask.astype(dtype))
    if cfg.particle_weighting == 0:
        card_pred = jnp.sum(jnp.where(in_m, pd * feat_w, 0.0)) \
            + n_valid_z * cfg.birth_weight
        dlog_w = jnp.sum(jnp.where(z_mask, log_norm, 0.0)) - card_pred
    else:
        cn_predict = jnp.sum(jnp.where(in_m, feat_w, 0.0))
        cn_update = jnp.sum(w_nd) + jnp.sum(w_det) + jnp.sum(w_birth)
        dlog_w = n_valid_z * clutter_density + cn_update - cn_predict \
            - cfg.clutter_rate

    # merge in disparity space
    min_fw = cfg.min_feature_weight
    act_a = in_m & (w_nd >= min_fw)
    act_b = det_valid & (w_det >= min_fw)
    act_c = z_mask & (w_birth >= min_fw)

    cand_mean = jnp.concatenate(
        [g_mean, mean_det.reshape(M * K, 3), b_mean], axis=0)
    cand_cov = jnp.concatenate(
        [g_cov, jnp.broadcast_to(cov_upd[None], (M, K, 3, 3)).reshape(
            M * K, 3, 3), b_cov], axis=0)
    cand_w = jnp.concatenate([w_nd, w_det.reshape(M * K), w_birth], axis=0)
    cand_act = jnp.concatenate([act_a, act_b.reshape(M * K), act_c], axis=0)

    cand_mean = jnp.where(cand_act[:, None], cand_mean, 0.0)
    cand_cov = jnp.where(cand_act[:, None, None], cand_cov, eye3)
    cand_w = jnp.where(cand_act, cand_w, 0.0)

    cand_mean, cand_cov, cand_w, cand_act, n_compact = compact_candidates(
        cand_mean, cand_cov, cand_w, cand_act, cfg.merge_candidate_cap)
    return dict(cand=(cand_mean, cand_cov, cand_w, cand_act),
                dlog_w=dlog_w, out_m=out_m, n_compact=n_compact)


def _disparity_update_post(mg, pre_out, cam_pose, cloud, feat_w, key,
                           cfg: SlamConfig):
    """Post-merge half: re-sample particle clouds from the merged GM,
    transform back to world space and recombine with out-of-range clouds."""
    K, N, _ = cloud.shape
    mg_mean, mg_cov, mg_w, _, n_dropped = mg
    n_dropped = n_dropped + pre_out["n_compact"]
    out_m = pre_out["out_m"]
    dlog_w = pre_out["dlog_w"]

    # re-particle-ize merged Gaussians (sampleGaussiansKernel :4250-4304)
    # then transform back to world space. Samples are REFLECTED off the
    # d = cfg.min_disparity floor: the unguarded reference maps d <= 0
    # samples through the 1/d singularity to points BEHIND the camera, and
    # the poisoned cloud's next moment fit becomes a persistent ghost
    # feature (see SlamConfig.min_disparity).
    new_uvd = sample_gaussians(mg_mean, mg_cov, N, key)  # [K, N, 3]
    # reflect (not clamp) below-floor samples: clamping piles mass exactly
    # at the floor, whose 1/d world-space leverage (depth fx/min_disparity)
    # dominates the next moment fit just as badly as the behind-camera points
    new_uvd = new_uvd.at[..., 2].set(
        cfg.min_disparity + jnp.abs(new_uvd[..., 2] - cfg.min_disparity))
    new_cloud_in = disparity_to_world(new_uvd, cam_pose[None, None, :], cfg)

    # recombine: merged (in-range) features + untouched out-of-range clouds
    all_cloud = jnp.concatenate([new_cloud_in, cloud], axis=0)   # [2K, N, 3]
    all_w = jnp.concatenate([mg_w, jnp.where(out_m, feat_w, 0.0)], axis=0)
    _, order = jax.lax.top_k(all_w, K)
    new_cloud = all_cloud[order]
    new_w = all_w[order]
    new_w = jnp.where(new_w > 0, new_w, 0.0)
    new_cloud = jnp.where((new_w > 0)[:, None, None], new_cloud, 0.0)

    overflow = jnp.maximum(
        jnp.sum((all_w > 0).astype(jnp.int32)) - K, 0) + n_dropped
    return new_cloud, new_w, dlog_w, overflow


def _disparity_update_single(cam_pose, cloud, feat_w, z, z_mask, key,
                             cfg: SlamConfig):
    """One particle's disparity update (pre -> merge -> post).
    Returns (new_cloud, new_feat_w, dlog_w, overflow)."""
    K = cloud.shape[0]
    pre_out = _disparity_update_pre(cam_pose, cloud, feat_w, z, z_mask, cfg)
    mg = gm_merge(*pre_out["cand"], cfg.min_separation, K,
                  cfg.distance_metric)
    return _disparity_update_post(mg, pre_out, cam_pose, cloud, feat_w,
                                  key, cfg)


class DisparityOutputs(NamedTuple):
    expected_pose: jax.Array     # [12]
    map_cloud: jax.Array         # [K, N, 3] MAP particle's clouds
    map_weight: jax.Array        # [K]
    n_eff: jax.Array
    resampled: jax.Array
    overflow: jax.Array


def disparity_step(state: DisparityState, z, z_mask, dt, do_predict,
                   cfg: SlamConfig, mesh=None):
    """Full SC-PHD step: predict -> update -> extract -> resample
    (run_disparity loop, main.cpp:1373-1439).

    ``mesh``: the particle mesh when running sharded (SURVEY.md §2.4-P1 —
    the per-particle cloud state [P, K, N, 3] shards on the particle axis
    like every other variant); routes the resampling migration through the
    neighbor exchange (parallel/migrate.py)."""
    key = jax.random.fold_in(state.rng, state.step)
    k_pred, k_upd, k_res = jax.random.split(key, 3)

    predicted = disparity_predict(state, dt, cfg, k_pred)
    state = jax.tree.map(
        lambda a, b: jnp.where(do_predict, a, b), predicted, state)

    P = state.cam_pose.shape[0]
    keys = jax.random.split(k_upd, P)
    # merge hoisted out of the vmap: one batch-level merge (the kernel
    # runs one program per particle over the whole batch)
    from ..ops.gm_merge import merge_batch_dispatch
    pre = jax.vmap(lambda cp, cl, fw: _disparity_update_pre(
        cp, cl, fw, z, z_mask, cfg))(state.cam_pose, state.cloud,
                                     state.feat_weight)
    K_feat = state.cloud.shape[1]
    M_ = z.shape[0]
    n_full = K_feat + M_ * K_feat + M_
    mg = merge_batch_dispatch(
        *pre["cand"], cfg, K_feat,
        sorted_prefix=0 < cfg.merge_candidate_cap < n_full)
    new_cloud, new_w, dlog_w, overflow = jax.vmap(
        lambda mg_t, pre_t, cp, cl, fw, k: _disparity_update_post(
            mg_t, pre_t, cp, cl, fw, k, cfg)
    )(mg, pre, state.cam_pose, state.cloud, state.feat_weight, keys)

    has_z = jnp.any(z_mask)
    log_w = state.log_weight + jnp.where(has_z, dlog_w, 0.0)
    log_w = log_w - logsumexp(log_w, axis=0)
    state = state.replace(
        cloud=jnp.where(has_z, new_cloud, state.cloud),
        feat_weight=jnp.where(has_z, new_w, state.feat_weight),
        log_weight=log_w)
    overflow = jnp.where(has_z, jnp.max(overflow), 0)

    # resampling happens BEFORE extraction in this pipeline
    # (main.cpp:1403-1434, unlike the synth driver). The cross-particle
    # gather only executes on resample steps (lax.cond): under
    # jit+NamedSharding an unconditional take would all-gather the ENTIRE
    # [P, K, N, 3] cloud state every step; on a particle mesh the gather
    # routes through the neighbor migration (parallel/migrate.py) exactly
    # like the synth variants.
    n_eff = effective_sample_ratio(state.log_weight)
    do_resample = n_eff <= cfg.resample_threshold
    ancestors = systematic_ancestors(state.log_weight, k_res, P)
    identity = jnp.arange(P, dtype=jnp.int32)

    def _do(st):
        if mesh is not None and getattr(cfg, "neighbor_migration", 1):
            st = _gather_disparity_sharded(st, ancestors, mesh, cfg)
        else:
            take = lambda x: jnp.take(x, ancestors, axis=0)
            st = st.replace(cam_pose=take(st.cam_pose),
                            cloud=take(st.cloud),
                            feat_weight=take(st.feat_weight))
        return st.replace(
            log_weight=jnp.full((P,), -jnp.log(float(P)),
                                st.log_weight.dtype),
            resample_idx=ancestors)

    def _skip(st):
        return st.replace(resample_idx=identity)

    state = jax.lax.cond(do_resample, _do, _skip, state)
    state = state.replace(step=state.step + 1)

    # extraction (recoverSlamState(DisparitySLAM), main.cpp:391-451).
    # One-hot contraction over the particle axis instead of a dynamic-index
    # gather: under SPMD a gather all-gathers the full sharded cloud state
    # (see filters.phd.extract for the same pattern).
    w = jnp.exp(state.log_weight)
    expected_pose = jnp.einsum("p,pd->d", w, state.cam_pose)
    oh = (jnp.arange(P) == jnp.argmax(state.log_weight)).astype(
        state.cloud.dtype)
    out = DisparityOutputs(
        expected_pose=expected_pose,
        map_cloud=jnp.einsum("p,pknd->knd", oh, state.cloud),
        map_weight=jnp.einsum("p,pk->k", oh, state.feat_weight),
        n_eff=n_eff, resampled=do_resample, overflow=overflow)
    return state, out


def _gather_disparity_sharded(state: DisparityState, ancestors, mesh, cfg):
    """Resample-step particle migration for the disparity state on a
    particle mesh: neighbor ppermute exchange when feasible, exact full
    gather otherwise (parallel/migrate.py — the same mechanism the synth
    variants use; the cloud leaf [P, K, N, 3] rides it unchanged)."""
    import jax as _jax

    from ..parallel.migrate import (default_row_budget, gather_rows_neighbor,
                                    neighbor_feasible)
    from ..parallel.sharding import PARTICLE_AXIS
    from jax.sharding import NamedSharding, PartitionSpec as _P

    n_dev = mesh.shape[PARTICLE_AXIS]
    P_ = state.cam_pose.shape[0]

    def full(st):
        take = lambda x: jnp.take(x, ancestors, axis=0)
        return st.replace(cam_pose=take(st.cam_pose), cloud=take(st.cloud),
                          feat_weight=take(st.feat_weight))

    if n_dev <= 2 or P_ % n_dev:
        return full(state)
    block = P_ // n_dev
    budget = getattr(cfg, "migration_row_budget", 0) or \
        default_row_budget(block)
    budget = min(budget, block)
    anc = _jax.lax.with_sharding_constraint(
        ancestors, NamedSharding(mesh, _P()))
    ok = neighbor_feasible(anc, n_dev, block, budget)

    def fast(st):
        cp, cl, fw = gather_rows_neighbor(
            mesh, anc, [st.cam_pose, st.cloud, st.feat_weight], budget)
        return st.replace(cam_pose=cp, cloud=cl, feat_weight=fw)

    return _jax.lax.cond(ok, fast, full, state)


def make_disparity_step_fn(cfg: SlamConfig, donate: bool = True):
    fn = functools.partial(disparity_step, cfg=cfg)
    if donate:
        return jax.jit(fn, donate_argnums=(0,))
    return jax.jit(fn)

"""Feature (landmark/target) motion models.

Equivalents of the GM feature motion models in
/root/reference/src/device_math.cuh:608-683 and the map-prediction kernels in
/root/reference/src/phdfilter.cu:891-963 (static, dynamic and jump-Markov
mixed prediction).

All functions operate on batched ``mean[..., D]`` / ``cov[..., D, D]`` /
``weight[...]`` arrays.
"""

from __future__ import annotations

import jax.numpy as jnp

from ..ops.math import logistic


def constant_position_predict(mean, cov, std_vx, std_vy, dt):
    """Random-walk (constant position) 2D model (device_math.cuh:662-683).

    Mean unchanged; cov diagonal += (std*dt)^2.
    """
    q = jnp.zeros_like(cov)
    q = q.at[..., 0, 0].set((std_vx * dt) ** 2)
    q = q.at[..., 1, 1].set((std_vy * dt) ** 2)
    return mean, cov + q


def constant_velocity_predict(mean, cov, std_ax, std_ay, dt,
                              scale_x=1.0, scale_y=1.0):
    """4D constant-velocity model with white-accel noise (device_math.cuh:608-657).

    State (x, y, vx, vy); F = [[I, dt*I], [0, I]];
    Q = [[dt^4/4 q, dt^3/2 q], [dt^3/2 q, dt^2 q]] with
    q = diag(std_ax^2 * scale_x, std_ay^2 * scale_y).
    """
    dtype = mean.dtype
    F = jnp.array(
        [[1, 0, dt, 0],
         [0, 1, 0, dt],
         [0, 0, 1, 0],
         [0, 0, 0, 1]], dtype=dtype)
    var_x = (std_ax ** 2) * scale_x
    var_y = (std_ay ** 2) * scale_y
    if jnp.ndim(var_x) > 0:
        # per-feature scaling (dynamic model survival scaling)
        zeros = jnp.zeros_like(var_x)
        qdiag = jnp.stack([var_x, var_y], axis=-1)
        d4 = (dt ** 4) / 4.0
        d3 = (dt ** 3) / 2.0
        d2 = dt ** 2
        Q = jnp.zeros(var_x.shape + (4, 4), dtype=dtype)
        Q = Q.at[..., 0, 0].set(d4 * var_x)
        Q = Q.at[..., 1, 1].set(d4 * var_y)
        Q = Q.at[..., 0, 2].set(d3 * var_x)
        Q = Q.at[..., 2, 0].set(d3 * var_x)
        Q = Q.at[..., 1, 3].set(d3 * var_y)
        Q = Q.at[..., 3, 1].set(d3 * var_y)
        Q = Q.at[..., 2, 2].set(d2 * var_x)
        Q = Q.at[..., 3, 3].set(d2 * var_y)
        del zeros, qdiag
    else:
        q = jnp.array([var_x, var_y], dtype=dtype)
        d4 = (dt ** 4) / 4.0
        d3 = (dt ** 3) / 2.0
        d2 = dt ** 2
        Q = jnp.zeros((4, 4), dtype=dtype)
        Q = Q.at[0, 0].set(d4 * q[0])
        Q = Q.at[1, 1].set(d4 * q[1])
        Q = Q.at[0, 2].set(d3 * q[0])
        Q = Q.at[2, 0].set(d3 * q[0])
        Q = Q.at[1, 3].set(d3 * q[1])
        Q = Q.at[3, 1].set(d3 * q[1])
        Q = Q.at[2, 2].set(d2 * q[0])
        Q = Q.at[3, 3].set(d2 * q[1])

    mean_new = jnp.einsum("ij,...j->...i", F, mean)
    cov_new = jnp.einsum("ij,...jk,lk->...il", F, cov, F) + Q
    return mean_new, cov_new


def mixed_model_predict(mean, cov, weight, cfg, dt):
    """Jump-Markov mixed static/dynamic map prediction
    (predictMapKernelMixed, phdfilter.cu:910-963).

    Input: 4D dynamic features. Returns predicted dynamic features (weights
    scaled by p_jmm * ps) plus 2D "jump" copies (weight (1 - p_jmm) * w) that
    may be injected into the static map.
    """
    vx = mean[..., 2]
    vy = mean[..., 3]
    v_mag = jnp.sqrt(vx * vx + vy * vy)
    sigmoid_v = 1.0 / (1.0 + jnp.exp(cfg.beta * (cfg.tau - v_mag)))

    if cfg.feature_model == 1:  # DYNAMIC_MODEL (phdfilter.cu:929-947)
        p_jmm = jnp.ones_like(v_mag)
        ps = 1.0 - logistic(v_mag, 0.0, 1.0 - cfg.ps, cfg.beta, cfg.tau)
        scale_x = logistic(vx, 0.0, 1.0, cfg.beta, cfg.tau)
        scale_y = logistic(vy, 0.0, 1.0, cfg.beta, cfg.tau)
    else:  # MIXED_MODEL (phdfilter.cu:949-953)
        p_jmm = sigmoid_v
        ps = jnp.full_like(v_mag, cfg.ps)
        scale_x = jnp.ones_like(v_mag)
        scale_y = jnp.ones_like(v_mag)

    mean_new, cov_new = constant_velocity_predict(
        mean, cov, cfg.std_ax_map, cfg.std_ay_map, dt, scale_x, scale_y)
    weight_new = p_jmm * ps * weight

    jump_weight = (1.0 - p_jmm) * weight
    jump_mean = mean[..., :2]
    jump_cov = cov[..., :2, :2]
    return (mean_new, cov_new, weight_new), (jump_mean, jump_cov, jump_weight)

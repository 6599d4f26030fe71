"""Range-bearing measurement model.

Equivalent of the measurement-side device code in
/root/reference/src/phdfilter.cu: predicted measurements + Jacobians
(:301-341), FOV probability of detection (:315-317), in-range classification
(computeInRangeKernel :1279-1358) and the inverse (birth) model (:205-242).

All functions are batched: ``pose[..., 6]``, feature ``mean[..., D]``.
"""

from __future__ import annotations

import jax.numpy as jnp

from ..ops.math import wrap_angle

# in-range classes (phdfilter.cu:1324-1346)
OUT_OF_RANGE = 0      # bypasses update AND merge
IN_RANGE = 1          # full update
NEARLY_IN_RANGE = 2   # bypasses update, participates in merge


def predict_measurement(pose, mean):
    """h(x): predicted (range, bearing) of feature ``mean[..., >=2]`` from pose.

    Returns (r, bearing, dx, dy, r2).
    """
    dx = mean[..., 0] - pose[..., 0]
    dy = mean[..., 1] - pose[..., 1]
    r2 = dx * dx + dy * dy
    r = jnp.sqrt(r2)
    bearing = wrap_angle(jnp.arctan2(dy, dx) - pose[..., 2])
    return r, bearing, dx, dy, r2


def detection_probability(r, bearing, cfg):
    """Pd = pd * 1{r <= maxRange, |bearing| <= maxBearing} (phdfilter.cu:315-317).

    Note the reference does NOT apply min_range here (only the in-range
    classifier does).
    """
    in_fov = (r <= cfg.max_range) & (jnp.abs(bearing) <= cfg.max_bearing)
    return jnp.where(in_fov, cfg.pd, 0.0)


def classify_in_range(pose, mean, weight, cfg):
    """Per-feature in-range class (computeInRangeKernel, phdfilter.cu:1324-1346).

    class 1: min_range <= r <= max_range and |b| <= max_bearing
    class 2: 0.8*min_range <= r <= 1.2*max_range and |b| <= 1.2*max_bearing
    class 0: otherwise.
    Dead slots (weight == 0) are classed 0 so they stay inert.
    """
    r, bearing, _, _, _ = predict_measurement(pose, mean)
    ab = jnp.abs(bearing)
    cls1 = (r >= cfg.min_range) & (r <= cfg.max_range) & (ab <= cfg.max_bearing)
    cls2 = (~cls1) & (r >= 0.8 * cfg.min_range) & (r <= 1.2 * cfg.max_range) \
        & (ab <= 1.2 * cfg.max_bearing)
    cls = jnp.where(cls1, IN_RANGE, jnp.where(cls2, NEARLY_IN_RANGE, OUT_OF_RANGE))
    return jnp.where(weight > 0, cls, OUT_OF_RANGE)


def measurement_jacobian(dx, dy, r, r2):
    """Jacobian of (r, bearing) wrt feature (x, y) — phdfilter.cu:320-325.

    Returns J[..., 2, 2] with rows (dr/dx, dr/dy), (db/dx, db/dy).
    """
    row_r = jnp.stack([dx / r, dy / r], axis=-1)
    row_b = jnp.stack([-dy / r2, dx / r2], axis=-1)
    return jnp.stack([row_r, row_b], axis=-2)


def birth_mean_cov(pose, z, cfg):
    """Inverse measurement -> birth Gaussian, 2D (phdfilter.cu:205-242).

    z[..., 2] = (range, bearing). Returns (mean[..., 2], cov[..., 2, 2]).
    cov = J (R * birth_noise_factor^2) J' with
    J = [[dx/r, -dy], [dy/r, dx]] (the inverse-model Jacobian wrt (r, b)).
    """
    rng = z[..., 0]
    theta = pose[..., 2] + z[..., 1]
    dx = rng * jnp.cos(theta)
    dy = rng * jnp.sin(theta)
    mean = jnp.stack([pose[..., 0] + dx, pose[..., 1] + dy], axis=-1)

    # clamp |range| so padded (zero) measurement slots stay NaN-free under
    # masking; preserve sign — the shipped datasets contain negative-range
    # clutter (unclamped Gaussian noise) and dx/r must stay = cos(theta)
    rng_safe = jnp.where(jnp.abs(rng) > 1e-6, rng,
                         jnp.where(rng < 0, -1e-6, 1e-6))
    j0 = dx / rng_safe
    j1 = dy / rng_safe
    j2 = -dy
    j3 = dx
    var_r = (cfg.std_range * cfg.birth_noise_factor) ** 2
    var_b = (cfg.std_bearing * cfg.birth_noise_factor) ** 2
    c00 = j0 * j0 * var_r + j2 * j2 * var_b
    c01 = j0 * j1 * var_r + j2 * j3 * var_b
    c11 = j1 * j1 * var_r + j3 * j3 * var_b
    cov = jnp.stack(
        [jnp.stack([c00, c01], axis=-1), jnp.stack([c01, c11], axis=-1)],
        axis=-2,
    )
    return mean, cov


def birth_mean_cov_4d(pose, z, cfg):
    """Inverse measurement -> 4D (position+velocity) birth (phdfilter.cu:244-299).

    Velocity means are zero; velocity variances come from cov_v{x,y}_birth.
    """
    mean2, cov2 = birth_mean_cov(pose, z, cfg)
    zeros = jnp.zeros_like(mean2[..., :1])
    mean = jnp.concatenate([mean2, zeros, zeros], axis=-1)
    batch = mean2.shape[:-1]
    cov = jnp.zeros(batch + (4, 4), dtype=mean2.dtype)
    cov = cov.at[..., :2, :2].set(cov2)
    cov = cov.at[..., 2, 2].set(cfg.cov_vx_birth)
    cov = cov.at[..., 3, 3].set(cfg.cov_vy_birth)
    return mean, cov


def seed_birth_velocity(b_mean_d, prev_z, z_mask, cfg):
    """Two-scan velocity initialization for 4D dynamic births
    (cfg.birth_velocity_init; extends the reference's zero-velocity birth,
    phdfilter.cu:267-281, whose movers must re-acquire velocity through
    the jump-Markov recursion).

    ``b_mean_d`` [M, 4] (world x, y, 0, 0), ``prev_z`` [Mp, 3] = previous
    scan's measurement positions in world coordinates (x, y, valid) for
    THIS particle. The velocity mean becomes (p - q) / dt for the nearest
    valid previous point q within ``birth_velocity_max * dt`` meters
    (else stays zero — clutter or a newly-visible object). dt is the
    nominal scan interval ``cfg.dt`` (measurement-less steps in between
    leave prev_z stale; the mixed MC protocol is all-measurement steps).
    """
    dt = max(float(cfg.dt), 1e-6)
    p = b_mean_d[:, :2]                                  # [M, 2]
    q = prev_z[:, :2]                                    # [Mp, 2]
    valid = prev_z[:, 2] > 0.5
    d2 = jnp.sum((p[:, None, :] - q[None, :, :]) ** 2, axis=-1)
    d2 = jnp.where(valid[None, :], d2, jnp.inf)
    j = jnp.argmin(d2, axis=1)                           # [M]
    dmin2 = jnp.min(d2, axis=1)
    gate = cfg.birth_velocity_max * dt
    ok = z_mask & (dmin2 <= gate * gate)
    v = (p - q[j]) / dt
    v = jnp.where(ok[:, None], v, 0.0)
    return b_mean_d.at[:, 2:].set(v)

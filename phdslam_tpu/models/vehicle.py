"""Vehicle motion models.

Equivalents of the reference prediction kernels
(/root/reference/src/phdfilter.cu:785-859): constant-velocity planar motion and
the Ackerman-steering bicycle model with encoder/steering noise and sensor
offset. Batched over the particle axis; noise drawn from ``jax.random``
(replacing the reference's host boost::mt19937 + per-thread noise arrays).

Pose layout: ``pose[..., 6] = (px, py, ptheta, vx, vy, vtheta)``
(slamtypes.h:44-51).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..ops.math import wrap_angle


def cv_predict(pose, noise_std, dt, key):
    """Constant-velocity vehicle prediction (phdfilter.cu:827-859).

    noise_std = (std_ax, std_ay, std_atheta). The reference host code scales
    the configured accelerations by 3 when generating noise
    (phdfilter.cu:1113-1117: ``3*config.ax*randn()``); that scaling is applied
    by the caller so this function stays a pure motion model.
    """
    n = pose.shape[0]
    eps = jax.random.normal(key, (n, 3), dtype=pose.dtype)
    ax = eps[:, 0] * noise_std[0]
    ay = eps[:, 1] * noise_std[1]
    ath = eps[:, 2] * noise_std[2]

    px, py, th = pose[:, 0], pose[:, 1], pose[:, 2]
    vx, vy, vth = pose[:, 3], pose[:, 4], pose[:, 5]
    c, s = jnp.cos(th), jnp.sin(th)

    px_new = px + dt * (vx * c - vy * s) + 0.5 * dt * dt * (ax * c - ay * s)
    py_new = py + dt * (vx * s + vy * c) + 0.5 * dt * dt * (ax * s + ay * c)
    th_new = wrap_angle(th + dt * vth + 0.5 * dt * dt * ath)
    vx_new = vx + dt * ax
    vy_new = vy + dt * ay
    vth_new = vth + dt * ath
    return jnp.stack([px_new, py_new, th_new, vx_new, vy_new, vth_new], axis=-1)


def ackerman_predict(pose, control, geom, noise_std, dt, key):
    """Ackerman-steering prediction (phdfilter.cu:785-825).

    control = (v_encoder, alpha); geom = (l, h, a, b);
    noise_std = (std_encoder, std_alpha).

    The velocity state components are zeroed, exactly as the reference kernel
    does (phdfilter.cu:818-820).
    """
    n = pose.shape[0]
    eps = jax.random.normal(key, (n, 2), dtype=pose.dtype)
    ve = control[0] + eps[:, 0] * noise_std[0]
    alpha = control[1] + eps[:, 1] * noise_std[1]

    l, h, a, b = geom
    px, py, th = pose[:, 0], pose[:, 1], pose[:, 2]

    tan_a = jnp.tan(alpha)
    vc = ve / (1.0 - tan_a * h / l)
    xc_dot = vc * jnp.cos(th)
    yc_dot = vc * jnp.sin(th)
    thc_dot = vc * tan_a / l

    s, c = jnp.sin(th), jnp.cos(th)
    px_new = px + dt * (xc_dot - thc_dot * (a * s + b * c))
    py_new = py + dt * (yc_dot + thc_dot * (a * c - b * s))
    th_new = wrap_angle(th + dt * thc_dot)
    zeros = jnp.zeros_like(px)
    return jnp.stack([px_new, py_new, th_new, zeros, zeros, zeros], axis=-1)

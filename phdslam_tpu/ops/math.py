"""Core math library (pure jnp, no sharding).

Re-design of the reference device math library
(/root/reference/src/device_math.cuh). Everything here is batched / vmap-able
over arbitrary leading axes and works on ``mean[..., D]`` / ``cov[..., D, D]``
layouts instead of the reference's flat per-Gaussian structs.

Reference quirks deliberately NOT replicated (SURVEY.md §7.3):
* ``evalGaussian`` (device_math.cuh:108-131) exponentiates ``+0.5 d'S⁻¹d``
  (sign bug); we use the correct ``-0.5``.
* ``computeMahalDist(Gaussian3D)`` has an ``innov[2]`` typo
  (device_math.cuh:339); we compute the true innovation.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

# The reference uses -FLT_MAX (slamtypes.h:26). We use a finite stand-in that
# still satisfies exp(LOG0) == 0 in f32 but cannot overflow to -inf when two
# log-domain quantities are added.
LOG0 = -1.0e30


def safe_log(x):
    """NaN-safe log: log(x) for x > 0, LOG0 otherwise (device_math.cuh:9-16)."""
    x = jnp.asarray(x)
    return jnp.where(x > 0, jnp.log(jnp.where(x > 0, x, 1.0)), LOG0)


def wrap_angle(a):
    """Wrap angle(s) to [-pi, pi] (device_math.cuh:241-250)."""
    a = jnp.asarray(a)
    two_pi = 2.0 * jnp.pi
    r = jnp.mod(a, two_pi)  # jnp.mod result has the sign of the divisor
    # match C fmod semantics (sign of dividend) so the boundary behavior
    # tracks the reference: fmod then shift into [-pi, pi]
    r = jnp.where((a < 0) & (r > 0), r - two_pi, r)
    r = jnp.where(r > jnp.pi, r - two_pi, r)
    r = jnp.where(r < -jnp.pi, r + two_pi, r)
    return r


def logistic(x, lower, upper, beta, tau):
    """Generalized logistic function (device_math.cuh:19-24)."""
    return (upper - lower) / (1.0 + jnp.exp(-beta * (x - tau)))


# ----------------------------------------------------------------------------
# Small fixed-size linear algebra, batched over leading axes.
# ----------------------------------------------------------------------------

def det2(A):
    """Determinant of batched 2x2 matrices ``A[..., 2, 2]``."""
    return A[..., 0, 0] * A[..., 1, 1] - A[..., 0, 1] * A[..., 1, 0]


def inv2(A):
    """Inverse of batched 2x2 matrices (device_math.cuh:61-69)."""
    d = det2(A)
    inv = jnp.stack(
        [
            jnp.stack([A[..., 1, 1], -A[..., 0, 1]], axis=-1),
            jnp.stack([-A[..., 1, 0], A[..., 0, 0]], axis=-1),
        ],
        axis=-2,
    )
    return inv / d[..., None, None]


def det_nd(A):
    """Determinant of batched DxD matrices; closed form for D==2."""
    if A.shape[-1] == 2:
        return det2(A)
    return jnp.linalg.det(A)


def inv_nd(A):
    """Inverse of batched DxD matrices; closed form for D==2."""
    if A.shape[-1] == 2:
        return inv2(A)
    return jnp.linalg.inv(A)


def sym(A):
    """Force symmetry: (A + A^T)/2 (device_math.cuh ``force_symmetric_covariance`` :710-725)."""
    return 0.5 * (A + jnp.swapaxes(A, -1, -2))


def chol2(A):
    """Cholesky factor of batched 2x2 SPD matrices (lower-triangular)."""
    l11 = jnp.sqrt(jnp.maximum(A[..., 0, 0], 1e-30))
    l21 = A[..., 1, 0] / l11
    l22 = jnp.sqrt(jnp.maximum(A[..., 1, 1] - l21 * l21, 1e-30))
    zeros = jnp.zeros_like(l11)
    return jnp.stack(
        [
            jnp.stack([l11, zeros], axis=-1),
            jnp.stack([l21, l22], axis=-1),
        ],
        axis=-2,
    )


# ----------------------------------------------------------------------------
# Gaussian evaluation / distances.
# ----------------------------------------------------------------------------

def gaussian_logpdf(x, mean, cov):
    """Log N(x; mean, cov) for batched inputs; x[..., D]."""
    d = x - mean
    dim = x.shape[-1]
    S_inv = inv_nd(cov)
    maha = jnp.einsum("...i,...ij,...j->...", d, S_inv, d)
    logdet = safe_log(det_nd(cov))
    return -0.5 * maha - 0.5 * logdet - 0.5 * dim * jnp.log(2.0 * jnp.pi)


def mahalanobis2(mean_a, cov_a, mean_b, cov_b):
    """Squared Mahalanobis distance with averaged covariance.

    Matches ``computeMahalDist`` (device_math.cuh:308-363): the metric uses
    Sigma = (cov_a + cov_b)/2 and returns d' Sigma^-1 d (no sqrt).
    """
    sigma = 0.5 * (cov_a + cov_b)
    d = mean_a - mean_b
    S_inv = inv_nd(sigma)
    return jnp.einsum("...i,...ij,...j->...", d, S_inv, d)


def hellinger2(mean_a, cov_a, mean_b, cov_b):
    """Hellinger-style distance (device_math.cuh:372-413, 2D specialization).

    Follows the reference formula exactly:
      eps   = -1/4 d' (A+B)^-1 d
      dist  = 1 - sqrt( sqrt(det(AB)) / det((A+B)/2) ) * exp(eps)
    """
    d = mean_a - mean_b
    sigma = cov_a + cov_b
    det_sigma = det_nd(sigma)
    S_inv = jnp.where(
        (det_sigma > 1.1754944e-38)[..., None, None],
        inv_nd(jnp.where((det_sigma > 1.1754944e-38)[..., None, None], sigma,
                         jnp.eye(sigma.shape[-1], dtype=sigma.dtype))),
        jnp.eye(sigma.shape[-1], dtype=sigma.dtype),
    )
    eps = -0.25 * jnp.einsum("...i,...ij,...j->...", d, S_inv, d)
    det_half = det_sigma / (2.0 ** sigma.shape[-1])
    det_prod = det_nd(jnp.einsum("...ij,...jk->...ik", cov_a, cov_b))
    ratio = jnp.sqrt(jnp.maximum(det_prod, 0.0)) / jnp.maximum(det_half, 1e-30)
    return 1.0 - jnp.sqrt(jnp.maximum(ratio, 0.0)) * jnp.exp(eps)


# ----------------------------------------------------------------------------
# Masked reductions (replace block-wide shared-memory reductions,
# device_math.cuh:452-547).
# ----------------------------------------------------------------------------

def masked_logsumexp(logw, mask, axis=-1):
    """Log-sum-exp over ``axis`` counting only entries where ``mask``.

    Returns LOG0 when nothing is selected.
    """
    logw = jnp.where(mask, logw, LOG0)
    m = jnp.max(logw, axis=axis, keepdims=True)
    m_safe = jnp.maximum(m, LOG0 * 0.5)  # avoid (-big) - (-big) producing junk
    s = jnp.sum(jnp.where(mask, jnp.exp(logw - m_safe), 0.0), axis=axis)
    out = jnp.squeeze(m_safe, axis) + jnp.log(jnp.maximum(s, 1e-38))
    any_sel = jnp.any(mask, axis=axis)
    return jnp.where(any_sel, out, LOG0)


def logsumexp(logw, axis=-1):
    m = jnp.max(logw, axis=axis, keepdims=True)
    return jnp.squeeze(m, axis) + jnp.log(
        jnp.sum(jnp.exp(logw - m), axis=axis))


def masked_sum(x, mask, axis=-1):
    return jnp.sum(jnp.where(mask, x, 0.0), axis=axis)

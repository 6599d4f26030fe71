"""Systematic (low-variance) particle resampling under jit.

Equivalent of ``resampleParticles`` (main.cpp:453-501): per-stratum
jittered systematic resampling — stratum j draws ``r_j = (j + u_j)/N`` with
``u_j ~ U(0, 1)`` (main.cpp:468), ancestor = first index whose cumulative
weight exceeds r_j. The reference's weight-sum overrun guard (fill with the
max-weight particle, main.cpp:475-494) maps to clamping out-of-range strata
to the argmax-weight ancestor.

The ancestor search is a vectorized ``searchsorted`` instead of the
reference's serial two-pointer walk.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def systematic_ancestors(log_weight, key, n_out):
    """Compute ancestor indices. Returns int32 [n_out]."""
    P = log_weight.shape[0]
    w = jnp.exp(log_weight)
    c = jnp.cumsum(w)
    u = jax.random.uniform(key, (n_out,), dtype=log_weight.dtype)
    r = (jnp.arange(n_out, dtype=log_weight.dtype) + u) / n_out
    idx = jnp.searchsorted(c, r, side="left").astype(jnp.int32)
    overrun = idx >= P
    max_idx = jnp.argmax(log_weight).astype(jnp.int32)
    return jnp.where(overrun, max_idx, idx)


def effective_sample_ratio(log_weight):
    """nEff / N = 1 / (N * sum exp(2 w)) (main.cpp:1281-1284)."""
    P = log_weight.shape[0]
    return 1.0 / (jnp.sum(jnp.exp(2.0 * log_weight)) * P)

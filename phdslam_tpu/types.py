"""Filter state pytrees.

Replacement for the reference's particle containers
(/root/reference/src/slamtypes.h:275-337 ``ParticleSLAM``/``SynthSLAM``).

Design (SURVEY.md §7.1): fixed-capacity, device-resident structure-of-arrays
instead of ragged ``vector<vector<Gaussian>>`` with per-step host<->device
copies. A GM slot with ``weight == 0`` is empty (the reference's merge loop
already treats weight 0 as a terminator, phdfilter.cu:2784). The whole state
is a pytree that is donated through a single jit'd ``step``; the particle axis
(leading dim P) is the sharding axis for multi-chip execution.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

from .pytree import pytree_dataclass


@pytree_dataclass
class GMState:
    """Per-particle fixed-capacity Gaussian mixture (SoA).

    mean:   [P, K, D]
    cov:    [P, K, D, D]  (empty slots hold identity to keep inverses finite)
    weight: [P, K] linear weights; 0 marks an empty slot
    """
    mean: jax.Array
    cov: jax.Array
    weight: jax.Array

    @staticmethod
    def empty(n_particles: int, capacity: int, dim: int, dtype=jnp.float32):
        return GMState(
            mean=jnp.zeros((n_particles, capacity, dim), dtype=dtype),
            cov=jnp.broadcast_to(
                jnp.eye(dim, dtype=dtype),
                (n_particles, capacity, dim, dim)).copy(),
            weight=jnp.zeros((n_particles, capacity), dtype=dtype),
        )

    @property
    def capacity(self) -> int:
        return self.weight.shape[-1]

    @property
    def dim(self) -> int:
        return self.mean.shape[-1]


@pytree_dataclass
class FilterState:
    """Full Rao-Blackwellized PHD-SLAM filter state (SynthSLAM equivalent).

    pose:        [P, 6] (px, py, ptheta, vx, vy, vtheta)
    log_weight:  [P] log particle weights
    map_static:  2D GM map per particle
    map_dynamic: 4D GM map per particle
    cardinality: [P, C+1] log cardinality distribution (CPHD) or None
    variance:    [P] MC map-variance estimates (phdVarianceKernel)
    resample_idx:[P] ancestor indices of the last resampling
    rng:         PRNG key (folded per step)
    step:        scalar int32 step counter
    """
    pose: jax.Array
    log_weight: jax.Array
    map_static: GMState
    map_dynamic: GMState
    variance: jax.Array
    resample_idx: jax.Array
    rng: jax.Array
    step: jax.Array
    cardinality: Optional[jax.Array] = None
    # [P, M, 3] previous scan's measurement positions in WORLD coordinates
    # per particle (x, y, valid) — only allocated for the mixed model's
    # two-scan velocity birth initialization (cfg.birth_velocity_init);
    # None otherwise
    prev_z: Optional[jax.Array] = None


def init_state(cfg, n_particles: Optional[int] = None,
               dtype=jnp.float32) -> FilterState:
    """Initialize particles at the configured prior pose (main.cpp:1130-1145)."""
    P = n_particles if n_particles is not None else cfg.n_particles
    K = cfg.max_components
    pose0 = jnp.array(
        [cfg.x0, cfg.y0, cfg.yaw0, cfg.vx0, cfg.vy0, cfg.vyaw0], dtype=dtype)
    cardinality = None
    if cfg.filter_type == 1:  # CPHD
        C = cfg.max_cardinality
        cardinality = jnp.full((P, C + 1), -jnp.log(float(C + 1)), dtype=dtype)
    prev_z = None
    if cfg.feature_model == 2 and getattr(cfg, "birth_velocity_init", 0):
        prev_z = jnp.zeros((P, cfg.max_measurements, 3), dtype=dtype)
    return FilterState(
        pose=jnp.broadcast_to(pose0, (P, 6)).copy(),
        log_weight=jnp.full((P,), -jnp.log(float(P)), dtype=dtype),
        map_static=GMState.empty(P, K, 2, dtype),
        map_dynamic=GMState.empty(P, K, 4, dtype),
        variance=jnp.zeros((P,), dtype=dtype),
        resample_idx=jnp.arange(P, dtype=jnp.int32),
        rng=jax.random.PRNGKey(cfg.seed),
        step=jnp.zeros((), dtype=jnp.int32),
        cardinality=cardinality,
        prev_z=prev_z,
    )

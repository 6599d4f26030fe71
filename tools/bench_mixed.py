"""Mixed jump-Markov step throughput.

Measures full filter steps/s (predict + mixed static+dynamic GM-PHD update
+ extraction + resampling) with one on-device lax.scan over varying
synthetic measurements (uniform random clutter; no world, no accuracy
check). Shapes mirror the ackerman benchmark (P=512, K=128, M=32).

Usage: python tools/bench_mixed.py [P K M T] (default 512 128 32 100)
"""
import functools
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

from phdslam_tpu.config import SlamConfig
from phdslam_tpu.filters.phd import phd_step
from phdslam_tpu.types import init_state


def bench(P=512, K=128, M=32, T=100, fast=1, reps=3, **overrides):
    """Best-of-``reps`` steps/s of a T-step scan; ``overrides`` are extra
    SlamConfig fields."""
    cfg = SlamConfig(
        n_particles=P, max_features=K, max_measurements=M,
        motion_type=0, feature_model=2, filter_type=0,
        vx0=1.5, vyaw0=0.2, ax=0.3, ayaw=0.03,
        max_range=12.0, std_range=0.5, std_bearing=0.02,
        clutter_rate=5.0, pd=0.95, birth_weight=0.05, min_separation=2.0,
        resample_threshold=0.5, particle_weighting=0, tau=0.2,
        cov_vx_birth=0.25, cov_vy_birth=0.25, std_ax_map=0.05,
        std_ay_map=0.05, mixed_fast_path=fast, seed=0,
        # dynamic-map stage-2 cap: the 4D gather/merge runs at this width
        # instead of the shared cap=512 (the dynamic map's live candidates
        # never reach it at these scales; drops would be overflow-counted)
        merge_candidate_cap_dynamic=128, **overrides)
    state = init_state(cfg)

    rng = np.random.default_rng(0)
    n_real = max(4, M - 8)
    zr = rng.uniform(1.0, 11.0, (T, M)).astype(np.float32)
    zb = rng.uniform(-1.5, 1.5, (T, M)).astype(np.float32)
    z_all = jnp.asarray(np.stack([zr, zb], axis=-1))
    mask_all = jnp.asarray(
        np.broadcast_to(np.arange(M)[None, :] < n_real, (T, M)).copy())

    step = functools.partial(phd_step, cfg=cfg)
    ctrl = jnp.zeros((2,), jnp.float32)

    @functools.partial(jax.jit, donate_argnums=(0,))
    def run_all(st):
        def body(carry, inp):
            z, zm = inp
            st, out = step(carry, z, zm, ctrl, jnp.float32(0.5),
                           jnp.asarray(True))
            return st, out.n_eff
        return jax.lax.scan(body, st, (z_all, mask_all))

    st, ne = run_all(state)                      # compile + warm
    jax.block_until_ready(ne)
    best = None
    for _ in range(reps):
        st2 = init_state(cfg)
        t0 = time.perf_counter()
        st2, ne = run_all(st2)
        jax.block_until_ready(ne)
        dt = time.perf_counter() - t0
        best = dt if best is None else min(best, dt)
    label = "fast" if fast else "slow"
    print(f"mixed P={P} K={K} M={M} [{label}]: {T/best:.1f} steps/s "
          f"({best*1000/T:.2f} ms/step)", flush=True)
    return T / best


if __name__ == "__main__":
    from phdslam_tpu.runtime.compile_cache import configure_compile_cache
    configure_compile_cache()
    args = [int(a) for a in sys.argv[1:]]
    if args:
        bench(*args)
    else:
        bench(512, 128, 32, 100, fast=1)
        bench(64, 128, 32, 50, fast=1)
        bench(64, 128, 32, 50, fast=0)   # slow-path comparison at small P

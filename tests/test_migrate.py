"""Neighbor-exchange resample migration (parallel/migrate.py) on the
8-device CPU mesh."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from phdslam_tpu.parallel import make_mesh
from phdslam_tpu.parallel.migrate import (default_row_budget,
                                          gather_rows_neighbor,
                                          neighbor_feasible)


@pytest.fixture(scope="module")
def mesh():
    assert jax.device_count() >= 8
    return make_mesh(8, devices=jax.devices("cpu"))


def _equilibrium_ancestry(P, rng, max_shift=3):
    """Sorted ancestry with small local repeats/drops — what systematic
    resampling produces at healthy nEff."""
    anc = np.arange(P)
    for _ in range(max_shift):
        i = rng.integers(0, P)
        j = rng.integers(max(0, i - 4), min(P, i + 4))
        anc[i] = anc[j]
    return np.sort(anc).astype(np.int32)


def test_neighbor_matches_full_gather(mesh):
    P, K = 64, 12
    rng = np.random.default_rng(0)
    anc = _equilibrium_ancestry(P, rng, max_shift=10)
    n_dev, block = 8, P // 8
    budget = default_row_budget(block)
    assert bool(neighbor_feasible(jnp.asarray(anc), n_dev, block, budget))

    leaves = [jnp.asarray(rng.normal(0, 1, (P, K, 2)).astype(np.float32)),
              jnp.asarray(rng.normal(0, 1, (P,)).astype(np.float32)),
              jnp.asarray(rng.normal(0, 1, (P, K, 2, 2)).astype(np.float32))]
    got = jax.jit(lambda a, *xs: gather_rows_neighbor(mesh, a, list(xs),
                                                      budget))(
        jnp.asarray(anc), *leaves)
    for g, x in zip(got, leaves):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(x)[anc])


def test_feasibility_rejects_far_ancestors():
    P, n_dev = 64, 8
    block = P // n_dev
    anc = np.arange(P, dtype=np.int32)
    anc[0] = 63                      # device 0 needs a device-7 row
    assert not bool(neighbor_feasible(jnp.asarray(anc), n_dev, block,
                                      default_row_budget(block)))
    # budget violation: device 1's whole block ancestors on device 0
    anc2 = np.arange(P, dtype=np.int32)
    anc2[block:2 * block] = np.arange(block)
    assert not bool(neighbor_feasible(jnp.asarray(anc2), n_dev, block,
                                      budget=2))
    assert bool(neighbor_feasible(jnp.asarray(anc2), n_dev, block,
                                  budget=block))


def test_sharded_step_with_forced_resampling(mesh):
    """Force resampling EVERY step (threshold 1.0) so the neighbor
    migration executes, and pin parity against the unsharded step."""
    from phdslam_tpu.config import SlamConfig
    from phdslam_tpu.filters.phd import make_step_fn
    from phdslam_tpu.parallel import init_sharded_state, make_sharded_step_fn
    from phdslam_tpu.types import init_state

    cfg = SlamConfig(n_particles=32, max_features=12, max_measurements=4,
                     motion_type=0, feature_model=0, filter_type=0,
                     max_range=15.0, std_range=0.25, std_bearing=0.02,
                     clutter_rate=5.0, pd=0.95, birth_weight=0.05,
                     min_separation=2.0, resample_threshold=2.0, seed=3)
    z = np.zeros((4, 2), np.float32)
    z[:3] = [[5.0, 0.1], [8.0, -0.4], [3.0, 1.0]]
    zm = np.zeros((4,), bool)
    zm[:3] = True
    z, zm = jnp.asarray(z), jnp.asarray(zm)
    ctrl = jnp.zeros((2,), jnp.float32)

    ref_step = make_step_fn(cfg, donate=False)
    sh_step = make_sharded_step_fn(cfg, mesh, donate=False)
    st_ref = init_state(cfg)
    st_sh = init_sharded_state(cfg, mesh)

    n_resampled = 0
    for n in range(5):
        dp = jnp.asarray(n > 0)
        st_ref, out_ref = ref_step(st_ref, z, zm, ctrl, jnp.float32(0.1), dp)
        st_sh, out_sh = sh_step(st_sh, z, zm, ctrl, jnp.float32(0.1), dp)
        n_resampled += int(out_sh.resampled)
        np.testing.assert_array_equal(np.asarray(out_sh.resample_idx),
                                      np.asarray(out_ref.resample_idx))
    assert n_resampled >= 4          # resampling actually exercised
    np.testing.assert_allclose(np.asarray(st_sh.pose),
                               np.asarray(st_ref.pose),
                               rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(np.asarray(st_sh.map_static.mean),
                               np.asarray(st_ref.map_static.mean),
                               rtol=2e-3, atol=2e-4)
    np.testing.assert_allclose(np.asarray(st_sh.map_static.weight),
                               np.asarray(st_ref.map_static.weight),
                               rtol=2e-3, atol=2e-5)

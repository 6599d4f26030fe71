"""Multi-chip sharding tests on the 8-device CPU mesh (SURVEY.md §4d).

Validates that the particle-sharded step (a) compiles and executes over a
mesh, (b) produces the same results as the unsharded step (the collectives
XLA inserts — psum weight normalization, resampling gather — must be
semantics-preserving), and (c) actually shards the state.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from phdslam_tpu.config import SlamConfig
from phdslam_tpu.filters.phd import make_step_fn
from phdslam_tpu.parallel import (init_sharded_state, make_mesh,
                                  make_sharded_step_fn)
from phdslam_tpu.types import init_state


def small_cfg(**kw):
    d = dict(n_particles=16, max_features=12, max_measurements=4,
             motion_type=0, feature_model=0, filter_type=0,
             max_range=15.0, std_range=0.25, std_bearing=0.02,
             clutter_rate=5.0, pd=0.95, birth_weight=0.05,
             min_separation=2.0, resample_threshold=0.5, seed=3)
    d.update(kw)
    return SlamConfig(**d)


def fake_inputs(m_max, n_z=3):
    z = np.zeros((m_max, 2), np.float32)
    z[:n_z] = [[5.0, 0.1], [8.0, -0.4], [3.0, 1.0]][:n_z]
    mask = np.zeros((m_max,), bool)
    mask[:n_z] = True
    return jnp.asarray(z), jnp.asarray(mask)


@pytest.fixture(scope="module")
def mesh():
    assert jax.device_count() >= 8, "conftest must force 8 CPU devices"
    return make_mesh(8, devices=jax.devices("cpu"))


def test_sharded_step_matches_unsharded(mesh):
    cfg = small_cfg()
    z, zm = fake_inputs(cfg.max_measurements)
    ctrl = jnp.zeros((2,), jnp.float32)

    ref_step = make_step_fn(cfg, donate=False)
    sh_step = make_sharded_step_fn(cfg, mesh, donate=False)

    st_ref = init_state(cfg)
    st_sh = init_sharded_state(cfg, mesh)

    for n in range(5):
        dp = jnp.asarray(n > 0)
        st_ref, out_ref = ref_step(st_ref, z, zm, ctrl, jnp.float32(0.1), dp)
        st_sh, out_sh = sh_step(st_sh, z, zm, ctrl, jnp.float32(0.1), dp)

    np.testing.assert_allclose(np.asarray(out_sh.expected_pose),
                               np.asarray(out_ref.expected_pose),
                               rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(float(out_sh.n_eff), float(out_ref.n_eff),
                               rtol=2e-4)
    np.testing.assert_allclose(np.asarray(st_sh.log_weight),
                               np.asarray(st_ref.log_weight),
                               rtol=2e-4, atol=2e-5)
    # MAP map estimate identical up to float reassociation
    np.testing.assert_allclose(np.asarray(out_sh.map_weight),
                               np.asarray(out_ref.map_weight),
                               rtol=2e-3, atol=1e-5)


def test_state_is_actually_sharded(mesh):
    cfg = small_cfg()
    st = init_sharded_state(cfg, mesh)
    shards = st.map_static.mean.sharding
    assert shards.num_devices == 8
    # leading axis split 16/8 = 2 per device
    shard_shape = shards.shard_shape(st.map_static.mean.shape)
    assert shard_shape[0] == 2


def test_sharded_step_with_resampling(mesh):
    # force resampling by concentrating weight: high threshold
    cfg = small_cfg(resample_threshold=1.0)
    z, zm = fake_inputs(cfg.max_measurements)
    ctrl = jnp.zeros((2,), jnp.float32)
    sh_step = make_sharded_step_fn(cfg, mesh, donate=False)
    st = init_sharded_state(cfg, mesh)
    for n in range(3):
        st, out = sh_step(st, z, zm, ctrl, jnp.float32(0.1),
                          jnp.asarray(n > 0))
    assert bool(out.resampled)
    # post-resample weights are uniform and the gather preserved validity
    lw = np.asarray(st.log_weight)
    np.testing.assert_allclose(lw, -np.log(cfg.n_particles), rtol=1e-5)
    assert np.isfinite(np.asarray(st.map_static.weight)).all()


def test_divisibility_check(mesh):
    cfg = small_cfg(n_particles=10)
    with pytest.raises(ValueError):
        init_sharded_state(cfg, mesh)


def test_run_sharded_matches_scanned(mesh, tmp_path):
    """Full-sequence sharded scan vs single-device scan on a real dataset."""
    from phdslam_tpu.eval.batch import generate_batch_datasets
    from phdslam_tpu.slam import SynthSLAMRunner

    root = str(tmp_path)
    generate_batch_datasets(root, n_runs=1, n_landmarks=12, n_steps=20,
                            seed=5)
    cfg = small_cfg(n_particles=16, max_features=24, max_measurements=32,
                    motion_type=1)
    cfg.l, cfg.h, cfg.a, cfg.b = 2.83, 0.76, 3.78, 0.5
    cfg.std_encoder, cfg.std_alpha = 2.0, 0.0873
    cfg.max_range, cfg.std_range, cfg.std_bearing = 10.0, 1.0, 0.0349
    cfg.clutter_rate = 20.0

    r1 = SynthSLAMRunner(cfg, f"{root}/run000")
    res1 = r1.run_scanned(collect_maps=False)
    r2 = SynthSLAMRunner(cfg, f"{root}/run000")
    res2 = r2.run_sharded(mesh)
    assert res2["n_devices"] == 8
    np.testing.assert_allclose(res2["est_poses"], res1["est_poses"],
                               rtol=1e-3, atol=5e-3)
    np.testing.assert_allclose(res2["n_eff"], res1["n_eff"],
                               rtol=1e-3, atol=1e-4)


def test_distributed_module_single_host():
    """Single-host behavior of the multi-host runtime helpers: initialize is
    a no-op without a cluster env, primary is True, and the global mesh
    spans the local devices."""
    import jax

    from phdslam_tpu.parallel import distributed

    assert distributed.initialize() is False  # no cluster env here
    assert distributed.is_primary()
    mesh = distributed.global_mesh()
    assert mesh.devices.size == len(jax.devices())
    assert distributed.process_local_batch(len(jax.devices()) * 4) \
        == len(jax.devices()) * 4  # one process owns everything


def test_make_mesh_fallback_and_cfg_resolution():
    """make_mesh must RAISE when fewer devices are available than asked for
    (no silent switch to another backend), and the auto merge-kernel knob
    must resolve against the MESH platform, not the default backend (the
    kernel compiles only for a GPU)."""
    import pytest

    from phdslam_tpu.config import SlamConfig
    from phdslam_tpu.parallel.sharding import _cfg_for_mesh, make_mesh

    mesh = make_mesh(8, devices=jax.devices("cpu"))
    assert mesh.devices.size == 8
    with pytest.raises(ValueError):
        make_mesh(10_000)
    with pytest.raises(ValueError):
        make_mesh(9, devices=jax.devices("cpu"))

    cfg = SlamConfig(n_particles=8, pallas_merge=1)
    r = _cfg_for_mesh(cfg, mesh)  # CPU mesh -> auto resolves to XLA path
    assert r.pallas_merge == 0
    cfg2 = SlamConfig(n_particles=8, pallas_merge=2)
    r2 = _cfg_for_mesh(cfg2, mesh)  # forced-interpret knob passes through
    assert r2.pallas_merge == 2


@pytest.mark.parametrize("variant_kw", [
    dict(filter_type=1, max_cardinality=24),        # CPHD
    dict(feature_model=2),                          # mixed jump-Markov
    # mixed + two-scan velocity births: the prev_z state leaf ([P, M, 3])
    # must shard/migrate like everything else
    dict(feature_model=2, birth_velocity_init=1,
         resample_threshold=1.1),
], ids=["cphd", "mixed", "mixed_velinit"])
def test_sharded_variants_match_unsharded(mesh, variant_kw):
    """The CPHD and mixed-model branches of phd_step must survive the SPMD
    partitioner unchanged: per-particle cardinality arrays ([P, C+1]) and the
    dynamic map shard on the particle axis like everything else."""
    cfg = small_cfg(**variant_kw)
    z, zm = fake_inputs(cfg.max_measurements)
    ctrl = jnp.zeros((2,), jnp.float32)

    ref_step = make_step_fn(cfg, donate=False)
    sh_step = make_sharded_step_fn(cfg, mesh, donate=False)
    st_ref = init_state(cfg)
    st_sh = init_sharded_state(cfg, mesh)

    for n in range(4):
        dp = jnp.asarray(n > 0)
        st_ref, out_ref = ref_step(st_ref, z, zm, ctrl, jnp.float32(0.1), dp)
        st_sh, out_sh = sh_step(st_sh, z, zm, ctrl, jnp.float32(0.1), dp)

    np.testing.assert_allclose(np.asarray(out_sh.expected_pose),
                               np.asarray(out_ref.expected_pose),
                               rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(np.asarray(st_sh.log_weight),
                               np.asarray(st_ref.log_weight),
                               rtol=2e-4, atol=2e-5)
    if variant_kw.get("filter_type") == 1:  # cardinality is CPHD-only
        np.testing.assert_allclose(np.asarray(out_sh.cardinality),
                                   np.asarray(out_ref.cardinality),
                                   rtol=2e-4, atol=2e-4)
    else:
        np.testing.assert_allclose(np.asarray(out_sh.map_weight),
                                   np.asarray(out_ref.map_weight),
                                   rtol=2e-3, atol=1e-5)


def test_eap_extraction_sharded_parity(mesh):
    """map_estimate=2 (EAP tree merge) under the particle mesh: the
    pairwise-tree levels reshape the sharded particle axis; the partitioner
    must keep the result identical to the unsharded tree."""
    cfg = small_cfg(map_estimate=2, particle_weighting=0)
    z, zm = fake_inputs(cfg.max_measurements)
    ctrl = jnp.zeros((2,), jnp.float32)

    ref_step = make_step_fn(cfg, donate=False)
    sh_step = make_sharded_step_fn(cfg, mesh, donate=False)
    st_ref = init_state(cfg)
    st_sh = init_sharded_state(cfg, mesh)

    for n in range(4):
        dp = jnp.asarray(n > 0)
        st_ref, out_ref = ref_step(st_ref, z, zm, ctrl, jnp.float32(0.1), dp)
        st_sh, out_sh = sh_step(st_sh, z, zm, ctrl, jnp.float32(0.1), dp)

    np.testing.assert_allclose(np.asarray(out_sh.map_weight),
                               np.asarray(out_ref.map_weight),
                               rtol=2e-3, atol=1e-5)
    np.testing.assert_allclose(np.asarray(out_sh.map_mean),
                               np.asarray(out_ref.map_mean),
                               rtol=2e-3, atol=2e-4)


def test_sharded_disparity_matches_unsharded(mesh):
    """The SC-PHD disparity step on a particle mesh (the monocular
    variant's multi-chip path — round-3 verdict item 4): per-particle
    cloud state [P, K, N, 3] shards on the particle axis; the resampling
    migration and one-hot MAP extraction must survive the partitioner
    with unchanged semantics."""
    from phdslam_tpu.filters.disparity import (init_disparity_state,
                                               make_disparity_step_fn)
    from phdslam_tpu.parallel.sharding import (
        init_sharded_disparity_state, make_sharded_disparity_step_fn)

    cfg = SlamConfig(
        n_particles=16, max_features=8, max_measurements=8,
        particles_per_feature=16, motion_type=0, filter_type=0,
        pd=0.9, clutter_rate=2.0, birth_weight=0.05, min_separation=8.0,
        fx=500.0, fy=500.0, u0=320.0, v0=240.0, image_width=640,
        image_height=480, std_u=1.0, std_v=1.0, disparity_birth=100.0,
        std_d_birth=30.0, vx0=0.25, dt=1.0,
        # force resampling so the sharded migration path executes
        resample_threshold=1.1, seed=5, pallas_merge=0)

    rng = np.random.default_rng(2)
    z = rng.uniform([100, 100], [540, 380], (8, 2)).astype(np.float32)
    zm = np.ones((8,), bool)
    z, zm = jnp.asarray(z), jnp.asarray(zm)

    ref_step = make_disparity_step_fn(cfg, donate=False)
    sh_step = make_sharded_disparity_step_fn(cfg, mesh, donate=False)
    st_ref = init_disparity_state(cfg)
    st_sh = init_sharded_disparity_state(cfg, mesh)

    for n in range(4):
        dp = jnp.asarray(n > 0)
        st_ref, out_ref = ref_step(st_ref, z, zm, jnp.float32(1.0), dp)
        st_sh, out_sh = sh_step(st_sh, z, zm, jnp.float32(1.0), dp)

    assert bool(out_ref.resampled)           # the migration actually ran
    np.testing.assert_allclose(np.asarray(out_sh.expected_pose),
                               np.asarray(out_ref.expected_pose),
                               rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(np.asarray(st_sh.log_weight),
                               np.asarray(st_ref.log_weight),
                               rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(np.asarray(st_sh.feat_weight),
                               np.asarray(st_ref.feat_weight),
                               rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(np.asarray(st_sh.cloud),
                               np.asarray(st_ref.cloud),
                               rtol=2e-4, atol=2e-4)
    # the state actually shards
    shard0 = st_sh.cloud.addressable_shards[0]
    assert shard0.data.shape[0] == cfg.n_particles // 8


def test_dense_shape_sharded_execution(mesh):
    """EXECUTED (not AOT) multi-device parity at a dense-flavored shape
    (round-3 verdict item 5): P=256, K=256, M=48, cap=384, EAP
    extraction on (the pairwise tree's cross-device levels), resampling
    forced every step so the migration runs at non-toy live counts —
    both the neighbor-exchange branch (default budget) and the
    infeasible-ancestry full-gather fallback (budget=1) must reproduce
    the single-device trace."""
    def cfg_of(**kw):
        d = dict(n_particles=256, max_features=256, max_measurements=48,
                 motion_type=1, feature_model=0, filter_type=0,
                 l=2.83, h=0.76, a=3.78, b=0.5, std_encoder=0.1,
                 std_alpha=0.01, max_range=15.0, std_range=0.5,
                 std_bearing=0.0349, clutter_rate=20.0, pd=0.95,
                 birth_weight=0.05, min_separation=5.0,
                 min_feature_weight=1e-6, merge_candidate_cap=384,
                 detection_topk=32, map_estimate=2,
                 resample_threshold=1.1, seed=0)
        d.update(kw)
        return SlamConfig(**d)

    rng = np.random.default_rng(0)
    M = 48
    z = np.column_stack([rng.uniform(1, 14, M),
                         rng.uniform(-3, 3, M)]).astype(np.float32)
    zm = np.ones(M, bool)
    zm[40:] = False
    z, zm = jnp.asarray(z), jnp.asarray(zm)
    ctrl = jnp.asarray([1.0, 0.05], jnp.float32)

    def run(step, st):
        outs = []
        for n in range(6):
            st, out = step(st, z, zm, ctrl, jnp.float32(1.0),
                           jnp.asarray(n > 0))
            outs.append(out)
        return st, outs[-1]

    cfg = cfg_of()
    st_ref, out_ref = run(make_step_fn(cfg, donate=False), init_state(cfg))
    live = int((np.asarray(st_ref.map_static.weight) > 0).sum(1).max())
    assert live > 100, f"scene too sparse to be a dense-shape probe: {live}"
    assert bool(out_ref.resampled)

    for budget_kw in ({}, {"migration_row_budget": 1}):
        cfg_b = cfg_of(**budget_kw)
        sh_step = make_sharded_step_fn(cfg_b, mesh, donate=False)
        st_sh, out_sh = run(sh_step, init_sharded_state(cfg_b, mesh))
        np.testing.assert_allclose(np.asarray(out_sh.expected_pose),
                                   np.asarray(out_ref.expected_pose),
                                   rtol=2e-4, atol=2e-4)
        np.testing.assert_allclose(np.asarray(st_sh.log_weight),
                                   np.asarray(st_ref.log_weight),
                                   rtol=2e-4, atol=2e-4)
        # EAP expected map (cross-device tree levels) matches
        np.testing.assert_allclose(np.asarray(out_sh.map_weight),
                                   np.asarray(out_ref.map_weight),
                                   rtol=2e-3, atol=2e-4)
        np.testing.assert_allclose(
            np.asarray(st_sh.map_static.weight),
            np.asarray(st_ref.map_static.weight), rtol=2e-3, atol=2e-4)

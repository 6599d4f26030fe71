"""Dynamic (4D) and mixed static+dynamic feature-model tests."""

import jax.numpy as jnp
import numpy as np

from phdslam_tpu.config import SlamConfig
from phdslam_tpu.filters.mixed import _update_mixed_single
from phdslam_tpu.filters.phd import _update_single, make_step_fn
from phdslam_tpu.types import init_state


def base_cfg(**kw):
    d = dict(n_particles=8, max_features=24, max_measurements=6,
             motion_type=0, max_range=25.0, std_range=0.25,
             std_bearing=0.02, clutter_rate=2.0, pd=0.95, birth_weight=0.05,
             min_separation=2.0, resample_threshold=0.3, filter_type=0,
             ax=0.05, ay=0.05, ayaw=0.005, cov_vx_birth=1.0,
             cov_vy_birth=1.0, std_ax_map=0.2, std_ay_map=0.2,
             ps=0.98, beta=1.0, tau=0.5, seed=5)
    d.update(kw)
    return SlamConfig(**d)


def measure(targets, rng, cfg, m_max):
    """Noisy range-bearing measurements of targets from the origin."""
    r = np.linalg.norm(targets, axis=1) + rng.normal(0, cfg.std_range,
                                                     len(targets))
    b = np.arctan2(targets[:, 1], targets[:, 0]) \
        + rng.normal(0, cfg.std_bearing, len(targets))
    z = np.zeros((m_max, 2), np.float32)
    z[:len(targets)] = np.stack([r, b], axis=1)
    mask = np.zeros((m_max,), bool)
    mask[:len(targets)] = True
    return jnp.asarray(z), jnp.asarray(mask)


def test_dynamic_model_tracks_moving_target():
    """feature_model=1: the 4D map should follow a constant-velocity target
    and estimate its velocity."""
    cfg = base_cfg(feature_model=1, particle_weighting=1)
    step = make_step_fn(cfg, donate=False)
    state = init_state(cfg)
    rng = np.random.default_rng(11)
    pos = np.array([[6.0, 2.0]])
    vel = np.array([[0.8, -0.4]])
    dt = 0.5
    for n in range(20):
        z, mask = measure(pos, rng, cfg, cfg.max_measurements)
        state, out = step(state, z, mask, jnp.zeros((2,), jnp.float32),
                         jnp.float32(dt), jnp.asarray(n > 0))
        pos = pos + vel * dt
    w = np.asarray(state.map_dynamic.weight[0])
    m = np.asarray(state.map_dynamic.mean[0])
    best = np.argmax(w)
    assert w[best] > 0.5
    # position tracks the PREVIOUS observed position (update at step n sees
    # the target before this step's advance)
    err = np.linalg.norm(m[best, :2] - (pos[0] - vel[0] * dt))
    assert err < 2.5, (m[best], pos)
    # velocity estimate has the right direction
    v_est = m[best, 2:]
    assert v_est @ vel[0] > 0, v_est


def test_mixed_matches_static_when_dynamic_empty():
    """With labeled all-static measurements and an empty dynamic map, the
    mixed update's static map must equal the static-only update."""
    cfg = base_cfg(feature_model=2, particle_weighting=1,
                   labeled_measurements=True)
    K, M = cfg.max_features, cfg.max_measurements
    rng = np.random.default_rng(3)
    pose = jnp.asarray(np.array([0.5, -0.2, 0.1, 0, 0, 0], np.float32))
    # seed a static map with 3 live features
    mean_s = jnp.asarray(np.zeros((K, 2), np.float32))
    mean_s = mean_s.at[:3].set(jnp.asarray(
        np.array([[5, 1], [8, -2], [3, 4]], np.float32)))
    cov_s = jnp.broadcast_to(jnp.eye(2) * 0.3, (K, 2, 2)).astype(jnp.float32)
    w_s = jnp.asarray(np.array([0.9, 0.8, 0.7] + [0.0] * (K - 3), np.float32))
    mean_d = jnp.zeros((K, 4), jnp.float32)
    cov_d = jnp.broadcast_to(jnp.eye(4), (K, 4, 4)).astype(jnp.float32)
    w_d = jnp.zeros((K,), jnp.float32)

    z, mask = measure(np.array([[5.1, 1.1], [7.9, -2.2]]), rng, cfg, M)
    labels = jnp.zeros((M,), jnp.int32)

    (sm, sc, sw), (dm, dc, dw), dlw_mixed, _ = _update_mixed_single(
        pose, mean_s, cov_s, w_s, mean_d, cov_d, w_d, z, labels, mask, cfg)
    sm2, sc2, sw2, dlw_static, _ = _update_single(
        pose, mean_s, cov_s, w_s, z, mask, cfg)

    np.testing.assert_allclose(np.asarray(sw), np.asarray(sw2),
                               rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(np.asarray(sm), np.asarray(sm2),
                               rtol=1e-5, atol=1e-5)
    # dynamic map stays empty apart from (zero-weight) labeled-out births
    assert float(jnp.max(dw)) == 0.0


def test_mixed_e2e_separates_static_and_moving():
    """Unlabeled mixed run: static landmarks land in the static map, the
    mover gets dynamic components."""
    cfg = base_cfg(feature_model=2, particle_weighting=1, tau=0.2,
                   min_separation=1.0)
    step = make_step_fn(cfg, donate=False)
    state = init_state(cfg)
    rng = np.random.default_rng(4)
    landmarks = np.array([[5.0, 3.0], [9.0, -4.0]])
    mover = np.array([[2.0, -6.0]])
    vel = np.array([[1.0, 0.5]])
    dt = 0.5
    for n in range(16):
        targets = np.concatenate([landmarks, mover])
        z, mask = measure(targets, rng, cfg, cfg.max_measurements)
        state, out = step(state, z, mask, jnp.zeros((2,), jnp.float32),
                         jnp.float32(dt), jnp.asarray(n > 0))
        mover = mover + vel * dt
    assert np.isfinite(np.asarray(state.log_weight)).all()
    w_s = np.asarray(state.map_static.weight[0])
    m_s = np.asarray(state.map_static.mean[0])
    # both landmarks present in the static map
    for lm in landmarks:
        d = np.linalg.norm(m_s[w_s > 0.4] - lm, axis=-1)
        assert d.size and d.min() < 1.0, (lm, m_s[w_s > 0.4])
    # dynamic map has at least one live component near the mover's track
    w_d = np.asarray(state.map_dynamic.weight[0])
    assert (w_d > 0.2).any()


def _mixed_state_and_z(cfg, seed=7, n_static=5, n_dyn=3):
    """Random multi-particle mixed state + one measurement set (few live
    features per map so top-T selection keeps every live lane and the fast
    pipeline is set-equivalent to the full-lane route)."""
    import jax

    from phdslam_tpu.types import init_state
    K, M, P = cfg.max_features, cfg.max_measurements, cfg.n_particles
    rng = np.random.default_rng(seed)
    state = init_state(cfg)
    pose = np.zeros((P, 6), np.float32)
    pose[:, :2] = rng.normal(0, 0.3, (P, 2))
    ms = np.zeros((P, K, 2), np.float32)
    ws = np.zeros((P, K), np.float32)
    ms[:, :n_static] = rng.uniform(2, 9, (1, n_static, 2)) \
        + rng.normal(0, 0.05, (P, n_static, 2))
    ws[:, :n_static] = rng.uniform(0.4, 1.0, (P, n_static))
    cs = np.broadcast_to(np.eye(2, dtype=np.float32) * 0.3,
                         (P, K, 2, 2)).copy()
    md = np.zeros((P, K, 4), np.float32)
    wd = np.zeros((P, K), np.float32)
    md[:, :n_dyn, :2] = rng.uniform(-8, -2, (1, n_dyn, 2)) \
        + rng.normal(0, 0.05, (P, n_dyn, 2))
    md[:, :n_dyn, 2:] = rng.normal(0, 0.3, (P, n_dyn, 2))
    wd[:, :n_dyn] = rng.uniform(0.4, 1.0, (P, n_dyn))
    cd = np.broadcast_to(np.eye(4, dtype=np.float32) * 0.4,
                         (P, K, 4, 4)).copy()
    state = state.replace(
        pose=jnp.asarray(pose),
        map_static=state.map_static.replace(
            mean=jnp.asarray(ms), cov=jnp.asarray(cs), weight=jnp.asarray(ws)),
        map_dynamic=state.map_dynamic.replace(
            mean=jnp.asarray(md), cov=jnp.asarray(cd), weight=jnp.asarray(wd)),
        log_weight=jnp.asarray(rng.normal(0, 0.2, (P,)).astype(np.float32)))
    targets = np.concatenate([ms[0, :2], md[0, :2, :2]])
    z, mask = measure(targets, np.random.default_rng(seed + 1), cfg, M)
    return state, z, mask


def test_mixed_fast_path_matches_slow():
    """The batch-hoisted fast pipeline (two-stage selection + batch merges)
    must reproduce the per-particle reference-shaped route: same maps, same
    particle-weight increments (phdfilter.cu:2323-2635 equivalence)."""
    import dataclasses

    from phdslam_tpu.filters.mixed import mixed_update

    for weighting, pallas_merge in ((0, 0), (1, 0), (0, 2)):
        # pallas_merge=2: the 2D/4D merge kernels (interpret mode on CPU)
        # must match the per-particle route too
        cfg = base_cfg(feature_model=2, particle_weighting=weighting,
                       n_particles=5, max_features=16, max_measurements=6,
                       merge_candidate_cap=64, detection_topk=8,
                       pallas_merge=pallas_merge)
        state, z, mask = _mixed_state_and_z(cfg)
        fast, ovf_f = mixed_update(state, z, mask, cfg)
        slow_cfg = dataclasses.replace(cfg, mixed_fast_path=0,
                                       pallas_merge=0)
        slow, ovf_s = mixed_update(state, z, mask, slow_cfg)

        np.testing.assert_allclose(np.asarray(fast.log_weight),
                                   np.asarray(slow.log_weight),
                                   rtol=2e-5, atol=2e-5)
        for name in ("map_static", "map_dynamic"):
            gf, gs = getattr(fast, name), getattr(slow, name)
            np.testing.assert_allclose(np.asarray(gf.weight),
                                       np.asarray(gs.weight),
                                       rtol=2e-4, atol=2e-5,
                                       err_msg=f"{name} w={weighting}")
            live = np.asarray(gs.weight) > 1e-6
            np.testing.assert_allclose(
                np.asarray(gf.mean)[live], np.asarray(gs.mean)[live],
                rtol=2e-4, atol=2e-4, err_msg=f"{name} w={weighting}")
            np.testing.assert_allclose(
                np.asarray(gf.cov)[live], np.asarray(gs.cov)[live],
                rtol=2e-3, atol=2e-4, err_msg=f"{name} w={weighting}")


def test_mixed_fast_path_labeled():
    """Label gating survives the fast pipeline: all-static labels leave the
    dynamic map without births."""
    cfg = base_cfg(feature_model=2, particle_weighting=1, n_particles=4,
                   max_features=16, max_measurements=6,
                   merge_candidate_cap=64, detection_topk=8,
                   labeled_measurements=True)
    state, z, mask = _mixed_state_and_z(cfg, n_dyn=0)
    from phdslam_tpu.filters.mixed import mixed_update
    labels = jnp.zeros((cfg.max_measurements,), jnp.int32)
    new, _ = mixed_update(state, z, mask, cfg, z_label=labels)
    assert float(jnp.max(new.map_dynamic.weight)) == 0.0
    assert float(jnp.max(new.map_static.weight)) > 0.3


def test_evaluate_mixed_end_to_end():
    """Full mixed-model SLAM accuracy (eval/parity.py::evaluate_mixed): CV
    vehicle + static landmarks + moving targets, unlabeled measurements — a
    configuration the reference implements but ships no dataset for. The
    cluster-process weighting (scheme 0) is required: without odometry the
    empty-map heuristic's weights are flat and the pose random-walks."""
    from phdslam_tpu.eval.parity import evaluate_mixed

    r = evaluate_mixed(seed=0, n_particles=64, n_steps=60)
    assert r["final_pose_err"] < 1.0, r
    assert r["static_ospa"] < 2.5, r
    assert r["dynamic_ospa"] < 4.8, r       # movers at least partially held
    assert r["n_dyn_est"] >= 1, r
    assert np.isfinite(r["n_eff"])


def test_two_scan_velocity_birth_seeding():
    """cfg.birth_velocity_init: dynamic births pair each measurement with
    the nearest previous-scan world position and seed the velocity mean
    with the displacement / dt (gated at birth_velocity_max * dt); no
    pair or gate exceeded -> reference zero-velocity birth."""
    import jax.numpy as jnp
    import numpy as np

    from phdslam_tpu.config import SlamConfig
    from phdslam_tpu.models import measurement

    cfg = SlamConfig(dt=0.5, birth_velocity_init=1, birth_velocity_max=3.0,
                     std_range=0.25, std_bearing=0.02,
                     birth_noise_factor=1.0, cov_vx_birth=0.25,
                     cov_vy_birth=0.25)
    pose = jnp.zeros((6,))
    # measurements at world (4, 0) and (0, 6) (range/bearing from origin)
    z = jnp.asarray([[4.0, 0.0], [6.0, np.pi / 2], [1.0, 0.0]], jnp.float32)
    zm = jnp.asarray([True, True, False])
    b_mean, _ = measurement.birth_mean_cov_4d(pose, z, cfg)
    # previous scan: (3.5, 0.2) pairs with (4, 0) -> v = (1.0, -0.4);
    # nothing within 1.5 m of (0, 6) -> zero velocity
    prev = jnp.asarray([[3.5, 0.2, 1.0], [9.0, 9.0, 1.0],
                        [0.0, 0.0, 0.0]], jnp.float32)
    seeded = measurement.seed_birth_velocity(b_mean, prev, zm, cfg)
    np.testing.assert_allclose(np.asarray(seeded[0, 2:]), [1.0, -0.4],
                               atol=1e-5)
    np.testing.assert_allclose(np.asarray(seeded[1, 2:]), [0.0, 0.0],
                               atol=1e-6)
    np.testing.assert_allclose(np.asarray(seeded[:, :2]),
                               np.asarray(b_mean[:, :2]), atol=1e-6)
    # invalid previous points never pair even when nearby: prev lane 2 at
    # the origin is marked invalid, and measurement 2 is masked anyway
    np.testing.assert_allclose(np.asarray(seeded[2, 2:]), [0.0, 0.0],
                               atol=1e-6)


def test_mixed_e2e_with_velocity_init_runs():
    """The full mixed step with birth_velocity_init on: prev_z threads
    through update/resample/shotgun without shape errors and the filter
    stays finite."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from phdslam_tpu.config import SlamConfig
    from phdslam_tpu.filters.phd import make_step_fn
    from phdslam_tpu.types import init_state

    cfg = SlamConfig(
        n_particles=8, max_features=16, max_measurements=6,
        motion_type=0, feature_model=2, filter_type=0,
        vx0=1.0, ax=0.3, ayaw=0.03, max_range=12.0, std_range=0.5,
        std_bearing=0.02, clutter_rate=2.0, pd=0.95, birth_weight=0.05,
        min_separation=2.0, resample_threshold=0.9, tau=0.2,
        cov_vx_birth=0.25, cov_vy_birth=0.25, birth_velocity_init=1,
        seed=0)
    state = init_state(cfg)
    assert state.prev_z is not None
    step = make_step_fn(cfg, donate=False)
    z = jnp.asarray([[5.0, 0.2], [7.0, -0.3]] + [[0, 0]] * 4, jnp.float32)
    zm = jnp.asarray([True, True] + [False] * 4)
    ctrl = jnp.zeros((2,), jnp.float32)
    for n in range(4):
        state, out = step(state, z, zm, ctrl, jnp.float32(0.5),
                          jnp.asarray(n > 0))
    assert np.isfinite(np.asarray(out.expected_pose)).all()
    assert np.isfinite(np.asarray(state.log_weight)).all()
    # prev_z recorded the scan
    pz = np.asarray(state.prev_z)
    assert (pz[:, :2, 2] > 0.5).all() and (pz[:, 2:, 2] < 0.5).all()


def test_dynamic_candidate_cap_fast_matches_slow():
    """merge_candidate_cap_dynamic: the separate stage-2 cap for the
    dynamic map must keep the fast pipeline equivalent to the
    per-particle reference-shaped route (which applies the same cap via
    _merge_map)."""
    import jax.numpy as jnp
    import numpy as np

    from phdslam_tpu.config import SlamConfig
    from phdslam_tpu.filters.mixed import mixed_update
    from phdslam_tpu.types import init_state

    def cfg_of(fast):
        return SlamConfig(
            n_particles=6, max_features=16, max_measurements=6,
            motion_type=0, feature_model=2, filter_type=0,
            max_range=12.0, std_range=0.5, std_bearing=0.02,
            clutter_rate=2.0, pd=0.95, birth_weight=0.05,
            min_separation=2.0, tau=0.2, cov_vx_birth=0.25,
            cov_vy_birth=0.25, merge_candidate_cap=64,
            merge_candidate_cap_dynamic=32, detection_topk=4,
            mixed_fast_path=fast, pallas_merge=0,
            particle_weighting=0, seed=0)

    rng = np.random.default_rng(1)
    z = jnp.asarray(np.column_stack([rng.uniform(1, 10, 6),
                                     rng.uniform(-1.5, 1.5, 6)]),
                    jnp.float32)
    zm = jnp.asarray(np.arange(6) < 4)
    sites = jnp.asarray(rng.uniform(-8, 8, (1, 4, 2)), jnp.float32)

    outs = []
    for fast in (1, 0):
        cfg = cfg_of(fast)
        state = init_state(cfg)
        # seed some live features so both maps have candidates
        ms = state.map_static
        mean = ms.mean.at[:, :4].set(sites)
        w = ms.weight.at[:, :4].set(0.8)
        state = state.replace(map_static=ms.replace(mean=mean, weight=w))
        st, _ = mixed_update(state, z, zm, cfg)
        outs.append(st)
    a, b = outs
    np.testing.assert_allclose(np.asarray(a.log_weight),
                               np.asarray(b.log_weight), rtol=2e-4,
                               atol=2e-4)
    for ga, gb in ((a.map_static, b.map_static),
                   (a.map_dynamic, b.map_dynamic)):
        np.testing.assert_allclose(np.asarray(ga.weight),
                                   np.asarray(gb.weight), rtol=2e-4,
                                   atol=2e-4)

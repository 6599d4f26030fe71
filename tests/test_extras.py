"""EAP map, MC variance, and single-feature weighting tests."""

import jax
import jax.numpy as jnp
import numpy as np

from phdslam_tpu.config import SlamConfig
from phdslam_tpu.filters.extras import (eap_expected_map,
                                        mc_variance_candidates)
from phdslam_tpu.types import GMState


def test_eap_expected_map_merges_across_particles():
    cfg = SlamConfig(min_separation=4.0, distance_metric=0)
    P, K = 4, 8
    gm = GMState.empty(P, K, 2)
    # all particles see the same feature at (5, 5) with w=0.9
    mean = np.zeros((P, K, 2), np.float32)
    mean[:, 0] = [5.0, 5.0]
    w = np.zeros((P, K), np.float32)
    w[:, 0] = 0.9
    gm = GMState(mean=jnp.asarray(mean),
                 cov=gm.cov, weight=jnp.asarray(w))
    log_weight = jnp.full((P,), -np.log(P), jnp.float32)
    m, c, wt = eap_expected_map(gm, log_weight, cfg)
    live = np.asarray(wt) > 0
    assert live.sum() == 1
    np.testing.assert_allclose(np.asarray(m)[live][0], [5.0, 5.0], atol=1e-5)
    # total EAP weight = sum_p exp(logw_p) * 0.9 = 0.9
    np.testing.assert_allclose(float(np.asarray(wt)[live][0]), 0.9,
                               rtol=1e-5)


def test_eap_tree_matches_flat_separated():
    """The log2(P)-depth pairwise tree (the reference's device-side
    reduction, phdfilter.cu:3828-3863) must agree with the flat one-pass
    merge when clusters are well separated: same per-site total weight and
    weighted means."""
    from phdslam_tpu.filters.extras import eap_expected_map_flat

    cfg = SlamConfig(min_separation=3.0, distance_metric=0)
    P, K = 16, 8
    rng = np.random.default_rng(2)
    sites = np.array([[5.0, 5.0], [-20.0, 8.0], [12.0, -30.0]])
    mean = np.zeros((P, K, 2), np.float32)
    w = np.zeros((P, K), np.float32)
    for s, site in enumerate(sites):
        mean[:, s] = site + rng.normal(0, 0.05, (P, 2))
        w[:, s] = rng.uniform(0.5, 1.0, P)
    gm = GMState(mean=jnp.asarray(mean),
                 cov=jnp.broadcast_to(
                     jnp.eye(2, dtype=jnp.float32) * 0.2, (P, K, 2, 2)),
                 weight=jnp.asarray(w))
    log_weight = jnp.asarray(
        rng.normal(0, 0.3, P).astype(np.float32))
    log_weight = log_weight - jax.nn.logsumexp(log_weight)

    mt, ct, wt = eap_expected_map(gm, log_weight, cfg)
    mf, cf, wf = eap_expected_map_flat(gm, log_weight, cfg)
    mt, wt, mf, wf = map(np.asarray, (mt, wt, mf, wf))
    assert (wt > 0).sum() == len(sites)
    assert (wf > 0).sum() == len(sites)
    for site in sites:
        it = np.argmin(np.linalg.norm(mt - site, axis=1))
        jf = np.argmin(np.linalg.norm(mf - site, axis=1))
        np.testing.assert_allclose(wt[it], wf[jf], rtol=1e-4)
        np.testing.assert_allclose(mt[it], mf[jf], rtol=1e-4, atol=1e-4)


def test_eap_tree_scales_shapewise():
    """Tree EAP never flattens to [P*K] lanes: its largest merge is
    [P/2, 2K] (the map_estimate=2 at-scale prerequisite)."""
    cfg = SlamConfig(min_separation=2.0)
    P, K = 64, 32
    gm = GMState.empty(P, K, 2)
    rng = np.random.default_rng(0)
    gm = GMState(
        mean=jnp.asarray(rng.normal(0, 20, (P, K, 2)).astype(np.float32)),
        cov=gm.cov,
        weight=jnp.asarray(
            (rng.uniform(0, 1, (P, K)) > 0.5).astype(np.float32) * 0.8))
    lw = jnp.full((P,), -np.log(P), jnp.float32)
    jaxpr = jax.make_jaxpr(
        lambda g, l: eap_expected_map(g, l, cfg))(gm, lw)
    assert f"{P * K},2" not in str(jaxpr.jaxpr).replace(" ", ""), \
        "flat [P*K, 2] merge lanes materialized"
    m, c, w = eap_expected_map(gm, lw, cfg)
    assert np.isfinite(np.asarray(m)).all()
    assert float(jnp.sum(w)) > 0


def test_mc_variance_is_finite_and_positive():
    key = jax.random.PRNGKey(0)
    N = 6
    mean = jnp.asarray(np.random.default_rng(0).normal(0, 5, (N, 2)),
                       jnp.float32)
    cov = jnp.broadcast_to(jnp.eye(2) * 0.5, (N, 2, 2)).astype(jnp.float32)
    w = jnp.asarray([0.5, 0.4, 0.0, 0.8, 0.2, 0.0], jnp.float32)
    v = mc_variance_candidates(mean, cov, w, 2, 32, key)
    assert np.isfinite(float(v))
    assert float(v) > 0


def test_scheme2_weighting_runs_e2e():
    from phdslam_tpu.filters.phd import make_step_fn
    from phdslam_tpu.types import init_state

    cfg = SlamConfig(
        n_particles=8, max_features=16, max_measurements=4, motion_type=0,
        feature_model=0, filter_type=0, particle_weighting=2,
        max_range=20.0, std_range=0.25, std_bearing=0.02, clutter_rate=2.0,
        pd=0.95, birth_weight=0.05, min_separation=2.0,
        resample_threshold=0.3, ax=0.1, ay=0.1, ayaw=0.01, seed=1)
    step = make_step_fn(cfg, donate=False)
    state = init_state(cfg)
    rng = np.random.default_rng(7)
    landmarks = np.array([[5.0, 2.0], [8.0, -3.0]])
    for n in range(8):
        r = np.linalg.norm(landmarks, axis=1) + rng.normal(0, 0.25, 2)
        b = np.arctan2(landmarks[:, 1], landmarks[:, 0]) \
            + rng.normal(0, 0.02, 2)
        z = np.zeros((4, 2), np.float32)
        z[:2] = np.stack([r, b], axis=1)
        mask = np.zeros((4,), bool)
        mask[:2] = True
        state, out = step(state, jnp.asarray(z), jnp.asarray(mask),
                          jnp.zeros((2,), jnp.float32), jnp.float32(0.1),
                          jnp.asarray(n > 0))
    assert np.isfinite(np.asarray(state.log_weight)).all()
    w = np.asarray(state.map_static.weight[0])
    assert (w > 0.4).sum() >= 2


def test_variance_estimator_in_step():
    from phdslam_tpu.filters.phd import make_step_fn
    from phdslam_tpu.types import init_state

    cfg = SlamConfig(
        n_particles=4, max_features=8, max_measurements=4, motion_type=0,
        feature_model=0, filter_type=0, particle_weighting=1,
        compute_variance=True, n_samples=8,
        max_range=20.0, std_range=0.25, std_bearing=0.02, clutter_rate=2.0,
        pd=0.95, birth_weight=0.05, min_separation=2.0,
        resample_threshold=0.3, seed=1)
    step = make_step_fn(cfg, donate=False)
    state = init_state(cfg)
    z = jnp.asarray([[5.0, 0.3], [7.0, -0.4], [0, 0], [0, 0]], jnp.float32)
    mask = jnp.asarray([True, True, False, False])
    for n in range(3):
        state, out = step(state, z, mask, jnp.zeros((2,), jnp.float32),
                          jnp.float32(0.1), jnp.asarray(n > 0))
    v = np.asarray(state.variance)
    assert np.isfinite(v).all()
    assert (v != 0).any()


def test_shotgun_prediction_contracts():
    """n_predict_particles > 1: expanded prediction, contracted state."""
    from phdslam_tpu.filters.phd import make_step_fn
    from phdslam_tpu.types import init_state

    cfg = SlamConfig(
        n_particles=8, n_predict_particles=3, max_features=16,
        max_measurements=4, motion_type=0, feature_model=0, filter_type=0,
        particle_weighting=1, max_range=20.0, std_range=0.25,
        std_bearing=0.02, clutter_rate=2.0, pd=0.95, birth_weight=0.05,
        min_separation=2.0, resample_threshold=0.3, ax=0.2, ay=0.2,
        ayaw=0.02, seed=1)
    step = make_step_fn(cfg, donate=False)
    state = init_state(cfg)
    z = jnp.asarray([[5.0, 0.3], [7.0, -0.4], [0, 0], [0, 0]], jnp.float32)
    mask = jnp.asarray([True, True, False, False])
    for n in range(4):
        state, out = step(state, z, mask, jnp.zeros((2,), jnp.float32),
                          jnp.float32(0.1), jnp.asarray(n > 0))
    # state stays at the base particle count
    assert state.pose.shape[0] == 8
    assert out.poses.shape[0] == 8
    assert np.isfinite(np.asarray(state.log_weight)).all()
    np.testing.assert_allclose(np.asarray(state.log_weight), -np.log(8),
                               rtol=1e-5)


def test_eap_extraction_in_step():
    """map_estimate=2 -> step outputs the EAP merged map."""
    from phdslam_tpu.filters.phd import make_step_fn
    from phdslam_tpu.types import init_state

    cfg = SlamConfig(
        n_particles=8, max_features=16, max_measurements=4, motion_type=0,
        feature_model=0, filter_type=0, particle_weighting=0,
        map_estimate=2, max_range=20.0, std_range=0.25, std_bearing=0.02,
        clutter_rate=1.0, pd=0.95, birth_weight=0.05, min_separation=2.0,
        resample_threshold=0.3, seed=1)
    step = make_step_fn(cfg, donate=False)
    state = init_state(cfg)
    z = jnp.asarray([[5.0, 0.3], [7.0, -0.4], [0, 0], [0, 0]], jnp.float32)
    mask = jnp.asarray([True, True, False, False])
    for n in range(6):
        state, out = step(state, z, mask, jnp.zeros((2,), jnp.float32),
                          jnp.float32(0.1), jnp.asarray(n > 0))
    w = np.asarray(out.map_weight)
    # EAP merges across particles: the two persistent landmarks should carry
    # weight ~1 each (summed across all particles scaled by particle weight)
    assert (w > 0.5).sum() >= 2
    assert np.isfinite(np.asarray(out.map_mean)).all()


def test_eap_cadence_knob():
    """cfg.eap_every = N: EAP tree on step % N == 0, MAP extraction in
    between (amortizes the tree's cost to ~1/N per step)."""
    from phdslam_tpu.filters.phd import make_step_fn
    from phdslam_tpu.types import init_state

    base = dict(
        n_particles=8, max_features=16, max_measurements=4, motion_type=0,
        feature_model=0, filter_type=0, particle_weighting=0,
        map_estimate=2, max_range=20.0, std_range=0.25, std_bearing=0.02,
        clutter_rate=1.0, pd=0.95, birth_weight=0.05, min_separation=2.0,
        resample_threshold=0.3, seed=1)
    cfg_every = SlamConfig(**base, eap_every=3)
    cfg_ref = SlamConfig(**base)
    cfg_map = SlamConfig(**{**base, "map_estimate": 1})
    z = jnp.asarray([[5.0, 0.3], [7.0, -0.4], [0, 0], [0, 0]], jnp.float32)
    mask = jnp.asarray([True, True, False, False])

    outs = {}
    for name, cfg in (("every", cfg_every), ("ref", cfg_ref),
                      ("map", cfg_map)):
        step = make_step_fn(cfg, donate=False)
        state = init_state(cfg)
        per_step = []
        for n in range(7):
            state, out = step(state, z, mask, jnp.zeros((2,), jnp.float32),
                              jnp.float32(0.1), jnp.asarray(n > 0))
            per_step.append(np.asarray(out.map_weight))
        outs[name] = per_step

    # EAP steps (state.step % 3 == 0 at extraction: steps 0, 3, 6) match the
    # every-step-EAP run exactly (same filter trajectory, deterministic keys)
    for n in (0, 3, 6):
        np.testing.assert_allclose(outs["every"][n], outs["ref"][n],
                                   rtol=1e-6)
    # in-between steps fall back to MAP extraction — bit-identical to a
    # map_estimate=1 run (identical filter trajectory either way)
    for n in (1, 2, 4, 5):
        np.testing.assert_allclose(outs["every"][n], outs["map"][n],
                                   rtol=1e-6)


def test_eap_tree_dropped_mass_diagnostic():
    """return_dropped counts clusters truncated by capacity; eap_tree_cap
    widens the intermediate levels so the tree keeps the GLOBAL
    top-out_cap mass instead of per-pair truncations (advisor finding: the
    reference's ragged tree never truncates mid-level)."""
    cfg = SlamConfig(min_separation=0.5, distance_metric=0)
    P, K = 8, 8
    rng = np.random.default_rng(5)
    # every particle contributes K well-separated distinct clusters with
    # distinct weights -> each pair merge holds 2K live clusters, over the
    # K intermediate cap; mid-level truncation drops per-PAIR lightest
    # clusters even when they are globally heavy
    mean = rng.uniform(-200, 200, (P, K, 2)).astype(np.float32)
    weight = rng.uniform(0.1, 1.0, (P, K)).astype(np.float32)
    gm = GMState(
        mean=jnp.asarray(mean),
        cov=jnp.broadcast_to(jnp.eye(2, dtype=jnp.float32) * 0.01,
                             (P, K, 2, 2)),
        weight=jnp.asarray(weight))
    lw = jnp.full((P,), -np.log(P), jnp.float32)
    out_cap = 2 * K
    m, c, w, dropped = eap_expected_map(gm, lw, cfg, out_cap=out_cap,
                                        return_dropped=True)
    assert int(dropped) > 0

    cfg_wide = SlamConfig(min_separation=0.5, distance_metric=0,
                          eap_tree_cap=P * K)
    m2, c2, w2, dropped2 = eap_expected_map(gm, lw, cfg_wide,
                                            out_cap=out_cap,
                                            return_dropped=True)
    # the wide tree keeps the global top-out_cap by weight: strictly more
    # retained mass than the per-pair-truncated narrow tree
    assert float(jnp.sum(w2)) > float(jnp.sum(w))
    np.testing.assert_allclose(
        float(jnp.sum(w2)),
        np.sort(weight.reshape(-1) / P)[-out_cap:].sum(), rtol=1e-4)

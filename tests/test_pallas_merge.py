"""Greedy-merge kernel (ops/pallas_merge.py, interpret mode on CPU) vs the
XLA while_loop reference, plus the dispatch around it."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from phdslam_tpu.ops.gm_merge import gm_merge_batch, pack_planes
from phdslam_tpu.ops.pallas_merge import gm_merge_pallas


def gm_merge_pallas_batch(mean, cov, weight, active, min_separation,
                          out_cap, metric=0, sorted_w=False, r_par=8):
    """The kernel on array-form inputs, as gm_merge_batch takes them."""
    return gm_merge_pallas(pack_planes(mean, cov, weight, active),
                           mean.shape[-1], min_separation, out_cap,
                           metric=metric, sorted_w=sorted_w, r_par=r_par,
                           interpret=True)


def assert_same_merge(got, ref, cov_atol=1e-4):
    """Same clusters in the same (greedy weight) order."""
    np.testing.assert_allclose(np.asarray(got[2]), np.asarray(ref[2]),
                               rtol=1e-4, atol=1e-6)  # weights
    np.testing.assert_allclose(np.asarray(got[0]), np.asarray(ref[0]),
                               rtol=1e-4, atol=1e-4)  # means
    np.testing.assert_allclose(np.asarray(got[1]), np.asarray(ref[1]),
                               rtol=1e-3, atol=cov_atol)  # covs
    np.testing.assert_array_equal(np.asarray(got[3]), np.asarray(ref[3]))
    np.testing.assert_array_equal(np.asarray(got[4]), np.asarray(ref[4]))


def random_case(P, N, K, seed, cluster=True):
    rng = np.random.default_rng(seed)
    if cluster:
        # clustered candidates so merging actually happens
        centers = rng.normal(0, 20, (P, 8, 2))
        idx = rng.integers(0, 8, (P, N))
        mean = centers[np.arange(P)[:, None], idx] + rng.normal(0, 0.3,
                                                                (P, N, 2))
    else:
        mean = rng.normal(0, 20, (P, N, 2))
    A = rng.normal(0, 0.5, (P, N, 2, 2))
    cov = np.einsum("pnij,pnkj->pnik", A, A)  # A A^T: symmetric PSD
    cov += np.eye(2) * 0.3
    w = rng.uniform(0, 1, (P, N)).astype(np.float32)
    act = rng.random((P, N)) < 0.7
    return (jnp.asarray(mean, jnp.float32), jnp.asarray(cov, jnp.float32),
            jnp.asarray(w), jnp.asarray(act))


def sort_prefix(mean, cov, w, act):
    """Active lanes as a weight-DESCENDING prefix, as top-cap callers emit
    them."""
    order = jnp.argsort(jnp.where(act, -w, 1.0), axis=-1)
    mean_s = jnp.take_along_axis(mean, order[..., None], axis=1)
    cov_s = jnp.take_along_axis(cov, order[..., None, None], axis=1)
    act_s = jnp.take_along_axis(act, order, axis=1)
    w_s = jnp.where(act_s, jnp.take_along_axis(w, order, axis=1), 0.0)
    return mean_s, cov_s, w_s, act_s


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("cluster", [True, False])
def test_pallas_merge_matches_xla(seed, cluster):
    P, N, K = 4, 64, 16
    mean, cov, w, act = random_case(P, N, K, seed, cluster)
    ref = gm_merge_batch(mean, cov, w, act, 4.0, K, 0)
    got = gm_merge_pallas_batch(mean, cov, w, act, 4.0, K)
    assert_same_merge(got, ref)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pallas_merge_sorted_w_matches_xla(seed):
    """sorted_w=True (cumsum principal pick) on weight-DESCENDING active
    prefixes must match the XLA reference exactly like the argmax path."""
    P, N, K = 4, 64, 16
    mean_s, cov_s, w_s, act_s = sort_prefix(
        *random_case(P, N, K, seed, cluster=True))
    ref = gm_merge_batch(mean_s, cov_s, w_s, act_s, 4.0, K, 0)
    got = gm_merge_pallas_batch(mean_s, cov_s, w_s, act_s, 4.0, K,
                                sorted_w=True)
    assert_same_merge(got, ref)


def test_pallas_merge_overflow_counts():
    # more clusters than capacity -> dropped leftovers reported
    P, N, K = 2, 64, 4
    rng = np.random.default_rng(3)
    mean = jnp.asarray(rng.normal(0, 100, (P, N, 2)), jnp.float32)  # spread
    cov = jnp.broadcast_to(jnp.eye(2) * 0.1, (P, N, 2, 2)).astype(jnp.float32)
    w = jnp.asarray(rng.uniform(0.1, 1, (P, N)), jnp.float32)
    act = jnp.ones((P, N), bool)
    ref = gm_merge_batch(mean, cov, w, act, 4.0, K, 0)
    got = gm_merge_pallas_batch(mean, cov, w, act, 4.0, K)
    assert int(got[4][0]) == int(ref[4][0]) > 0


def test_filter_step_with_pallas_merge_matches():
    """Full filter step: merge kernel (interpret) vs XLA merge."""
    from phdslam_tpu.config import SlamConfig
    from phdslam_tpu.filters.phd import make_step_fn
    from phdslam_tpu.types import init_state

    base = dict(n_particles=8, max_features=16, max_measurements=4,
                motion_type=0, feature_model=0, filter_type=0,
                particle_weighting=1, max_range=20.0, std_range=0.25,
                std_bearing=0.02, clutter_rate=2.0, pd=0.95,
                birth_weight=0.05, min_separation=2.0,
                resample_threshold=0.3, seed=1)
    z = jnp.asarray([[5.0, 0.3], [7.0, -0.4], [0, 0], [0, 0]], jnp.float32)
    mask = jnp.asarray([True, True, False, False])

    results = []
    for pm in (0, 2):
        from phdslam_tpu.config import SlamConfig
        cfg = SlamConfig(**base, pallas_merge=pm)
        step = make_step_fn(cfg, donate=False)
        state = init_state(cfg)
        for n in range(5):
            state, out = step(state, z, mask, jnp.zeros((2,), jnp.float32),
                              jnp.float32(0.1), jnp.asarray(n > 0))
        results.append((np.asarray(state.map_static.weight),
                        np.asarray(state.log_weight),
                        np.asarray(out.expected_pose)))
    np.testing.assert_allclose(results[0][0], results[1][0], rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_allclose(results[0][1], results[1][1], rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(results[0][2], results[1][2], rtol=1e-4,
                               atol=1e-5)


def random_case_3d(P, N, seed):
    rng = np.random.default_rng(seed)
    centers = rng.normal(0, 25, (P, 8, 3))
    idx = rng.integers(0, 8, (P, N))
    mean = centers[np.arange(P)[:, None], idx] + rng.normal(0, 0.4,
                                                            (P, N, 3))
    A = rng.normal(0, 0.5, (P, N, 3, 3))
    cov = np.einsum("pnij,pnkj->pnik", A, A) + np.eye(3) * 0.3
    w = rng.uniform(0, 1, (P, N)).astype(np.float32)
    act = rng.random((P, N)) < 0.7
    return (jnp.asarray(mean, jnp.float32), jnp.asarray(cov, jnp.float32),
            jnp.asarray(w), jnp.asarray(act))


@pytest.mark.parametrize("seed", [0, 1])
def test_pallas_merge_3d_matches_xla(seed):
    """D=3 kernel (disparity features) vs the generic XLA merge."""
    P, N, K = 4, 64, 16
    mean, cov, w, act = random_case_3d(P, N, seed)
    ref = gm_merge_batch(mean, cov, w, act, 4.0, K, 0)
    got = gm_merge_pallas_batch(mean, cov, w, act, 4.0, K)
    assert_same_merge(got, ref)


def random_case_nd(P, N, D, seed):
    rng = np.random.default_rng(seed)
    centers = rng.normal(0, 25, (P, 8, D))
    idx = rng.integers(0, 8, (P, N))
    mean = centers[np.arange(P)[:, None], idx] + rng.normal(0, 0.4,
                                                            (P, N, D))
    A = rng.normal(0, 0.5, (P, N, D, D))
    cov = np.einsum("pnij,pnkj->pnik", A, A) + np.eye(D) * 0.3
    w = rng.uniform(0, 1, (P, N)).astype(np.float32)
    act = rng.random((P, N)) < 0.7
    return (jnp.asarray(mean, jnp.float32), jnp.asarray(cov, jnp.float32),
            jnp.asarray(w), jnp.asarray(act))


@pytest.mark.parametrize("seed", [0, 1])
def test_pallas_merge_4d_matches_xla(seed):
    """D=4 kernel (dynamic CV features) vs the generic XLA merge."""
    P, N, K = 4, 64, 16
    mean, cov, w, act = random_case_nd(P, N, 4, seed)
    ref = gm_merge_batch(mean, cov, w, act, 4.0, K, 0)
    got = gm_merge_pallas_batch(mean, cov, w, act, 4.0, K)
    assert_same_merge(got, ref, cov_atol=2e-4)


@pytest.mark.parametrize("seed", [0, 1])
def test_pallas_merge_hellinger_matches_xla(seed):
    """Hellinger metric in the D=2 kernel vs the XLA merge."""
    P, N, K = 4, 64, 16
    mean, cov, w, act = random_case(P, N, K, seed, cluster=True)
    ref = gm_merge_batch(mean, cov, w, act, 0.6, K, 1)
    got = gm_merge_pallas_batch(mean, cov, w, act, 0.6, K, metric=1)
    assert_same_merge(got, ref)


def test_merge_terminates_on_nan_weights():
    """A NaN/non-positive active weight must not hang the while_loop (the
    per-particle counter only advances on emission; stalled rows drop)."""
    P, N, K = 2, 64, 16
    mean, cov, w, act = random_case(P, N, K, 0)
    w = np.array(w, copy=True)
    w[0, :] = np.nan          # whole particle NaN
    w[1, :8] = 0.0            # some zero-weight active lanes
    out = gm_merge_pallas_batch(jnp.asarray(mean), jnp.asarray(cov),
                                jnp.asarray(w), jnp.asarray(act), 4.0, K)
    # it RETURNED (no hang); the healthy particle still merged
    assert int(out[3][1]) > 0


def test_width_switch_covers_non_tile_widths():
    """merge_batch_dispatch's lax.switch must include the FULL width as a
    branch even when N is not a power of two."""
    from phdslam_tpu.config import SlamConfig
    from phdslam_tpu.ops.gm_merge import gm_merge_batch, merge_batch_dispatch
    cfg = SlamConfig(min_separation=4.0, distance_metric=0, pallas_merge=2)
    P, N, K = 2, 300, 16                   # N = 300: not a power of two
    mean, cov, w, act = random_case(P, N, K, 1)
    mean, cov, w = mean[:, :N], cov[:, :N], w[:, :N]
    act = jnp.ones((P, N), bool)           # live everywhere -> needs full N
    # honor the sorted_prefix contract: active lanes in DESCENDING weight
    # order (the kernel's cumsum principal pick now relies on it)
    order = jnp.argsort(-w, axis=-1)
    mean = jnp.take_along_axis(mean, order[..., None], axis=1)
    cov = jnp.take_along_axis(cov, order[..., None, None], axis=1)
    w = jnp.take_along_axis(w, order, axis=1)
    ref = gm_merge_batch(mean, cov, w, act, 4.0, K, 0)
    got = merge_batch_dispatch(mean, cov, w, act, cfg, K,
                               sorted_prefix=True)
    np.testing.assert_array_equal(np.asarray(got[3]), np.asarray(ref[3]))
    np.testing.assert_allclose(np.asarray(got[2]), np.asarray(ref[2]),
                               rtol=1e-4, atol=1e-6)


def test_uncompacted_layout_not_width_switched():
    """With merge_candidate_cap >= the full lane count, compact_candidates
    returns the ORIGINAL (unsorted) layout; the update must not claim
    sorted_prefix and silently slice off scattered active lanes."""
    import copy

    from phdslam_tpu.filters.phd import _batched_update
    from tests.test_selection_pipeline import make_cfg, random_batch

    cfg = make_cfg(detection_topk=0, merge_candidate_cap=10 ** 6,
                   pallas_merge=2)
    cfg0 = copy.deepcopy(cfg)
    cfg0.pallas_merge = 0                 # XLA reference path
    pose, mean, cov, w, z, zm = random_batch(5)
    out_a = _batched_update(pose, mean, cov, w, z, zm, cfg)
    out_b = _batched_update(pose, mean, cov, w, z, zm, cfg0)
    for a, b in zip(out_a, out_b):
        np.testing.assert_allclose(np.asarray(a, np.float32),
                                   np.asarray(b, np.float32),
                                   rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("block", [4, 32])
def test_merge_block_size_equivalent(block):
    """One program per particle: a particle's merge is bit-identical
    whether it runs alone or inside a batch of ``block`` particles."""
    mean, cov, w, act = sort_prefix(*random_case(block, 64, 16, seed=9))
    batch = gm_merge_pallas_batch(mean, cov, w, act, 4.0, 16, sorted_w=True)
    for p in (0, block - 1):
        alone = gm_merge_pallas_batch(mean[p:p + 1], cov[p:p + 1],
                                      w[p:p + 1], act[p:p + 1], 4.0, 16,
                                      sorted_w=True)
        for a, b in zip(alone, batch):
            np.testing.assert_array_equal(np.asarray(a[0]),
                                          np.asarray(b[p]))


@pytest.mark.parametrize("N", [384, 768, 1536])
def test_pow2_lane_padding_is_exact(N):
    """Lane widths that are not powers of two are padded with inactive
    lanes inside the kernel wrapper: the output equals both the kernel on
    an explicitly padded input and the XLA reference."""
    P, K = 2, 32
    mean, cov, w, act = random_case(P, N, K, seed=N)
    ref = gm_merge_batch(mean, cov, w, act, 4.0, K, 0)
    got = gm_merge_pallas_batch(mean, cov, w, act, 4.0, K)
    pad = 1 << (N - 1).bit_length()
    padded = gm_merge_pallas_batch(
        jnp.pad(mean, ((0, 0), (0, pad - N), (0, 0))),
        jnp.concatenate([cov, jnp.broadcast_to(
            jnp.eye(2, dtype=cov.dtype), (P, pad - N, 2, 2))], axis=1),
        jnp.pad(w, ((0, 0), (0, pad - N))),
        jnp.pad(act, ((0, 0), (0, pad - N))), 4.0, K)
    for a, b in zip(got, padded):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert_same_merge(got, ref)


@pytest.mark.parametrize("P", [1, 3, 7])
def test_odd_particle_counts(P):
    """Particle counts that are not a power of two (or a block multiple)
    merge exactly like the reference."""
    mean, cov, w, act = random_case(P, 64, 16, seed=P)
    ref = gm_merge_batch(mean, cov, w, act, 4.0, 16, 0)
    got = gm_merge_pallas_batch(mean, cov, w, act, 4.0, 16)
    assert_same_merge(got, ref)


@pytest.mark.parametrize("pallas_merge,platform,route", [
    (0, "gpu", "xla"),
    (1, "cpu", "xla"),
    (1, "gpu", "kernel"),
    (2, "cpu", "interpret"),
    (2, "gpu", "interpret"),
])
def test_merge_route_by_platform(monkeypatch, pallas_merge, platform,
                                 route):
    """The knob resolves against the platform: the compiled kernel only on
    a GPU, interpret mode only when forced, the XLA loop otherwise."""
    from phdslam_tpu.config import SlamConfig
    from phdslam_tpu.ops.gm_merge import merge_route
    monkeypatch.setattr(jax, "default_backend", lambda: platform)
    assert merge_route(SlamConfig(pallas_merge=pallas_merge)) == route


@pytest.mark.parametrize("n", [64, 300, 512, 1536])
def test_switch_widths(n):
    """Width-switch branches: increasing powers of two from n/4, ending
    with n itself, so every live count has a branch that holds it."""
    from phdslam_tpu.ops.gm_merge import switch_widths
    widths = switch_widths(n)
    assert widths[-1] == n
    assert widths == sorted(set(widths))
    assert all(w & (w - 1) == 0 and w >= n // 4 for w in widths[:-1])


def test_pack_unpack_roundtrip():
    from phdslam_tpu.ops.gm_merge import unpack_planes
    mean, cov, w, act = random_case_nd(3, 20, 4, seed=2)
    packed = pack_planes(mean, cov, w, act)
    assert packed.shape == (3, 2 + 4 + 10, 20)
    for a, b in zip(unpack_planes(packed, 4), (mean, cov, w, act)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.gpu
@pytest.mark.parametrize("D,metric", [(2, 0), (2, 1), (3, 0), (4, 0)])
def test_kernel_compiled_on_gpu_matches_xla(gpu_device, D, metric):
    """The kernel compiled for the card (no interpret mode) vs the XLA
    reference; skips without a CUDA GPU (run by chip_smoke.py)."""
    mean, cov, w, act = sort_prefix(*random_case_nd(8, 300, D, seed=D))
    sep = 0.6 if metric else 4.0
    ref = gm_merge_batch(mean, cov, w, act, sep, 32, metric)
    got = gm_merge_pallas(pack_planes(mean, cov, w, act), D, sep, 32,
                          metric=metric, sorted_w=True)
    assert_same_merge(got, ref, cov_atol=2e-4)

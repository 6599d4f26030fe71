"""CPHD filter tests: log-domain combinatorics vs brute-force NumPy oracles,
and an end-to-end smoke run.

Oracle formulas are written directly from Vo's analytic CPHD construction
(the reference's functional spec, phdfilter.cu.bak §3.5 of SURVEY.md), in
linear-domain float64 with itertools combinatorics — structurally independent
from the jax implementation.
"""

import itertools
import math

import jax.numpy as jnp
import numpy as np
import pytest

from phdslam_tpu.config import SlamConfig
from phdslam_tpu.filters.cphd import (binomial_birth_cardinality,
                                      cardinality_predict, cphd_constants,
                                      log_esf, log_esf_omit, psi_terms)
from phdslam_tpu.ops.math import LOG0


def esf_bruteforce(vals):
    """e_k via sum over k-subsets of products."""
    M = len(vals)
    out = np.zeros(M + 1)
    out[0] = 1.0
    for k in range(1, M + 1):
        out[k] = sum(np.prod(c) for c in itertools.combinations(vals, k))
    return out


def test_log_esf_matches_bruteforce():
    vals = np.array([0.5, 2.0, 1.5, 0.25], np.float64)
    ll = jnp.log(jnp.asarray(vals, jnp.float32))
    mask = jnp.ones((4,), bool)
    e = np.exp(np.asarray(log_esf(ll, mask), np.float64))
    np.testing.assert_allclose(e, esf_bruteforce(vals), rtol=1e-5)


def test_log_esf_masked():
    vals = np.array([0.5, 2.0, 1.5, 0.25], np.float64)
    ll = jnp.log(jnp.asarray(vals, jnp.float32))
    mask = jnp.asarray([True, False, True, False])
    e = np.exp(np.asarray(log_esf(ll, mask), np.float64))
    expect = esf_bruteforce(vals[[0, 2]])
    np.testing.assert_allclose(e[:3], expect, rtol=1e-5)
    assert (e[3:] < 1e-20).all()


def test_log_esf_omit():
    vals = np.array([0.5, 2.0, 1.5], np.float64)
    ll = jnp.log(jnp.asarray(vals, jnp.float32))
    mask = jnp.ones((3,), bool)
    esfd = np.exp(np.asarray(log_esf_omit(ll, mask), np.float64))
    for m in range(3):
        keep = np.delete(vals, m)
        np.testing.assert_allclose(esfd[m], esf_bruteforce(keep), rtol=1e-5)


def test_binomial_birth_cardinality():
    cn = np.exp(np.asarray(binomial_birth_cardinality(3, 0.25, 8),
                           np.float64))
    from scipy.stats import binom  # noqa: F401 — not in image? fallback below
    # manual binomial pmf
    expect = np.zeros(9)
    for k in range(4):
        expect[k] = math.comb(3, k) * 0.25 ** k * 0.75 ** (3 - k)
    np.testing.assert_allclose(cn[:4], expect[:4], rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(cn.sum(), 1.0, rtol=1e-5)


def test_cardinality_predict_is_convolution():
    rng = np.random.default_rng(0)
    a = rng.random(6); a /= a.sum()
    b = rng.random(6); b /= b.sum()
    log_pred = np.asarray(cardinality_predict(
        jnp.log(jnp.asarray(a, jnp.float32)),
        jnp.log(jnp.asarray(b, jnp.float32))), np.float64)
    expect = np.convolve(a, b)[:6]
    np.testing.assert_allclose(np.exp(log_pred), expect, rtol=1e-4)


def psi_oracle(lam, cn_clutter_rate, cn_predict, ip_qdw, wsum, C):
    """Brute-force Upsilon^0/Upsilon^1 (Vo's analytic CPHD) in float64."""
    M = len(lam)
    esf = esf_bruteforce(lam)
    pk = [math.exp(-cn_clutter_rate) * cn_clutter_rate ** k / math.factorial(k)
          for k in range(C + 1)]
    psi0 = np.zeros(C + 1)
    psi1 = np.zeros(C + 1)
    for n in range(C + 1):
        for j in range(0, min(n, M) + 1):
            perm = math.factorial(n) / math.factorial(n - j)
            common = math.factorial(M - j) * pk[M - j] * esf[j] \
                * ip_qdw ** (n - j) / wsum ** n
            psi0[n] += perm * common
            if j + 1 <= n:
                perm1 = math.factorial(n) / math.factorial(n - j - 1)
                common1 = math.factorial(M - j) * pk[M - j] * esf[j] \
                    * ip_qdw ** (n - j - 1) / wsum ** n
                psi1[n] += perm1 * common1
    ip0 = float(np.dot(psi0, cn_predict))
    ip1 = float(np.dot(psi1, cn_predict))
    return psi0, ip0, ip1


def test_psi_terms_vs_oracle():
    cfg = SlamConfig(max_cardinality=12, clutter_rate=2.0, max_range=10.0,
                     max_bearing=np.pi)
    consts = cphd_constants(cfg)
    lam = np.array([1.2, 0.7, 2.5], np.float64)
    M = 3
    ip_qdw, wsum = 0.8, 2.0
    # Poisson(1.5) predicted cardinality, truncated
    cn = np.array([math.exp(-1.5) * 1.5 ** n / math.factorial(n)
                   for n in range(13)])

    ll = jnp.log(jnp.asarray(lam, jnp.float32))
    zm = jnp.ones((M,), bool)
    esf_full = log_esf(ll, zm)
    esfd = log_esf_omit(ll, zm)
    log_psi0, ip0, ip1, ip1d = psi_terms(
        consts, esf_full, esfd, jnp.log(jnp.asarray(cn, jnp.float32)),
        jnp.float32(np.log(ip_qdw)), jnp.float32(np.log(wsum)), M, zm)

    o_psi0, o_ip0, o_ip1 = psi_oracle(lam, cfg.clutter_rate, cn, ip_qdw,
                                      wsum, 12)
    got_psi0 = np.exp(np.asarray(log_psi0, np.float64))
    np.testing.assert_allclose(got_psi0, o_psi0, rtol=2e-3)
    np.testing.assert_allclose(np.exp(float(ip0)), o_ip0, rtol=2e-3)
    np.testing.assert_allclose(np.exp(float(ip1)), o_ip1, rtol=2e-3)

    # psi1d oracle: psi1 with measurement m removed and clutter order M-1
    for m in range(M):
        keep = np.delete(lam, m)
        esf_d = esf_bruteforce(keep)
        psi1d = np.zeros(13)
        for n in range(13):
            for j in range(0, min(n, M - 1) + 1):
                if j + 1 <= n:
                    perm1 = math.factorial(n) / math.factorial(n - j - 1)
                    pk = math.exp(-2.0) * 2.0 ** (M - 1 - j) \
                        / math.factorial(M - 1 - j)
                    psi1d[n] += perm1 * math.factorial(M - 1 - j) * pk \
                        * esf_d[j] * ip_qdw ** (n - j - 1) / wsum ** n
        expect = float(np.dot(psi1d, cn))
        np.testing.assert_allclose(np.exp(float(ip1d[m])), expect, rtol=2e-3)


def test_cphd_e2e_smoke():
    """Short CPHD run on synthetic data: finite weights, sane cardinality."""
    from phdslam_tpu.filters.phd import make_step_fn
    from phdslam_tpu.types import init_state

    cfg = SlamConfig(
        n_particles=8, max_features=16, max_measurements=4,
        motion_type=0, feature_model=0, filter_type=1, max_cardinality=32,
        max_range=20.0, std_range=0.25, std_bearing=0.02, clutter_rate=2.0,
        pd=0.95, birth_weight=0.05, min_separation=2.0,
        resample_threshold=0.3, ax=0.1, ay=0.1, ayaw=0.01, seed=1)
    step = make_step_fn(cfg, donate=False)
    state = init_state(cfg)
    rng = np.random.default_rng(7)
    landmarks = np.array([[5.0, 2.0], [8.0, -3.0], [3.0, 6.0]])
    for n in range(10):
        # noisy measurements of fixed landmarks from the origin
        r = np.linalg.norm(landmarks, axis=1) + rng.normal(0, 0.25, 3)
        b = np.arctan2(landmarks[:, 1], landmarks[:, 0]) \
            + rng.normal(0, 0.02, 3)
        z = np.zeros((4, 2), np.float32)
        z[:3] = np.stack([r, b], axis=1)
        mask = np.zeros((4,), bool)
        mask[:3] = True
        state, out = step(state, jnp.asarray(z), jnp.asarray(mask),
                          jnp.zeros((2,), jnp.float32), jnp.float32(0.1),
                          jnp.asarray(n > 0))
    assert np.isfinite(float(out.n_eff))
    assert np.isfinite(np.asarray(state.log_weight)).all()
    cn = np.exp(np.asarray(state.cardinality))
    np.testing.assert_allclose(cn.sum(axis=1), 1.0, rtol=1e-3)
    # cardinality mass should concentrate near the true landmark count (3)
    mean_card = (cn * np.arange(cn.shape[1])).sum(axis=1).mean()
    assert 1.0 <= mean_card <= 8.0
    # the map should contain >= 3 significant components
    w = np.asarray(state.map_static.weight)
    assert (w[0] > 0.4).sum() >= 3


def test_cphd_det_kernel_route_matches_grid_route():
    """The CPHD fast path with the merge kernel (interpret mode) must
    reproduce it with the XLA while_loop merge: same maps, cardinalities
    and particle weights (phdfilter.cu.bak:1058-1479)."""
    import dataclasses

    from phdslam_tpu.filters.cphd import cphd_constants, cphd_update
    from phdslam_tpu.types import init_state

    cfg = SlamConfig(
        n_particles=6, max_features=16, max_measurements=6,
        motion_type=0, feature_model=0, filter_type=1, max_cardinality=24,
        max_range=20.0, std_range=0.25, std_bearing=0.02, clutter_rate=2.0,
        pd=0.95, birth_weight=0.05, min_separation=2.0,
        merge_candidate_cap=48, detection_topk=8,
        resample_threshold=0.3, seed=1, pallas_merge=2)
    rng = np.random.default_rng(3)
    state = init_state(cfg)
    K, P = cfg.max_features, cfg.n_particles
    mean = np.zeros((P, K, 2), np.float32)
    w = np.zeros((P, K), np.float32)
    mean[:, :4] = np.array([[5, 1], [8, -2], [3, 4], [6, 6]], np.float32) \
        + rng.normal(0, 0.05, (P, 4, 2))
    w[:, :4] = rng.uniform(0.4, 1.0, (P, 4))
    state = state.replace(
        pose=jnp.asarray(rng.normal(0, 0.2, (P, 6)).astype(np.float32)),
        map_static=state.map_static.replace(
            mean=jnp.asarray(mean), weight=jnp.asarray(w)),
        log_weight=jnp.asarray(
            rng.normal(0, 0.2, (P,)).astype(np.float32)))

    z = np.zeros((6, 2), np.float32)
    z[:5] = [[5.1, 0.19], [8.2, -0.24], [5.0, 0.92], [8.5, 0.78],
             [4.0, -1.0]]
    zm = np.zeros((6,), bool)
    zm[:5] = True
    z, zm = jnp.asarray(z), jnp.asarray(zm)
    consts = cphd_constants(cfg)

    st_k, ovf_k = cphd_update(state, z, zm, consts, cfg)
    cfg_g = dataclasses.replace(cfg, pallas_merge=0)
    st_g, ovf_g = cphd_update(state, z, zm, consts, cfg_g)

    np.testing.assert_allclose(np.asarray(st_k.log_weight),
                               np.asarray(st_g.log_weight),
                               rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(np.asarray(st_k.cardinality),
                               np.asarray(st_g.cardinality),
                               rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(np.asarray(st_k.map_static.weight),
                               np.asarray(st_g.map_static.weight),
                               rtol=2e-4, atol=2e-5)
    live = np.asarray(st_g.map_static.weight) > 1e-6
    np.testing.assert_allclose(
        np.asarray(st_k.map_static.mean)[live],
        np.asarray(st_g.map_static.mean)[live], rtol=2e-4, atol=2e-4)


def test_gated_births_suppress_compatible_measurements():
    """gate_births=True (birthsKernel .bak:750 + compatibleZ :1695): a
    measurement within gate_threshold of an existing in-range feature does
    NOT birth; an incompatible one does. The birth-cardinality binomial
    uses the gated count."""
    import dataclasses

    from phdslam_tpu.filters.cphd import cphd_constants, cphd_update
    from phdslam_tpu.types import init_state

    cfg = SlamConfig(
        n_particles=2, max_features=16, max_measurements=4,
        motion_type=0, feature_model=0, filter_type=1, max_cardinality=16,
        max_range=20.0, std_range=0.25, std_bearing=0.02, clutter_rate=2.0,
        pd=0.95, birth_weight=0.05, min_separation=2.0,
        merge_candidate_cap=32, detection_topk=4,
        resample_threshold=0.3, seed=1, gate_births=True)
    state = init_state(cfg)
    K, P = cfg.max_features, cfg.n_particles
    mean = np.zeros((P, K, 2), np.float32)
    w = np.zeros((P, K), np.float32)
    mean[:, 0] = [5.0, 0.0]                 # one live feature straight ahead
    w[:, 0] = 0.9
    state = state.replace(map_static=state.map_static.replace(
        mean=jnp.asarray(mean), weight=jnp.asarray(w)))

    z = np.zeros((4, 2), np.float32)
    z[0] = [5.0, 0.0]                       # right on the feature: gated out
    z[1] = [12.0, 1.2]                      # far away: births
    zm = np.zeros((4,), bool)
    zm[:2] = True
    z, zm = jnp.asarray(z), jnp.asarray(zm)
    consts = cphd_constants(cfg)

    st_g, _ = cphd_update(state, z, zm, consts, cfg)
    st_u, _ = cphd_update(state, z, zm, consts,
                          dataclasses.replace(cfg, gate_births=False))

    n_live_g = int((np.asarray(st_g.map_static.weight[0]) > 0).sum())
    n_live_u = int((np.asarray(st_u.map_static.weight[0]) > 0).sum())
    assert n_live_u == n_live_g + 1, (n_live_g, n_live_u)
    # the far measurement's birth is present in both
    mg = np.asarray(st_g.map_static.mean[0])
    wg = np.asarray(st_g.map_static.weight[0])
    far = np.array([12.0 * np.cos(1.2), 12.0 * np.sin(1.2)])
    d = np.linalg.norm(mg[wg > 0] - far, axis=1)
    assert d.min() < 0.5, (mg[wg > 0], far)
    # gated binomial: mass at birth-count 1 vs 2 — the gated cardinality
    # must differ from the ungated one
    assert not np.allclose(np.asarray(st_g.cardinality),
                           np.asarray(st_u.cardinality), atol=1e-6)


def test_cardinality_predict_batch_matches_per_particle():
    """The linear-domain Toeplitz-matmul convolution (matmul form) equals the
    per-particle log-domain logsumexp convolution."""
    import jax

    from phdslam_tpu.filters.cphd import cardinality_predict_batch

    rng = np.random.default_rng(3)
    P, C1 = 16, 33
    # spread over many magnitudes incl. deeply-negative log probabilities
    log_cn = jnp.asarray(rng.uniform(-60, 0, (P, C1)), jnp.float32)
    log_birth = jnp.asarray(rng.uniform(-40, 0, C1), jnp.float32)
    a = jax.vmap(lambda c: cardinality_predict(c, log_birth))(log_cn)
    b = cardinality_predict_batch(log_cn, log_birth)
    am, bm = np.asarray(a, np.float64), np.asarray(b, np.float64)
    # compare in probability space (log values below the f32 underflow
    # horizon differ representationally but are identically ~0 mass)
    np.testing.assert_allclose(np.exp(bm - bm.max()),
                               np.exp(am - am.max()), atol=1e-5)


def test_log_esf_omit_wide_dynamic_range():
    """Shared-per-row-max caveat of the prefix/suffix convolution form
    (advisor, round 3): with adversarially wide-spanning log_lambda the
    esfd entries whose dominant term sits far below the row peak may
    underflow to LOG0 where a per-output logsumexp stays finite. Pin that
    (a) every entry within the f32 horizon of its row peak is exact, and
    (b) the downstream psi1d inner products are insensitive to the
    underflowed tail."""
    lam = np.exp(np.array([10.0, -80.0, 5.0, -60.0], np.float64))
    M = len(lam)
    ll = jnp.asarray(np.log(lam), jnp.float32)
    zm = jnp.ones((M,), bool)
    esfd = np.asarray(log_esf_omit(ll, zm), np.float64)

    for m in range(M):
        keep = np.delete(lam, m)
        oracle = esf_bruteforce(keep)[:M]          # orders 0..M-1
        peak = oracle.max()
        got = np.exp(esfd[m])
        for k in range(M):
            if oracle[k] / peak > 1e-30:
                # within the f32 horizon: exact (relative to magnitude)
                np.testing.assert_allclose(got[k], oracle[k], rtol=1e-3)
            else:
                # may have underflowed to LOG0 — but must not be LARGER
                # than the true value by more than f32 noise
                assert got[k] <= oracle[k] * (1 + 1e-3) + 1e-300

    # downstream insensitivity: ip1d from the f32 esfd matches the full
    # float64 oracle (psi1d weights esfd by comparably-scaled factors and
    # sums over k, so the ~e^-88-relative tail cannot move the result)
    cfg = SlamConfig(max_cardinality=12, clutter_rate=2.0, max_range=10.0,
                     max_bearing=np.pi)
    consts = cphd_constants(cfg)
    ip_qdw, wsum = 0.8, 2.0
    cn = np.array([math.exp(-1.5) * 1.5 ** n / math.factorial(n)
                   for n in range(13)])
    esf_full = log_esf(ll, zm)
    _, _, _, ip1d = psi_terms(
        consts, esf_full, jnp.asarray(esfd, jnp.float32),
        jnp.log(jnp.asarray(cn, jnp.float32)),
        jnp.float32(np.log(ip_qdw)), jnp.float32(np.log(wsum)), M, zm)
    for m in range(M):
        keep = np.delete(lam, m)
        esf_d = esf_bruteforce(keep)
        psi1d = np.zeros(13)
        for n in range(13):
            for j in range(0, min(n, M - 1) + 1):
                if j + 1 <= n:
                    perm1 = math.factorial(n) / math.factorial(n - j - 1)
                    pk = math.exp(-2.0) * 2.0 ** (M - 1 - j) \
                        / math.factorial(M - 1 - j)
                    psi1d[n] += perm1 * math.factorial(M - 1 - j) * pk \
                        * esf_d[j] * ip_qdw ** (n - j - 1) / wsum ** n
        expect = float(np.dot(psi1d, cn))
        np.testing.assert_allclose(np.exp(float(ip1d[m])), expect,
                                   rtol=5e-3)


def test_psi1d_pref_suf_route_matches_esfd_route():
    """The fused ip1d correlation (pref_suf Toeplitz matmul inside
    psi_terms) reassociates the esfd convolution + inner product — it
    must match the explicit esfd route to f32 accuracy."""
    from phdslam_tpu.filters.cphd import log_esf_prefix_suffix

    rng = np.random.default_rng(5)
    M = 12
    cfg = SlamConfig(max_cardinality=32, clutter_rate=3.0, max_range=10.0,
                     max_bearing=np.pi)
    consts = cphd_constants(cfg)
    ll = jnp.asarray(rng.uniform(-4, 2, M), jnp.float32)
    zm = jnp.asarray(np.arange(M) < 9)
    ll = jnp.where(zm, ll, LOG0)
    cn = rng.dirichlet(np.ones(33)).astype(np.float32)

    esf_full = log_esf(ll, zm)
    esfd = log_esf_omit(ll, zm)
    args = (consts, esf_full, esfd, jnp.log(jnp.asarray(cn)),
            jnp.float32(-0.2), jnp.float32(0.9), 9, zm)
    _, _, _, ip1d_a = psi_terms(*args)
    _, _, _, ip1d_b = psi_terms(
        consts, esf_full, None, jnp.log(jnp.asarray(cn)),
        jnp.float32(-0.2), jnp.float32(0.9), 9, zm,
        pref_suf=log_esf_prefix_suffix(ll, zm))
    a = np.asarray(ip1d_a, np.float64)
    b = np.asarray(ip1d_b, np.float64)
    live = np.asarray(zm)
    np.testing.assert_allclose(b[live], a[live], rtol=2e-4, atol=1e-4)
    assert (b[~live] < -1e30).all()

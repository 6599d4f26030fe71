"""Smoke test of the (C)PHD-SLAM filter on one NVIDIA GPU.

Drives the main path once through the entry points a user calls and checks
what comes out, phase by phase; any failed phase raises and the script
exits nonzero. One process uses the card.

    python chip_smoke.py          # one card: every phase below
    python chip_smoke.py --four   # four cards: the particle mesh only

Phases (one card):

* the test suite's tests marked ``gpu``;
* kernels: the greedy-merge kernel (ops/pallas_merge.py) compiled for the
  card vs ``gm_merge_batch`` (the XLA reference) at the widths the filter
  merges at, and the candidate gather vs numpy;
* ackerman P=10240, all 331 measurement steps, through SynthSLAMRunner,
  scored against the dataset's ground truth;
* short CPHD P=512, mixed P=512 and disparity P=200 runs (every merge
  width the filter uses), each with finite weights;
* dense P=10240/K=1024: compile one step, print memory_analysis(), then
  run a few steps if it fits.

``--four`` runs ackerman P=10240 through ``make_sharded_scan_fn`` on a
four-card particle mesh and on one card, and compares them.

The last line of output is one JSON object with the device JAX reports.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import jax
import jax.numpy as jnp
import numpy as np

from phdslam_tpu.config import load_config
from phdslam_tpu.eval import parity
from phdslam_tpu.ops.gather import take_cols
from phdslam_tpu.ops.gm_merge import gm_merge_batch, pack_planes
from phdslam_tpu.ops.pallas_merge import gm_merge_pallas
from phdslam_tpu.runtime.compile_cache import configure_compile_cache
from phdslam_tpu.slam import SynthSLAMRunner

# healthy accuracy band on data/ackerman over the full sequence
# (.claude/skills/verify/SKILL.md)
POSE_ERR_BAND = (0.2, 0.6)      # mean XY pose error, m
OSPA_MAX = 3.0                  # mean OSPA(1, 5)

# four cards vs one: per-step expected-pose agreement (float rounding) and
# the bound on the ATE difference once resampling draws diverge
PARITY_TOL_M = 1e-3
ATE_TOL_M = 0.1

# merge-kernel vs reference tolerances (f32, matmul precision "highest"):
# the greedy decisions must agree exactly (cluster counts); the moments
# differ only by summation order
W_RTOL, W_ATOL = 1e-4, 1e-6
MEAN_RTOL, MEAN_ATOL = 1e-4, 1e-4
COV_RTOL, COV_ATOL = 1e-3, 1e-4

# name, P, N candidates, K clusters, D, metric, min_separation
MERGE_CASES = [
    ("ackerman", 10240, 512, 128, 2, 0, 5.0),
    ("dense", 1024, 1536, 1024, 2, 0, 5.0),
    ("hellinger", 1024, 512, 128, 2, 1, 0.6),
    ("disparity_d3", 200, 512, 24, 3, 0, 20.0),
    ("mixed_d4", 512, 512, 24, 4, 0, 2.0),
]


def check(ok, what):
    """A failed check ends the run with an error (asserts vanish under -O)."""
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def require_gpu(devices):
    """Refuse to run anywhere but a CUDA GPU."""
    platform = devices[0].platform if devices else None
    if platform != "gpu":
        raise SystemExit(f"chip_smoke.py needs a CUDA GPU; JAX found "
                         f"{platform!r}")


def card_name_and_power():
    """nvidia-smi's name and power limit, from a child that stays off
    JAX."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def _median_ms(fn, *args, n=3):
    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts)) * 1e3


def merge_case(P, N, K, D, seed, n_centers=None, live_frac=0.5):
    """Clustered candidate sets, active lanes a weight-descending prefix
    (the layout top-cap compaction hands the merge)."""
    rng = np.random.default_rng(seed)
    n_centers = n_centers or max(4, K // 2)
    centers = rng.uniform(-150, 150, (P, n_centers, D))
    idx = rng.integers(0, n_centers, (P, N))
    mean = centers[np.arange(P)[:, None], idx] \
        + rng.normal(0, 0.4, (P, N, D))
    A = rng.normal(0, 0.3, (P, N, D, D))
    cov = np.einsum("pnij,pnkj->pnik", A, A) + 0.2 * np.eye(D)
    n_live = int(N * live_frac)
    w = np.zeros((P, N), np.float32)
    w[:, :n_live] = -np.sort(-rng.uniform(0.01, 1, (P, n_live)), axis=1)
    act = w > 0
    return (jnp.asarray(mean, jnp.float32), jnp.asarray(cov, jnp.float32),
            jnp.asarray(w), jnp.asarray(act))


def phase_gpu_tests():
    """The test suite's tests marked ``gpu`` (they need the card), run in
    this process."""
    import pytest
    print("== tests marked gpu", flush=True)
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider", "tests"])
    check(rc == 0, f"pytest -m gpu exit code {rc}")


def phase_kernels():
    print("== kernels: merge kernel vs gm_merge_batch", flush=True)
    for i, (name, P, N, K, D, metric, sep) in enumerate(MERGE_CASES):
        mean, cov, w, act = merge_case(P, N, K, D, seed=i)
        ref_fn = jax.jit(lambda m, c, w_, a: gm_merge_batch(
            m, c, w_, a, sep, K, metric))
        ker_fn = jax.jit(lambda pk: gm_merge_pallas(
            pk, D, sep, K, metric=metric, sorted_w=True))
        packed = pack_planes(mean, cov, w, act)
        ref = jax.device_get(ref_fn(mean, cov, w, act))
        got = jax.device_get(ker_fn(packed))
        counts_equal = bool(np.array_equal(got[3], ref[3]))
        dropped_equal = bool(np.array_equal(got[4], ref[4]))
        dw = float(np.max(np.abs(got[2] - ref[2])))
        dm = float(np.max(np.abs(got[0] - ref[0])))
        t_ref = _median_ms(ref_fn, mean, cov, w, act)
        t_ker = _median_ms(ker_fn, packed)
        print(f"merge {name}: P={P} N={N}->K={K} D={D} metric={metric} "
              f"clusters/particle={float(np.mean(ref[3])):.1f} "
              f"max|dw|={dw:.3g} max|dmean|={dm:.3g} "
              f"counts_equal={counts_equal} dropped_equal={dropped_equal} "
              f"warm ms: xla={t_ref:.3f} kernel={t_ker:.3f}", flush=True)
        check(counts_equal and dropped_equal, f"{name} cluster counts")
        np.testing.assert_allclose(got[2], ref[2], W_RTOL, W_ATOL,
                                   err_msg=name)
        np.testing.assert_allclose(got[0], ref[0], MEAN_RTOL, MEAN_ATOL,
                                   err_msg=name)
        np.testing.assert_allclose(got[1], ref[1], COV_RTOL, COV_ATOL,
                                   err_msg=name)

    print("== kernels: candidate gather vs numpy", flush=True)
    rng = np.random.default_rng(7)
    P, C, R, cap = 1024, 16, 1024, 1536        # dense table widths
    tab = rng.normal(size=(P, C, R)).astype(np.float32)
    idx = rng.integers(0, R, (P, cap)).astype(np.int32)
    idx[:, 0], idx[:, -1] = 0, R - 1
    got = jax.device_get(jax.jit(take_cols)(jnp.asarray(idx),
                                            jnp.asarray(tab)))
    ref = np.take_along_axis(
        tab, np.broadcast_to(idx[:, None, :], (P, C, cap)), axis=2)
    equal = bool(np.array_equal(got, ref))
    print(f"gather P={P} C={C} R={R} cap={cap}: bit_equal={equal}",
          flush=True)
    check(equal, "gather bit-equality")


def _weights_finite(state):
    leaves = [state.log_weight, state.map_static.weight,
              state.map_dynamic.weight]
    if state.cardinality is not None:
        leaves.append(state.cardinality)
    return all(bool(np.isfinite(np.asarray(x)).all()) for x in leaves)


def phase_ackerman():
    print("== ackerman P=10240, full sequence (SynthSLAMRunner)",
          flush=True)
    cfg = load_config("cfg/ackerman.cfg")
    cfg.n_particles = 10240
    t0 = time.perf_counter()
    SynthSLAMRunner(cfg, "data/ackerman").run_scanned(collect_maps=True)
    setup_s = time.perf_counter() - t0
    r = SynthSLAMRunner(cfg, "data/ackerman")
    res = r.run_scanned(collect_maps=True)
    sc = parity.score_synth_run(r, res, "data/ackerman")
    finite = _weights_finite(r.state)
    n_meas = sum(p.z_idx >= 0 for p in r.schedule)
    print(f"ackerman P=10240: {len(r.schedule)} filter steps "
          f"({n_meas} measurement steps) steps/s={res['steps_per_s']:.2f} "
          f"mean_pose_err={sc['mean_pose_err']:.4f} m "
          f"mean_ospa={sc['mean_ospa']:.4f} "
          f"mean_nEff={sc['mean_n_eff']:.4f} finite_weights={finite} "
          f"first run incl. compile {setup_s:.1f} s", flush=True)
    check(finite, "ackerman finite weights")
    check(POSE_ERR_BAND[0] <= sc["mean_pose_err"] <= POSE_ERR_BAND[1],
          f"ackerman pose error in {POSE_ERR_BAND}")
    check(sc["mean_ospa"] <= OSPA_MAX, f"ackerman OSPA <= {OSPA_MAX}")


def phase_short_runs():
    print("== short runs: CPHD P=512, mixed P=512, disparity P=200",
          flush=True)
    cfg = load_config("cfg/ackerman_cphd.cfg")
    cfg.n_particles = 512
    cfg.n_steps = 300
    r = SynthSLAMRunner(cfg, "data/ackerman")
    res = r.run_scanned(collect_maps=True)
    sc = parity.score_synth_run(r, res, "data/ackerman")
    finite = _weights_finite(r.state)
    print(f"cphd P=512 ({len(r.schedule)} steps): "
          f"mean_pose_err={sc['mean_pose_err']:.4f} m "
          f"finite_weights={finite}", flush=True)
    check(finite, "cphd finite weights")

    mx = parity.evaluate_mixed(n_particles=512, n_steps=60)
    print(f"mixed P=512 (60 steps): static_ospa={mx['static_ospa']:.4f} "
          f"mean_pose_err={mx['mean_pose_err']:.4f} m "
          f"finite_weights={mx['weights_finite']}", flush=True)
    check(mx["weights_finite"], "mixed finite weights")

    dp = parity.evaluate_disparity(n_steps=40,
                                   cfg_overrides={"n_particles": 200})
    print(f"disparity P=200 (40 steps): ospa={dp['ospa']:.4f} "
          f"finite_weights={dp['weights_finite']}", flush=True)
    check(dp["weights_finite"], "disparity finite weights")


def phase_dense(n_steps=6):
    print("== dense P=10240 K=1024: compile + memory_analysis", flush=True)
    cfg = load_config("cfg/dense.cfg")
    cfg.n_particles = 10240
    r = SynthSLAMRunner(cfg, "data/dense")
    plans = r.schedule[:n_steps]

    def args_of(plan, state):
        z = r.z_dev[max(plan.z_idx, 0)]
        zm = r.mask_dev[max(plan.z_idx, 0)] & (plan.z_idx >= 0)
        ctrl = r.controls_dev[max(plan.c_idx, 0)]
        return (state, z, zm, ctrl, jnp.float32(plan.dt),
                jnp.asarray(plan.do_predict))

    t0 = time.perf_counter()
    compiled = r.step_fn.lower(*args_of(plans[0], r.state)).compile()
    print(f"dense step compile {time.perf_counter() - t0:.1f} s", flush=True)
    ma = compiled.memory_analysis()
    fields = ("argument_size_in_bytes", "output_size_in_bytes",
              "alias_size_in_bytes", "temp_size_in_bytes",
              "generated_code_size_in_bytes")
    sizes = {f: int(getattr(ma, f)) for f in fields}
    need = (sizes["argument_size_in_bytes"] + sizes["output_size_in_bytes"]
            - sizes["alias_size_in_bytes"] + sizes["temp_size_in_bytes"])
    limit = jax.devices()[0].memory_stats()["bytes_limit"]
    fits = need <= limit
    print("dense memory_analysis: "
          + " ".join(f"{k}={v}" for k, v in sizes.items())
          + f" needed={need} device_limit={limit} fits={fits}", flush=True)
    if not fits:
        print(f"dense P=10240 does not fit: short by {need - limit} bytes; "
              "steps skipped", flush=True)
        return
    state = r.state
    t0 = time.perf_counter()
    for plan in plans:
        state, out = compiled(*args_of(plan, state))
    jax.block_until_ready(out.expected_pose)
    wall = time.perf_counter() - t0
    finite = _weights_finite(state)
    peak = jax.devices()[0].memory_stats().get("peak_bytes_in_use")
    print(f"dense P=10240: {len(plans)} steps in {wall:.3f} s "
          f"finite_weights={finite} peak_bytes_in_use={peak}", flush=True)
    check(finite, "dense finite weights")


def phase_four():
    from phdslam_tpu.parallel import make_mesh
    print("== four cards: ackerman P=10240, make_sharded_scan_fn vs one "
          "card", flush=True)
    mesh = make_mesh(4)
    cfg = load_config("cfg/ackerman.cfg")
    cfg.n_particles = 10240

    def warm_then_timed(run):
        run(SynthSLAMRunner(cfg, "data/ackerman"))      # compile
        r = SynthSLAMRunner(cfg, "data/ackerman")
        return r, run(r)

    r1, one = warm_then_timed(lambda r: r.run_scanned())
    r4, four = warm_then_timed(lambda r: r.run_sharded(mesh=mesh))
    gt = np.load("data/ackerman/groundtruth.npz")["traj"]
    midx = [i for i, p in enumerate(r1.schedule) if p.z_idx >= 0]
    zidx = np.asarray([p.z_idx for p in r1.schedule if p.z_idx >= 0])

    def ate(res):
        est = res["est_poses"][midx][:, :2]
        return float(np.mean(np.linalg.norm(est - gt[zidx, :2], axis=1)))

    d = np.linalg.norm(four["est_poses"][:, :2] - one["est_poses"][:, :2],
                       axis=1)
    off = np.nonzero(d > PARITY_TOL_M)[0]
    first_off = int(off[0]) if len(off) else None
    ate1, ate4 = ate(one), ate(four)
    finite = _weights_finite(r4.state)
    print(f"four-card parity of per-step expected poses: "
          f"{int(np.sum(d <= PARITY_TOL_M))}/{len(d)} steps within "
          f"{PARITY_TOL_M} m (first step beyond: {first_off}); "
          f"max {float(d.max()):.6g} m, mean {float(d.mean()):.6g} m. The "
          f"weight psum runs in another order on four cards, so the runs "
          f"agree to float rounding until a resampling draw lands on the "
          f"other side of a cumulative-weight boundary; after that they are "
          f"two draws of the same filter, compared by ATE (|dATE| <= "
          f"{ATE_TOL_M} m).", flush=True)
    print(f"ATE one={ate1:.6f} m four={ate4:.6f} m; steps/s "
          f"one={one['steps_per_s']:.4f} four={four['steps_per_s']:.4f}; "
          f"finite_weights={finite}", flush=True)
    check(finite, "four-card finite weights")
    check(abs(ate4 - ate1) <= ATE_TOL_M, "four-card ATE parity")
    for a in (ate1, ate4):
        check(POSE_ERR_BAND[0] <= a <= POSE_ERR_BAND[1],
              f"ATE in {POSE_ERR_BAND}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card particle mesh phase")
    args = ap.parse_args(argv)

    devices = jax.devices()
    require_gpu(devices)
    cache = configure_compile_cache()
    print(card_name_and_power(), flush=True)
    print(f"jax {jax.__version__} device_kind={devices[0].device_kind} "
          f"device_count={len(devices)} compile_cache={cache}", flush=True)
    if args.four:
        phase_four()
    else:
        phase_gpu_tests()
        phase_kernels()
        phase_ackerman()
        phase_short_runs()
        phase_dense()
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(devices)}}))


if __name__ == "__main__":
    main()

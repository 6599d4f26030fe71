"""Accuracy parity evaluation on the reference's canonical datasets.

Implements the reference's acceptance protocol (SURVEY.md §4,
python/batch_analyze.py): per-step XY pose error and OSPA(p=1, c=5) between
the extracted map estimate and the ground-truth landmark set, on the
``simData2_cv`` and ``simData2_ackerman`` sequences.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from ..config import load_config
from ..eval.ospa import extract_map_estimate, ospa_distance
from ..slam import SynthSLAMRunner


def evaluate_dataset(cfg_path: str, repo_root: str = ".",
                     n_steps: Optional[int] = None,
                     overrides: Optional[dict] = None,
                     ospa_samples: Optional[int] = None,
                     runner: str = "scanned"):
    """Run the filter on a dataset and score against its ground truth.

    OSPA is scored on EVERY measurement step by default — the reference's
    protocol (python/batch_analyze.py:29-33 scores each step); pass
    ``ospa_samples`` to subsample (legacy round-1..4 behavior).

    ``runner``: "scanned" = the whole sequence as one on-device lax.scan;
    "chunked" = fixed-size scan chunks.
    Returns dict with pose_err [T], ospa [T or sampled], throughput, etc.
    """
    cfg = load_config(cfg_path, overrides)
    data_dir = os.path.join(repo_root, cfg.data_directory)
    if n_steps:
        cfg.n_steps = n_steps

    r = SynthSLAMRunner(cfg, data_dir)
    if runner == "chunked":
        res = r.run_chunked(chunk=32, collect_maps=True)
    else:
        res = r.run_scanned(collect_maps=True)
    return score_synth_run(r, res, data_dir, ospa_samples)


def score_synth_run(r: SynthSLAMRunner, res: dict, data_dir: str,
                    ospa_samples: Optional[int] = None):
    """Pose error and OSPA(1, 5) of a finished run (``res`` from one of
    ``r``'s runners, collected with ``collect_maps=True``) against the
    dataset's ground truth."""
    gt = np.load(os.path.join(data_dir, "groundtruth.npz"))
    traj, landmarks = gt["traj"], gt["landmarks"]
    # true map at step k = landmarks observed up to k (batch_analyze.py
    # scores vs the per-step true map)
    cum_counts = (gt["cumulative_counts"] if "cumulative_counts" in gt.files
                  else np.full(len(traj), len(landmarks)))

    midx = [i for i, p in enumerate(r.schedule) if p.z_idx >= 0]
    zidx = [p.z_idx for p in r.schedule if p.z_idx >= 0]
    est = res["est_poses"][midx]
    T = min(len(est), len(traj))
    pose_err = np.linalg.norm(est[:T, :2] - traj[np.asarray(zidx[:T]), :2],
                              axis=1)

    ospa_every = max(1, T // ospa_samples) if ospa_samples else 1
    ospas = []
    for j in range(0, T, ospa_every):
        est_map = extract_map_estimate(res["map_weights"][midx[j]],
                                       res["map_means"][midx[j]])
        true_map = landmarks[: cum_counts[min(zidx[j], len(cum_counts) - 1)]]
        o, loc, cn = ospa_distance(true_map, est_map, p=1, c=5)
        ospas.append(o)

    return {
        "pose_err": pose_err,
        "ospa": np.asarray(ospas),
        "est_poses": est,
        "final_pose_err": float(pose_err[-1]),
        "mean_pose_err": float(pose_err.mean()),
        "max_pose_err": float(pose_err.max()),
        "final_ospa": float(ospas[-1]),
        "mean_ospa": float(np.mean(ospas)),
        "steps_per_s": res["steps_per_s"],
        "mean_loop_ms": 1000.0 / max(res["steps_per_s"], 1e-9),
        "mean_n_eff": float(np.mean(res["n_eff"])),
    }


_MIXED_SCAN_CACHE: dict = {}


def _mixed_cfg(n_particles, seed, **overrides):
    from ..config import SlamConfig
    base = dict(
        n_particles=n_particles, max_features=24, max_measurements=32,
        motion_type=0, feature_model=2, filter_type=0,
        vx0=1.5, vyaw0=0.2, ax=0.3, ayaw=0.03,
        max_range=12.0, std_range=0.5,
        std_bearing=0.02, clutter_rate=5.0, pd=0.95,
        min_separation=2.0, resample_threshold=0.5,
        # cluster-process weighting (scheme 0): without odometry the pose
        # is anchored ONLY by the particle weights, and scheme 1 (Vo
        # empty-map, a cardinality-balance heuristic) is nearly flat across
        # particles here (nEff stays ~0.9, no resampling signal, the pose
        # random-walks 20-40 m); scheme 0 sums the log normalizers — the
        # actual measurement likelihood — and tracks at the 0.1 m level.
        particle_weighting=0, tau=0.2, cov_vx_birth=0.25, cov_vy_birth=0.25,
        # Monte-Carlo-swept dynamic-birth tuning:
        # birth_weight 0.02 keeps fresh clutter births in the dynamic map
        # below the min_expected_feature_weight extraction threshold
        # (bw/(cd+bw) ~ 0.23 < 0.33); the near-zero CV process noise stops
        # tracked movers' velocity estimates from diffusing between
        # detections. Together: dynamic OSPA 4.4 -> 2.8-3.3.
        birth_weight=0.02, std_ax_map=0.01, std_ay_map=0.01, seed=seed)
    base.update(overrides)
    return SlamConfig(**base)


def _mixed_world(n_landmarks, n_movers, n_steps, dt, seed, max_meas):
    """Generate one mixed world + the full measurement schedule up front
    (host): landmarks, CV-loop trajectory, movers on constant-velocity
    tracks, unlabeled noisy measurements of both per step."""
    from . import simdata

    rng = np.random.default_rng(seed)
    sp = simdata.SensorParams(max_range=12.0, std_range=0.5,
                              std_bearing=0.02, pd=0.95, clutter_rate=5.0)
    # yaw_rate 0.2 at v 1.5 -> a 7.5 m-radius loop that stays inside the
    # +-12 m landmark field (a wider loop leaves the field and the filter
    # runs open-loop)
    landmarks, traj = simdata.generate_world_cv(
        n_landmarks=n_landmarks, extent=12.0, n_steps=n_steps, dt=dt,
        seed=seed, v0=1.5, yaw_rate=0.2)
    movers = rng.uniform(-8.0, 8.0, size=(n_movers, 2))
    mover_v = rng.uniform(-0.5, 0.5, size=(n_movers, 2))

    z_all = np.zeros((n_steps, max_meas, 2), np.float32)
    mask_all = np.zeros((n_steps, max_meas), bool)
    mv = movers.copy()
    vel = mover_v.copy()
    mv_hist = np.zeros((n_steps, len(movers), 2))
    for n in range(n_steps):
        mv_hist[n] = mv
        targets = np.vstack([landmarks, mv])
        zs = simdata.noisy_measurements(traj[n], targets, sp, rng)
        m = min(len(zs), max_meas)
        z_all[n, :m] = zs[:m]
        mask_all[n, :m] = True
        if n < n_steps - 1:         # keep mv at the last-measured positions
            mv = mv + vel * dt
            # reflect off the +-8.5 field boundary: a mover drifting out of
            # the landmark field leaves the vehicle's sensor range for the
            # rest of the run, making the final-map score meaningless
            # (round-3 finding: unbounded CV movers exited by step ~16-40
            # in 2 of 4 worlds)
            for ax in range(2):
                hi = mv[:, ax] > 8.5
                lo = mv[:, ax] < -8.5
                vel[hi | lo, ax] *= -1.0
                mv[hi, ax] = 17.0 - mv[hi, ax]
                mv[lo, ax] = -17.0 - mv[lo, ax]

    seen = np.zeros(len(landmarks), bool)
    for t in range(n_steps):
        seen |= np.linalg.norm(landmarks - traj[t, :2], axis=1) \
            <= sp.max_range
    return dict(landmarks=landmarks, traj=traj, movers_final=mv,
                mover_v=vel, mv_hist=mv_hist, seen=seen,
                z_all=z_all, mask_all=mask_all)


def _mixed_scan_fn(cfg):
    """Jitted whole-sequence mixed-filter scan, cached per config shape so
    MC campaigns trace once (the round-1 re-tracing lesson, slam.py)."""
    import dataclasses
    import functools

    import jax
    import jax.numpy as jnp

    from ..filters.phd import phd_step

    # `seed` only enters init_state (the rng key is a traced ARGUMENT via
    # state.rng), so exclude it from the cache key — an MC campaign must
    # reuse ONE traced program across its fresh-seed runs (a per-seed key
    # would recompile every run)
    key = tuple((f.name, getattr(cfg, f.name))
                for f in dataclasses.fields(cfg) if f.name != "seed")
    fn = _MIXED_SCAN_CACHE.get(key)
    if fn is None:
        step = functools.partial(phd_step, cfg=cfg)
        ctrl = jnp.zeros((2,), jnp.float32)

        @functools.partial(jax.jit, donate_argnums=(0,))
        def fn(state, z_all, mask_all, dt):
            def body(st, inp):
                z, zm, n = inp
                st, out = step(st, z, zm, ctrl, dt, n > 0)
                return st, (out.expected_pose, out.n_eff)
            T = z_all.shape[0]
            return jax.lax.scan(
                body, state, (z_all, mask_all, jnp.arange(T)))
        _MIXED_SCAN_CACHE[key] = fn
    return fn


def evaluate_mixed(n_landmarks: int = 30, n_movers: int = 2,
                   n_steps: int = 100, dt: float = 0.15, seed: int = 0,
                   n_particles: int = 256, ospa_c: float = 5.0,
                   cfg_overrides: Optional[dict] = None):
    """End-to-end accuracy of the mixed (jump-Markov) model on a world with
    BOTH static landmarks and moving targets — a configuration the
    reference implements (phdUpdateKernelMixed, phdfilter.cu:2323-2635) but
    ships no dataset for.

    CV vehicle (controls-free), unlabeled range-bearing measurements of
    landmarks + constant-velocity movers; the whole sequence runs as one
    on-device scan (jit cached across calls — MC-campaign ready). Scores
    the final static-map OSPA vs the landmarks, the final dynamic-map
    positions vs the movers' final true positions, and the dynamic map's
    VELOCITY error vs the movers' true velocities (matched by position).
    """
    import jax
    import jax.numpy as jnp

    from ..types import init_state

    w = _mixed_world(n_landmarks, n_movers, n_steps, dt, seed, 32)
    cfg = _mixed_cfg(n_particles, seed, **(cfg_overrides or {}))

    run = _mixed_scan_fn(cfg)
    state = init_state(cfg)
    state, (ep, ne) = run(state, jnp.asarray(w["z_all"]),
                          jnp.asarray(w["mask_all"]), jnp.float32(dt))
    jax.block_until_ready(ne)
    weights_finite = all(
        bool(np.isfinite(np.asarray(x)).all())
        for x in (state.log_weight, state.map_static.weight,
                  state.map_dynamic.weight))
    ep = np.asarray(ep)

    traj = w["traj"]
    pose_err = np.linalg.norm(ep[:, :2] - traj[:n_steps, :2], axis=1)
    best = int(np.argmax(np.asarray(state.log_weight)))
    s_w = np.asarray(state.map_static.weight[best])
    s_m = np.asarray(state.map_static.mean[best])
    est_static = extract_map_estimate(s_w, s_m)
    o_s, _, _ = ospa_distance(w["landmarks"][w["seen"]], est_static,
                              p=1, c=ospa_c)

    d_w = np.asarray(state.map_dynamic.weight[best])
    d_full = np.asarray(state.map_dynamic.mean[best])
    # dynamic-target extraction thresholds at min_expected_feature_weight
    # (the reference's expected-target threshold, slamtypes.h:169) instead
    # of the static protocol's round(sum w): every scan's fresh CLUTTER
    # births sit at birth_weight/(clutter_density+birth_weight) ~ 0.3 in
    # the dynamic map, and with only ~2 true targets the round-sum
    # cardinality is dominated by that transient (round-3 analysis; the
    # static map's ~25 targets drown the same pollution)
    thr = cfg.min_expected_feature_weight
    est_dyn = d_full[d_w > thr][:, :2]
    est_dyn_full = d_full[d_w > thr]
    est_dyn_round = extract_map_estimate(d_w, d_full[:, :2])
    # dynamic truth = movers within sensor range at the final step: the
    # reference KILLS out-of-range dynamic features by design
    # (phdfilter.cu:3714-3719), so targets that left the sensor footprint
    # are definitionally absent from any conforming filter's dynamic map
    vis = np.linalg.norm(w["movers_final"] - w["traj"][len(w["mv_hist"]) - 1,
                                                       :2],
                         axis=1) <= cfg.max_range
    truth_dyn = w["movers_final"][vis]
    if len(truth_dyn):
        o_d, _, _ = ospa_distance(truth_dyn, est_dyn, p=1, c=ospa_c)
        o_dr, _, _ = ospa_distance(truth_dyn, est_dyn_round, p=1, c=ospa_c)
    else:
        o_d = o_dr = float("nan")
    # track-level stats over visible movers: detected = an estimate within
    # 2 m; position error of detected tracks. Also scored: (a) per-speed
    # strata (a |v| < tau mover is DEFINITIONALLY static to the
    # jump-Markov model — the reference's own semantics,
    # phdfilter.cu:910-963 — so slow-stratum misses are expected), and
    # (b) detection in EITHER map (the mixed filter's full output: slow
    # movers legitimately land in the static map)
    speeds = np.linalg.norm(np.asarray(w["mover_v"]), axis=1)[vis]
    det, perr, det_any, det_speed = [], [], [], []
    for mvp, spd in zip(truth_dyn, speeds):
        if len(est_dyn):
            dmin = float(np.min(np.linalg.norm(est_dyn - mvp, axis=1)))
        else:
            dmin = float("inf")
        det.append(dmin < 2.0)
        det_speed.append(spd)
        if dmin < 2.0:
            perr.append(dmin)
        dmin_s = (float(np.min(np.linalg.norm(est_static - mvp, axis=1)))
                  if len(est_static) else float("inf"))
        det_any.append(min(dmin, dmin_s) < 2.0)

    # velocity error of position-matched dynamic estimates
    vel_errs = []
    for i, mvp in enumerate(w["movers_final"]):
        if not vis[i] or len(est_dyn_full) == 0:
            continue
        j = int(np.argmin(np.linalg.norm(est_dyn_full[:, :2] - mvp,
                                         axis=1)))
        if np.linalg.norm(est_dyn_full[j, :2] - mvp) < ospa_c:
            vel_errs.append(np.linalg.norm(
                est_dyn_full[j, 2:4] - w["mover_v"][i]))
    return {
        "static_ospa": float(o_s), "dynamic_ospa": float(o_d),
        "dynamic_ospa_round": float(o_dr),
        "n_dyn_visible": int(vis.sum()),
        "dyn_detected_frac": (float(np.mean(det)) if det
                              else float("nan")),
        "dyn_detected_any_frac": (float(np.mean(det_any)) if det_any
                                  else float("nan")),
        "det_flags": det, "det_any_flags": det_any,
        "det_speeds": det_speed,
        "dyn_track_err": (float(np.mean(perr)) if perr else float("nan")),
        "n_static_true": int(w["seen"].sum()),
        "n_static_est": len(est_static),
        "n_dyn_est": len(est_dyn),
        "pose_err": pose_err,
        "mean_pose_err": float(pose_err.mean()),
        "final_pose_err": float(pose_err[-1]),
        "vel_err": (float(np.mean(vel_errs)) if vel_errs else float("nan")),
        "n_eff": float(np.asarray(ne)[-1]),
        "weights_finite": weights_finite,
    }


def evaluate_mixed_mc(n_runs: int = 50, n_landmarks: int = 30,
                      n_movers: int = 2, n_steps: int = 100,
                      dt: float = 0.15, n_particles: int = 256,
                      ospa_c: float = 5.0,
                      cfg_overrides: Optional[dict] = None,
                      verbose: bool = False):
    """The reference's Monte-Carlo acceptance protocol
    (python/batch_run.py + batch_analyze.py: 50-100 fresh noise/world
    realizations, mean +- std of the per-run metrics) applied to the mixed
    jump-Markov filter. One traced program serves all runs."""
    rows = []
    for s in range(n_runs):
        r = evaluate_mixed(n_landmarks=n_landmarks, n_movers=n_movers,
                           n_steps=n_steps, dt=dt, seed=s,
                           n_particles=n_particles, ospa_c=ospa_c,
                           cfg_overrides=cfg_overrides)
        rows.append(r)
        if verbose:
            print(f"run {s}: pose {r['mean_pose_err']:.2f} "
                  f"static {r['static_ospa']:.2f} "
                  f"dyn {r['dynamic_ospa']:.2f} vel {r['vel_err']:.2f}",
                  flush=True)

    def agg(k):
        v = np.asarray([r[k] for r in rows], np.float64)
        v = v[np.isfinite(v)]
        return (float(v.mean()), float(v.std())) if len(v) else \
            (float("nan"), float("nan"))

    # speed-stratified detection over ALL visible movers of the campaign
    flags = np.concatenate([np.asarray(r["det_flags"], bool)
                            for r in rows]) if rows else np.zeros(0, bool)
    flags_any = np.concatenate([np.asarray(r["det_any_flags"], bool)
                                for r in rows]) if rows else flags
    spd = np.concatenate([np.asarray(r["det_speeds"], np.float64)
                          for r in rows]) if rows else np.zeros(0)
    strata = {}
    for name, lo, hi in (("slow_0.2-0.35", 0.2, 0.35),
                         ("mid_0.35-0.5", 0.35, 0.5),
                         ("fast_0.5+", 0.5, np.inf)):
        m = (spd >= lo) & (spd < hi)
        strata[name] = {
            "n": int(m.sum()),
            "dyn": float(flags[m].mean()) if m.any() else float("nan"),
            "either": (float(flags_any[m].mean()) if m.any()
                       else float("nan"))}

    return {
        "n_runs": n_runs,
        "det_strata": strata,
        "det_overall": {"dyn": float(flags.mean()) if len(flags) else
                        float("nan"),
                        "either": float(flags_any.mean()) if len(flags_any)
                        else float("nan")},
        "pose": agg("mean_pose_err"),
        "static_ospa": agg("static_ospa"),
        "dynamic_ospa": agg("dynamic_ospa"),
        "dyn_detected_frac": agg("dyn_detected_frac"),
        "dyn_track_err": agg("dyn_track_err"),
        "vel_err": agg("vel_err"),
        "runs": rows,
    }


def evaluate_disparity(cfg_path: str = "cfg/disparity.cfg",
                       n_landmarks: int = 25, n_steps: int = 60,
                       seed: int = 0, follow_trajectory: bool = True,
                       ospa_c: float = 1.0, work_dir: Optional[str] = None,
                       cfg_overrides: Optional[dict] = None):
    """Mapping accuracy of the monocular SC-PHD pipeline.

    Generates a synthetic camera world (simdata.generate_disparity_world,
    intrinsics taken from ``cfg_path``), runs the disparity filter — by
    default in known-pose mapping mode (follow_trajectory, main.cpp:1335-1339),
    which isolates MAP accuracy from pose drift — and scores the extracted 3D
    landmark estimate with OSPA(1, c=``ospa_c`` m) against the landmarks that
    were ever visible in the image during the sequence.
    """
    import tempfile

    from ..slam_disparity import run_disparity
    from . import simdata

    cfg = load_config(cfg_path)
    for k, v in (cfg_overrides or {}).items():
        setattr(cfg, k, v)
    cfg.follow_trajectory = follow_trajectory
    cfg.n_steps = n_steps

    landmarks, traj, measurements = simdata.generate_disparity_world(
        n_landmarks=n_landmarks, n_steps=n_steps, dt=cfg.dt, seed=seed,
        fx=cfg.fx, fy=cfg.fy, u0=cfg.u0, v0=cfg.v0,
        width=int(cfg.image_width), height=int(cfg.image_height),
        std_uv=cfg.std_u, pd=cfg.pd, clutter_rate=cfg.clutter_rate,
        vx=cfg.vx0)

    # landmarks ever inside the image and in front of the camera
    observed = np.zeros(len(landmarks), bool)
    for t in range(n_steps):
        R = simdata.camera_rotation_np(*traj[t, 3:6])
        pc = (landmarks - traj[t, :3]) @ R
        zc = pc[:, 2]
        with np.errstate(divide="ignore", invalid="ignore"):
            u = cfg.u0 - cfg.fx * pc[:, 0] / zc
            v = cfg.v0 - cfg.fy * pc[:, 1] / zc
        observed |= ((zc < -0.5) & (u > 0) & (u < cfg.image_width)
                     & (v > 0) & (v < cfg.image_height))

    import contextlib
    ctx = (contextlib.nullcontext(work_dir) if work_dir
           else tempfile.TemporaryDirectory(prefix="disparity_eval_"))
    with ctx as tmp:
        simdata.write_disparity_run_dir(tmp, measurements)
        np.savetxt(os.path.join(tmp, "traj.txt"), traj)
        res = run_disparity(cfg, data_dir=tmp)
    st = res["final_state"]
    best = int(np.argmax(np.asarray(st.log_weight)))
    feat_means = np.asarray(st.cloud[best]).mean(axis=1)       # [K, 3]
    feat_w = np.asarray(st.feat_weight[best])
    est_map = extract_map_estimate(feat_w, feat_means)
    o, loc, cn = ospa_distance(landmarks[observed], est_map, p=1, c=ospa_c)
    out = {
        "ospa": float(o), "ospa_loc": float(loc), "ospa_cn": float(cn),
        "n_true": int(observed.sum()), "n_est": len(est_map),
        "steps_per_s": res["steps_per_s"], "n_eff": res["n_eff"],
        "weights_finite": all(
            bool(np.isfinite(np.asarray(x)).all())
            for x in (st.log_weight, st.feat_weight)),
    }
    if not follow_trajectory:
        # full-SLAM mode (the reference's primary disparity path,
        # main.cpp:1347-1371: filtered camera pose from the jittered
        # particle init): per-step camera position error vs the true
        # trajectory
        est = np.asarray(res["est_poses"])[:, :3]
        err = np.linalg.norm(est - traj[:len(est), :3], axis=1)
        out["pose_err"] = err
        out["mean_pose_err"] = float(err.mean())
        out["final_pose_err"] = float(err[-1])
    return out


if __name__ == "__main__":
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("config", help="path to config file (cfg/cv.cfg, ...)")
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--particles", type=int, default=None)
    args = ap.parse_args()
    ov = {}
    if args.particles:
        ov["n_particles"] = args.particles
    res = evaluate_dataset(args.config, n_steps=args.steps, overrides=ov)
    print(f"mean_pose_err={res['mean_pose_err']:.3f} m  "
          f"max_pose_err={res['max_pose_err']:.3f} m  "
          f"mean_ospa={res['mean_ospa']:.3f}  "
          f"final_ospa={res['final_ospa']:.3f}  "
          f"steps_per_s={res['steps_per_s']:.2f}")

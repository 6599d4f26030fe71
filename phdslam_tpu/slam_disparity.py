"""Disparity (monocular SC-PHD) SLAM driver.

Equivalent of ``run_disparity`` (/root/reference/src/
main.cpp:1324-1440): loads per-step (u, v) image measurement sets, derives
the image-space clutter density, runs the jitted SC-PHD step, and reports
the estimated 6-DOF camera trajectory.
"""

from __future__ import annotations

import os
import time
from typing import List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from .config import SlamConfig
from .filters.disparity import init_disparity_state, make_disparity_step_fn
from .runtime import io

# traced whole-sequence programs cached across runs (same lesson as
# slam.py._SCAN_CACHE: per-call re-tracing costs seconds of host time and
# pollutes throughput measurements)
_DSCAN_CACHE: dict = {}


def _cfg_key(cfg: SlamConfig):
    import dataclasses
    # seed excluded: it only enters init_disparity_state (the rng is a
    # traced argument), so one traced program serves fresh-seed reruns
    return tuple(
        (f.name, getattr(cfg, f.name)) for f in dataclasses.fields(cfg)
        if f.name != "seed")


def load_image_measurements(path: str) -> List[np.ndarray]:
    """One time step per line; pairs of (u, v) (loadMeasurements
    <imageMeasurementSet>, main.cpp:221-245)."""
    out: List[np.ndarray] = []
    with open(path) as fh:
        first = True
        for line in fh:
            if first:
                first = False
                continue
            vals = np.fromstring(line, sep=" ") if line.strip() \
                else np.empty(0)
            n = (len(vals) // 2) * 2
            out.append(vals[:n].reshape(-1, 2).astype(np.float32))
    if out and out[-1].size == 0:
        out.pop()
    return out


def run_disparity(cfg: SlamConfig, data_dir: Optional[str] = None,
                  out_dir: Optional[str] = None, verbose: bool = False,
                  scanned: bool = True, chunk: int = 0,
                  timing: bool = False):
    """Run the SC-PHD filter over an image-measurement dataset.

    With ``cfg.follow_trajectory`` the camera poses are taken from
    ``traj.txt`` instead of being filtered — single-particle mapping-only
    mode (main.cpp:1335-1339, 1383-1387).

    Execution strategies (mirroring the synth driver):

    * ``scanned`` (default): the whole sequence as one on-device
      ``lax.scan`` — no host round-trips inside the loop.
    * ``chunk > 0``: host loop over fixed-size on-device scans — keeps
      each dispatch short at reference particle scale (200-512,
      main.cpp:991 / cfg/config.cfg:141); records chunk-granular wall
      times for loopTime.log.
    * ``timing=True``: reference-faithful per-step loop — every step
      blocks and records its TRUE wall clock into loopTime.log (the
      disparity loop's gettimeofday timing, main.cpp:1433-1438), and
      ``cfg.debug`` additionally dumps per-step particle ``.mat`` files
      (the DEBUG writeParticlesMat call, main.cpp:1397-1400).
    """
    data_dir = data_dir or cfg.data_directory
    measurements = load_image_measurements(
        os.path.join(data_dir, "measurements.txt"))
    n_steps = cfg.n_steps if cfg.n_steps > 0 else len(measurements)
    measurements = measurements[:n_steps]

    traj = None
    if cfg.follow_trajectory:
        traj = np.loadtxt(os.path.join(data_dir, "traj.txt"))
        if traj.shape[1] < 12:
            traj = np.pad(traj, ((0, 0), (0, 12 - traj.shape[1])))
        cfg.n_particles = 1  # main.cpp:1338

    m_max = min(max(8, max((len(z) for z in measurements), default=1)),
                cfg.max_measurements)
    z, mask = io.pad_measurements(measurements, m_max)

    state = init_disparity_state(cfg)
    z_dev = jnp.asarray(z)
    mask_dev = jnp.asarray(mask)
    T = len(measurements)
    step_ms: list = []
    chunk_ms: list = []

    if traj is not None:
        traj_np = traj[np.minimum(np.arange(T), len(traj) - 1)]
        traj_dev = jnp.asarray(traj_np, jnp.float32)
    else:
        traj_dev = jnp.zeros((T, 12), jnp.float32)
    do_pred_np = (np.arange(T) > 0) & (traj is None)

    if (scanned or chunk) and not verbose and not timing:
        import functools

        from .filters.disparity import disparity_step

        follow = traj is not None

        def get_scan(n_len):
            # one traced program per scan length; the remainder chunk gets
            # its own cached program so the filter never steps through
            # phantom padded steps (advisor finding, round 3: a padded tail
            # advanced rng/step/resampling history past the real sequence)
            ck = (_cfg_key(cfg), follow, z_dev.shape[1:], n_len)
            run_scan = _DSCAN_CACHE.get(ck)
            if run_scan is not None:
                return run_scan

            def body(carry, inp):
                st, = carry
                z_n, m_n, tr_n, dp = inp
                if follow:
                    st = st.replace(cam_pose=tr_n[None, :])
                st, out = disparity_step(st, z_n, m_n,
                                         jnp.float32(cfg.dt), dp, cfg=cfg)
                return (st,), (out.expected_pose, out.n_eff)

            @functools.partial(jax.jit, donate_argnums=(0,))
            def run_scan(st, z_all, m_all, traj_all, dp_all):
                (st,), ys = jax.lax.scan(
                    body, (st,), (z_all, m_all, traj_all, dp_all))
                return st, ys

            _DSCAN_CACHE[ck] = run_scan
            return run_scan

        do_pred = jnp.asarray(do_pred_np)
        if not chunk:
            run_scan = get_scan(T)
            t0 = time.perf_counter()
            state, (ep, ne) = run_scan(state, z_dev, mask_dev, traj_dev,
                                       do_pred)
            jax.block_until_ready(ne)
            wall = time.perf_counter() - t0
        else:
            run_scan = get_scan(min(chunk, T))
            if T % chunk:
                get_scan(T % chunk)  # compile the remainder program up front
            t0 = time.perf_counter()
            t_c = t0
            eps, nes = [], []
            for lo in range(0, T, chunk):
                hi = min(lo + chunk, T)
                scan_i = run_scan if hi - lo == min(chunk, T) \
                    else get_scan(hi - lo)
                sl = slice(lo, hi)
                state, (ep_i, ne_i) = scan_i(state, z_dev[sl], mask_dev[sl],
                                             traj_dev[sl], do_pred[sl])
                eps.append(ep_i)
                nes.append(ne_i)
                jax.block_until_ready(ne_i)
                now = time.perf_counter()
                chunk_ms.append((now - t_c) * 1000.0)
                t_c = now
            wall = time.perf_counter() - t0
            ep = jnp.concatenate(eps)[:T]
            ne = jnp.concatenate(nes)[:T]
        est_poses = np.asarray(ep)
        n_effs = np.asarray(ne)
        outs = [None] * T
    else:
        step = make_disparity_step_fn(cfg)
        t0 = time.perf_counter()
        outs = []
        for n in range(T):
            t_step = time.perf_counter()
            if traj is not None:
                # pose from the trajectory; skip prediction (main.cpp:1384)
                state = state.replace(cam_pose=jnp.asarray(
                    traj[min(n, len(traj) - 1)], jnp.float32)[None, :])
            state, out = step(state, z_dev[n], mask_dev[n],
                              jnp.float32(cfg.dt),
                              jnp.asarray(n > 0 and traj is None))
            outs.append(out)
            if timing:
                jax.block_until_ready(out.n_eff)
                step_ms.append((time.perf_counter() - t_step) * 1000.0)
                if cfg.debug and out_dir:
                    os.makedirs(out_dir, exist_ok=True)
                    io.write_disparity_particles_mat(
                        os.path.join(out_dir, f"particles{n:05d}.mat"),
                        state)
            if verbose and n % 20 == 0:
                print(f"step {n}/{len(measurements)} "
                      f"nEff={float(out.n_eff):.3f}")
        jax.block_until_ready(outs[-1].n_eff)
        wall = time.perf_counter() - t0
        est_poses = np.asarray(jnp.stack([o.expected_pose for o in outs]))
        n_effs = np.asarray(jnp.stack([o.n_eff for o in outs]))

    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        # loopTime.log: true per-step > chunk-granular > run average
        if step_ms:
            per = np.asarray(step_ms)
        elif chunk_ms:
            sizes = [min(chunk, T - lo) for lo in range(0, T, chunk)]
            per = np.concatenate([
                np.full((n,), ms / n)
                for ms, n in zip(chunk_ms, sizes)])[:T]
        else:
            per = np.full((T,), wall * 1000.0 / max(1, T))
        with open(os.path.join(out_dir, "loopTime.log"), "w") as fh:
            fh.write("\n".join("%g" % t for t in per) + "\n")
        np.savetxt(os.path.join(out_dir, "trajectory.txt"), est_poses)

    if np.isnan(n_effs).any():
        first = int(np.argmax(np.isnan(n_effs)))
        print(f"nan weights detected at step {first}!")  # main.cpp:1424-1428

    return {
        "est_poses": est_poses,
        "n_eff": n_effs,
        "wall_s": wall,
        "steps_per_s": T / wall,
        "step_ms": np.asarray(step_ms) if step_ms else None,
        "chunk_ms": np.asarray(chunk_ms) if chunk_ms else None,
        "final_state": state,
    }

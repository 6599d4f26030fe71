"""Top-level synthetic-data SLAM driver.

Equivalent of the reference driver ``run_synth``
(/root/reference/src/main.cpp:1075-1322): loads the datasets, builds the
per-step input schedule (timestamp-driven interleaving of controls and
measurements, main.cpp:1187-1237), runs the jitted filter step over the
device-resident state, and writes ``state_estimateXXXXX.log`` +
``loopTime.log`` compatible outputs.

Unlike the reference — which copies the full particle set host<->device every
step (SURVEY.md §2.4-P7) — the state lives on device for the whole run; the
host only receives the small extracted estimates it writes to disk.
"""

from __future__ import annotations

import functools
import os
import time
from dataclasses import dataclass
from typing import List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from .config import SlamConfig
from .filters.phd import make_step_fn, phd_step
from .runtime import io
from .types import FilterState, init_state


def _cfg_key(cfg: SlamConfig):
    """Hashable snapshot of a config for the jit caches."""
    import dataclasses
    return tuple(
        (f.name, getattr(cfg, f.name)) for f in dataclasses.fields(cfg))


# jitted program caches keyed by (cfg snapshot, variant flags): without
# them a 50-run MC campaign re-traces the full step per run. Dataset arrays
# are jit ARGUMENTS, not closure constants, so one traced program serves
# every same-shape run.
_SCAN_CACHE: dict = {}
_CHUNK_CACHE: dict = {}
_STEP_CACHE: dict = {}


def _cached_step_fn(cfg: SlamConfig):
    key = _cfg_key(cfg)
    fn = _STEP_CACHE.get(key)
    if fn is None:
        fn = _STEP_CACHE[key] = make_step_fn(cfg)
    return fn


@dataclass
class StepPlan:
    """One entry of the input schedule (main.cpp:1187-1237)."""
    z_idx: int          # measurement set index, -1 if none
    c_idx: int          # control index, -1 if none
    dt: float
    do_predict: bool


def build_schedule(n_measure_steps: int, n_controls: int,
                   measurement_times: np.ndarray, control_times: np.ndarray,
                   dt_default: float, n_steps_limit: int) -> List[StepPlan]:
    """Interleave measurement/control inputs by timestamp (main.cpp:1187-1237).

    Without timestamps: one measurement set + previous control per step.
    """
    plans: List[StepPlan] = []
    if len(measurement_times) == 0:
        for n in range(n_measure_steps):
            plans.append(StepPlan(z_idx=n, c_idx=min(n - 1, n_controls - 1)
                                  if n > 0 else -1,
                                  dt=dt_default, do_predict=n > 0))
    else:
        z_idx = c_idx = 0
        current_time = 0.0
        while z_idx < len(measurement_times) and c_idx < len(control_times):
            if measurement_times[z_idx] < control_times[c_idx]:
                t = float(control_times[c_idx])  # sic: ref uses control time
                plans.append(StepPlan(z_idx=z_idx, c_idx=-1,
                                      dt=t - current_time, do_predict=True))
                current_time = t
                z_idx += 1
            elif measurement_times[z_idx] == control_times[c_idx]:
                t = float(control_times[c_idx])
                plans.append(StepPlan(z_idx=z_idx, c_idx=c_idx,
                                      dt=t - current_time, do_predict=True))
                current_time = t
                z_idx += 1
                c_idx += 1
            else:
                t = float(control_times[c_idx])
                plans.append(StepPlan(z_idx=-1, c_idx=c_idx,
                                      dt=t - current_time, do_predict=True))
                current_time = t
                c_idx += 1
    if n_steps_limit > 0:
        plans = plans[:n_steps_limit]
    return plans


class SynthSLAMRunner:
    """End-to-end filter runner on a dataset directory."""

    def __init__(self, cfg: SlamConfig, data_dir: Optional[str] = None,
                 m_max: Optional[int] = None):
        self.cfg = cfg
        data_dir = data_dir or cfg.data_directory
        measurements = io.load_measurements(
            os.path.join(data_dir, "measurements.txt"),
            labeled=cfg.labeled_measurements)
        controls_path = os.path.join(data_dir, "controls.txt")
        self.controls = (io.load_controls(controls_path)
                         if os.path.exists(controls_path)
                         else np.zeros((0, 2), np.float32))
        mt = io.load_timestamps(os.path.join(data_dir,
                                             "measurement_times.txt"))
        ct = io.load_timestamps(os.path.join(data_dir, "control_times.txt"))

        if m_max is None:
            longest = max((len(z) for z in measurements), default=1)
            m_max = min(max(8, int(np.ceil(longest / 8.0)) * 8),
                        cfg.max_measurements)
        self.m_max = m_max
        self.z, self.z_mask = io.pad_measurements(measurements, m_max)
        self.n_truncated = sum(
            max(0, len(z) - m_max) for z in measurements)

        self.schedule = build_schedule(
            len(measurements), len(self.controls), mt, ct, cfg.dt,
            cfg.n_steps)

        self.step_fn = _cached_step_fn(cfg)
        self.state = init_state(cfg)

        # device-resident dataset
        self.z_dev = jnp.asarray(self.z)
        self.mask_dev = jnp.asarray(self.z_mask)
        self.controls_dev = (jnp.asarray(self.controls)
                             if len(self.controls) else
                             jnp.zeros((1, 2), jnp.float32))

    def schedule_arrays(self):
        """Pack the input schedule into device arrays for lax.scan."""
        T = len(self.schedule)
        z_idx = np.array([max(p.z_idx, 0) for p in self.schedule], np.int32)
        has_z = np.array([p.z_idx >= 0 for p in self.schedule], bool)
        c_idx = np.array([max(p.c_idx, 0) for p in self.schedule], np.int32)
        has_c = np.array([p.c_idx >= 0 for p in self.schedule], bool)
        dts = np.array([p.dt for p in self.schedule], np.float32)
        do_pred = np.array([p.do_predict for p in self.schedule], bool)
        return (jnp.asarray(z_idx), jnp.asarray(has_z), jnp.asarray(c_idx),
                jnp.asarray(has_c), jnp.asarray(dts), jnp.asarray(do_pred))

    def run_scanned(self, collect_maps: bool = False):
        """Run the FULL sequence as one on-device lax.scan — zero host
        round-trips inside the loop (the replacement for the
        reference's per-step host loop, SURVEY.md §2.4-P7).

        Returns stacked per-step outputs (expected poses, nEff, optionally MAP
        maps) after a single device sync.
        """
        cfg = self.cfg
        sched = self.schedule_arrays()
        key = (_cfg_key(cfg), bool(collect_maps), self.z_dev.shape,
               self.controls_dev.shape, len(self.schedule))
        run_all = _SCAN_CACHE.get(key)
        if run_all is None:
            step = functools.partial(phd_step, cfg=cfg)

            def body_of(z_all, mask_all, controls):
                def body(carry, inp):
                    state, last_ctrl = carry
                    zi, hz, ci, hc, dt, dp = inp
                    ctrl = jnp.where(hc, controls[ci], last_ctrl)
                    z = z_all[zi]
                    zm = mask_all[zi] & hz
                    state, out = step(state, z, zm, ctrl, dt, dp)
                    ys = (out.expected_pose, out.n_eff, out.resampled,
                          out.overflow)
                    if collect_maps:
                        ys = ys + (out.map_mean, out.map_weight)
                    return (state, ctrl), ys
                return body

            @functools.partial(jax.jit, donate_argnums=(0,))
            def run_all(state, z_all, mask_all, controls, *sched_arrays):
                init = (state, jnp.zeros((2,), jnp.float32))
                (state, _), ys = jax.lax.scan(
                    body_of(z_all, mask_all, controls), init, sched_arrays)
                return state, ys

            _SCAN_CACHE[key] = run_all

        t0 = time.perf_counter()
        self.state, ys = run_all(self.state, self.z_dev, self.mask_dev,
                                 self.controls_dev, *sched)
        jax.block_until_ready(ys)
        wall = time.perf_counter() - t0
        out = {
            "est_poses": np.asarray(ys[0]),
            "n_eff": np.asarray(ys[1]),
            "resampled": np.asarray(ys[2]),
            "overflow": int(np.asarray(ys[3]).max()),
            "wall_s": wall,
            "steps_per_s": len(self.schedule) / wall,
        }
        if collect_maps:
            out["map_means"] = np.asarray(ys[4])
            out["map_weights"] = np.asarray(ys[5])
        return out

    def run_chunked(self, chunk: int = 64, collect_maps: bool = True,
                    collect_particles: bool = False, timing: bool = False,
                    checkpoint_every: int = 0, checkpoint_dir: str = None,
                    start_step: int = 0, last_ctrl=None):
        """Run the sequence as a host loop over fixed-size on-device scans.

        One medium-sized XLA program (scan of ``chunk`` steps) compiled
        once, then
        ``ceil(T/chunk)`` dispatches with zero per-step host work. Outputs
        stay on device until one final fetch.

        ``timing=True`` blocks after each chunk and records true per-chunk
        wall times (res["chunk_ms"]; write_logs expands them into a
        chunk-granular loopTime.log — the async runner gives per-STEP
        times). ``checkpoint_every=N`` saves a checkpoint of the
        full filter state inside the loop whenever a chunk boundary
        crosses a multiple of N steps (the reference serializes at step
        100, main.cpp:1262-1269; ours is periodic for preemption
        recovery). ``start_step`` skips already-completed steps when
        resuming from such a checkpoint; ``last_ctrl`` restores the
        carried control at that boundary (saved in the checkpoint extra —
        timestamped schedules have measurement-only steps whose predict
        reuses the last applied control, main.cpp:1192-1229).
        """
        cfg = self.cfg
        z_all, mask_all = self.z_dev, self.mask_dev
        controls = self.controls_dev
        sched = self.schedule_arrays()
        T = len(self.schedule)
        n_chunks = (T + chunk - 1) // chunk
        Tp = n_chunks * chunk
        # pad with inert steps (no measurement, no control, no predict)
        def pad(x, val):
            return jnp.concatenate(
                [x, jnp.full((Tp - T,) + x.shape[1:], val, x.dtype)])
        z_idx = pad(sched[0], 0)
        has_z = pad(sched[1], False)
        c_idx = pad(sched[2], 0)
        has_c = pad(sched[3], False)
        dts = pad(sched[4], 0.0)
        do_pred = pad(sched[5], False)

        key = (_cfg_key(cfg), bool(collect_maps), bool(collect_particles),
               self.z_dev.shape, self.controls_dev.shape, chunk)
        run_chunk = _CHUNK_CACHE.get(key)
        if run_chunk is None:
            step = functools.partial(phd_step, cfg=cfg)

            def body_of(za, ma, ctls):
                def body(carry, inp):
                    state, last_ctrl = carry
                    zi, hz, ci, hc, dt, dp = inp
                    ctrl = jnp.where(hc, ctls[ci], last_ctrl)
                    z = za[zi]
                    zm = ma[zi] & hz
                    state, out = step(state, z, zm, ctrl, dt, dp)
                    ys = [out.expected_pose, out.n_eff, out.resampled,
                          out.overflow]
                    if collect_maps:
                        ys += [out.map_mean, out.map_weight]
                    if collect_particles:
                        ys += [out.log_weight, out.poses, out.resample_idx,
                               out.map_cov, out.cardinality]
                    return (state, ctrl), tuple(ys)
                return body

            @functools.partial(jax.jit, donate_argnums=(0,))
            def run_chunk(state, last_ctrl, za, ma, ctls, *inp):
                (state, last_ctrl), ys = jax.lax.scan(
                    body_of(za, ma, ctls), (state, last_ctrl), inp)
                return state, last_ctrl, ys

            _CHUNK_CACHE[key] = run_chunk

        if start_step % chunk:
            raise ValueError(
                f"start_step ({start_step}) must be a multiple of the chunk "
                f"size ({chunk}) — checkpoints are saved at chunk boundaries")
        t0 = time.perf_counter()
        t_chunk = t0
        last_ctrl = (jnp.zeros((2,), jnp.float32) if last_ctrl is None
                     else jnp.asarray(last_ctrl, jnp.float32))
        chunks = []
        chunk_ms = []
        first_chunk = max(0, min(start_step, T)) // chunk
        if first_chunk >= n_chunks:
            raise ValueError(
                f"start_step ({start_step}) is at or past the end of the "
                f"{T}-step schedule — nothing to resume")
        next_ckpt = None
        if checkpoint_every > 0 and checkpoint_dir:
            from .runtime.checkpoint import save_checkpoint
            done = first_chunk * chunk
            next_ckpt = (done // checkpoint_every + 1) * checkpoint_every
        for i in range(first_chunk, n_chunks):
            sl = slice(i * chunk, (i + 1) * chunk)
            self.state, last_ctrl, ys = run_chunk(
                self.state, last_ctrl, z_all, mask_all, controls,
                z_idx[sl], has_z[sl], c_idx[sl],
                has_c[sl], dts[sl], do_pred[sl])
            chunks.append(ys)
            if timing:
                jax.block_until_ready(ys[0])
                now = time.perf_counter()
                chunk_ms.append((now - t_chunk) * 1000.0)
                t_chunk = now
            steps_done = min((i + 1) * chunk, T)
            if next_ckpt is not None and steps_done >= next_ckpt:
                save_checkpoint(
                    os.path.join(checkpoint_dir, f"step{steps_done:05d}"),
                    self.state,
                    extra={"step": np.asarray(steps_done),
                           "last_ctrl": np.asarray(last_ctrl)})
                next_ckpt = (steps_done // checkpoint_every + 1) \
                    * checkpoint_every
        jax.block_until_ready(chunks[-1][0])
        wall = time.perf_counter() - t0

        pad_steps = first_chunk * chunk         # resumed-over prefix

        def cat(k):
            parts = [np.asarray(c[k]) for c in chunks]
            if pad_steps:                       # zero-fill skipped steps
                parts.insert(0, np.zeros((pad_steps,) + parts[0].shape[1:],
                                         parts[0].dtype))
            return np.concatenate(parts)[:T]
        out = {
            "est_poses": cat(0),
            "n_eff": cat(1),
            "resampled": cat(2),
            "overflow": int(cat(3).max()),
            "wall_s": wall,
            "steps_per_s": (T - pad_steps) / wall,
            "chunk": chunk,
            "chunk_ms": np.asarray(chunk_ms),
            "start_step": pad_steps,
        }
        if collect_maps:
            out["map_means"] = cat(4)
            out["map_weights"] = cat(5)
        if collect_particles:
            base = 6 if collect_maps else 4
            out["log_weights"] = cat(base)
            out["poses"] = cat(base + 1)
            out["resample_idx"] = cat(base + 2)
            out["map_covs"] = cat(base + 3)
            out["cardinalities"] = cat(base + 4)
        return out

    def run_sharded(self, mesh=None, collect_maps: bool = False):
        """Run the full sequence with the particle axis sharded over a device
        mesh (SURVEY.md §2.4-P1): one on-device lax.scan whose cross-particle
        reductions become collectives. ``mesh`` defaults to all devices."""
        from .parallel import (init_sharded_state, make_mesh,
                               make_sharded_scan_fn, shard_state)
        cfg = self.cfg
        if mesh is None:
            mesh = make_mesh()
        run_all = make_sharded_scan_fn(cfg, mesh)
        state = shard_state(mesh, self.state)
        sched = self.schedule_arrays()
        t0 = time.perf_counter()
        state, ys = run_all(state, self.z_dev, self.mask_dev,
                            self.controls_dev, *sched)
        jax.block_until_ready(ys)
        wall = time.perf_counter() - t0
        self.state = state
        return {
            "est_poses": np.asarray(ys[0]),
            "n_eff": np.asarray(ys[1]),
            "resampled": np.asarray(ys[2]),
            "overflow": int(np.asarray(ys[3]).max()),
            "wall_s": wall,
            "steps_per_s": len(self.schedule) / wall,
            "n_devices": mesh.devices.size,
        }

    def write_logs(self, out_dir: str, res: dict, log_every: int = 1):
        """Write state_estimate logs + loopTime.log from a run_chunked result
        collected with ``collect_maps=True, collect_particles=True``
        (main.cpp:848-954, :1300-1305).

        loopTime.log carries TRUE per-step wall times when the run recorded
        them: per-step (async runner with timing) or chunk-granular (each
        chunk's measured wall time divided over its steps). Only a run with
        no timing record falls back to the run average.
        """
        cfg = self.cfg
        os.makedirs(out_dir, exist_ok=True)
        T = len(res["est_poses"])
        cns = res.get("cardinalities")
        for n in range(res.get("start_step", 0), T, log_every):
            gm = (res["map_weights"][n], res["map_means"][n],
                  res["map_covs"][n])
            io.write_state_log(
                out_dir, n, res["est_poses"][n],
                gm if cfg.feature_model == 0 else None,
                gm if cfg.feature_model == 1 else None,
                res["log_weights"][n], res["poses"][n],
                res["resample_idx"][n],
                cns[n] if cns is not None else None,
                cfg.max_cardinality, cfg.filter_type)
        step_ms = res.get("step_ms")
        if step_ms is None and len(res.get("chunk_ms", ())):
            chunk = res["chunk"]
            per = np.repeat(np.asarray(res["chunk_ms"]) / chunk, chunk)
            skip = res.get("start_step", 0)
            step_ms = np.concatenate([np.zeros(skip), per])[:T]
        if step_ms is None:
            step_ms = np.full((T,), res["wall_s"] * 1000.0 / max(1, T))
        with open(os.path.join(out_dir, "loopTime.log"), "w") as fh:
            fh.write("\n".join("%g" % t for t in step_ms) + "\n")

    def run(self, out_dir: Optional[str] = None, log_every: int = 1,
            verbose: bool = False, sync_every: int = 0,
            collect_state_logs: bool = False, timing: bool = False):
        """Run the full sequence with asynchronous dispatch.

        The per-step jitted function is dispatched without host
        synchronization (JAX's async dispatch keeps the device saturated);
        outputs stay on device until a single fetch at the end. This is the
        streaming counterpart of :meth:`run_scanned` — same device work, but
        no scan-sized XLA program to compile. ``sync_every > 0`` inserts
        periodic syncs to record wall-clock checkpoints (loopTime.log
        equivalent at block granularity).

        ``timing=True`` makes the loop reference-faithful instead of
        asynchronous: every step blocks and records its TRUE wall time
        (res["step_ms"] -> per-step loopTime.log, main.cpp:1300-1305), and
        a separately-dispatched prediction phase is timed per step into
        res["predict_ms"] (-> predicttime.log, the CUDA-event prediction
        timing of phdfilter.cu:1244-1251).
        """
        cfg = self.cfg
        if out_dir:
            os.makedirs(out_dir, exist_ok=True)
        outs = []
        state_snaps = []
        block_times = []
        step_times = []
        predict_times = []
        pred_fn = None
        if timing:
            from .filters.phd import predict as _predict
            from .runtime.profiling import timed_call
            pred_fn = jax.jit(functools.partial(_predict, cfg=cfg))
        last_control = jnp.zeros((2,), jnp.float32)
        zeros_z = jnp.zeros((self.m_max, 2), jnp.float32)
        zeros_mask = jnp.zeros((self.m_max,), bool)

        t0 = time.perf_counter()
        t_block = t0
        for n, plan in enumerate(self.schedule):
            if plan.c_idx >= 0:
                last_control = self.controls_dev[plan.c_idx]
            if plan.z_idx >= 0:
                z = self.z_dev[plan.z_idx]
                zm = self.mask_dev[plan.z_idx]
            else:
                z, zm = zeros_z, zeros_mask
            if timing:
                t_step = time.perf_counter()
                if plan.do_predict:
                    # timing-only extra dispatch: measures the prediction
                    # phase in isolation (the step re-runs it fused)
                    key = jax.random.fold_in(self.state.rng, self.state.step)
                    _, p_ms = timed_call(pred_fn, self.state, last_control,
                                         jnp.float32(plan.dt),
                                         key=jax.random.split(key, 3)[0])
                else:
                    p_ms = 0.0
                predict_times.append(p_ms)
            self.state, out = self.step_fn(
                self.state, z, zm, last_control,
                jnp.float32(plan.dt), plan.do_predict)
            if timing:
                jax.block_until_ready(out.n_eff)
                step_times.append((time.perf_counter() - t_step) * 1000.0)
            outs.append(out)
            if collect_state_logs or out_dir:
                # out.* are fresh jit outputs — safe to hold across the next
                # step's donation of the state buffers.
                state_snaps.append((out.log_weight, out.poses,
                                    out.resample_idx))
            if sync_every and (n + 1) % sync_every == 0:
                jax.block_until_ready(out.n_eff)
                now = time.perf_counter()
                block_times.append((now - t_block) * 1000.0 / sync_every)
                t_block = now
                if verbose:
                    print(f"step {n}/{len(self.schedule)} "
                          f"nEff={float(out.n_eff):.3f} "
                          f"{block_times[-1]:.2f}ms/step")

        jax.block_until_ready(outs[-1].n_eff)
        wall = time.perf_counter() - t0

        est_poses = np.asarray(jnp.stack([o.expected_pose for o in outs]))
        n_effs = np.asarray(jnp.stack([o.n_eff for o in outs]))
        overflow = int(np.asarray(
            jnp.max(jnp.stack([o.overflow for o in outs]))))

        if out_dir:
            maps_w = np.asarray(jnp.stack([o.map_weight for o in outs]))
            maps_m = np.asarray(jnp.stack([o.map_mean for o in outs]))
            maps_c = np.asarray(jnp.stack([o.map_cov for o in outs]))
            for n in range(0, len(outs), log_every):
                lw, poses, ridx = state_snaps[n]
                gm = (maps_w[n], maps_m[n], maps_c[n])
                io.write_state_log(
                    out_dir, n, est_poses[n],
                    gm if cfg.feature_model == 0 else None,
                    gm if cfg.feature_model == 1 else None,
                    np.asarray(lw), np.asarray(poses), np.asarray(ridx),
                    np.asarray(outs[n].cardinality),
                    cfg.max_cardinality, cfg.filter_type)
            with open(os.path.join(out_dir, "loopTime.log"), "w") as fh:
                if step_times:                  # true per-step wall times
                    fh.write("\n".join("%g" % t for t in step_times) + "\n")
                else:
                    per_step = wall * 1000.0 / max(1, len(outs))
                    fh.write("\n".join("%g" % per_step for _ in outs) + "\n")
            if predict_times:                   # phdfilter.cu:1244-1251
                with open(os.path.join(out_dir, "predicttime.log"),
                          "w") as fh:
                    fh.write("\n".join("%g" % t for t in predict_times)
                             + "\n")

        if np.isnan(n_effs).any():
            first = int(np.argmax(np.isnan(n_effs)))
            print(f"nan weights detected at step {first}!")  # main.cpp:1307

        return {
            "est_poses": est_poses,
            "n_eff": n_effs,
            "wall_s": wall,
            "steps_per_s": len(outs) / wall,
            "loop_ms": np.asarray(block_times),
            "step_ms": np.asarray(step_times) if step_times else None,
            "predict_ms": (np.asarray(predict_times) if predict_times
                           else None),
            "overflow": overflow,
            "truncated_measurements": self.n_truncated,
            "outs": outs,
        }

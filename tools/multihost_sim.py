"""True multi-process execution of the distributed runtime on one machine.

The reference has no multi-node story (SURVEY.md §5: single process, single
GPU); BASELINE.md asks for filter rate "at 1 chip, 1 host, and N>=2 hosts".
This harness runs on the CPU only (virtual devices). It runs the ACTUAL
multi-host code path — ``jax.distributed.initialize``
(phdslam_tpu.parallel.distributed), a global mesh spanning the processes, and
the same jit + NamedSharding step — as N separate OS processes with 4 virtual
CPU devices each, wired together over the Gloo collectives backend. Every
cross-host mechanism is exercised for real: process-local shard addressing,
cross-process psum for weight normalization/nEff, the resampling ancestry
all-gather, and the map-migration gather (forced by resample_threshold=1).

Usage:
    python tools/multihost_sim.py [--nproc 2] [--steps 8] [--particles 32]

Prints a parity verdict (N-process trace vs single-process trace) and one
JSON summary line.
"""

import argparse
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _child(rank: int, nproc: int, port: int, steps: int, particles: int):
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax
    jax.config.update("jax_platforms", "cpu")

    from phdslam_tpu.parallel import distributed

    if nproc > 1:
        ok = distributed.initialize(f"localhost:{port}", nproc, rank)
        assert ok and jax.process_count() == nproc

    if os.environ.get("MH_VARIANT") == "disparity":
        _child_disparity(rank, nproc, steps, particles)
        return

    import jax.numpy as jnp
    import numpy as np

    from phdslam_tpu.config import SlamConfig
    from phdslam_tpu.parallel import init_sharded_state, make_sharded_step_fn

    mesh = distributed.global_mesh()
    cfg = SlamConfig(
        n_particles=particles, max_features=12, max_measurements=4,
        motion_type=0, feature_model=0, filter_type=0,
        max_range=15.0, std_range=0.25, std_bearing=0.02,
        clutter_rate=5.0, pd=0.95, birth_weight=0.05, min_separation=2.0,
        resample_threshold=1.0,  # resample every step: forces the migration
        seed=3)                  # gather across process boundaries

    z = np.zeros((cfg.max_measurements, 2), np.float32)
    z[:3] = [[5.0, 0.1], [8.0, -0.4], [3.0, 1.0]]
    zm = np.zeros((cfg.max_measurements,), bool)
    zm[:3] = True
    ctrl = np.zeros((2,), np.float32)

    step = make_sharded_step_fn(cfg, mesh, donate=False)
    load_ckpt = os.environ.get("MH_LOAD_CKPT")
    save_ckpt = os.environ.get("MH_SAVE_CKPT")
    if load_ckpt:
        # resume-across-process-count: every rank loads the replicated host
        # checkpoint, shard_state carves out this mesh's shards (the
        # global-value-on-every-process convention of parallel/sharding.py)
        from phdslam_tpu.parallel import shard_state
        from phdslam_tpu.runtime.checkpoint import load_checkpoint
        from phdslam_tpu.types import init_state
        host_state = load_checkpoint(load_ckpt, init_state(cfg))
        host_state = jax.tree.map(np.asarray, host_state)
        state = shard_state(mesh, host_state)
    else:
        state = init_sharded_state(cfg, mesh)

    import time
    steps = max(2, steps)  # need >=1 timed step after the warm-up step
    poses, neffs = [], []
    t0 = None
    out = None
    for n in range(steps):
        if n == 1:
            jax.block_until_ready(state.pose)
            t0 = time.perf_counter()
        state, out = step(state, jnp.asarray(z), jnp.asarray(zm),
                          jnp.asarray(ctrl), jnp.float32(0.1),
                          jnp.asarray(n > 0 or load_ckpt is not None))
        poses.append(np.asarray(out.expected_pose)[:3].tolist())
        neffs.append(float(out.n_eff))
    jax.block_until_ready(out.n_eff)
    wall = time.perf_counter() - t0

    if save_ckpt:
        # all-gather the sharded state to replicated, read the local copy,
        # save from rank 0 (host checkpoint)
        from jax.sharding import NamedSharding, PartitionSpec
        repl = jax.jit(
            lambda s: s,
            out_shardings=jax.tree.map(
                lambda _: NamedSharding(mesh, PartitionSpec()), state)
        )(state)
        host_state = jax.tree.map(
            lambda x: np.asarray(x.addressable_data(0)), repl)
        if rank == 0:
            from phdslam_tpu.runtime.checkpoint import save_checkpoint
            save_checkpoint(save_ckpt, host_state)
        if nproc > 1:
            from jax.experimental import multihost_utils
            multihost_utils.sync_global_devices("ckpt_saved")

    if rank == 0:
        print("RESULT " + json.dumps({
            "poses": poses, "n_eff": neffs,
            "steps_per_s": (steps - 1) / wall,
            "n_processes": jax.process_count(),
            "n_devices": len(jax.devices()),
            "resampled": bool(out.resampled),
        }), flush=True)


def _child_disparity(rank: int, nproc: int, steps: int, particles: int):
    """SC-PHD disparity variant of the multi-process parity run: the
    per-particle cloud state [P, K, N, 3] shards across the process
    group's devices; resampling forced every step so the cloud migration
    (ppermute neighbor exchange / fallback gather) crosses process
    boundaries."""
    import time

    import jax
    import jax.numpy as jnp
    import numpy as np

    from phdslam_tpu.config import SlamConfig
    from phdslam_tpu.parallel import distributed
    from phdslam_tpu.parallel.sharding import (
        init_sharded_disparity_state, make_sharded_disparity_step_fn)

    mesh = distributed.global_mesh()
    cfg = SlamConfig(
        n_particles=particles, max_features=8, max_measurements=8,
        particles_per_feature=16, motion_type=0, filter_type=0,
        pd=0.9, clutter_rate=2.0, birth_weight=0.05, min_separation=8.0,
        fx=500.0, fy=500.0, u0=320.0, v0=240.0, image_width=640,
        image_height=480, std_u=1.0, std_v=1.0, disparity_birth=100.0,
        std_d_birth=30.0, vx0=0.25, resample_threshold=1.1, seed=5)

    rng = np.random.default_rng(2)
    z = rng.uniform([100, 100], [540, 380], (8, 2)).astype(np.float32)
    zm = np.ones((8,), bool)

    step = make_sharded_disparity_step_fn(cfg, mesh, donate=False)
    state = init_sharded_disparity_state(cfg, mesh)
    poses, neffs = [], []
    t0 = None
    out = None
    steps = max(2, steps)
    for n in range(steps):
        if n == 1:
            jax.block_until_ready(state.cam_pose)
            t0 = time.perf_counter()
        state, out = step(state, jnp.asarray(z), jnp.asarray(zm),
                          jnp.float32(1.0), jnp.asarray(n > 0))
        poses.append(np.asarray(out.expected_pose)[:3].tolist())
        neffs.append(float(out.n_eff))
    jax.block_until_ready(out.n_eff)
    wall = time.perf_counter() - t0

    if rank == 0:
        print("RESULT " + json.dumps({
            "poses": poses, "n_eff": neffs,
            "steps_per_s": (steps - 1) / wall,
            "n_processes": jax.process_count(),
            "n_devices": len(jax.devices()),
            "resampled": bool(out.resampled),
        }), flush=True)


def _run_group(nproc: int, port: int, steps: int, particles: int,
               timeout_s: float = 480.0, extra_env: dict = None) -> dict:
    """Launch the rank processes and wait for ALL of them, polling so a
    crashed or hung rank is detected promptly and the whole group is killed
    (a dead rank leaves its peers blocked inside a Gloo collective forever).
    Each rank's stdout goes to its own temp file — a PIPE would stall a
    chatty rank once the 64 KB pipe buffer fills while the parent waits."""
    import tempfile
    import time

    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "MH_SAVE_CKPT", "MH_LOAD_CKPT")}
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env.update(extra_env or {})
    procs, logs = [], []
    try:
        for r in range(nproc):
            logs.append(tempfile.TemporaryFile(mode="w+", prefix=f"mh{r}_"))
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--child",
                 str(r), str(nproc), str(port), str(steps), str(particles)],
                stdout=logs[-1], stderr=subprocess.STDOUT,
                text=True, env=env, cwd=REPO))
        deadline = time.monotonic() + timeout_s
        while True:
            codes = [p.poll() for p in procs]
            if all(c is not None for c in codes):
                break
            failed = [r for r, c in enumerate(codes)
                      if c is not None and c != 0]
            if failed or time.monotonic() > deadline:
                for p in procs:
                    if p.poll() is None:
                        p.kill()
                logs[failed[0] if failed else 0].seek(0)
                tail = logs[failed[0] if failed else 0].read()[-3000:]
                raise RuntimeError(
                    f"rank {'%d failed' % failed[0] if failed else 'group timed out'}:\n{tail}")
            time.sleep(0.2)
        for r, (p, lg) in enumerate(zip(procs, logs)):
            if p.returncode != 0:
                lg.seek(0)
                raise RuntimeError(f"rank {r} failed:\n{lg.read()[-3000:]}")
        logs[0].seek(0)
        for line in logs[0].read().splitlines():
            if line.startswith("RESULT "):
                return json.loads(line[len("RESULT "):])
        raise RuntimeError("no RESULT line from rank 0")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for lg in logs:
            lg.close()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--child", nargs=5, metavar=("RANK", "NPROC", "PORT",
                                                 "STEPS", "PARTICLES"))
    ap.add_argument("--nproc", type=int, default=2)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--particles", type=int, default=32)
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--disparity", action="store_true",
                    help="run the SC-PHD disparity variant (cloud-state "
                         "sharding + forced cross-process migration)")
    ap.add_argument("--ckpt-test", action="store_true",
                    help="resume-across-process-count parity: run half the "
                         "steps on 2 processes, checkpoint, resume on "
                         "--nproc processes, compare the resumed trace "
                         "against an uninterrupted 1-process run")
    args = ap.parse_args()

    if args.child:
        _child(*(int(x) for x in args.child))
        return

    import socket

    def free_port():
        with socket.socket() as s:
            s.bind(("localhost", 0))
            return s.getsockname()[1]

    if args.ckpt_test:
        import numpy as np
        import tempfile
        s1 = max(2, args.steps // 2)
        s2 = max(2, args.steps - s1)
        with tempfile.TemporaryDirectory(prefix="mh_ckpt_") as tmp:
            ckpt = os.path.join(tmp, "ck")
            _run_group(2, free_port(), s1, args.particles,
                       extra_env={"MH_SAVE_CKPT": ckpt})
            resumed = _run_group(args.nproc, free_port(), s2,
                                 args.particles,
                                 extra_env={"MH_LOAD_CKPT": ckpt})
            ref = _run_group(1, 0, s1 + s2, args.particles)
        pose_err = float(np.max(np.abs(
            np.asarray(resumed["poses"])
            - np.asarray(ref["poses"])[s1:s1 + s2])))
        parity = pose_err < 5e-4
        print(f"2-proc ckpt -> {args.nproc}-proc resume vs uninterrupted "
              f"1-proc: max pose diff {pose_err:.2e} -> "
              f"{'PARITY' if parity else 'MISMATCH'}")
        print(json.dumps({
            "metric": "multiprocess_ckpt_resume_parity", "parity": parity,
            "nproc": args.nproc, "pose_maxdiff": pose_err,
        }))
        sys.exit(0 if parity else 1)

    # nproc=1 skips jax.distributed entirely — no port needed; probe the
    # coordinator port right before the distributed group launches to keep
    # the bind-race window minimal
    variant_env = {"MH_VARIANT": "disparity"} if args.disparity else {}
    ref = _run_group(1, 0, args.steps, args.particles,
                     extra_env=variant_env)
    dist = _run_group(args.nproc, args.port or free_port(), args.steps,
                      args.particles, extra_env=variant_env)

    import numpy as np
    pose_err = float(np.max(np.abs(
        np.asarray(dist["poses"]) - np.asarray(ref["poses"]))))
    neff_err = float(np.max(np.abs(
        np.asarray(dist["n_eff"]) - np.asarray(ref["n_eff"]))))
    parity = pose_err < 5e-4 and neff_err < 5e-4
    print(f"1-process trace vs {args.nproc}-process trace: "
          f"max pose diff {pose_err:.2e}, max nEff diff {neff_err:.2e} -> "
          f"{'PARITY' if parity else 'MISMATCH'}")
    print(json.dumps({
        "metric": "multiprocess_parity", "parity": parity,
        "nproc": args.nproc, "global_devices": dist["n_devices"],
        "pose_maxdiff": pose_err, "neff_maxdiff": neff_err,
        "resample_migration_exercised": dist["resampled"],
        "steps_per_s_1p": round(ref["steps_per_s"], 2),
        "steps_per_s_np": round(dist["steps_per_s"], 2),
    }))
    sys.exit(0 if parity else 1)


if __name__ == "__main__":
    main()

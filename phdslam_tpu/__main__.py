"""Command-line driver.

Mirrors the reference binary's CLI (/root/reference/src/main.cpp:1442-1514):

    python -m phdslam_tpu <config.cfg> [synth|disparity] [profile]

* positional 1: config file path
* positional 2: run type (default ``synth``; ``disparity`` runs the
  monocular SC-PHD pipeline)
* ``--profile``: snapshot-replay profiling mode — loads a saved checkpoint
  and executes a single measurement update (the reference's 3rd-argument
  profile run, main.cpp:1314-1321)

Outputs go to a timestamped directory containing ``state_estimateXXXXX.log``
files, ``loopTime.log`` and a copy of the config (main.cpp:1480-1510).
"""

from __future__ import annotations

import argparse
import os
import shutil
import time


def main(argv=None):
    ap = argparse.ArgumentParser(prog="phdslam_tpu")
    ap.add_argument("config", help="config file path")
    ap.add_argument("run_type", nargs="?", default="synth",
                    choices=["synth", "disparity"])
    ap.add_argument("--profile", metavar="CHECKPOINT",
                    help="load checkpoint and run a single update")
    ap.add_argument("--out-dir", default=None,
                    help="output directory (default: timestamped)")
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--particles", type=int, default=None)
    ap.add_argument("--runner", default="chunked",
                    choices=["chunked", "scanned", "async"],
                    help="execution strategy for the filter loop")
    ap.add_argument("--chunk", type=int, default=64,
                    help="steps per on-device scan for the chunked runner")
    ap.add_argument("--checkpoint-every", type=int, default=0,
                    help="write a checkpoint every N steps during "
                         "the run (chunked runner; main.cpp:1262-1269)")
    ap.add_argument("--resume", metavar="CHECKPOINT", default=None,
                    help="resume a chunked run from a mid-run checkpoint "
                         "written by --checkpoint-every")
    ap.add_argument("--timing", action="store_true",
                    help="reference-faithful timed loop (async runner): "
                         "true per-step loopTime.log + predicttime.log")
    ap.add_argument("--replay", default=None,
                    choices=["png", "gif", "mp4"],
                    help="write a replay artifact (4-panel frames: map, "
                         "particles, weights, cardinality) + the "
                         "weight-inspector figure (chunked runner)")
    ap.add_argument("--replay-every", type=int, default=10,
                    help="replay frame stride")
    ap.add_argument("--debug", action="store_true",
                    help="enable NaN checks (the reference's NaN-weight "
                         "abort, main.cpp:1307, as a raised error)")
    ap.add_argument("--trace", metavar="DIR", default=None,
                    help="write a jax.profiler trace of the run")
    ap.add_argument("--distributed", action="store_true",
                    help="initialize the multi-host runtime "
                         "(jax.distributed; same command on every host)")
    args = ap.parse_args(argv)

    from .runtime.compile_cache import configure_compile_cache
    configure_compile_cache()
    if args.distributed:
        from .parallel import distributed
        multi = distributed.initialize()
        if multi:
            import jax
            print(f"multi-host runtime: process "
                  f"{jax.process_index()}/{jax.process_count()}, "
                  f"{len(jax.devices())} global devices")

    from .config import load_config
    cfg = load_config(args.config)
    if args.steps is not None:
        cfg.n_steps = args.steps
    if args.particles is not None:
        cfg.n_particles = args.particles

    out_dir = args.out_dir
    if out_dir is None:
        stamp = time.strftime("%Y%m%d-%H%M%S")
        out_dir = os.path.join("runs", stamp)
    os.makedirs(out_dir, exist_ok=True)
    shutil.copy(args.config, os.path.join(out_dir, "config.cfg"))

    import contextlib

    from .runtime import profiling
    ctx = contextlib.ExitStack()
    if args.debug:
        ctx.enter_context(profiling.debug_mode(nan_checks=True))
    if args.trace:
        ctx.enter_context(profiling.trace(args.trace))

    with ctx:
        if args.run_type == "disparity":
            from .slam_disparity import run_disparity
            res = run_disparity(
                cfg, out_dir=out_dir, timing=args.timing,
                chunk=(args.chunk if args.runner == "chunked" else 0))
        elif args.profile:
            from .runtime.checkpoint import profile_single_update
            res = profile_single_update(cfg, args.profile)
        else:
            from .slam import SynthSLAMRunner
            runner = SynthSLAMRunner(cfg)
            if args.timing and args.runner != "async":
                print("--timing uses the per-step async runner")
                args.runner = "async"
            start_step = 0
            last_ctrl = None
            if args.resume:
                import numpy as np

                from .runtime.checkpoint import load_checkpoint
                if args.runner != "chunked":
                    # a non-chunked runner would replay the full schedule
                    # from step 0 on the already-advanced state
                    ap.error("--resume requires --runner chunked "
                             "(start_step is only honored there)")
                try:
                    state, extra = load_checkpoint(
                        args.resume, runner.state,
                        extra_like={"step": np.asarray(0),
                                    "last_ctrl": np.zeros(2, np.float32)})
                except Exception:   # pre-round-3 checkpoint: step only
                    state, extra = load_checkpoint(
                        args.resume, runner.state,
                        extra_like={"step": np.asarray(0)})
                runner.state = state
                if extra:
                    start_step = int(np.asarray(extra["step"]))
                    if "last_ctrl" in extra:
                        last_ctrl = np.asarray(extra["last_ctrl"])
                print(f"resumed from {args.resume} at step {start_step}")
            if args.runner == "chunked":
                res = runner.run_chunked(
                    chunk=args.chunk,
                    collect_maps=True, collect_particles=True, timing=True,
                    checkpoint_every=args.checkpoint_every,
                    checkpoint_dir=(os.path.join(out_dir, "checkpoints")
                                    if args.checkpoint_every else None),
                    start_step=start_step, last_ctrl=last_ctrl)
                runner.write_logs(out_dir, res)
                if args.replay:
                    import numpy as np

                    from .eval.plots import (animate_run,
                                             plot_weight_inspector)
                    gt = None
                    gt_path = os.path.join(cfg.data_directory,
                                           "groundtruth.npz")
                    if os.path.exists(gt_path):
                        gt = dict(np.load(gt_path))
                    art = animate_run(res, os.path.join(out_dir, "replay"),
                                      gt=gt, fmt=args.replay,
                                      every=args.replay_every)
                    plot_weight_inspector(
                        res["log_weights"],
                        os.path.join(out_dir, "weights.png"))
                    if args.replay == "png":
                        art = os.path.dirname(art[0])
                    print(f"replay artifact: {art}")
            elif args.runner == "scanned":
                res = runner.run_scanned()
            else:
                res = runner.run(out_dir=out_dir, timing=args.timing)
            if args.checkpoint_every and args.runner != "chunked":
                from .runtime.checkpoint import save_checkpoint
                save_checkpoint(os.path.join(out_dir, "checkpoint"),
                                runner.state)

    print(f"done: {len(res['est_poses'])} steps "
          f"{res.get('steps_per_s', 0):.2f} steps/s -> {out_dir}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""Sharded-program overhead on ONE device.

Does the NamedSharding step program (the one ``run_sharded`` builds, with
its partitioner-inserted collectives reduced to no-ops on a 1-device mesh)
run at the same rate as the unsharded program on the same device?

Protocol: ackerman P=10240 and dense P=10240/K=1024, truncated schedules,
best-of-N.

Usage: python tools/sharded_overhead.py [ackerman|dense|both]
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

from phdslam_tpu.config import load_config
from phdslam_tpu.parallel import make_mesh
from phdslam_tpu.slam import SynthSLAMRunner


def _best_of(make_runner, run_once, reps=3):
    run_once(make_runner())                      # compile + warm
    best = None
    for _ in range(reps):
        r = make_runner()
        t0 = time.perf_counter()
        run_once(r)
        dt = time.perf_counter() - t0
        best = dt if best is None else min(best, dt)
    return best


def row(name, cfg_path, data_dir, particles, n_steps, reps=3):
    cfg = load_config(cfg_path)
    cfg.n_particles = particles
    cfg.n_steps = n_steps

    def make():
        return SynthSLAMRunner(cfg, data_dir)

    T = len(make().schedule)
    mesh = make_mesh(1)     # ONE device: the sharded program, collectives

    w_un = _best_of(make, lambda r: r.run_scanned(collect_maps=False), reps)
    w_sh = _best_of(make, lambda r: r.run_sharded(mesh=mesh), reps)
    un, sh = T / w_un, T / w_sh
    ovh = (w_sh - w_un) / w_un * 100.0
    print(f"{name}: unsharded {un:.2f} steps/s | sharded(1-dev mesh) "
          f"{sh:.2f} steps/s | overhead {ovh:+.1f}%", flush=True)
    return un, sh, ovh


def main(which="both"):
    if which in ("ackerman", "both"):
        row("ackerman P=10240 (200 sched steps)", "cfg/ackerman.cfg",
            "data/ackerman", 10240, 200)
    if which in ("dense", "both"):
        row("dense P=10240 K=1024 (40 steps)", "cfg/dense.cfg",
            "data/dense", 10240, 40)


if __name__ == "__main__":
    from phdslam_tpu.runtime.compile_cache import configure_compile_cache
    configure_compile_cache()
    main(sys.argv[1] if len(sys.argv) > 1 else "both")

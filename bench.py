"""Headline benchmark + scale matrix: filter steps/s across configurations.

Headline: the full Rao-Blackwellized GM-PHD SLAM filter (predict + GM-PHD
update + extraction + resampling) over the synthetic Ackerman dataset
(/root/reference/matlab/measurements_synth_ackerman.txt protocol, 331
measurement steps + 999 controls interleaved by timestamp) at the
reference's default particle count (512, main.cpp:991), best-of-3.

The matrix covers the scale configurations: P=10240 chunked, dense
P=1024/K=1024 and P=10240/K=1024 (BASELINE >=1k-component target), CPHD
P=512 and P=10240, mixed jump-Markov P=512 and P=10240, disparity P=200
and P=512 — single timed run each, best-of-3 on the headline only. A row
that fails stops the run.

Baseline: the reference publishes no numbers (BASELINE.md); its implied
target is real-time operation at the dataset rate dt=0.1 s -> 10 filter
steps/s. ``vs_baseline`` is the measured multiple of that real-time rate.

Prints ONE JSON line (headline metric keys, a ``matrix`` dict and the
``device`` the rows ran on).
"""

import json
import sys
import time


def _timed_runner(make_runner, run_once, reps):
    """Best-of-``reps`` wall time; one extra warm run for compilation."""
    run_once(make_runner())
    best = None
    for _ in range(reps):
        r = make_runner()
        t0 = time.perf_counter()
        run_once(r)
        dt = time.perf_counter() - t0
        best = dt if best is None else min(best, dt)
    return best


def _row(cfg_path, data_dir, particles, runner, reps, chunk=64,
         overrides=None):
    from phdslam_tpu.config import load_config
    from phdslam_tpu.slam import SynthSLAMRunner

    cfg = load_config(cfg_path)
    cfg.n_particles = particles
    for k, v in (overrides or {}).items():
        setattr(cfg, k, v)

    def make():
        return SynthSLAMRunner(cfg, data_dir)

    n_steps = len(make().schedule)
    if runner == "scanned":
        wall = _timed_runner(make,
                             lambda r: r.run_scanned(collect_maps=False),
                             reps)
    else:
        wall = _timed_runner(
            make, lambda r: r.run_chunked(chunk=chunk, collect_maps=False),
            reps)
    return round(n_steps / wall, 2)


def _mixed_row(P=512, T=100, reps=1):
    import os
    sys.path.insert(0, os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "tools"))
    import bench_mixed
    return round(bench_mixed.bench(P, 128, 32, T, fast=1, reps=reps), 2)


def _disparity_row(P, n_steps=60, reps=2):
    """Disparity SC-PHD throughput at reference particle scale
    (cfg/config.cfg:141 n_particles=200, main.cpp:991 default 512)."""
    import copy
    import tempfile

    from phdslam_tpu.config import load_config
    from phdslam_tpu.eval import simdata
    from phdslam_tpu.slam_disparity import run_disparity

    cfg0 = load_config("cfg/disparity.cfg")
    _, _, measurements = simdata.generate_disparity_world(
        n_landmarks=24, n_steps=n_steps, dt=cfg0.dt, seed=0,
        fx=cfg0.fx, fy=cfg0.fy, u0=cfg0.u0, v0=cfg0.v0,
        width=int(cfg0.image_width), height=int(cfg0.image_height),
        std_uv=cfg0.std_u, pd=cfg0.pd, clutter_rate=cfg0.clutter_rate,
        vx=cfg0.vx0)
    with tempfile.TemporaryDirectory() as tmp:
        simdata.write_disparity_run_dir(tmp, measurements)
        cfg = copy.deepcopy(cfg0)
        cfg.n_particles = P
        cfg.n_steps = n_steps
        chunk = 20 if P >= 200 else 0
        run_disparity(copy.deepcopy(cfg), data_dir=tmp, chunk=chunk)  # warm
        best = 0.0
        for _ in range(reps):
            res = run_disparity(copy.deepcopy(cfg), data_dir=tmp,
                                chunk=chunk)
            best = max(best, res["steps_per_s"])
    return round(best, 2)


def main():
    import jax

    from phdslam_tpu.runtime.compile_cache import configure_compile_cache

    configure_compile_cache()
    dev = jax.devices()[0]
    device = {"platform": dev.platform, "kind": dev.device_kind,
              "count": len(jax.devices())}
    print(f"device: {device}", file=sys.stderr)

    ack = "cfg/ackerman.cfg"
    cphd = "cfg/ackerman_cphd.cfg"
    matrix = {"ackerman_512p": _row(ack, "data/ackerman", 512, "scanned",
                                    reps=3)}
    rows = [
        ("ackerman_10240p", lambda: _row(ack, "data/ackerman", 10240,
                                         "chunked", reps=1, chunk=16)),
        ("dense_1024p_1024k", lambda: _row("cfg/dense.cfg", "data/dense",
                                           1024, "chunked", reps=1,
                                           chunk=16)),
        ("dense_10240p_1024k", lambda: _row("cfg/dense.cfg", "data/dense",
                                            10240, "chunked", reps=1,
                                            chunk=4)),
        ("cphd_512p", lambda: _row(cphd, "data/ackerman", 512, "scanned",
                                   reps=3)),
        ("cphd_10240p", lambda: _row(cphd, "data/ackerman", 10240,
                                     "chunked", reps=3, chunk=16)),
        ("mixed_512p", _mixed_row),
        ("mixed_10240p", lambda: _mixed_row(P=10240, T=30)),
        ("disparity_200p", lambda: _disparity_row(200)),
        ("disparity_512p", lambda: _disparity_row(512)),
    ]
    for name, fn in rows:
        matrix[name] = fn()

    headline = matrix["ackerman_512p"]
    print(json.dumps({
        "metric": "ackerman_512p_filter_steps_per_s_scanned",
        "value": headline,
        "unit": "steps/s",
        "vs_baseline": round(headline / 10.0, 3),
        "matrix": matrix,
        "device": device,
    }))


if __name__ == "__main__":
    main()

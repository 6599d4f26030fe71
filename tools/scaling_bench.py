"""Multi-chip scaling analysis of the sharded filter step.

BASELINE.md asks for filter updates/s/chip at 1 chip / 1 host / N hosts
with >=80% scaling efficiency. This tool runs on the CPU only, on an
8-device virtual mesh: the devices share one physical socket, so timing
them says nothing about scaling. What it does verify, and reports:

1. **Correct SPMD compilation** — the sharded step
   (`parallel.make_sharded_step_fn`, jit + NamedSharding over the particle
   mesh) compiles and runs on an 8-device mesh (also covered by
   tests/test_sharding.py, which checks numerical parity vs single-device).
2. **Collective inventory** — every cross-device op XLA inserted into the
   compiled module, with its payload size. The filter is
   embarrassingly particle-parallel except log-weight normalization, nEff,
   extraction, and resampling; scaling efficiency at pod scale is set by
   the ratio of these collective bytes to per-device compute.

Per-step collective traffic is O(P) scalars + one map all-gather when
resampling migrates particles; local compute is O(P/N * (K M + clusters
* cap)). The printed ratio is the hardware-independent basis for the >=80%
efficiency expectation; the time of the collectives on GPUs comes only
from a profiler trace of a run on the cards.

Usage: python tools/scaling_bench.py  (forces the CPU backend)
"""

import json
import os
import re
import sys

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

DTYPE_BYTES = {"f32": 4, "s32": 4, "u32": 4, "pred": 1, "f64": 8, "s64": 8,
               "bf16": 2, "f16": 2, "s8": 1, "u8": 1}
COLLECTIVES = ("all-reduce", "all-gather", "all-to-all", "collective-permute",
               "reduce-scatter", "collective-broadcast")


def shape_bytes(shape_str):
    m = re.match(r"(\w+)\[([\d,]*)\]", shape_str)
    if not m:
        return 0
    dt, dims = m.groups()
    n = 1
    for d in dims.split(","):
        if d:
            n *= int(d)
    return n * DTYPE_BYTES.get(dt, 4)


def make_cfg(n_particles, K=128, M=64, cap=512, **kw):
    from phdslam_tpu.config import SlamConfig
    base = dict(
        n_particles=n_particles, max_features=K, max_measurements=M,
        motion_type=1, feature_model=0, filter_type=0,
        l=2.83, h=0.76, a=3.78, b=0.5, std_encoder=0.1, std_alpha=0.01,
        max_range=12.0, std_range=0.5, std_bearing=0.0349,
        clutter_rate=5.0, pd=0.95, birth_weight=0.05, min_separation=4.0,
        resample_threshold=0.5, merge_candidate_cap=cap, pallas_merge=0,
        seed=0)
    base.update(kw)
    return SlamConfig(**base)


def analyze_collectives(hlo):
    """Split an HLO module into unconditional vs cond-branch collectives.
    Returns (uncond, cond_only) dicts: kind -> (count, bytes)."""
    comps = {}
    name = None
    for line in hlo.splitlines():
        if line.rstrip().endswith("{") and ("(" in line):
            m2 = re.match(r"\s*(?:ENTRY\s+)?%?([\w\.\-]+)", line)
            name = m2.group(1) if m2 else None
            comps[name] = []
        elif name is not None:
            comps[name].append(line.strip())
    branch_comps = set()
    for lines in comps.values():
        for ls in lines:
            if "conditional(" in ls:
                branch_comps.update(re.findall(
                    r"(?:true_computation|false_computation|branch_computations=\{?)=?%([\w\.\-]+)",
                    ls))
                branch_comps.update(re.findall(r"%([\w\.\-]+)", ls.split(
                    "computations={")[-1]) if "computations={" in ls else [])
    uncond, cond_only = {}, {}
    for cname, lines in comps.items():
        bucket = cond_only if cname in branch_comps else uncond
        for ls in lines:
            for kind in COLLECTIVES:
                if re.search(rf"= \(?[\w\[\],\s]*\)?\s*{kind}\(", ls) \
                        or f" {kind}(" in ls:
                    shapes = re.findall(r"(\w+\[[\d,]*\])",
                                        ls.split("=", 1)[1].split(kind)[0])
                    b = sum(shape_bytes(s) for s in shapes)
                    c, t = bucket.get(kind, (0, 0))
                    bucket[kind] = (c + 1, t + b)
    return uncond, cond_only


def print_buckets(uncond, cond_only):
    print(f"{'collective':22s} {'count':>5s} {'bytes/step':>12s}")
    for tag, bucket in (("every step", uncond),
                        ("resample steps only", cond_only)):
        if bucket:
            print(f"-- {tag}:")
            for kind, (c, b) in bucket.items():
                print(f"{kind:22s} {c:5d} {b:12,d}")
    return sum(b for _, b in uncond.values())


def main(n_dev=8, p_per_dev=128, cfg=None, execute=True):
    from phdslam_tpu.parallel import (init_sharded_state, make_mesh,
                                      make_sharded_step_fn)

    if cfg is None:
        cfg = make_cfg(p_per_dev * n_dev)
    P, K, M = cfg.n_particles, cfg.max_features, cfg.max_measurements

    mesh = make_mesh(n_dev)
    step = make_sharded_step_fn(cfg, mesh, donate=False)
    state = jax.eval_shape(
        lambda: init_sharded_state(cfg, mesh)) if not execute else \
        init_sharded_state(cfg, mesh)
    if not execute:
        # compile-only inventory at shapes too large to run on the CPU
        # mesh (2 host cores): AOT-lower from shape structs
        from phdslam_tpu.parallel.sharding import state_shardings
        sh = state_shardings(mesh, state)
        state = jax.tree.map(
            lambda s, shard: jax.ShapeDtypeStruct(s.shape, s.dtype,
                                                  sharding=shard),
            state, sh)
    z = jnp.zeros((M, 2), jnp.float32).at[:6].set(
        jnp.asarray(np.random.default_rng(0).uniform(
            [1, -3], [10, 3], (6, 2)), jnp.float32))
    zm = jnp.arange(M) < 6
    args = (state, z, zm, jnp.asarray([1.0, 0.05], jnp.float32),
            jnp.float32(1.0), jnp.asarray(True))

    lowered = step.lower(*args)
    compiled = lowered.compile()
    hlo = compiled.as_text()

    if execute:
        # run it too — proof of execution on the 8-device mesh
        st2, out = step(*args)
        jax.block_until_ready(out.expected_pose)
        assert np.isfinite(np.asarray(out.expected_pose)).all()

    print(f"sharded step compiled{' + executed' if execute else ''} on "
          f"{n_dev}-device mesh (P={P}, K={K}, M={M}, "
          f"cap={cfg.merge_candidate_cap}, "
          f"map_estimate={cfg.map_estimate})\n")

    # ops in a computation referenced by a `conditional(...)` only execute
    # when that branch is taken (the resample migration lives there)
    uncond, cond_only = analyze_collectives(hlo)
    coll_bytes = print_buckets(uncond, cond_only)

    state_bytes = sum(np.prod(x.shape) * 4 for x in jax.tree.leaves(state)
                      if hasattr(x, "shape"))
    local_grid = (P // n_dev) * M * K * 4
    print(f"\ntotal collective payload/step: {coll_bytes:,d} B")
    print(f"per-device local state:        {int(state_bytes)//n_dev:,d} B")
    print(f"per-device [P/N,M,K] grid:     {local_grid:,d} B")
    ratio = coll_bytes / max(local_grid, 1)
    print(f"collective : local-grid ratio: {ratio:.3f}")
    print("\n(note: the resample-steps bucket holds BOTH lax.cond branches "
          "of the migration — the executed path is the collective-permute "
          "neighbor exchange (parallel/migrate.py, bytes ∝ 2 x budget rows "
          "per leaf); the full all-gather is its infeasible-ancestry "
          "fallback and does not execute on equilibrium resampling steps)")
    print(json.dumps({"metric": "collective_bytes_per_step_8dev",
                      "value": int(coll_bytes), "unit": "bytes"}))


def disparity_inventory(n_dev=8, P=64, K=16, N=32, M=16):
    """Collective inventory + executed step for the sharded SC-PHD
    disparity pipeline (round-4 verdict item: the monocular variant's
    mesh path needs an inventory row like the synth variants)."""
    from phdslam_tpu.config import SlamConfig
    from phdslam_tpu.parallel import make_mesh
    from phdslam_tpu.parallel.sharding import (
        init_sharded_disparity_state, make_sharded_disparity_step_fn)

    cfg = SlamConfig(
        n_particles=P, max_features=K, max_measurements=M,
        particles_per_feature=N, motion_type=0, filter_type=0,
        pd=0.9, clutter_rate=2.0, birth_weight=0.05, min_separation=8.0,
        fx=500.0, fy=500.0, u0=320.0, v0=240.0, image_width=640,
        image_height=480, std_u=1.0, std_v=1.0, disparity_birth=100.0,
        std_d_birth=30.0, vx0=0.25, resample_threshold=1.1, seed=0)
    mesh = make_mesh(n_dev)
    step = make_sharded_disparity_step_fn(cfg, mesh, donate=False)
    state = init_sharded_disparity_state(cfg, mesh)
    rng = np.random.default_rng(0)
    z = jnp.asarray(rng.uniform([100, 100], [540, 380], (M, 2)),
                    jnp.float32)
    zm = jnp.asarray(np.arange(M) < 8)
    args = (state, z, zm, jnp.float32(1.0), jnp.asarray(True))
    compiled = step.lower(*args).compile()
    st2, out = step(*args)
    jax.block_until_ready(out.expected_pose)
    assert np.isfinite(np.asarray(out.expected_pose)).all()
    print(f"sharded DISPARITY step compiled + executed on {n_dev}-device "
          f"mesh (P={P}, K={K}, N={N}, M={M}; resampling forced -> the "
          f"migration path is in the per-step trace)\n")
    uncond, cond_only = analyze_collectives(compiled.as_text())
    coll = print_buckets(uncond, cond_only)
    cloud_bytes = (P // n_dev) * K * N * 3 * 4
    print(f"\ntotal unconditional collective payload/step: {coll:,d} B")
    print(f"per-device cloud state [P/N, K, N, 3]:       {cloud_bytes:,d} B")
    print(json.dumps({"metric": "disparity_collective_bytes_per_step_8dev",
                      "value": int(coll), "unit": "bytes"}))


def weak_scaling(p_per_dev=128, steps=8):
    """1/2/4/8-device CPU-mesh wall clock at fixed per-device particle
    count — a WEAK scaling signal only: every virtual device shares the
    same host socket (2 cores here), so growth above 1x reflects host
    contention, not interconnect cost. Recorded because it bounds the sharded
    step's software overhead; the collective inventory above is the
    hardware-independent basis for the >=80% efficiency expectation."""
    import time

    from phdslam_tpu.parallel import (init_sharded_state, make_mesh,
                                      make_sharded_step_fn)
    print(f"\nweak scaling (P/device = {p_per_dev}, {steps} steps, "
          f"{os.cpu_count()} host cores):")
    rows = {}
    for n_dev in (1, 2, 4, 8):
        cfg = make_cfg(p_per_dev * n_dev, K=64, M=16, cap=128)
        mesh = make_mesh(n_dev)
        step = make_sharded_step_fn(cfg, mesh, donate=False)
        state = init_sharded_state(cfg, mesh)
        M = cfg.max_measurements
        z = jnp.zeros((M, 2), jnp.float32).at[:6].set(
            jnp.asarray(np.random.default_rng(0).uniform(
                [1, -3], [10, 3], (6, 2)), jnp.float32))
        zm = jnp.arange(M) < 6
        args = (z, zm, jnp.asarray([1.0, 0.05], jnp.float32),
                jnp.float32(1.0), jnp.asarray(True))
        state, out = step(state, *args)           # compile + warm
        jax.block_until_ready(out.expected_pose)
        t0 = time.perf_counter()
        for _ in range(steps):
            state, out = step(state, *args)
        jax.block_until_ready(out.expected_pose)
        ms = (time.perf_counter() - t0) * 1000.0 / steps
        rows[n_dev] = ms
        print(f"  {n_dev} devices (P={cfg.n_particles}): {ms:7.1f} ms/step "
              f"({ms / rows[1]:.2f}x of 1-device)")
    print(json.dumps({"metric": "weak_scaling_ms_per_step",
                      "value": rows, "unit": "ms",
                      "host_cores": os.cpu_count()}))


if __name__ == "__main__":
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--dense", action="store_true",
                    help="compile-only collective inventory at the dense "
                         "BASELINE shape (P=10240, K=1024, M=96, cap=1536)")
    ap.add_argument("--eap", action="store_true",
                    help="with --dense: map_estimate=2 (EAP tree levels in "
                         "the inventory)")
    ap.add_argument("--weak", action="store_true",
                    help="1/2/4/8-device weak-scaling wall clock")
    ap.add_argument("--disparity", action="store_true",
                    help="executed collective inventory for the sharded "
                         "SC-PHD disparity step")
    args = ap.parse_args()
    if args.disparity:
        disparity_inventory()
    elif args.dense:
        cfg = make_cfg(10240, K=1024, M=96, cap=1536,
                       map_estimate=(2 if args.eap else 1),
                       detection_topk=48)
        main(n_dev=8, cfg=cfg, execute=False)
    elif args.weak:
        weak_scaling()
    else:
        main()

"""Roofline verification of the hot filter stages (BASELINE.md target:
"GM-update and prune/merge kernels at speed-of-light per chip").

For each hot stage of the GM-PHD update at the benchmark shapes, this tool
computes the analytic MINIMUM HBM traffic (inputs read once + outputs
written once) and FLOP count, measures on-device time, and reports achieved
bandwidth/compute against the chip's roofline: time_bound = max(bytes / BW,
flops / peak). Stages whose measured time approaches the bound are at
speed-of-light; the report states which resource bounds each stage.

Peaks come from ``PEAKS``, keyed by ``jax.devices()[0].device_kind``, with
their source. A device that is not in the table is an error, not a
default: the table is filled when the benchmark is defined for a card.

Usage: python tools/roofline.py [P] [cfg_path] — prints a table + one
JSON line. cfg_path defaults to cfg/ackerman.cfg; pass cfg/dense.cfg to
roofline the dense (K=1024) shapes.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# device_kind -> {"hbm_bytes_s": ..., "f32_flops_s": ..., "source": ...}
PEAKS: dict = {}


def device_peaks():
    import jax
    kind = jax.devices()[0].device_kind
    if kind not in PEAKS:
        raise KeyError(f"no roofline peaks for device kind {kind!r}; add "
                       "them to tools/roofline.py PEAKS with their source")
    return PEAKS[kind]


def measure(fn, *args, n=20):
    import jax
    f = jax.jit(fn)
    r = jax.block_until_ready(f(*args))
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(n):
            r = f(*args)
        jax.block_until_ready(r)
        best = min(best, (time.perf_counter() - t0) / n)
    return best


def main(P=512, cfg_path="cfg/ackerman.cfg"):
    import jax
    import jax.numpy as jnp

    from phdslam_tpu.runtime.compile_cache import configure_compile_cache
    configure_compile_cache()
    peaks = device_peaks()
    hbm, flops_s = peaks["hbm_bytes_s"], peaks["f32_flops_s"]

    from phdslam_tpu.config import load_config
    from phdslam_tpu.filters import phd
    from phdslam_tpu.ops import ekf
    from phdslam_tpu.ops.gm_merge import merge_batch_dispatch

    cfg = load_config(cfg_path)
    cfg.n_particles = P
    K, M, cap = cfg.max_features, cfg.max_measurements, cfg.merge_candidate_cap
    key = jax.random.PRNGKey(0)
    mean = jax.random.uniform(key, (P, K, 2), minval=-20, maxval=20)
    n_live = max(50, K // 3)
    weight = jnp.broadcast_to(jnp.where(jnp.arange(K) < n_live, 0.5, 0.0),
                              (P, K))
    cov = jnp.broadcast_to(jnp.eye(2) * 0.5, (P, K, 2, 2))
    pose = jnp.zeros((P, 6))
    z = jax.random.uniform(jax.random.PRNGKey(1), (M, 2), minval=0, maxval=8)
    zmask = jnp.arange(M) < min(29, M - 1) + (M // 3 if M > 64 else 0)
    f4 = 4

    rows = []

    def add(name, t, bytes_, flops, note):
        t_bw = bytes_ / hbm
        t_fl = flops / flops_s
        bound = max(t_bw, t_fl)
        rows.append(dict(stage=name, ms=t * 1e3, bound_ms=bound * 1e3,
                         sol=bound / t, gbs=bytes_ / t / 1e9,
                         bound_by="HBM" if t_bw >= t_fl else note, note=note))

    # --- EKF pre-update: per-feature S, S^-1, gain, Joseph cov ------------
    pre_fn = lambda p_, m_, c_: jax.vmap(
        lambda p, m, c: ekf.ekf_preupdate(p, m, c, cfg))(p_, m_, c_)
    t = measure(pre_fn, pose, mean, cov)
    by = P * K * (2 + 4) * f4 + P * K * (4 + 4 + 1 + 4 + 2 + 2 + 3) * f4
    fl = P * K * 120
    add("ekf_preupdate [P,K]", t, by, fl, "FLOP")
    pre = jax.jit(pre_fn)(pose, mean, cov)

    # --- detection likelihood grid [P,M,K] --------------------------------
    det_fn = lambda pre_, w_: jax.vmap(
        lambda pr, w: ekf.ekf_detection_linear(pr, w, z))(pre_, w_)
    t = measure(det_fn, pre, weight)
    by = P * K * 7 * f4 + P * M * K * f4          # planes in, pdw out
    fl = P * M * K * 20
    add("detection grid [P,M,K]", t, by, fl, "FLOP")

    # --- full pre half (grid + selection + candidate gather) --------------
    full_pre = lambda p_, m_, c_, w_: jax.vmap(
        lambda p, m, c, w: phd._update_single_pre(
            p, m, c, w, z, zmask, cfg))(p_, m_, c_, w_)
    t = measure(full_pre, pose, mean, cov, weight)
    by = (P * K * (2 + 4 + 1) * f4                # map in
          + P * M * K * f4 * 3                    # pdw materialize + 2 passes
          + P * cap * (2 + 4 + 1) * f4)           # candidates out
    fl = P * M * K * 30 + P * cap * K * 16 * 2
    add("update pre-half", t, by, fl, "FLOP")
    pre_out = jax.jit(full_pre)(pose, mean, cov, weight)

    # --- greedy merge ----------------------------------------------
    from phdslam_tpu.ops.gm_merge import merge_batch_dispatch_packed
    if pre_out["gather"] is not None:
        cand_fn = jax.jit(lambda p_: phd._finish_candidates_packed(p_, 2))
        t = measure(cand_fn, pre_out)
        rows.append(dict(stage="candidate gather", ms=t * 1e3,
                         bound_ms=None, sol=None, gbs=None, bound_by="",
                         note="deferred batch gather, packed planes"))
        packed = cand_fn(pre_out)
        mfn = lambda pk: merge_batch_dispatch_packed(pk, 2, cfg, K,
                                                     sorted_prefix=True)
        t = measure(mfn, packed)
        mg = jax.jit(mfn)(packed)
    else:
        cm, cc, cw, ca = pre_out["cand"]
        mfn2 = lambda *a: merge_batch_dispatch(*a, cfg, K)
        t = measure(mfn2, cm, cc, cw, ca)
        mg = jax.jit(mfn2)(cm, cc, cw, ca)
    by = P * 7 * cap * f4 + P * 8 * K * f4
    # the loop's work is data-dependent (~clusters x N x ~40 lane-ops);
    # report the memory roofline + achieved cluster rate instead
    add("greedy merge", t, by, 0, "loop")
    import numpy as np
    clusters = float(jnp.sum(mg[3]))
    rows[-1]["note"] = (f"data-dep loop: {clusters/P:.0f} clusters/particle, "
                        f"{clusters / t / 1e6:.1f}M clusters/s")

    # --- post half (recombine + top-K compaction) --------------------------
    post = lambda mg_, pre_, m_, c_, w_: jax.vmap(
        lambda t_, p2, m, c, w: phd._update_single_post(
            t_, p2, m, c, w, cfg))(mg_, pre_, m_, c_, w_)
    t = measure(post, mg, pre_out, mean, cov, weight)
    n_all = K + cap
    by = P * n_all * (2 + 4 + 1) * f4 + P * K * (2 + 4 + 1) * f4
    fl = P * K * n_all * 2                        # sort compares (approx)
    add("update post-half", t, by, fl, "FLOP")

    # --- full batched update ------------------------------------------------
    t = measure(lambda p_, m_, c_, w_: phd._batched_update(
        p_, m_, c_, w_, z, zmask, cfg), pose, mean, cov, weight)
    rows.append(dict(stage="FULL GM update", ms=t * 1e3, bound_ms=None,
                     sol=None, gbs=None, bound_by="", note="end-to-end"))

    print(f"\nRoofline @ P={P}, K={K}, M={M}, cap={cap} "
          f"({jax.devices()[0].device_kind}: {hbm/1e9:.0f} GB/s, "
          f"{peaks['source']})")
    print(f"{'stage':28s} {'ms':>8s} {'bound ms':>9s} {'SoL':>6s} "
          f"{'GB/s':>7s}  bound/note")
    for r in rows:
        sol = f"{r['sol']*100:5.1f}%" if r["sol"] else "     -"
        bnd = f"{r['bound_ms']:9.3f}" if r["bound_ms"] is not None else "        -"
        gbs = f"{r['gbs']:7.1f}" if r["gbs"] else "      -"
        print(f"{r['stage']:28s} {r['ms']:8.3f} {bnd} {sol} {gbs}  "
              f"{r['bound_by']} {r['note']}")
    print(json.dumps({"metric": f"gm_update_ms_P{P}",
                      "value": round(rows[-1]["ms"], 2), "unit": "ms"}))


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 512,
         sys.argv[2] if len(sys.argv) > 2 else "cfg/ackerman.cfg")

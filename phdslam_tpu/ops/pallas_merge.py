"""Greedy Gaussian-mixture merge as one Pallas kernel for NVIDIA GPUs.

The plain reference is :func:`ops.gm_merge.gm_merge_batch`, a vmapped
bounded ``lax.while_loop``. Under XLA each trip of that loop is a round of
kernel launches plus full ``[P, N]`` passes through device memory, and the
loop runs until the particle with the most clusters is done. This kernel
runs the same greedy loop inside one launch (Pallas, Triton route): one
program per particle, as the reference's ``phdUpdateMergeKernel<<<nP,
256>>>`` (phdfilter.cu:2707-2898) runs one thread block per particle. The
particle's candidate planes stay in registers for the whole loop, the
principal moments are scalar loads, and every emitted cluster is a scalar
store, so the output never lives in registers.

Layout (SoA planes, f32), generic in the feature dimension D:
  input  [P, 2 + D + T, N]: w, act, D mean planes, T = D(D+1)/2
                            upper-triangle covariance planes (row-major)
  output [P, 2 + D + T, K]: w, D mean planes, T covariance planes, and a
                            plane holding the leftover-candidate count

Lane widths N and K are padded to powers of two (Triton's block shapes);
padded lanes are inactive and padded output slots are sliced off.

Each loop trip extracts up to ``r_par`` clusters while reproducing the
sequential greedy order exactly:

  * tentative principals = the R highest-weight unmerged candidates;
  * tentative r is VALID iff no valid higher-weight principal lies within
    ``min_separation`` of it (in the sequential loop such a principal
    would have absorbed it first);
  * each candidate joins the highest-weight valid principal that covers
    it (in the sequential loop earlier clusters claim candidates first).

Induction on the sequential greedy sequence shows that the valid
principals and their clusters are the same as the sequential loop's, so
R cuts the number of trips, not the result.

Metrics: Mahalanobis with averaged covariance for D = 2, 3, 4
(``computeMahalDist``, device_math.cuh:308-363) and Hellinger for D = 2
(device_math.cuh:372-413).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu


def n_cov_planes(D):
    return D * (D + 1) // 2


def tri_pairs(D):
    """Upper-triangle (a, b) index pairs in the packed plane order."""
    return [(a, b) for a in range(D) for b in range(a, D)]


def next_pow2(n):
    return 1 << max(0, int(n) - 1).bit_length()


def default_num_warps(n_lanes, D):
    """Warps per program, chosen by a sweep on the H100: one warp per 512
    lanes (fewer warps keep each cluster's reductions short), four times
    that for D = 4, whose 16 planes need the extra registers."""
    return int(min(16, max(1, n_lanes // 512) * (4 if D == 4 else 1)))


def _sub(x, y):
    return [a - b for a, b in zip(x, y)]


def _mahalanobis(d, s, D):
    """d' S^-1 d for symmetric S given as its upper-triangle planes ``s``.

    Closed forms: 2x2 and 3x3 adjugates; 4x4 through the 2x2-block Schur
    complement d'S^-1 d = p'A^-1 p + u'M^-1 u with S = [[A, B], [B', C]],
    d = (p, q), M = C - B'A^-1 B, u = B'A^-1 p - q."""
    if D == 2:
        s00, s01, s11 = s
        det = jnp.maximum(s00 * s11 - s01 * s01, 1e-30)
        return (d[0] * d[0] * s11 - 2.0 * d[0] * d[1] * s01
                + d[1] * d[1] * s00) / det
    if D == 3:
        s00, s01, s02, s11, s12, s22 = s
        det = (s00 * (s11 * s22 - s12 * s12)
               - s01 * (s01 * s22 - s12 * s02)
               + s02 * (s01 * s12 - s11 * s02))
        det = jnp.where(jnp.abs(det) > 1e-30, det, 1e-30)
        i00 = (s11 * s22 - s12 * s12) / det
        i01 = (s02 * s12 - s01 * s22) / det
        i02 = (s01 * s12 - s02 * s11) / det
        i11 = (s00 * s22 - s02 * s02) / det
        i12 = (s01 * s02 - s00 * s12) / det
        i22 = (s00 * s11 - s01 * s01) / det
        return (d[0] * d[0] * i00 + d[1] * d[1] * i11 + d[2] * d[2] * i22
                + 2.0 * (d[0] * d[1] * i01 + d[0] * d[2] * i02
                         + d[1] * d[2] * i12))
    assert D == 4
    s00, s01, s02, s03, s11, s12, s13, s22, s23, s33 = s
    det_a = s00 * s11 - s01 * s01
    det_a = jnp.where(jnp.abs(det_a) > 1e-30, det_a, 1e-30)
    a00, a01, a11 = s11 / det_a, -s01 / det_a, s00 / det_a
    g00 = a00 * s02 + a01 * s12
    g01 = a00 * s03 + a01 * s13
    g10 = a01 * s02 + a11 * s12
    g11 = a01 * s03 + a11 * s13
    m00 = s22 - (s02 * g00 + s12 * g10)
    m01 = s23 - (s02 * g01 + s12 * g11)
    m11 = s33 - (s03 * g01 + s13 * g11)
    det_m = m00 * m11 - m01 * m01
    det_m = jnp.where(jnp.abs(det_m) > 1e-30, det_m, 1e-30)
    v0 = a00 * d[0] + a01 * d[1]
    v1 = a01 * d[0] + a11 * d[1]
    u0 = s02 * v0 + s12 * v1 - d[2]
    u1 = s03 * v0 + s13 * v1 - d[3]
    return (d[0] * v0 + d[1] * v1
            + (u0 * u0 * m11 - 2.0 * u0 * u1 * m01 + u1 * u1 * m00) / det_m)


def _hellinger2d(d, a, b):
    """Hellinger distance of 2D Gaussians a, b (mirrors ops.math.hellinger2,
    including its tiny-determinant identity fallback)."""
    s00, s01, s11 = a[0] + b[0], a[1] + b[1], a[2] + b[2]
    det_s = s00 * s11 - s01 * s01
    ok = det_s > 1.1754944e-38
    det_safe = jnp.where(ok, det_s, 1.0)
    quad_inv = (d[0] * d[0] * s11 - 2.0 * d[0] * d[1] * s01
                + d[1] * d[1] * s00) / det_safe
    quad_eye = d[0] * d[0] + d[1] * d[1]
    eps = -0.25 * jnp.where(ok, quad_inv, quad_eye)
    det_half = det_s / 4.0
    det_prod = (a[0] * a[2] - a[1] * a[1]) * (b[0] * b[2] - b[1] * b[1])
    ratio = jnp.sqrt(jnp.maximum(det_prod, 0.0)) / jnp.maximum(det_half, 1e-30)
    return 1.0 - jnp.sqrt(jnp.maximum(ratio, 0.0)) * jnp.exp(eps)


def _distance(mean_a, cov_a, mean_b, cov_b, D, metric):
    d = _sub(mean_a, mean_b)
    if metric == 1:
        return _hellinger2d(d, cov_a, cov_b)
    return _mahalanobis(d, [0.5 * (x + y) for x, y in zip(cov_a, cov_b)], D)


def _merge_kernel(x_ref, o_ref, *, D, out_cap, min_sep, r_par, metric,
                  sorted_w):
    """One particle's greedy merge. x_ref [C, N], o_ref [C, K]."""
    T = n_cov_planes(D)
    N = x_ref.shape[-1]
    K = o_ref.shape[-1]
    R = r_par
    w = x_ref[0, :]
    m = [x_ref[2 + i, :] for i in range(D)]
    c = [x_ref[2 + D + j, :] for j in range(T)]
    lane = jax.lax.broadcasted_iota(jnp.int32, (N,), 0)
    pairs = tri_pairs(D)

    def principal(idx):
        """Scalar loads of lane ``idx``'s mean and covariance."""
        pm = [x_ref[2 + i, idx] for i in range(D)]
        pc = [x_ref[2 + D + j, idx] for j in range(T)]
        return pm, pc

    def store(plane, slot, val, ok):
        plgpu.store(o_ref.at[plane, pl.ds(slot, 1)], val, mask=ok)

    def body(carry):
        count, unmerged = carry
        unm = unmerged > 0.5

        # --- R tentative principals in weight order ----------------------
        idxs, hass = [], []
        if sorted_w:
            # active lanes are weight-DESCENDING (top-cap-compacted sets):
            # principal r is the (r+1)-th unmerged lane, found with one
            # cumsum; the argmax tie rule (lowest index) picks the same lane
            rank = jnp.cumsum(unmerged, axis=0)
            total = jnp.max(rank)
            for r in range(R):
                hit = unm & (rank == float(r + 1))
                idxs.append(jnp.min(jnp.where(hit, lane, N - 1)))
                hass.append(total > float(r))
        else:
            w_act = jnp.where(unm, w, -1.0)
            for _ in range(R):
                imax = jnp.argmax(w_act, axis=0).astype(jnp.int32)
                hass.append(jnp.max(w_act) > 0.0)
                idxs.append(imax)
                w_act = jnp.where(lane == imax, -1.0, w_act)
        prin = [principal(i) for i in idxs]

        # --- validity chain (scalars) -------------------------------------
        valid = [hass[0]]
        for r in range(1, R):
            v = hass[r]
            for s in range(r):
                d_sr = _distance(prin[s][0], prin[s][1], prin[r][0],
                                 prin[r][1], D, metric)
                v = v & ~(valid[s] & (d_sr < min_sep))
            valid.append(v)

        # --- assignment, moment matching, emission -----------------------
        unassigned = unm
        n_emit = jnp.zeros((), jnp.int32)
        for r in range(R):
            pm, pc = prin[r]
            slot = count + n_emit
            can_emit = valid[r] & (slot < out_cap)
            dist = _distance(pm, pc, m, c, D, metric)
            sel = unassigned & ((dist < min_sep) | (lane == idxs[r])) \
                & can_emit
            sw = jnp.where(sel, w, 0.0)
            W = jnp.sum(sw)
            W_safe = jnp.maximum(W, 1e-30)
            mu = [jnp.sum(sw * mi) / W_safe for mi in m]
            dd = [mui - mi for mui, mi in zip(mu, m)]
            cov = [jnp.sum(sw * (c[j] + dd[a] * dd[b])) / W_safe
                   for j, (a, b) in enumerate(pairs)]
            ok = jnp.full((1,), can_emit)
            store(0, slot, jnp.full((1,), W), ok)
            for i in range(D):
                store(1 + i, slot, jnp.full((1,), mu[i]), ok)
            for j in range(T):
                store(1 + D + j, slot, jnp.full((1,), cov[j]), ok)
            unassigned = unassigned & ~sel
            n_emit = n_emit + can_emit.astype(jnp.int32)

        # guaranteed progress: a particle with budget left that emitted
        # nothing has no usable principal (remaining weights NaN or <= 0)
        # and would spin forever; drop its remaining lanes (the NaN then
        # surfaces in the particle weights, where debug mode catches it)
        stalled = (n_emit == 0) & (count < out_cap)
        unassigned = unassigned & ~stalled
        return count + n_emit, unassigned.astype(jnp.float32)

    def cond(carry):
        count, unmerged = carry
        return (jnp.max(unmerged) > 0.5) & (count < out_cap)

    act = x_ref[1, :]
    if sorted_w:
        # the rank pick has no positive-weight check (the argmax pick's
        # max > 0 has); keep degenerate (w <= 0 or NaN) lanes out of it
        act = jnp.where(w > 0, act, 0.0)
    unmerged0 = jnp.where(act > 0.5, 1.0, 0.0)
    count, unmerged = jax.lax.while_loop(
        cond, body, (jnp.zeros((), jnp.int32), unmerged0))

    # empty slots: weight 0, mean 0, identity covariance. Their addresses
    # are disjoint from the emitted slots, so no store races another.
    lane_k = jax.lax.broadcasted_iota(jnp.int32, (K,), 0)
    empty = lane_k >= count
    zeros = jnp.zeros((K,), jnp.float32)
    ones = jnp.ones((K,), jnp.float32)
    plgpu.store(o_ref.at[0], zeros, mask=empty)
    for i in range(D):
        plgpu.store(o_ref.at[1 + i], zeros, mask=empty)
    for j, (a, b) in enumerate(pairs):
        plgpu.store(o_ref.at[1 + D + j], ones if a == b else zeros,
                    mask=empty)
    n_left = jnp.sum(unmerged)
    o_ref[1 + D + T, :] = jnp.full((K,), n_left)


@functools.partial(jax.jit, static_argnames=(
    "D", "min_separation", "out_cap", "metric", "sorted_w", "r_par",
    "num_warps", "interpret"))
def gm_merge_pallas(packed, D, min_separation, out_cap, metric=0,
                    sorted_w=False, r_par=4, num_warps=None,
                    interpret=False):
    """Greedy merge of packed candidate planes [P, 2 + D + T, N].

    Drop-in for ``gm_merge_batch`` on the unpacked arrays. Returns
    (out_mean [P, K, D], out_cov [P, K, D, D], out_w [P, K], n_merged [P],
    n_dropped [P]) with K = ``out_cap``; empty slots hold (0, I, 0).

    ``sorted_w``: the caller guarantees active lanes are a weight-
    descending prefix (top-cap-compacted sets), which lets the principal
    pick use one cumsum instead of R argmax reductions.
    """
    P, C, N = packed.shape
    T = n_cov_planes(D)
    assert C == 2 + D + T, (C, D)
    assert metric == 0 or D == 2, "Hellinger is implemented for D = 2"
    N_pad = next_pow2(N)
    K_pad = next_pow2(out_cap)
    if N_pad != N:
        # inactive lanes: zero weight and mean, identity covariance
        fill = [0.0, 0.0] + [0.0] * D \
            + [1.0 if a == b else 0.0 for a, b in tri_pairs(D)]
        pad = jnp.broadcast_to(
            jnp.asarray(fill, packed.dtype)[None, :, None],
            (P, C, N_pad - N))
        packed = jnp.concatenate([packed, pad], axis=2)
    C_out = 2 + D + T
    kernel = functools.partial(
        _merge_kernel, D=D, out_cap=out_cap, min_sep=float(min_separation),
        r_par=max(1, r_par), metric=metric, sorted_w=sorted_w)
    out = pl.pallas_call(
        kernel,
        out_shape=jax.ShapeDtypeStruct((P, C_out, K_pad), jnp.float32),
        grid=(P,),
        in_specs=[pl.BlockSpec((None, C, N_pad), lambda p: (p, 0, 0))],
        out_specs=pl.BlockSpec((None, C_out, K_pad), lambda p: (p, 0, 0)),
        backend="triton",
        compiler_params=plgpu.CompilerParams(
            num_warps=num_warps or default_num_warps(N_pad, D),
            num_stages=1),
        interpret=interpret,
        name=f"gm_merge_d{D}",
    )(packed)
    out = out[:, :, :out_cap]
    out_w = out[:, 0]
    out_mean = jnp.stack([out[:, 1 + i] for i in range(D)], axis=-1)
    full = [[None] * D for _ in range(D)]
    for j, (a, b) in enumerate(tri_pairs(D)):
        full[a][b] = full[b][a] = out[:, 1 + D + j]
    out_cov = jnp.stack([jnp.stack(row, axis=-1) for row in full], axis=-2)
    n_merged = jnp.sum((out_w > 0).astype(jnp.int32), axis=-1)
    n_dropped = out[:, 1 + D + T, 0].astype(jnp.int32)
    return out_mean, out_cov, out_w, n_merged, n_dropped


def kernel_platform_ok(platform=None) -> bool:
    """True when the platform can compile this kernel (a CUDA GPU)."""
    return (platform or jax.default_backend()) == "gpu"

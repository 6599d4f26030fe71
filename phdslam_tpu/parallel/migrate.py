"""O(changed-particles) resample migration over the particle mesh.

The naive post-resampling gather ``x[ancestors]`` lowers, under the SPMD
partitioner, to an all-gather of the ENTIRE map state (14.7 MB at
P=1024/K=128, from the compiled module's collective inventory): every
device materializes every row to pick the few it needs.

This module replaces it with a neighbor exchange (SURVEY.md §2.4 note)
that exploits two facts:

1. the ancestry vector is already replicated O(P) scalars, so EVERY
   device can compute exactly which rows every other device needs;
2. systematic resampling emits (near-)sorted ancestors
   (ops/resample.py — r_j strictly increasing), so in equilibrium each
   device's ancestor window overlaps its own block and at most its ring
   neighbors.

Protocol (shard_map over the particle axis):
  * rows whose ancestor lives on-device: local gather, zero traffic;
  * rows from a ring neighbor (distance 1): the SENDER compacts exactly
    the rows its neighbor needs into a fixed [R]-row buffer (both sides
    derive the identical row order from the replicated ancestry) and one
    ppermute moves it — bytes ∝ migrated rows (padded to the static
    budget R), not map size;
  * a replicated feasibility predicate (all ancestors within one device,
    per-edge counts <= R) routes the step through lax.cond; infeasible
    (heavily skewed) resampling steps fall back to the exact full gather.

Worst-case correctness is the fallback's; the common case moves
2 x R-row buffers instead of (N-1) full blocks.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
try:
    from jax import shard_map           # jax >= 0.8
except ImportError:  # pragma: no cover
    from jax.experimental.shard_map import shard_map
from jax.sharding import NamedSharding, PartitionSpec as P

from .sharding import PARTICLE_AXIS


def default_row_budget(block: int) -> int:
    """Static per-edge row budget: half a block, at least 8 rows."""
    return max(8, block // 2)


def neighbor_feasible(anc, n_dev, block, budget):
    """Replicated predicate: every ancestor within one device of its output
    row, and every (sender -> receiver) edge needs at most ``budget`` rows."""
    P_ = anc.shape[0]
    own = (jnp.arange(P_, dtype=jnp.int32) // block)
    src = anc // block
    diff = src - own
    dev_ok = jnp.all(jnp.abs(diff) <= 1)
    cnt_ok = jnp.asarray(True)
    for s in (-1, 1):
        m = (diff == s).astype(jnp.int32)
        per_recv = jax.ops.segment_sum(m, own, num_segments=n_dev)
        cnt_ok = cnt_ok & jnp.all(per_recv <= budget)
    return dev_ok & cnt_ok


def _migrate_local(anc, leaves, *, n_dev, block, budget, axis):
    """Per-device body: local rows + two R-row neighbor buffers."""
    L, R = block, budget
    d = jax.lax.axis_index(axis)
    my_anc = jax.lax.dynamic_slice_in_dim(anc, d * L, L)      # [L]
    src_dev = my_anc // L
    local_idx = jnp.clip(my_anc - d * L, 0, L - 1)
    is_local = src_dev == d

    def bmask(m, x):
        return m.reshape((L,) + (1,) * (x.ndim - 1))

    outs = [jnp.where(bmask(is_local, x), x[local_idx], jnp.zeros_like(x))
            for x in leaves]

    perms = {s: [(j, (j + s) % n_dev) for j in range(n_dev)]
             for s in (-1, 1)}
    iota_L = jnp.arange(L, dtype=jnp.int32)
    for s in (-1, 1):
        # SENDER role: build the buffer receiver (d+s) needs from my block.
        recv_anc = jax.lax.dynamic_slice_in_dim(
            anc, ((d + s) % n_dev) * L, L)
        needed_by_recv = (recv_anc // L) == d
        keys = jnp.where(needed_by_recv, iota_L, L)
        pos = jax.lax.sort(keys)[:R]              # receiver-row order
        src_rows = jnp.clip(
            jnp.take(recv_anc, jnp.minimum(pos, L - 1)) - d * L, 0, L - 1)

        # RECEIVER role: I receive from d - s; reconstruct the same order.
        my_needed = src_dev == ((d - s) % n_dev)
        rank = jnp.clip(jnp.cumsum(my_needed.astype(jnp.int32)) - 1,
                        0, R - 1)
        for i, x in enumerate(leaves):
            buf = x[src_rows]                                 # [R, ...]
            buf = jax.lax.ppermute(buf, axis, perms[s])
            outs[i] = jnp.where(bmask(my_needed, x), buf[rank], outs[i])
    return tuple(outs)


def gather_rows_neighbor(mesh, anc, leaves, budget=None):
    """shard_map neighbor migration of per-particle arrays.

    ``anc`` [P] int32 (replicated ancestry), ``leaves``: list of arrays with
    leading particle axis sharded over ``mesh``. Caller must have checked
    :func:`neighbor_feasible`. Returns migrated leaves.
    """
    n_dev = mesh.shape[PARTICLE_AXIS]
    P_ = anc.shape[0]
    block = P_ // n_dev
    budget = budget or default_row_budget(block)
    specs = [P(PARTICLE_AXIS, *([None] * (x.ndim - 1))) for x in leaves]
    fn = functools.partial(_migrate_local, n_dev=n_dev, block=block,
                           budget=budget, axis=PARTICLE_AXIS)
    return shard_map(
        lambda a, *xs: fn(a, list(xs)),
        mesh=mesh,
        in_specs=(P(),) + tuple(specs),
        out_specs=tuple(specs),
    )(anc, *leaves)


def gather_particles_sharded(state, ancestors, mesh, cfg):
    """Drop-in for filters.phd._gather_particles on a particle mesh:
    neighbor exchange when feasible, exact full gather otherwise."""
    from ..filters.phd import _gather_particles

    n_dev = mesh.shape[PARTICLE_AXIS]
    P_ = state.pose.shape[0]
    if n_dev <= 2 or P_ % n_dev:
        return _gather_particles(state, ancestors)
    block = P_ // n_dev
    budget = getattr(cfg, "migration_row_budget", 0) or \
        default_row_budget(block)
    budget = min(budget, block)
    anc = jax.lax.with_sharding_constraint(
        ancestors, NamedSharding(mesh, P()))
    ok = neighbor_feasible(anc, n_dev, block, budget)

    names = ["pose", "log_weight"]
    leaves = [state.pose, state.log_weight]
    for mname in ("map_static", "map_dynamic"):
        gm = getattr(state, mname)
        for f in ("mean", "cov", "weight"):
            names.append(f"{mname}.{f}")
            leaves.append(getattr(gm, f))
    names.append("variance")
    leaves.append(state.variance)
    if state.cardinality is not None:
        names.append("cardinality")
        leaves.append(state.cardinality)
    if state.prev_z is not None:
        names.append("prev_z")
        leaves.append(state.prev_z)

    def rebuild(new_leaves):
        kv = dict(zip(names, new_leaves))
        return state.replace(
            pose=kv["pose"], log_weight=kv["log_weight"],
            map_static=state.map_static.replace(
                mean=kv["map_static.mean"], cov=kv["map_static.cov"],
                weight=kv["map_static.weight"]),
            map_dynamic=state.map_dynamic.replace(
                mean=kv["map_dynamic.mean"], cov=kv["map_dynamic.cov"],
                weight=kv["map_dynamic.weight"]),
            variance=kv["variance"],
            cardinality=kv.get("cardinality", state.cardinality),
            prev_z=kv.get("prev_z", state.prev_z))

    def fast(st):
        return rebuild(gather_rows_neighbor(mesh, anc, leaves, budget))

    def slow(st):
        return _gather_particles(st, anc)

    return jax.lax.cond(ok, fast, slow, state)

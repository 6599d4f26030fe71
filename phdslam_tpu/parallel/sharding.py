"""Multi-chip particle sharding.

The reference is single-GPU/single-process (SURVEY.md §2.4): its only
"distribution" is cudaMemcpy host<->device. This engine shards the
particle axis over a 1-D ``particle`` device mesh (SURVEY.md §2.4-P1) and
lets the XLA SPMD partitioner insert the collectives (NCCL on GPUs):

* particle log-weight normalization / nEff      -> all-reduce (psum)
* expected-pose extraction                       -> psum of weighted poses
* MAP-map extraction (argmax-weight particle)    -> all-gather of one map
* systematic resampling ancestry                 -> all-gather of P scalars
* particle migration after resampling            -> gather of map blocks

Everything else in the filter step is per-particle embarrassingly parallel
and runs without any communication. This is the ``jit`` + ``NamedSharding``
formulation: the step function keeps its global (single-program) semantics
from :mod:`..filters.phd`; sharding annotations on the state pytree tell XLA
where the data lives, and the partitioner turns the handful of cross-particle
reductions above into collectives.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..config import SlamConfig
from ..filters.phd import phd_step
from ..types import FilterState, init_state

PARTICLE_AXIS = "particle"

# jitted-program caches keyed on (cfg, mesh, donate): a fresh jit wrapper
# per call re-TRACES the whole scan on the host — tens of seconds at dense
# shapes
_SHARDED_FN_CACHE: dict = {}


def _cache_key(cfg: SlamConfig, mesh: Mesh, donate: bool, kind: str):
    import dataclasses
    cfg_key = tuple((f.name, getattr(cfg, f.name))
                    for f in dataclasses.fields(cfg))
    mesh_key = (mesh.devices.flat[0].platform,
                tuple(d.id for d in mesh.devices.flat), mesh.axis_names)
    return (kind, cfg_key, mesh_key, donate)


def make_mesh(n_devices: Optional[int] = None, devices=None) -> Mesh:
    """Build the 1-D particle mesh over ``devices`` (default: the default
    backend's devices), using the first ``n_devices`` of them. Raises when
    fewer are available; a virtual CPU mesh is asked for explicitly with
    ``devices=jax.devices("cpu")`` (device count set by
    ``--xla_force_host_platform_device_count``).
    """
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        if len(devices) < n_devices:
            raise ValueError(
                f"requested {n_devices} mesh devices but only "
                f"{len(devices)} are available")
        devices = devices[:n_devices]
    return Mesh(np.asarray(devices), (PARTICLE_AXIS,))


def _cfg_for_mesh(cfg: SlamConfig, mesh: Mesh) -> SlamConfig:
    """Resolve the auto (=1) merge-kernel knob against the MESH's platform:
    the kernel compiles only for a GPU, and the default backend can differ
    from the mesh (a CPU mesh on a GPU host)."""
    from ..ops.pallas_merge import kernel_platform_ok
    if cfg.pallas_merge != 1 or kernel_platform_ok(
            mesh.devices.flat[0].platform):
        return cfg
    import dataclasses
    return dataclasses.replace(cfg, pallas_merge=0)


def _particle_spec(x) -> P:
    """Shard the leading (particle) axis; replicate the rest of the dims."""
    return P(PARTICLE_AXIS, *([None] * (np.ndim(x) - 1)))


def state_shardings(mesh: Mesh, state: FilterState) -> FilterState:
    """NamedSharding pytree for a FilterState: per-particle arrays are sharded
    on their leading axis; the PRNG key and step counter are replicated."""
    repl = NamedSharding(mesh, P())

    def shard_leaf(x):
        return NamedSharding(mesh, _particle_spec(x))

    sharded = jax.tree.map(shard_leaf, state)
    return sharded.replace(rng=repl, step=repl)


def shard_state(mesh: Mesh, state: FilterState) -> FilterState:
    """Place a host/single-device FilterState onto the mesh.

    On a multi-process mesh the leaves are passed as host (numpy) arrays in
    global-value-on-every-process convention: init_state is deterministic in
    cfg, so every process holds the same global value and device_put carves
    out its addressable shards.
    """
    sh = state_shardings(mesh, state)
    multiproc = any(d.process_index != jax.process_index()
                    for d in mesh.devices.flat)

    def put(x, s):
        # an already-distributed jax.Array (e.g. state from a previous
        # run_sharded) spans non-addressable devices — np.asarray on it
        # raises; pass it straight to device_put instead
        to_host = multiproc and not (isinstance(x, jax.Array)
                                     and not x.is_fully_addressable)
        return jax.device_put(np.asarray(x) if to_host else x, s)

    return jax.tree.map(put, state, sh)


def init_sharded_state(cfg: SlamConfig, mesh: Mesh,
                       n_particles: Optional[int] = None) -> FilterState:
    P_total = n_particles if n_particles is not None else cfg.n_particles
    n_dev = mesh.devices.size
    if P_total % n_dev != 0:
        raise ValueError(
            f"n_particles={P_total} must be divisible by mesh size {n_dev}")
    return shard_state(mesh, init_state(cfg, P_total))


def make_sharded_step_fn(cfg: SlamConfig, mesh: Mesh, donate: bool = True):
    """Jit the filter step with particle-axis shardings over ``mesh``.

    Returns ``step(state, z, z_mask, control, dt, do_predict) -> (state, out)``
    where the state stays resident and sharded across the mesh between calls.
    The jitted program is cached per (cfg, mesh, donate) — see
    ``_SHARDED_FN_CACHE``.
    """
    key = _cache_key(cfg, mesh, donate, "step")
    hit = _SHARDED_FN_CACHE.get(key)
    if hit is not None:
        return hit
    cfg = _cfg_for_mesh(cfg, mesh)
    example = init_state(cfg, mesh.devices.size)  # shapes only, for specs
    st_sh = state_shardings(mesh, example)
    repl = NamedSharding(mesh, P())
    part = NamedSharding(mesh, P(PARTICLE_AXIS))

    # StepOutputs: extracted estimates are replicated; per-particle
    # diagnostics stay sharded.
    from ..filters.phd import StepOutputs
    out_sh = StepOutputs(
        expected_pose=repl, map_mean=repl, map_cov=repl, map_weight=repl,
        n_eff=repl, resampled=repl, overflow=repl,
        log_weight=part,
        poses=NamedSharding(mesh, P(PARTICLE_AXIS, None)),
        resample_idx=part, cardinality=repl)

    fn = functools.partial(phd_step, cfg=cfg, mesh=mesh)
    jitted = jax.jit(
        fn,
        in_shardings=(st_sh, repl, repl, repl, repl, repl),
        out_shardings=(st_sh, out_sh),
        donate_argnums=(0,) if donate else ())
    _SHARDED_FN_CACHE[key] = jitted
    return jitted


def disparity_state_shardings(mesh: Mesh, state):
    """NamedSharding pytree for a DisparityState: per-particle leaves
    (cam_pose, log_weight, cloud [P, K, N, 3], feat_weight, resample_idx)
    shard on the particle axis; rng/step replicate."""
    repl = NamedSharding(mesh, P())
    sharded = jax.tree.map(
        lambda x: NamedSharding(mesh, _particle_spec(x)), state)
    return sharded.replace(rng=repl, step=repl)


def init_sharded_disparity_state(cfg: SlamConfig, mesh: Mesh):
    from ..filters.disparity import init_disparity_state
    if cfg.n_particles % mesh.devices.size:
        raise ValueError(
            f"n_particles={cfg.n_particles} must be divisible by mesh "
            f"size {mesh.devices.size}")
    state = init_disparity_state(cfg)
    sh = disparity_state_shardings(mesh, state)
    return jax.tree.map(jax.device_put, state, sh)


def make_sharded_disparity_step_fn(cfg: SlamConfig, mesh: Mesh,
                                   donate: bool = True):
    """Jit the SC-PHD disparity step (filters/disparity.py) with
    particle-axis shardings over ``mesh`` — the monocular variant's
    multi-chip path (SURVEY.md §2.4-P1; reference behavioral spec
    disparityUpdate, phdfilter.cu:4572-5216).

    Returns ``step(state, z, z_mask, dt, do_predict) -> (state, out)``.
    """
    from ..filters.disparity import DisparityOutputs, disparity_step, \
        init_disparity_state
    cfg = _cfg_for_mesh(cfg, mesh)
    example = jax.eval_shape(lambda: init_disparity_state(cfg))
    st_sh = disparity_state_shardings(mesh, example)
    repl = NamedSharding(mesh, P())
    out_sh = DisparityOutputs(
        expected_pose=repl, map_cloud=repl, map_weight=repl,
        n_eff=repl, resampled=repl, overflow=repl)

    fn = functools.partial(disparity_step, cfg=cfg, mesh=mesh)
    return jax.jit(
        fn,
        in_shardings=(st_sh, repl, repl, repl, repl),
        out_shardings=(st_sh, out_sh),
        donate_argnums=(0,) if donate else ())


def make_sharded_scan_fn(cfg: SlamConfig, mesh: Mesh, donate: bool = True):
    """Jit a whole-sequence lax.scan over the sharded step (run_scanned's
    device loop, but multi-chip). Inputs are the stacked per-step schedule
    arrays; all T steps execute on device with collectives only.
    Cached per (cfg, mesh, donate) — a fresh wrapper per call re-traces
    the whole scan (see ``_SHARDED_FN_CACHE``)."""
    key = _cache_key(cfg, mesh, donate, "scan")
    hit = _SHARDED_FN_CACHE.get(key)
    if hit is not None:
        return hit
    cfg = _cfg_for_mesh(cfg, mesh)
    example = init_state(cfg, mesh.devices.size)
    st_sh = state_shardings(mesh, example)
    repl = NamedSharding(mesh, P())

    def run_all(state, z_all, mask_all, controls, z_idx, has_z, c_idx,
                has_c, dts, do_pred):
        def body(carry, inp):
            st, last_ctrl = carry
            zi, hz, ci, hc, dt, dp = inp
            ctrl = jnp.where(hc, controls[ci], last_ctrl)
            z = z_all[zi]
            zm = mask_all[zi] & hz
            st, out = phd_step(st, z, zm, ctrl, dt, dp, cfg=cfg,
                               mesh=mesh)
            return (st, ctrl), (out.expected_pose, out.n_eff, out.resampled,
                                out.overflow)
        init = (state, jnp.zeros((2,), state.pose.dtype))
        (state, _), ys = jax.lax.scan(
            body, init, (z_idx, has_z, c_idx, has_c, dts, do_pred))
        return state, ys

    jitted = jax.jit(
        run_all,
        in_shardings=(st_sh,) + (repl,) * 9,
        out_shardings=(st_sh, (repl, repl, repl, repl)),
        donate_argnums=(0,) if donate else ())
    _SHARDED_FN_CACHE[key] = jitted
    return jitted

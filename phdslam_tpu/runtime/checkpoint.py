"""Checkpoint / resume / snapshot-replay profiling.

The reference's only persistence is a boost binary serialization of the full
``SynthSLAM`` + measurement set at step 100 (``state100.bin``,
/root/reference/src/main.cpp:87-145, 1262-1269), reloaded by the profiling
mode to replay a single ``phdUpdateSynth`` (main.cpp:1314-1321).

Here: general checkpointing of the filter-state pytree (one ``.npz`` of its
leaves plus the pickled tree structure), usable every N steps for
preemption recovery (SURVEY.md §5), plus the same single-update replay
harness.
"""

from __future__ import annotations

import os
import pickle
from typing import Any, Optional

import jax
import numpy as np

def save_checkpoint(path: str, state: Any, extra: Optional[dict] = None):
    """Save a filter-state pytree (+ optional extras dict of arrays) as
    ``<path>/leaves.npz`` + ``<path>/treedef.pkl``. The leaves are fetched
    to the host first, so on a multi-process group only one process (the
    one holding a gathered host state) should call it."""
    path = os.path.abspath(path)
    payload = {"state": state}
    if extra:
        payload["extra"] = extra
    leaves, treedef = jax.tree.flatten(payload)
    os.makedirs(path, exist_ok=True)
    np.savez(os.path.join(path, "leaves.npz"),
             *[np.asarray(x) for x in leaves])
    with open(os.path.join(path, "treedef.pkl"), "wb") as fh:
        pickle.dump(treedef, fh)


def _validate_like(like_tree: Any, loaded_tree: Any, path: str):
    """Shape/dtype check of a restored pytree against the caller's ``like``
    template: resuming a checkpoint saved under a different particle/feature
    capacity must fail with a clear error here, not an opaque jit shape
    error hundreds of frames later. The npz layout restores raw leaves
    with no structural validation of its own."""
    like_leaves, like_def = jax.tree.flatten(like_tree)
    loaded_leaves, loaded_def = jax.tree.flatten(loaded_tree)
    if like_def != loaded_def:
        raise ValueError(
            f"checkpoint/config structure mismatch at {path}: saved tree "
            f"{loaded_def} != expected {like_def} (was the checkpoint saved "
            "under a different filter configuration?)")
    for a, b in zip(like_leaves, loaded_leaves):
        a_sh, b_sh = np.shape(a), np.shape(b)
        if a_sh != b_sh:
            raise ValueError(
                f"checkpoint/config shape mismatch at {path}: saved leaf "
                f"shape {b_sh} != expected {a_sh} — the checkpoint was "
                "saved under different capacities (n_particles / "
                "max_features / max_measurements); resume with the original "
                "config or re-initialize.")


def load_checkpoint(path: str, like: Any, extra_like: Optional[dict] = None):
    """Load a checkpoint saved by :func:`save_checkpoint`.

    ``like`` is a pytree with the same structure (e.g. a fresh init_state)
    used to restore types/shapes. When the checkpoint was saved with an
    ``extra`` dict, pass a matching ``extra_like`` and receive
    ``(state, extra)`` instead of just the state.
    """
    path = os.path.abspath(path)
    with open(os.path.join(path, "treedef.pkl"), "rb") as fh:
        treedef = pickle.load(fh)
    data = np.load(os.path.join(path, "leaves.npz"))
    leaves = [data[k] for k in data.files]
    payload = jax.tree.unflatten(treedef, leaves)
    # validate the state subtree only: a checkpoint saved WITH extras is
    # still loadable without requesting them (and vice versa fails in
    # unflatten above)
    _validate_like(like, payload["state"], path)
    state = jax.tree.map(jax.numpy.asarray, payload["state"])
    if extra_like is not None:
        return state, payload.get("extra")
    return state


def profile_single_update(cfg, ckpt_path: str, z=None, z_mask=None):
    """Reload a checkpoint and execute exactly one measurement update —
    the reference's kernel-profiling harness (main.cpp:1314-1321).

    Returns {"est_poses": [1, 6], "update_ms": float}.
    """
    import time

    import jax.numpy as jnp

    from ..filters.phd import make_step_fn
    from ..types import init_state

    state = load_checkpoint(ckpt_path, init_state(cfg))
    step = make_step_fn(cfg, donate=False)
    if z is None:
        z = jnp.zeros((cfg.max_measurements, 2), jnp.float32)
        z_mask = jnp.zeros((cfg.max_measurements,), bool)
    args = (state, z, z_mask, jnp.zeros((2,), jnp.float32),
            jnp.float32(cfg.dt), jnp.asarray(False))
    state2, out = step(*args)            # compile
    jax.block_until_ready(out.expected_pose)
    t0 = time.perf_counter()
    state2, out = step(*args)
    jax.block_until_ready(out.expected_pose)
    ms = (time.perf_counter() - t0) * 1000.0
    return {"est_poses": np.asarray(out.expected_pose)[None],
            "update_ms": ms, "steps_per_s": 1000.0 / ms}

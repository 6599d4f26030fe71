"""Multi-host runtime: process initialization + global particle mesh.

The reference is single-process/single-GPU (SURVEY.md §2.4 — no MPI/NCCL);
this module is the new distributed backend BASELINE.md asks for. One JAX
process per host; ``jax.distributed.initialize`` wires the hosts into one
runtime, after which ``jax.devices()`` spans every host's GPUs and the
SAME jit + NamedSharding step from :mod:`.sharding` runs globally — the
per-step collectives are O(P) scalars (NCCL on GPUs, see
tools/scaling_bench.py); the network between hosts is touched only at
init, dataset broadcast and checkpoints.

Typical launch (same command on every host; the scheduler provides the
env vars):

    python -m phdslam_tpu cfg/ackerman.cfg synth --out-dir runs/multihost \
        --distributed

or programmatically::

    from phdslam_tpu.parallel import distributed
    distributed.initialize()              # no-op on a single host
    mesh = distributed.global_mesh()
    step = make_sharded_step_fn(cfg, mesh)

Only process 0 should write logs/checkpoint metadata (``is_primary``).
"""

from __future__ import annotations

import os
from typing import Optional

import jax


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> bool:
    """Initialize the multi-host runtime when running under a launcher.

    Reads ``JAX_COORDINATOR_ADDRESS``/``JAX_NUM_PROCESSES``/
    ``JAX_PROCESS_ID`` when the arguments are not given (SLURM multi-node
    jobs are detected too). Returns True if a multi-process runtime was
    initialized, False for the single-host case (everything keeps working
    on the local devices — the mesh from :func:`global_mesh` is then
    host-local). A failed initialization raises.
    """
    coordinator_address = coordinator_address or os.environ.get(
        "JAX_COORDINATOR_ADDRESS")
    if num_processes is None and "JAX_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["JAX_NUM_PROCESSES"])
    if process_id is None and "JAX_PROCESS_ID" in os.environ:
        process_id = int(os.environ["JAX_PROCESS_ID"])

    explicit = coordinator_address is not None
    multi_worker = int(os.environ.get("SLURM_JOB_NUM_NODES", "1")) > 1 \
        or (num_processes or 1) > 1
    if not explicit and not multi_worker:
        return False
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id)
    return jax.process_count() > 1


def is_primary() -> bool:
    """True on the process that should write logs/checkpoints."""
    return jax.process_index() == 0


def global_mesh():
    """1-D particle mesh over every device of every connected host."""
    from .sharding import make_mesh
    return make_mesh(devices=jax.devices())


def process_local_batch(p_total: int) -> int:
    """Particles this process materializes when feeding a global array
    (jax.make_array_from_process_local_data convention)."""
    n = jax.process_count()
    if p_total % n != 0:
        raise ValueError(f"n_particles={p_total} not divisible by "
                         f"{n} processes")
    return p_total // n

"""Tracing / profiling / debug observability.

Rebuilds the reference's instrumentation layer (SURVEY.md §5):
* per-step wall clock -> ``loopTime.log`` (main.cpp:1300-1305) — written by
  the runners; :class:`StepTimer` is the shared accumulator.
* CUDA-event kernel timing -> ``predicttime.log`` (phdfilter.cu:1244-1251)
  — :func:`timed_call` blocks on the result and records device ms.
* cuPrintf device printf (phdfilter.cu:3448) -> ``debug_print_mode`` turns
  on ``jax.debug.print`` hooks in filter code gated by ``cfg.debug``.
* race/NaN observability (SURVEY.md §5) -> :func:`debug_mode` enables
  ``jax_debug_nans`` + disables jit for step-through debugging.
* XLA profiler traces -> :func:`trace` context manager around a run
  (view with TensorBoard or xprof).
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import List, Optional

import jax


class StepTimer:
    """Wall-clock accumulator compatible with loopTime.log."""

    def __init__(self):
        self.times_ms: List[float] = []
        self._t0: Optional[float] = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self, sync_on=None):
        if sync_on is not None:
            jax.block_until_ready(sync_on)
        self.times_ms.append((time.perf_counter() - self._t0) * 1000.0)

    def write(self, path: str):
        with open(path, "w") as fh:
            fh.write("\n".join("%g" % t for t in self.times_ms) + "\n")


def timed_call(fn, *args, **kwargs):
    """Run fn, block on its outputs, return (result, elapsed_ms) —
    the predicttime.log pattern."""
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    jax.block_until_ready(out)
    return out, (time.perf_counter() - t0) * 1000.0


@contextlib.contextmanager
def trace(log_dir: str):
    """jax.profiler trace around a block (device timeline -> TensorBoard)."""
    os.makedirs(log_dir, exist_ok=True)
    jax.profiler.start_trace(log_dir)
    try:
        yield log_dir
    finally:
        jax.profiler.stop_trace()


@contextlib.contextmanager
def debug_mode(nan_checks: bool = True, disable_jit: bool = False):
    """NaN detection + optional jit-disable (the analog of the
    reference's -G -DTHRUST_DEBUG builds + NaN-weight abort)."""
    ctxs = []
    if nan_checks:
        ctxs.append(jax.debug_nans(True))
    if disable_jit:
        ctxs.append(jax.disable_jit())
    with contextlib.ExitStack() as stack:
        for c in ctxs:
            stack.enter_context(c)
        yield

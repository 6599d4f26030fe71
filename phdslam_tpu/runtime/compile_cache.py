"""JAX's persistent compilation cache, in one place.

Entry points (``python -m phdslam_tpu``, ``bench.py``, ``chip_smoke.py``
and the tools) call :func:`configure_compile_cache` once at start-up. When
``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and nothing else
is set here; otherwise the cache goes to ``<repo>/.jax_cache``, a fixed
absolute path (the path is part of the cache's key, so a directory that
moves with the working directory never hits).
"""

from __future__ import annotations

import os

import jax

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def compile_cache_dir(environ=None) -> tuple[str, bool]:
    """(directory, from_env): the cache directory this process should use
    and whether it came from ``JAX_COMPILATION_CACHE_DIR``."""
    env = (os.environ if environ is None else environ).get(ENV_VAR)
    if env:
        return env, True
    return os.path.join(REPO_ROOT, ".jax_cache"), False


def configure_compile_cache() -> str:
    """Point JAX's persistent cache at :func:`compile_cache_dir` and return
    the directory."""
    path, from_env = compile_cache_dir()
    if not from_env:
        jax.config.update("jax_compilation_cache_dir", path)
    return path

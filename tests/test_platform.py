"""Platform plumbing: the compile-cache rule, the pytree dataclasses that
replace flax.struct, and chip_smoke.py's refusal to run without a GPU."""

import os
import sys

import jax
import numpy as np
import pytest

from phdslam_tpu.runtime import compile_cache


def test_compile_cache_dir_from_env():
    path, from_env = compile_cache.compile_cache_dir(
        {"JAX_COMPILATION_CACHE_DIR": "/some/cache"})
    assert (path, from_env) == ("/some/cache", True)


def test_compile_cache_dir_default_is_fixed_repo_path(tmp_path,
                                                      monkeypatch):
    """Unset: <repo>/.jax_cache as an absolute path that does not move
    with the working directory."""
    monkeypatch.chdir(tmp_path)
    path, from_env = compile_cache.compile_cache_dir({})
    assert not from_env and os.path.isabs(path)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert path == os.path.join(repo, ".jax_cache")


def test_configure_compile_cache_sets_nothing_when_env_set(monkeypatch):
    calls = []
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/env/cache")
    monkeypatch.setattr(jax.config, "update",
                        lambda *a: calls.append(a))
    assert compile_cache.configure_compile_cache() == "/env/cache"
    assert calls == []


def test_pytree_dataclass_replace_flatten_jit_roundtrip():
    from phdslam_tpu.config import SlamConfig
    from phdslam_tpu.types import FilterState, GMState, init_state

    st = init_state(SlamConfig(n_particles=4, max_features=6,
                               filter_type=0))
    assert st.cardinality is None and st.prev_z is None
    leaves, treedef = jax.tree.flatten(st)
    back = jax.tree.unflatten(treedef, leaves)
    assert isinstance(back, FilterState)
    assert isinstance(back.map_static, GMState)

    st2 = st.replace(log_weight=st.log_weight + 1.0)
    assert st2 is not st and st2.pose is st.pose
    with pytest.raises(Exception):
        st.step = 3                      # frozen, like flax.struct

    @jax.jit
    def bump(s):
        return s.replace(step=s.step + 1,
                         map_static=s.map_static.replace(
                             weight=s.map_static.weight + 2.0))

    out = bump(st)
    assert int(out.step) == 1
    np.testing.assert_array_equal(np.asarray(out.map_static.weight),
                                  np.asarray(st.map_static.weight) + 2.0)
    assert out.cardinality is None


def test_pytree_dataclass_disparity_state_maps():
    from phdslam_tpu.config import SlamConfig
    from phdslam_tpu.filters.disparity import (DisparityState,
                                               init_disparity_state)
    st = init_disparity_state(SlamConfig(n_particles=3, max_features=4,
                                         particles_per_feature=5))
    doubled = jax.tree.map(lambda x: x * 2, st)
    assert isinstance(doubled, DisparityState)
    np.testing.assert_array_equal(np.asarray(doubled.cloud),
                                  2 * np.asarray(st.cloud))


def test_chip_smoke_refuses_cpu():
    """chip_smoke.py exits nonzero, before printing any result, on a CPU
    backend."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, repo)
    try:
        import chip_smoke
    finally:
        sys.path.remove(repo)
    with pytest.raises(SystemExit) as exc:
        chip_smoke.require_gpu(jax.devices("cpu"))
    assert exc.value.code not in (0, None)
    with pytest.raises(SystemExit):
        chip_smoke.main([])

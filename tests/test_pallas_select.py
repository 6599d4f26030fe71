"""Candidate row/column gathers (ops/gather.py) vs a numpy reference.

A gather is an exact copy, so equality is bit-for-bit, not approximate.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from phdslam_tpu.ops.gather import take_cols, take_rows


@pytest.mark.parametrize("P,cap,R,C", [
    (16, 64, 32, 16),     # K-table shape class
    (16, 64, 8, 8),       # M-table shape class (small R)
    (5, 33, 7, 3),        # ragged: odd dims
    (1, 8, 4, 2),         # single particle
])
def test_rows_match_xla(P, cap, R, C):
    rng = np.random.default_rng(0)
    idx = rng.integers(0, R, (P, cap)).astype(np.int32)
    tab = rng.normal(size=(P, R, C)).astype(np.float32)
    out = take_rows(jnp.asarray(idx), jnp.asarray(tab))
    ref = np.take_along_axis(tab, idx[:, :, None], axis=1)
    np.testing.assert_array_equal(np.asarray(out), ref)


@pytest.mark.parametrize("P,cap,R,C", [
    (16, 64, 32, 16),
    (5, 33, 7, 3),
    (1, 8, 4, 2),
])
def test_cols_match_xla(P, cap, R, C):
    rng = np.random.default_rng(1)
    idx = rng.integers(0, R, (P, cap)).astype(np.int32)
    tab_t = rng.normal(size=(P, C, R)).astype(np.float32)
    out = take_cols(jnp.asarray(idx), jnp.asarray(tab_t))
    ref = np.take_along_axis(
        tab_t, np.broadcast_to(idx[:, None, :], (P, C, cap)), axis=2)
    np.testing.assert_array_equal(np.asarray(out), ref)


@pytest.mark.parametrize("take", ["rows", "cols"])
def test_gather_boundary_indices(take):
    """First and last rows, repeated indices, and non-finite table values
    are copied exactly (a one-hot product would turn inf/NaN rows into NaN
    everywhere)."""
    P, R, C = 3, 9, 5
    rng = np.random.default_rng(2)
    tab = rng.normal(size=(P, R, C)).astype(np.float32)
    tab[:, R - 1, 0] = np.inf
    tab[:, 0, 1] = np.nan
    idx = np.array([[0, R - 1, R - 1, 0, 4]] * P, np.int32)
    if take == "rows":
        out = np.asarray(take_rows(jnp.asarray(idx), jnp.asarray(tab)))
        ref = np.take_along_axis(tab, idx[:, :, None], axis=1)
    else:
        tab_t = np.swapaxes(tab, 1, 2).copy()
        out = np.asarray(take_cols(jnp.asarray(idx), jnp.asarray(tab_t)))
        ref = np.take_along_axis(
            tab_t, np.broadcast_to(idx[:, None, :], (P, C, idx.shape[1])),
            axis=2)
    np.testing.assert_array_equal(out, ref)


def test_gather_unbatched_and_two_batch_axes():
    """The gathers take any number of leading batch axes, including none
    (the single-particle paths)."""
    rng = np.random.default_rng(3)
    tab = rng.normal(size=(2, 3, 6, 4)).astype(np.float32)
    idx = rng.integers(0, 6, (2, 3, 5)).astype(np.int32)
    out = np.asarray(take_rows(jnp.asarray(idx), jnp.asarray(tab)))
    np.testing.assert_array_equal(
        out, np.take_along_axis(tab, idx[..., None], axis=2))
    out1 = np.asarray(take_rows(jnp.asarray(idx[0, 0]),
                                jnp.asarray(tab[0, 0])))
    np.testing.assert_array_equal(out1, tab[0, 0][idx[0, 0]])

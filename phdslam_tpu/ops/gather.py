"""Per-particle row and column gathers.

Exact copies through ``take_along_axis``; the index arrays carry one
leading axis per batch dimension of the table.
"""

from __future__ import annotations

import jax.numpy as jnp


def take_rows(idx, tab):
    """out[..., c, :] = tab[..., idx[..., c], :].

    idx [..., cap] int32 in [0, R); tab [..., R, C] -> [..., cap, C]."""
    return jnp.take_along_axis(tab, idx[..., :, None], axis=-2)


def take_cols(idx, tab_t):
    """out[..., :, c] = tab_t[..., :, idx[..., c]] (transposed tables).

    idx [..., cap] int32 in [0, R); tab_t [..., C, R] -> [..., C, cap]."""
    return jnp.take_along_axis(tab_t, idx[..., None, :], axis=-1)

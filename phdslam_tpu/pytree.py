"""Frozen dataclasses registered as JAX pytrees.

Every field is a pytree child (arrays, nested pytrees or None); there are
no static fields. ``replace`` returns a copy with some fields changed, the
way filter state is updated inside jitted steps.
"""

from __future__ import annotations

import dataclasses

import jax


def pytree_dataclass(cls):
    """Decorator: a frozen dataclass whose fields are all pytree data."""
    cls = dataclasses.dataclass(frozen=True)(cls)
    cls.replace = lambda self, **changes: dataclasses.replace(self, **changes)
    names = [f.name for f in dataclasses.fields(cls)]
    return jax.tree_util.register_dataclass(cls, data_fields=names,
                                            meta_fields=[])

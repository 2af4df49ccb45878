"""Frozen dataclasses that are JAX pytrees.

`@dataclass` makes a frozen dataclass and registers it with
`jax.tree_util.register_dataclass`: fields are pytree children unless
declared with `field(pytree_node=False)`, in which case they are static
(part of the tree structure, so hashable, and a change retraces a jitted
function). Instances get `.replace(**changes)`.
"""
from __future__ import annotations

import dataclasses

import jax


def field(pytree_node: bool = True, **kwargs):
    """A dataclass field; `pytree_node=False` makes it static metadata."""
    meta = dict(kwargs.pop("metadata", None) or {})
    meta["pytree_node"] = pytree_node
    return dataclasses.field(metadata=meta, **kwargs)


def dataclass(cls):
    cls = dataclasses.dataclass(frozen=True)(cls)
    fields = dataclasses.fields(cls)
    jax.tree_util.register_dataclass(
        cls,
        data_fields=[f.name for f in fields if f.metadata.get("pytree_node", True)],
        meta_fields=[f.name for f in fields if not f.metadata.get("pytree_node", True)],
    )
    cls.replace = dataclasses.replace
    return cls

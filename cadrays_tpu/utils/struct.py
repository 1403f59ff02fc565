"""Frozen dataclasses that are JAX pytrees.

`dataclass` registers the class with `jax.tree_util.register_dataclass`:
fields declared with `field(pytree_node=False)` are static metadata (part
of the tree structure, so a change retraces a jitted function); all other
fields are leaves. Instances are immutable; `.replace(**changes)` returns
an updated copy.
"""
from __future__ import annotations

import dataclasses

import jax

_STATIC = "static"


def field(pytree_node: bool = True, **kwargs):
    """A dataclass field; `pytree_node=False` makes it static metadata."""
    metadata = dict(kwargs.pop("metadata", None) or {})
    metadata[_STATIC] = not pytree_node
    return dataclasses.field(metadata=metadata, **kwargs)


def dataclass(cls):
    """Make `cls` a frozen dataclass registered as a pytree."""
    cls = dataclasses.dataclass(frozen=True)(cls)
    fields = dataclasses.fields(cls)
    jax.tree_util.register_dataclass(
        cls,
        data_fields=[f.name for f in fields if not f.metadata.get(_STATIC)],
        meta_fields=[f.name for f in fields if f.metadata.get(_STATIC)])
    cls.replace = dataclasses.replace
    return cls

"""Trees of tensors: the state is nested NamedTuples of tensors (and the
metrics a dict of them), walked depth first in field order, the order of
the JAX package's pytrees."""

from __future__ import annotations

import torch


def tree_map(fn, *trees):
    """fn over the tensor leaves of equal nested (named) tuples or dicts."""
    first = trees[0]
    if isinstance(first, torch.Tensor):
        return fn(*trees)
    if isinstance(first, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in first}
    parts = [tree_map(fn, *subs) for subs in zip(*trees)]
    return type(first)(*parts) if hasattr(first, "_fields") else type(first)(parts)


def tree_leaves(tree) -> list:
    """The tensors of nested (named) tuples, depth first in field order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [leaf for sub in tree for leaf in tree_leaves(sub)]


def tree_unflatten(template, leaves):
    """`template`'s structure with the leaves taken in order from the
    iterator `leaves`."""
    return tree_map(lambda _: next(leaves), template)

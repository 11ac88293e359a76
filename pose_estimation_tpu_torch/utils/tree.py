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
    """The tensors of nested (named) tuples or dicts, depth first in field
    order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = tree.values()
    return [leaf for sub in tree for leaf in tree_leaves(sub)]


def tree_unflatten(template, leaves):
    """`template`'s structure with the leaves taken in order from the
    iterator `leaves`."""
    return tree_map(lambda _: next(leaves), template)


def associative_scan(fn, elems):
    """Inclusive scan along dim 0 of the associative `fn(a, b)` over a tree
    of tensors: element k is fn(...fn(e0, e1)..., ek). The odd/even
    recursion of `jax.lax.associative_scan` (adjacent pairs reduced, scanned
    recursively, the even positions filled in), so that products associate
    in the JAX package's order. Out of place and unrolled on the static
    length: it runs under `torch.func.vmap` and in a CUDA graph capture."""
    n = tree_leaves(elems)[0].shape[0]
    if n < 2:
        return elems
    odd = associative_scan(fn, fn(tree_map(lambda x: x[0:-1:2], elems),
                                  tree_map(lambda x: x[1::2], elems)))
    head = tree_map(lambda x: x[:1], elems)
    if n > 2:
        rest = fn(odd if n % 2 else tree_map(lambda x: x[:-1], odd),
                  tree_map(lambda x: x[2::2], elems))
        head = tree_map(lambda h, r: torch.cat([h, r]), head, rest)
    return tree_map(_interleave, head, odd)


def _interleave(even, odd):
    """even[0], odd[0], even[1], ... along dim 0 (even one longer or equal)."""
    k = odd.shape[0]
    out = torch.stack([even[:k], odd], dim=1).flatten(0, 1)
    return torch.cat([out, even[k:]]) if even.shape[0] > k else out

"""Parameter trees: nested dicts and lists with tensors at the leaves.

The leaf order is the JAX package's tree-flatten order — dict keys
sorted, lists in order — so a flattened payload, the quantizer's
uniforms and Algorithm 2's columns line up with `repro` element for
element (e.g. a discriminator flattens as layers[0].conv.w,
layers[1].bn.bias, layers[1].bn.scale, layers[1].conv.w, ...).
"""
from __future__ import annotations

import torch


def tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for child in tree for leaf in tree_leaves(child)]
    return [tree]


def tree_map(fn, tree, *rest):
    """Apply `fn` leafwise over `tree` and the same-structured `rest`."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, *children)
                          for children in zip(tree, *rest))
    return fn(tree, *rest)


def tree_unflatten(like, leaves):
    """A tree shaped like `like` holding `leaves` in flatten order."""
    it = iter(leaves)
    out = tree_map(lambda _: next(it), like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree has")
    return out


def tree_stack(trees):
    """Stack same-structured trees along a new leading axis."""
    return tree_map(lambda *xs: torch.stack(xs), trees[0], *trees[1:])


def tree_index(tree, i):
    """Slice i of a stacked tree."""
    return tree_map(lambda x: x[i], tree)

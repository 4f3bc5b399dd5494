"""Leaf lists of the nested containers the guard takes.

The JAX package walks pytrees with `jax.tree_util`; the port's trees are
dicts, lists, tuples and NamedTuples of tensors (a `state_dict`, an
optimizer's `state_dict`, a batch), or a module, whose leaves are its
parameters.  Dict keys are visited sorted, as `jax.tree_util` visits
them, so "the first float leaf" names the same leaf in both packages.
None is an empty subtree; anything else is a leaf.
"""

from __future__ import annotations

from typing import Any, Callable, List, Tuple

import torch


def flatten(tree: Any) -> Tuple[List[Any], Callable[[List[Any]], Any]]:
    """`(leaves, rebuild)`: `rebuild(new_leaves)` is `tree` with its
    leaves replaced in the same order (a module is returned as is, its
    parameters being written in place by the caller)."""
    if isinstance(tree, torch.nn.Module):
        params = list(tree.parameters())
        return params, lambda _vals: tree
    if tree is None:
        return [], lambda _vals: None
    if isinstance(tree, dict):
        keys = sorted(tree)
        subs = [flatten(tree[k]) for k in keys]
        kind = type(tree)

        def rebuild_dict(vals):
            out, off = {}, 0
            for k, (leaves, rb) in zip(keys, subs):
                out[k] = rb(vals[off:off + len(leaves)])
                off += len(leaves)
            return out if kind is dict else kind(out)
        return [l for leaves, _ in subs for l in leaves], rebuild_dict
    if isinstance(tree, (list, tuple)):
        subs = [flatten(v) for v in tree]

        def rebuild_seq(vals):
            items, off = [], 0
            for leaves, rb in subs:
                items.append(rb(vals[off:off + len(leaves)]))
                off += len(leaves)
            if hasattr(tree, "_fields"):  # NamedTuple
                return type(tree)(*items)
            return type(tree)(items)
        return [l for leaves, _ in subs for l in leaves], rebuild_seq
    return [tree], lambda vals: vals[0]


def leaves(tree: Any) -> List[Any]:
    return flatten(tree)[0]


def is_float(leaf: Any) -> bool:
    """A floating-point tensor (integer and bool leaves are finite by
    construction, and the guard skips them as the JAX package does)."""
    return isinstance(leaf, torch.Tensor) and leaf.dtype.is_floating_point


def tree_map(fn: Callable[[Any], Any], tree: Any) -> Any:
    vals, rebuild = flatten(tree)
    return rebuild([fn(v) for v in vals])

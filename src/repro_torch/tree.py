"""Trees of tensors: nested dicts, lists and tuples whose leaves are
tensors (the port's stand-in for JAX's pytrees)."""
from __future__ import annotations

import torch

__all__ = ["tree_map", "tree_stack", "tree_from_paths"]


def tree_map(fn, tree, *rest):
    """``fn`` on every leaf of ``tree`` and the leaves at the same place in
    each tree of ``rest`` (which have ``tree``'s structure)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_stack(trees):
    """Nested dicts of tensors stacked leaf by leaf along a new dim 0."""
    if isinstance(trees[0], dict):
        return {k: tree_stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def tree_from_paths(flat: dict, sep: str) -> dict:
    """The tree of ``flat``'s leaves, each keyed by its ``sep``-joined key
    path; a node whose keys are all digits becomes a list."""
    tree: dict = {}
    for name, leaf in flat.items():
        *path, last = name.split(sep)
        node = tree
        for k in path:
            node = node.setdefault(k, {})
        node[last] = leaf

    def lists(node):
        if not isinstance(node, dict):
            return node
        if all(k.isdigit() for k in node):
            return [lists(node[str(i)]) for i in range(len(node))]
        return {k: lists(v) for k, v in node.items()}
    return lists(tree)

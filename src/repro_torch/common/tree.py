"""Nested dicts and lists of tensors, flattened in the reference's order.

JAX flattens a pytree with dict keys sorted and list items by index; the
port's training state (params, AdamW moments, checkpoints) is the same
kind of tree with tensors at the leaves, so one order serves both and a
leaf's name is its path joined by "/" (``blocks/0/attn/wq``), as the
reference's checkpoint manifest names it.
"""

from __future__ import annotations


def flatten(tree, prefix: str = "") -> list:
    """[(name, leaf)] in the reference's order: dict keys sorted, list and
    tuple items by index; anything else is a leaf."""
    if isinstance(tree, dict):
        return [kv for key in sorted(tree) for kv in flatten(tree[key], f"{prefix}{key}/")]
    if isinstance(tree, (list, tuple)):
        return [kv for i, item in enumerate(tree) for kv in flatten(item, f"{prefix}{i}/")]
    return [(prefix[:-1], tree)]


def leaves(tree) -> list:
    return [leaf for _, leaf in flatten(tree)]


def unflatten(tree_like, new_leaves):
    """A tree of ``tree_like``'s structure holding ``new_leaves`` in order."""
    it = iter(new_leaves)

    def build(t):
        if isinstance(t, dict):
            return {key: build(t[key]) for key in sorted(t)}
        if isinstance(t, (list, tuple)):
            return type(t)(build(item) for item in t)
        return next(it)

    out = build(tree_like)
    if next(it, None) is not None:
        raise ValueError("unflatten: more leaves than the tree holds")
    return out

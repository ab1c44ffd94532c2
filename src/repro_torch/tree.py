"""Nested dicts of tensors: the port's pytrees.

A tree is a dict whose values are trees or leaves. Leaves are walked in
`jax.tree.flatten`'s order for dicts, keys sorted at every level, so a
state's leaves, shapes and bytes come out in the JAX package's order.
"""
from __future__ import annotations


def items(tree, prefix: tuple = ()):
    """(key path, leaf) pairs in sorted-key order."""
    if not isinstance(tree, dict):
        return [(prefix, tree)]
    out = []
    for key in sorted(tree):
        out.extend(items(tree[key], prefix + (key,)))
    return out


def leaves(tree) -> list:
    return [leaf for _, leaf in items(tree)]


def map(fn, tree, *rest):
    """`fn` applied leaf by leaf over trees of one structure."""
    if not isinstance(tree, dict):
        return fn(tree, *rest)
    return {key: map(fn, tree[key], *(r[key] for r in rest))
            for key in tree}


def unstack(stacked) -> list:
    """A tree of stacked leaves as one tree of views per index of their
    leading axis (one unbind per leaf: under autograd its backward stacks
    the gradients once)."""
    slices = [leaf.unbind(0) for leaf in leaves(stacked)]
    return [unflatten(stacked, [s[i] for s in slices])
            for i in range(len(slices[0]))]


def unflatten(template, new_leaves):
    """A tree of `template`'s structure holding `new_leaves` in order."""
    it = iter(new_leaves)

    def build(node):
        if not isinstance(node, dict):
            leaf = next(it, None)
            if leaf is None:
                raise ValueError("fewer leaves than the template holds")
            return leaf
        return {key: build(node[key]) for key in sorted(node)}

    out = build(template)
    if next(it, None) is not None:
        raise ValueError("more leaves than the template holds")
    return out

"""Small helpers over nested tuples of tensors (NamedTuples, tuples, None).

They take the place of ``jax.tree.map`` for the few structures this
package passes around: cell environments and the solver's problem data.
"""

from __future__ import annotations

import torch


def tree_map(fn, tree, *rest):
    """Apply fn leaf-wise over tensors; None and non-tensor leaves pass
    through unchanged (ints in NamedTuples are static metadata)."""
    if tree is None:
        return None
    if isinstance(tree, tuple):
        items = [tree_map(fn, t, *[r[i] for r in rest])
                 for i, t in enumerate(tree)]
        return type(tree)(*items) if hasattr(tree, "_fields") \
            else tuple(items)
    if isinstance(tree, torch.Tensor):
        return fn(tree, *rest)
    return tree


def stack(items):
    """Stack a list of same-structured NamedTuples along a new axis 0."""
    first = items[0]
    return type(first)(*[torch.stack(list(f)) for f in zip(*items)])

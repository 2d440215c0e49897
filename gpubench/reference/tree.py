"""A small tree map over the containers the port's batches are built of:
dicts, lists, tuples and NamedTuples (`FrameData`, `CanonicalFrame`,
`SmplRef`). Every other object is a leaf. The port's
counterpart of `jax.tree.map` on numpy or tensor leaves."""
from __future__ import annotations


def tree_map(fn, tree, *rest):
    """fn applied leaf by leaf to `tree` and the trees of the same
    structure in `rest`; the result keeps the structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, '_fields'):
        return type(tree)(*(tree_map(fn, *parts)
                            for parts in zip(tree, *rest)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, *parts) for parts in zip(tree, *rest))
    return fn(tree, *rest)


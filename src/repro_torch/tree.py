"""Parameter trees: nested dicts, lists, tuples and NamedTuples with
tensors at the leaves (the port's stand-in for ``jax.tree``).  A model's
``params_tree()`` is one; so are the optimizer's moments and a
checkpoint's ``{"params": ..., "opt": AdamWState}``."""
from __future__ import annotations


def _children(node):
    """(key, child) pairs of an inner node, or None for a leaf."""
    if isinstance(node, dict):
        return list(node.items())
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return list(zip(node._fields, node))
    if isinstance(node, (list, tuple)):
        return list(enumerate(node))
    return None


def leaves_with_path(tree, prefix: tuple = ()) -> list:
    """[(path, leaf)] in order; a path is the tuple of keys, indices and
    field names from the root."""
    kids = _children(tree)
    if kids is None:
        return [(prefix, tree)]
    return [item for k, v in kids
            for item in leaves_with_path(v, prefix + (k,))]


def leaves(tree) -> list:
    return [leaf for _, leaf in leaves_with_path(tree)]


def path_key(path: tuple) -> str:
    """``"blocks/0/attn/wq"``: a path as one string."""
    return "/".join(str(p) for p in path)


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and of the trees in ``rest``
    (the same structure), rebuilt in that structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [tree_map(fn, v, *(r[i] for r in rest))
               for i, v in enumerate(tree)]
        if hasattr(tree, "_fields"):
            return type(tree)(*out)
        return type(tree)(out)
    return fn(tree, *rest)

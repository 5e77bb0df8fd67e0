"""Nested dicts, tuples and lists of tensors (the frontend state, a frame's
metrics): the few pytree operations the port needs, without JAX. ``None``
stays ``None``, as in a JAX pytree; anything else that is not a container
is a leaf."""
from __future__ import annotations


def tree_map(fn, tree):
    """``tree`` with ``fn`` applied to every leaf; the containers rebuilt."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return None if tree is None else fn(tree)


def tree_leaves(tree) -> list:
    """The leaves of ``tree``, depth first in insertion order."""
    out = []
    tree_map(out.append, tree)
    return out


def tree_pairs(dst, src, path: str = "") -> list:
    """(path, dst leaf, src leaf) for two trees of one structure; raises
    ValueError where the structures differ."""
    if isinstance(dst, dict) and isinstance(src, dict):
        if dst.keys() != src.keys():
            raise ValueError(f"{path or 'tree'}: keys {sorted(dst)} against {sorted(src)}")
        return [p for k in dst for p in tree_pairs(dst[k], src[k], f"{path}/{k}")]
    if isinstance(dst, (tuple, list)) and type(dst) is type(src):
        if len(dst) != len(src):
            raise ValueError(f"{path or 'tree'}: {len(dst)} entries against {len(src)}")
        return [p for i, (d, s) in enumerate(zip(dst, src))
                for p in tree_pairs(d, s, f"{path}/{i}")]
    if isinstance(dst, (dict, tuple, list)) or isinstance(src, (dict, tuple, list)):
        raise ValueError(f"{path or 'tree'}: {type(dst).__name__} against "
                         f"{type(src).__name__}")
    return [] if dst is None and src is None else [(path, dst, src)]

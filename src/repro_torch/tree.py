"""Nested parameter trees: dicts (keys in sorted order, as JAX flattens
them) and lists of tensors.  The port's stand-in for ``jax.tree``: the
optimizer, the train step and the checkpoints walk params, gradients and
moments through these."""

from __future__ import annotations

from typing import Any, Callable, Iterator, List, Tuple

Path = Tuple[Any, ...]


def leaves_with_paths(tree, prefix: Path = ()) -> Iterator[Tuple[Path, Any]]:
    """(path, leaf) for every leaf, dict keys sorted, lists in order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves_with_paths(tree[k], prefix + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from leaves_with_paths(v, prefix + (i,))
    else:
        yield prefix, tree


def leaves(tree) -> List[Any]:
    return [leaf for _, leaf in leaves_with_paths(tree)]


def path_key(path: Path) -> str:
    """A leaf's key in a checkpoint: its path joined by "/" (the JAX
    package's ``_leaf_paths`` format)."""
    return "/".join(str(p) for p in path)


def map_tree(fn: Callable, tree, *rest, with_path: bool = False,
             prefix: Path = ()):
    """``fn(leaf, *other_leaves)`` (``fn(path, leaf, ...)`` with
    ``with_path``) over trees of one structure; returns that structure."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, tree[k], *(r[k] for r in rest),
                            with_path=with_path, prefix=prefix + (k,))
                for k in tree}
    if isinstance(tree, (list, tuple)):
        return [map_tree(fn, v, *(r[i] for r in rest), with_path=with_path,
                         prefix=prefix + (i,))
                for i, v in enumerate(tree)]
    return fn(prefix, tree, *rest) if with_path else fn(tree, *rest)

"""Nested-dict trees of tensors: the port's stand-in for `jax.tree`.

Parameters, gradients and optimizer moments are nested dicts whose leaves
are tensors (the JAX package's pytrees of dicts).  Every function here
walks dicts by key, so trees built in another key order still line up.
Keys of a flattened tree are the "/"-joined dict keys, as
`repro.checkpoint.manager._flatten` names them.
"""

from __future__ import annotations

from typing import Any, Callable, Iterator, Tuple


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """`fn` over the leaves of `tree` and the same leaves of `rest`."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree: Any) -> Iterator[Any]:
    if isinstance(tree, dict):
        for v in tree.values():
            yield from tree_leaves(v)
    else:
        yield tree


def tree_flatten_with_paths(tree: Any, prefix: Tuple[str, ...] = ()
                            ) -> Iterator[Tuple[str, Any]]:
    """("a/b/c", leaf) pairs in the tree's order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from tree_flatten_with_paths(v, prefix + (str(k),))
    else:
        yield "/".join(prefix), tree


"""Trees of tensors, the port's counterpart of the JAX pytrees that the
training substrate carries: dicts, lists, tuples and NamedTuples, with
None as an empty subtree and anything else as a leaf.

Dict keys are flattened in sorted order, as JAX flattens them, so leaf i
of a tree here is leaf i of the same tree in the reference (and
`optimizer.global_norm` sums the leaves in the reference's order).  A
tree's structure is a JSON-able `spec`, which the checkpoint manifest
stores in place of a pickled treedef.
"""
from __future__ import annotations

import importlib
from typing import Any, Callable, Iterator, List, Optional, Tuple

IsLeaf = Optional[Callable[[Any], bool]]


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(type(x), "_fields")


def _walk(x, is_leaf: IsLeaf, leaves: List[Any]) -> dict:
    if is_leaf is not None and is_leaf(x):
        leaves.append(x)
        return {"leaf": True}
    if x is None:
        return {"none": True}
    if isinstance(x, dict):
        keys = sorted(x)
        return {"dict": keys, "children": [_walk(x[k], is_leaf, leaves) for k in keys]}
    if _is_namedtuple(x):
        cls = type(x)
        return {"namedtuple": f"{cls.__module__}:{cls.__qualname__}",
                "children": [_walk(c, is_leaf, leaves) for c in x]}
    if isinstance(x, (list, tuple)):
        return {type(x).__name__: [_walk(c, is_leaf, leaves) for c in x]}
    leaves.append(x)
    return {"leaf": True}


def flatten(tree: Any, is_leaf: IsLeaf = None) -> Tuple[List[Any], dict]:
    """(leaves in JAX's order, spec).  Module-level recursion, not a nested
    closure: a recursive closure is a reference cycle, which would keep the
    leaves (a train step's whole state) alive until the cyclic collector
    runs."""
    leaves: List[Any] = []
    spec = _walk(tree, is_leaf, leaves)
    return leaves, spec


def _namedtuple_class(name: str):
    module, qualname = name.split(":")
    obj = importlib.import_module(module)
    for part in qualname.split("."):
        obj = getattr(obj, part)
    return obj


def _build(s: dict, it: Iterator[Any]) -> Any:
    if "leaf" in s:
        return next(it)
    if "none" in s:
        return None
    if "dict" in s:
        return {k: _build(c, it) for k, c in zip(s["dict"], s["children"])}
    if "namedtuple" in s:
        return _namedtuple_class(s["namedtuple"])(*[_build(c, it) for c in s["children"]])
    if "list" in s:
        return [_build(c, it) for c in s["list"]]
    return tuple(_build(c, it) for c in s["tuple"])


def unflatten(spec: dict, leaves: List[Any]) -> Any:
    """The tree of `spec` with `leaves` in flatten's order."""
    it = iter(leaves)
    out = _build(spec, it)
    if next(it, it) is not it:
        raise ValueError("more leaves than the spec holds")
    return out


def leaves(tree: Any, is_leaf: IsLeaf = None) -> List[Any]:
    return flatten(tree, is_leaf)[0]


def tree_map(fn: Callable, tree: Any, *rest: Any, is_leaf: IsLeaf = None) -> Any:
    """fn over the leaves of `tree` and the matching leaves of `rest`, which
    must have `tree`'s structure."""
    first, spec = flatten(tree, is_leaf)
    others = []
    for other in rest:
        got, other_spec = flatten(other, is_leaf)
        if other_spec != spec:
            raise ValueError("trees of different structure")
        others.append(got)
    return unflatten(spec, [fn(*xs) for xs in zip(first, *others)])


def _paths(x, is_leaf: IsLeaf, path: tuple, out: List[tuple]) -> None:
    if is_leaf is not None and is_leaf(x):
        out.append(path)
    elif x is None:
        return
    elif isinstance(x, dict):
        for k in sorted(x):
            _paths(x[k], is_leaf, path + (k,), out)
    elif _is_namedtuple(x):
        for name, c in zip(type(x)._fields, x):
            _paths(c, is_leaf, path + (name,), out)
    elif isinstance(x, (list, tuple)):
        for i, c in enumerate(x):
            _paths(c, is_leaf, path + (i,), out)
    else:
        out.append(path)


def tree_map_with_path(fn: Callable, tree: Any, *rest: Any, is_leaf: IsLeaf = None) -> Any:
    """`tree_map` with each leaf's path as fn's first argument: the tuple of
    dict keys, NamedTuple field names and sequence indices (ints) from the
    root, as `jax.tree_util.tree_map_with_path` gives them."""
    out: List[tuple] = []
    _paths(tree, is_leaf, (), out)
    it = iter(out)
    return tree_map(lambda *xs: fn(next(it), *xs), tree, *rest, is_leaf=is_leaf)

"""Path-keyed views of nested parameter containers.

Path strings are ``/``-joined dict keys and sequence indices, the same
strings the reference's ``utils/trees.py`` and its ``t::<path>``
checkpoints use, in the same (sorted-key) order.
"""
from __future__ import annotations

from typing import Any, List, Tuple


def tree_paths(tree) -> List[Tuple[str, Any]]:
    """[(path_str, leaf)] with '/'-joined dict-key paths; dicts are
    walked in sorted key order, lists and tuples by index.  A bare leaf
    has the path ``""``."""
    out: List[Tuple[str, Any]] = []

    def walk(prefix, node):
        if isinstance(node, dict):
            items = ((str(k), node[k]) for k in sorted(node))
        elif isinstance(node, (list, tuple)):
            items = ((str(i), v) for i, v in enumerate(node))
        else:
            out.append(("/".join(prefix), node))
            return
        for k, v in items:
            walk(prefix + [k], v)

    walk([], tree)
    return out

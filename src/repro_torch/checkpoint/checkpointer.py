"""Parameter-tree flattening shared by the ``.pvqz`` artifact (PyTorch port
of ``repro.checkpoint.checkpointer``'s ``_flatten`` / ``_unflatten_into``).

A tree is nested dicts of tensors and ``PackedPVQ`` leaves.  Its flat form
keys each leaf by the ``/``-joined path and lists the leaves in sorted key
order at every level, which is how JAX flattens a dict: the reference's
order, so both packages write a file's leaves in the same sequence.
"""

from __future__ import annotations

from typing import Any, Dict

from ..core.packed import is_packed, sorted_leaves


def _flatten(tree: Any) -> Dict[str, Any]:
    """{path: tensor | PackedPVQ} in sorted key order; packed leaves stay whole."""
    return dict(sorted_leaves(tree))


def _unflatten_into(tree: Any, flat: Dict[str, Any]) -> Any:
    """``tree``'s structure with every leaf taken from ``flat``: packed
    leaves as they are, raw tensors cast to the target leaf's dtype and
    device and reshaped to its shape."""

    def visit(sub, path):
        if isinstance(sub, dict):
            return {key: visit(sub[key], f"{path}/{key}" if path else str(key)) for key in sub}
        leaf = flat[path]
        if is_packed(leaf):
            return leaf
        return leaf.to(device=sub.device, dtype=sub.dtype).reshape(sub.shape)

    return visit(tree, "")

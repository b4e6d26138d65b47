"""Per-tensor gradient-norm clipping and tree helpers.

Port of `cadx_tpu/utils/tree.py`: the reference (Classes/CNNModel.py:
217-222) clips each gradient array by its own L2 norm, max_norm 5.0, with
a 1e-6 fudge in the denominator. The norm is taken in float32 and the
scale stays on the device, so clipping never waits for the host. A tree
is a module (its parameters), a tensor or array, or a dict, list or
tuple of trees.
"""

from __future__ import annotations

import torch


def clip_tensor_by_norm(g: torch.Tensor, max_norm: float = 5.0) -> torch.Tensor:
    """g * (max_norm / (norm + 1e-6)) iff norm > max_norm, else g."""
    norm = torch.linalg.vector_norm(g.to(torch.float32))
    # a tensor numerator: `scalar / tensor` is a reciprocal and a product
    limit = torch.full((), max_norm, device=g.device)
    scale = torch.where(norm > max_norm, limit / (norm + 1e-6),
                        torch.ones((), device=g.device))
    return (g * scale).to(g.dtype)


def clip_grads_per_leaf(grads, max_norm: float = 5.0) -> list[torch.Tensor]:
    """Clip every tensor of `grads` by its own norm."""
    return [clip_tensor_by_norm(g, max_norm) for g in grads]


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def tree_size(tree) -> int:
    """Total number of scalars in a tree."""
    if isinstance(tree, torch.nn.Module):
        return sum(p.numel() for p in tree.parameters())
    total = []
    _map(lambda x: total.append(int(x.numel() if isinstance(x, torch.Tensor) else x.size)), tree)
    return sum(total)


def tree_cast(tree, dtype):
    """Every tensor of a tree cast to `dtype` (a module's parameters, as
    a list in `parameters()` order)."""
    if isinstance(tree, torch.nn.Module):
        tree = [p.detach() for p in tree.parameters()]
    return _map(lambda x: torch.as_tensor(x).to(dtype), tree)

"""Optimizers as ``(init, update)`` pairs on tensors and dicts of tensors.

The reference's ``optim/optimizers.py``: ``sgd`` (the paper's client and
server optimizer, lr 0.01, momentum 0.9), ``adamw``, ``apply_updates``
and ``global_norm``. A tree is a tensor or a dict of tensors (a parameter
dict), or one flat shard of the parameters: the sharded trainer updates
only its |θ|/M shard, so optimizer state is O(|θ|/M) a device, and passes
the whole gradient's norm as ``update(..., norm=)`` for the clipping.
Updates are plain tensor ops in the reference's order (no ``alpha=``,
``addcmul`` or ``lerp``, which fuse a multiply into an add).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Mapping, NamedTuple

import torch

Tree = Any


@dataclass(frozen=True)
class Optimizer:
    init: Callable[[Tree], Tree]
    update: Callable[..., tuple[Tree, Tree]]
    # update(grads, opt_state, params, norm=None) -> (updates, new_state);
    # apply:  params + updates


def _tree_map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    """``fn`` leaf by leaf over a tensor or a dict of tensors (and equally
    keyed dicts in ``rest``)."""
    if isinstance(tree, Mapping):
        return {k: fn(v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


def _leaves(tree: Tree) -> list:
    return list(tree.values()) if isinstance(tree, Mapping) else [tree]


def apply_updates(params: Tree, updates: Tree) -> Tree:
    return _tree_map(lambda p, u: p + u.to(p.dtype) if u is not None else p,
                    params, updates)


def global_norm(tree: Tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                          for x in _leaves(tree)))


def sgd(lr: float, momentum: float = 0.0, nesterov: bool = False
        ) -> Optimizer:
    """SGD with optional (Nesterov) momentum; velocity is f32."""
    def init(params):
        if momentum == 0.0:
            return ()
        return _tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                        params)

    def update(grads, state, params=None, norm=None):
        # sgd does not clip: ``norm`` is taken and unused
        if momentum == 0.0:
            return _tree_map(lambda g: -lr * g, grads), ()
        new_v = _tree_map(lambda v, g: momentum * v + g.to(torch.float32),
                         state, grads)
        if nesterov:
            step = _tree_map(lambda v, g: momentum * v + g.to(torch.float32),
                            new_v, grads)
        else:
            step = new_v
        return _tree_map(lambda s: -lr * s, step), new_v

    return Optimizer(init, update)


class AdamState(NamedTuple):
    step: torch.Tensor          # 0-d int32
    mu: Tree
    nu: Tree


def adamw(lr: float, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.0,
          grad_clip_norm: float | None = None) -> Optimizer:
    """AdamW with f32 moments and optional global-norm gradient clipping;
    the step count lives on the parameters' device. ``update``'s ``norm``
    is the whole gradient's global norm when ``grads`` is one shard of it
    (None: the norm of ``grads``)."""
    f32 = torch.float32

    def init(params):
        z = lambda p: torch.zeros_like(p, dtype=f32)
        step = torch.zeros((), dtype=torch.int32,
                           device=_leaves(params)[0].device)
        return AdamState(step, _tree_map(z, params), _tree_map(z, params))

    def update(grads, state, params, norm=None):
        if grad_clip_norm is not None:
            gn = global_norm(grads) if norm is None else norm
            scale = torch.clamp(grad_clip_norm / (gn + 1e-9), max=1.0)
            grads = _tree_map(lambda g: g * scale, grads)
        step = state.step + 1
        mu = _tree_map(lambda m, g: b1 * m + (1 - b1) * g.to(f32),
                       state.mu, grads)
        nu = _tree_map(lambda v, g: b2 * v + (1 - b2) * torch.square(
            g.to(f32)), state.nu, grads)
        bc1 = 1 - b1 ** step.to(f32)
        bc2 = 1 - b2 ** step.to(f32)

        def upd(m, v, p):
            u = -lr * (m / bc1) / (torch.sqrt(v / bc2) + eps)
            if weight_decay:
                u = u - lr * weight_decay * p.to(f32)
            return u

        updates = _tree_map(upd, mu, nu, params)
        return updates, AdamState(step, mu, nu)

    return Optimizer(init, update)

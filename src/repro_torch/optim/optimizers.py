"""Optimizers as ``(init, update)`` pairs on tensors and dicts of tensors.

The port's share of the reference's ``optim/optimizers.py``: ``sgd`` (the
paper's client and server optimizer, lr 0.01, momentum 0.9),
``apply_updates`` and ``global_norm``. A tree is a tensor or a dict of
tensors (a parameter dict). ``adamw`` waits with the trainer's
``train_loop`` (ROADMAP queue 1, item 11).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Mapping

import torch

Tree = Any


@dataclass(frozen=True)
class Optimizer:
    init: Callable[[Tree], Tree]
    update: Callable[..., tuple[Tree, Tree]]
    # update(grads, opt_state, params) -> (updates, new_state);
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

    def update(grads, state, params=None):
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

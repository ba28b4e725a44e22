"""First-order baselines the paper compares against: SGD, Momentum-SGD
(Sutskever et al.), Adam (twin of ``repro/optim/first_order.py``). Pure
(init, step) pairs over parameter trees."""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch
from torch.func import grad_and_value
from torch.utils._pytree import tree_leaves, tree_map


class FirstOrderOptimizer(NamedTuple):
    init: Callable[[Any], Any]
    step: Callable[..., tuple]   # (loss_fn, params, state, batch) -> (params, state, metrics)


def _value_and_grad(loss_fn, params, batch):
    g, loss = grad_and_value(loss_fn)(params, batch)
    return loss.detach(), g


def _metrics(loss, g):
    sq = sum(torch.sum(x.float() * x.float()) for x in tree_leaves(g))
    return {"loss": loss, "grad_norm": torch.sqrt(sq)}


def sgd(lr: float) -> FirstOrderOptimizer:
    def init(params):
        return ()

    def step(loss_fn, params, state, batch):
        loss, g = _value_and_grad(loss_fn, params, batch)
        new = tree_map(lambda p, gg: p - lr * gg.to(p.dtype), params, g)
        return new, state, _metrics(loss, g)

    return FirstOrderOptimizer(init, step)


def momentum_sgd(lr: float, beta: float = 0.9) -> FirstOrderOptimizer:
    def init(params):
        return tree_map(torch.zeros_like, params)

    def step(loss_fn, params, state, batch):
        loss, g = _value_and_grad(loss_fn, params, batch)
        vel = tree_map(lambda v, gg: beta * v + gg.to(v.dtype), state, g)
        new = tree_map(lambda p, v: p - lr * v, params, vel)
        return new, vel, _metrics(loss, g)

    return FirstOrderOptimizer(init, step)


class AdamState(NamedTuple):
    m: Any
    v: Any
    t: torch.Tensor


def adam(lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8
         ) -> FirstOrderOptimizer:
    def init(params):
        z = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                     params)
        dev = tree_leaves(params)[0].device
        return AdamState(z, z, torch.zeros((), dtype=torch.int32, device=dev))

    def step(loss_fn, params, state, batch):
        loss, g = _value_and_grad(loss_fn, params, batch)
        t = state.t + 1
        m = tree_map(lambda mm, gg: b1 * mm + (1 - b1) * gg.float(), state.m, g)
        v = tree_map(lambda vv, gg: b2 * vv + (1 - b2) * torch.square(gg.float()),
                     state.v, g)
        bc1 = 1 - b1 ** t.float()
        bc2 = 1 - b2 ** t.float()
        new = tree_map(
            lambda p, mm, vv: p - (lr * (mm / bc1) / (torch.sqrt(vv / bc2) + eps)).to(p.dtype),
            params, m, v)
        return new, AdamState(m, v, t), _metrics(loss, g)

    return FirstOrderOptimizer(init, step)

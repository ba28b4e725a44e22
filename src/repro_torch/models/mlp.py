"""The paper's own networks: fully-connected classifiers (twin of
``repro/models/mlp.py``).

Parameters follow the reference's layout and leaf order: a list of layers,
each ``{"b": (d_out,), "w": (d_in, d_out)}`` with ``b`` first, so that
``torch.utils._pytree`` flattens them as ``jax.tree_util`` does (sorted
keys). ``w`` is (d_in, d_out), not ``nn.Linear``'s (d_out, d_in).
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .._device import resolve_device

_ACTIVATIONS = {"tanh": torch.tanh, "relu": torch.relu, "sigmoid": torch.sigmoid}


class MLPApi(NamedTuple):
    init: Callable
    loss_fn: Callable
    logits_fn: Callable
    out_loss_fn: Callable
    accuracy: Callable


def _logits(params, x, act):
    h = x
    for layer in params[:-1]:
        h = act(h @ layer["w"] + layer["b"])
    return h @ params[-1]["w"] + params[-1]["b"]


class MLP(nn.Module):
    """The classifier as a module. ``param_tree()`` gives its parameters in
    the functional layout that ``build_mlp``'s functions and the HF step
    take. Weights are drawn on the CPU from ``generator`` and then moved, so
    one seed gives the same network on every device."""

    def __init__(self, layer_dims: Sequence[int], activation: str = "tanh", *,
                 generator: torch.Generator, device="cuda"):
        super().__init__()
        dev = resolve_device(device)
        self.act = _ACTIVATIONS[activation]
        self.layers = nn.ModuleList()
        for din, dout in zip(layer_dims[:-1], layer_dims[1:]):
            w = torch.randn(din, dout, generator=generator) * (1.0 / din) ** 0.5
            self.layers.append(nn.ParameterDict({
                "b": nn.Parameter(torch.zeros(dout, device=dev)),
                "w": nn.Parameter(w.to(dev)),
            }))

    def param_tree(self):
        return [{"b": l["b"].detach(), "w": l["w"].detach()} for l in self.layers]

    def forward(self, x):
        return _logits([{"b": l["b"], "w": l["w"]} for l in self.layers], x, self.act)


def build_mlp(layer_dims: Sequence[int], activation: str = "tanh", *,
              device="cuda") -> MLPApi:
    """layer_dims = (in, hidden..., n_classes). Batch: {"x": (B,D) f32,
    "y": (B,) int64}. ``init(generator)`` returns a parameter tree on
    ``device``."""
    act = _ACTIVATIONS[activation]
    resolve_device(device)

    def init(generator: torch.Generator):
        return MLP(layer_dims, activation, generator=generator,
                   device=device).param_tree()

    def logits_fn(params, batch):
        return _logits(params, batch["x"], act)

    def out_loss_fn(logits, batch):
        logp = F.log_softmax(logits.float(), dim=-1)
        nll = -torch.gather(logp, -1, batch["y"][:, None])[:, 0]
        return torch.mean(nll)

    def loss_fn(params, batch):
        return out_loss_fn(logits_fn(params, batch), batch)

    def accuracy(params, batch):
        pred = torch.argmax(logits_fn(params, batch), dim=-1)
        return torch.mean((pred == batch["y"]).float())

    return MLPApi(init, loss_fn, logits_fn, out_loss_fn, accuracy)

"""Optimizers of the port: the first-order baselines and the unified
(init, step) interface over them and the HF variants."""
from .api import Optimizer, make_optimizer
from .first_order import FirstOrderOptimizer, adam, momentum_sgd, sgd

__all__ = ["adam", "momentum_sgd", "sgd", "FirstOrderOptimizer", "make_optimizer",
           "Optimizer"]

"""Core of the port: the Hessian-free optimizer (twin of ``repro.core``)."""
from .hvp import fd_hvp, make_damped, make_gnvp, make_hvp

__all__ = ["fd_hvp", "make_damped", "make_gnvp", "make_hvp"]

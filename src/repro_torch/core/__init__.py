"""Core of the port: the Hessian-free optimizer (twin of ``repro.core``)."""

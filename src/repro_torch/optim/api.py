"""Unified optimizer interface (twin of ``repro/optim/api.py``): the
first-order baselines and the paper's HF variants behind one (init, step)
surface, selected by ``HFOptConfig.name``.

HF steps take the full batch for the gradient and the line search, and the
leading ``hvp_batch_frac`` of it as the curvature mini-batch (paper Alg. 2:
full gradient, mini-batch Hessian).
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

from ..configs.base import HFOptConfig
from ..core.distributed import data_parallel_hf_step, slice_batch as _slice_batch
from ..core.hf import HFConfig, hf_init, hf_step
from .first_order import adam, momentum_sgd, sgd

FIRST_ORDER = ("sgd", "momentum", "adam")


class Optimizer(NamedTuple):
    name: str
    init: Callable[[Any], Any]
    step: Callable[..., tuple]  # (params, state, batch) -> (params, state, metrics)


def hf_config(opt: HFOptConfig) -> HFConfig:
    return HFConfig(
        solver=opt.name,
        max_cg_iters=opt.max_cg_iters,
        cg_tol=opt.cg_tol,
        init_damping=opt.init_damping,
        cg_decay=opt.cg_decay,
        precondition=opt.precondition,
        krylov_backend=opt.krylov_backend,
        curvature_mode=opt.curvature_mode,
        curvature_chunk_size=opt.curvature_chunk_size,
        sstep_s=opt.sstep_s,
        sstep_solver=opt.sstep_solver,
        sstep_basis=opt.sstep_basis,
        overlap=opt.overlap,
        nc_mode=opt.nc_mode,
        reject_nonfinite=opt.reject_nonfinite,
        strict_descent=opt.strict_descent,
        descent_guard=opt.descent_guard,
        reject_boost=opt.reject_boost,
    )


def make_optimizer(opt: HFOptConfig, loss_fn, model_out_fn=None, out_loss_fn=None,
                   mesh=None, *, device="cuda") -> Optimizer:
    """``mesh`` (a ``DataMesh``, ``launch.mesh.make_data_mesh``) selects the
    data-parallel HF step (``core.distributed``): the batch is this
    process's shard, params and state are replicated, and the curvature
    batch is the leading ``hvp_batch_frac`` of the shard. First-order
    optimizers take no mesh."""
    if opt.name in FIRST_ORDER:
        if mesh is not None:
            raise ValueError(
                f"mesh= is only supported for the HF optimizers (got first-order {opt.name!r})")
        fo = {
            "sgd": lambda: sgd(opt.lr),
            "momentum": lambda: momentum_sgd(opt.lr, opt.momentum),
            "adam": lambda: adam(opt.lr),
        }[opt.name]()

        def fo_step(params, state, batch):
            return fo.step(loss_fn, params, state, batch)

        return Optimizer(opt.name, fo.init, fo_step)

    cfg = hf_config(opt)

    def init(params):
        return hf_init(params, cfg, device=device)

    if mesh is not None:
        step = data_parallel_hf_step(
            loss_fn, mesh, cfg, hvp_frac=opt.hvp_batch_frac,
            model_out_fn=model_out_fn, out_loss_fn=out_loss_fn, device=device)
        return Optimizer(opt.name, init, step)

    def step(params, state, batch):
        return hf_step(loss_fn, params, state, batch, _slice_batch(batch, opt.hvp_batch_frac),
                       cfg, model_out_fn=model_out_fn, out_loss_fn=out_loss_fn,
                       device=device)

    return Optimizer(opt.name, init, step)

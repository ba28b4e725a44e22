"""The data-parallel HF step across processes (twin of
``repro/core/distributed.py``): the paper's Algorithm 2 with its MPI
schedule written out.

Each process holds a shard of the batch; parameters and optimizer state are
replicated. The loss is averaged over the mesh (``preduce_value``, whose
gradient is the local one), so

  * the gradient  = local gradient + ONE all-reduce (Alg. 2 line 4),
  * each curvature product = local product + ONE all-reduce (line 5),
  * each line-search trial = ONE scalar all-reduce (line 9).

Every reduction goes through ``core.collectives.preduce`` under a tag
("loss", "out_loss", "grad_hvp"), so :func:`count_executed` counts the
executed schedule and ``metrics["blocking_syncs"]`` is held against
``core.comm_model``. Everything else (the Krylov recurrences, damping,
direction choice) runs on replicated state on every process, the flat
backend's kernels included; the all-reduce results are the same bits on
every rank, so the processes stay in step.

Under ``HFConfig.overlap`` the gradient reduce is started before the
curvature operator's build and waited on where the Krylov right-hand side
is formed (``grad_reduce.start``; the reference's hidden grad-reduce).

The curvature slice (``hvp_frac`` < 1) is taken of the local shard, as in
the reference, so one and two processes then differ by design.

Only ``curvature_mode="linearize"`` runs here: the naive and chunked modes
evaluate the loss under ``torch.func.jvp``/``vmap``, inside which a
collective cannot run (ROADMAP item 27).
"""
from __future__ import annotations

from typing import Any, Callable, Sequence

import torch
from torch.utils._pytree import tree_leaves, tree_map

from .collectives import preduce, preduce_start, preduce_value
from .hf import HFConfig, hf_step


def slice_batch(batch, frac: float):
    """The curvature mini-batch: the leading ``frac`` of every leaf (at
    least one example); ``batch`` itself for ``frac`` ≥ 1."""
    if frac >= 1.0:
        return batch
    return tree_map(lambda x: x[:max(int(x.shape[0] * frac), 1)], batch)


def require_linearize(curvature_mode: str) -> None:
    """Raise for a curvature mode that does not run across processes."""
    if curvature_mode != "linearize":
        raise NotImplementedError(
            f"curvature_mode={curvature_mode!r} across processes is not ported yet "
            "(ROADMAP item 27): only 'linearize' runs data-parallel")


def data_parallel_hf_step(
    loss_fn: Callable[[Any, Any], torch.Tensor],
    mesh,
    config: HFConfig,
    *,
    data_axes: Sequence[str] = ("data",),
    hvp_frac: float = 1.0,
    model_out_fn=None,
    out_loss_fn=None,
    device="cuda",
):
    """Returns step(params, state, batch) -> (params, state, metrics).

    ``batch`` is this process's shard (``launch.multiproc.shard_batch``);
    ``params``/``state`` are the same on every process
    (``launch.multiproc.replicate``). ``mesh`` is a ``DataMesh``
    (``launch.mesh.make_data_mesh``) whose one axis is ``data_axes``."""
    if tuple(data_axes) != tuple(mesh.axis_names):
        raise ValueError(f"data_axes {tuple(data_axes)} must be the mesh's axes "
                         f"{tuple(mesh.axis_names)}")
    require_linearize(config.curvature_mode)

    def dloss(p, b):
        return preduce_value(loss_fn(p, b), mesh, "loss")

    def dout_loss(z, b):
        return preduce_value(out_loss_fn(z, b), mesh, "out_loss")

    # Explicit gradient/product reduces: the wrapped loss leaves each process
    # its local gradient, and their mean is Alg. 2's "reduce to root".
    def grad_reduce(t):
        return preduce(t, mesh, "grad_hvp")

    grad_reduce.start = lambda t: preduce_start(t, mesh, "grad_hvp")
    # A block of w stacked tangents: one all-reduce, counted w times as the
    # reference's vmapped callback counts it.
    grad_reduce.block = lambda t: preduce(t, mesh, "grad_hvp",
                                          count=tree_leaves(t)[0].shape[0])

    def step(params, state, batch):
        return hf_step(
            dloss, params, state, batch, slice_batch(batch, hvp_frac), config,
            model_out_fn=model_out_fn,
            out_loss_fn=None if out_loss_fn is None else dout_loss,
            grad_reduce=grad_reduce, device=device,
        )

    return step

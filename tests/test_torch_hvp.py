"""The port's ``core/hvp.py`` against ``repro.core.hvp``: ``make_hvp`` (all
three modes), ``make_gnvp`` and ``make_damped`` on an MLP (16, 32, 4), to 1e-5
of the product's largest entry; ``fd_hvp`` against the reference's
``fd_hvp`` on the same parameters and tangent; the exact product against
float64 finite differences; and the twin of
``tests/test_models_property.py::test_hvp_matches_finite_difference``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch.nn.functional as F  # noqa: E402
from torch.utils._pytree import tree_leaves, tree_map  # noqa: E402

from repro.core import hvp as jhvp  # noqa: E402
from repro.data import classification_dataset as jax_dataset  # noqa: E402
from repro.models import build_mlp as jax_build_mlp  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.core import fd_hvp, make_damped, make_gnvp, make_hvp  # noqa: E402
from repro_torch.data.synthetic import lm_batch  # noqa: E402
from repro_torch.interop import batch_from_numpy, params_from_numpy  # noqa: E402
from repro_torch.models.mlp import build_mlp  # noqa: E402
from repro_torch.models.transformer import build_model  # noqa: E402

DIMS = (16, 32, 4)
B = 24
CHUNK = 10  # two full microbatches and a remainder of 4
LAM = 0.7


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    prev = torch.get_num_threads(), torch.get_float32_matmul_precision()
    torch.set_num_threads(2)
    torch.set_float32_matmul_precision("highest")
    yield
    torch.set_num_threads(prev[0])
    torch.set_float32_matmul_precision(prev[1])


@pytest.fixture(scope="module")
def setup():
    jm = jax_build_mlp(DIMS)
    jp = jm.init(jax.random.PRNGKey(1))
    jb = jax_dataset(jax.random.PRNGKey(0), B, DIMS[0], DIMS[-1])
    rng = np.random.default_rng(5)
    v = [{"b": rng.standard_normal(o).astype(np.float32),
          "w": rng.standard_normal((i, o)).astype(np.float32)}
         for i, o in zip(DIMS[:-1], DIMS[1:])]
    return dict(
        jm=jm, jp=jp, jb=jb, jv=jax.tree_util.tree_map(jnp.asarray, v),
        tm=build_mlp(DIMS, device="cpu"),
        tp=params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu"),
        tv=params_from_numpy(v, "cpu"),
        tb=batch_from_numpy({k: np.asarray(x) for k, x in jb.items()}, "cpu"),
    )


def _flat(tree):
    """One float64 numpy vector of a JAX or torch tree."""
    if isinstance(tree_leaves(tree)[0], torch.Tensor):
        return np.concatenate([l.detach().double().numpy().ravel() for l in tree_leaves(tree)])
    return np.concatenate([np.asarray(l, np.float64).ravel()
                           for l in jax.tree_util.tree_leaves(tree)])


def _close(got, want, tol):
    """max |got − want| ≤ tol · max |want|, over the flattened trees."""
    g, w = _flat(got), _flat(want)
    assert g.shape == w.shape
    assert np.max(np.abs(g - w)) <= tol * np.max(np.abs(w))


@pytest.mark.parametrize("mode,chunk", [("naive", 0), ("linearize", 0), ("chunked", CHUNK)])
def test_make_hvp_matches_reference(setup, mode, chunk):
    s = setup
    jop = jhvp.make_hvp(s["jm"].loss_fn, s["jp"], s["jb"], mode=mode, chunk_size=chunk)
    top = make_hvp(s["tm"].loss_fn, s["tp"], s["tb"], mode=mode, chunk_size=chunk)
    _close(top(s["tv"]), jop(s["jv"]), 1e-5)


def test_make_gnvp_and_damped_match_reference(setup):
    s = setup
    jm, tm = s["jm"], s["tm"]
    jop = jhvp.make_gnvp(jm.logits_fn, jm.out_loss_fn, s["jp"], s["jb"])
    top = make_gnvp(tm.logits_fn, tm.out_loss_fn, s["tp"], s["tb"])
    _close(top(s["tv"]), jop(s["jv"]), 1e-5)
    _close(make_damped(top, LAM)(s["tv"]), jhvp.make_damped(jop, LAM)(s["jv"]), 1e-5)


def test_fd_hvp_matches_reference_fd_hvp(setup):
    """Both oracles in f32 at ε = 1e-3: a gradient's f32 rounding (~1e-7 of
    |g|) over 2ε leaves ~1e-4 of noise, so they are held to 2e-3 of
    max|fd| of each other, and each to 2e-3 of the exact product."""
    s = setup
    jfd = jhvp.fd_hvp(s["jm"].loss_fn, s["jp"], s["jb"], s["jv"], eps=1e-3)
    tfd = fd_hvp(s["tm"].loss_fn, s["tp"], s["tb"], s["tv"], eps=1e-3)
    assert all(l.dtype == torch.float32 for l in tree_leaves(tfd))
    _close(tfd, jfd, 2e-3)
    exact = make_hvp(s["tm"].loss_fn, s["tp"], s["tb"])(s["tv"])
    _close(tfd, exact, 2e-3)
    _close(jfd, exact, 2e-3)


def _loss64(params, batch):
    """The MLP's tanh network and mean cross-entropy, in the dtype of its
    parameters (the model's own loss rounds the logits to f32)."""
    h = batch["x"].to(params[0]["w"].dtype)
    for layer in params[:-1]:
        h = torch.tanh(h @ layer["w"] + layer["b"])
    logits = h @ params[-1]["w"] + params[-1]["b"]
    return -torch.mean(torch.gather(F.log_softmax(logits, -1), -1, batch["y"][:, None]))


@pytest.mark.parametrize("mode,chunk", [("naive", 0), ("linearize", 0), ("chunked", CHUNK)])
def test_hvp_matches_float64_finite_difference(setup, mode, chunk):
    """The port's and the reference's f32 products against a float64
    central difference at ε = 1e-4 (truncation ~ε² and rounding ~1e-16/ε,
    both far under the f32 products' ~1e-7): 1e-5 of max|Hv|."""
    s = setup
    p64 = tree_map(lambda t: t.double(), s["tp"])
    v64 = tree_map(lambda t: t.double(), s["tv"])
    fd64 = fd_hvp(_loss64, p64, s["tb"], v64, eps=1e-4)
    assert all(l.dtype == torch.float64 for l in tree_leaves(fd64))
    top = make_hvp(s["tm"].loss_fn, s["tp"], s["tb"], mode=mode, chunk_size=chunk)
    jop = jhvp.make_hvp(s["jm"].loss_fn, s["jp"], s["jb"], mode=mode, chunk_size=chunk)
    _close(top(s["tv"]), fd64, 1e-5)
    _close(jop(s["jv"]), fd64, 1e-5)


@pytest.mark.parametrize("arch", ["qwen2-1.5b"])
def test_hvp_matches_finite_difference_in_aggregate(arch):
    """Twin of ``tests/test_models_property.py::test_hvp_matches_finite_difference``
    on the port's smoke config: v = 0.01 everywhere, ε = 1e-3, and the
    cosine of the exact product and the f32 finite difference above 0.99
    (per-coordinate finite-difference noise is large)."""
    cfg = configs.get_smoke_config(arch)
    model = build_model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    batch = lm_batch(torch.Generator().manual_seed(1), cfg, 2, 16, device="cpu")
    v = tree_map(lambda p: torch.ones_like(p) * 0.01, params)
    hv = _flat(make_hvp(model.loss_fn, params, batch)(v))
    fd = _flat(fd_hvp(model.loss_fn, params, batch, v, eps=1e-3))
    cos = np.dot(hv, fd) / (np.linalg.norm(hv) * np.linalg.norm(fd) + 1e-12)
    assert cos > 0.99

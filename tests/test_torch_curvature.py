"""The port's curvature engine against ``repro.core.curvature``: Hessian and
Gauss-Newton vector products on an MLP (16, 32, 4) in every mode, to 1e-5
relative to the product's largest entry."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from torch.utils._pytree import tree_leaves  # noqa: E402

from repro.core import curvature as jcurv  # noqa: E402
from repro.data import classification_dataset as jax_dataset  # noqa: E402
from repro.models import build_mlp as jax_build_mlp  # noqa: E402
from repro_torch.core import curvature as curv  # noqa: E402
from repro_torch.interop import batch_from_numpy, params_from_numpy  # noqa: E402
from repro_torch.models.mlp import build_mlp  # noqa: E402

DIMS = (16, 32, 4)
B = 24
CHUNK = 10  # two full microbatches and a remainder of 4


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def setup():
    jm = jax_build_mlp(DIMS)
    tm = build_mlp(DIMS, device="cpu")
    jp = jm.init(jax.random.PRNGKey(1))
    jb = jax_dataset(jax.random.PRNGKey(0), B, DIMS[0], DIMS[-1])
    rng = np.random.default_rng(3)
    v = [{"b": rng.standard_normal(o).astype(np.float32),
          "w": rng.standard_normal((i, o)).astype(np.float32)}
         for i, o in zip(DIMS[:-1], DIMS[1:])]
    np_p = jax.tree_util.tree_map(np.asarray, jp)
    return dict(
        jm=jm, tm=tm, jp=jp, jb=jb, jv=jax.tree_util.tree_map(jnp.asarray, v),
        tp=params_from_numpy(np_p, "cpu"), tv=params_from_numpy(v, "cpu"),
        tb=batch_from_numpy({k: np.asarray(x) for k, x in jb.items()}, "cpu"),
    )


def _assert_tree_close(jtree, ttree, tol=1e-5):
    jl, tl = jax.tree_util.tree_leaves(jtree), tree_leaves(ttree)
    assert len(jl) == len(tl)
    scale = max(float(np.max(np.abs(np.asarray(l)))) for l in jl)
    for a, b in zip(jl, tl):
        np.testing.assert_allclose(b.detach().numpy(), np.asarray(a), rtol=tol,
                                   atol=tol * scale)


MODES = [("naive", 0, True), ("linearize", 0, True), ("chunked", CHUNK, True),
         ("chunked", CHUNK, False), ("chunked", 0, True)]


@pytest.mark.parametrize("mode,chunk,remat", MODES)
def test_hvp_matches_reference(setup, mode, chunk, remat):
    s = setup
    jop = jcurv.make_hvp_op(s["jm"].loss_fn, s["jp"], s["jb"], mode=mode,
                            chunk_size=chunk, remat=remat)
    top = curv.make_hvp_op(s["tm"].loss_fn, s["tp"], s["tb"], mode=mode,
                           chunk_size=chunk, remat=remat)
    _assert_tree_close(jop(s["jv"]), top(s["tv"]))
    # a second application reuses the cached graph
    _assert_tree_close(jop(s["jv"]), top(s["tv"]))


@pytest.mark.parametrize("mode,chunk,remat", MODES)
def test_gnvp_matches_reference(setup, mode, chunk, remat):
    s = setup
    jm, tm = s["jm"], s["tm"]
    jop = jcurv.make_gnvp_op(jm.logits_fn, jm.out_loss_fn, s["jp"], s["jb"],
                             mode=mode, chunk_size=chunk, remat=remat)
    top = curv.make_gnvp_op(tm.logits_fn, tm.out_loss_fn, s["tp"], s["tb"],
                            mode=mode, chunk_size=chunk, remat=remat)
    _assert_tree_close(jop(s["jv"]), top(s["tv"]))
    _assert_tree_close(jop(s["jv"]), top(s["tv"]))


def test_shared_primal_matches_reference(setup):
    s = setup
    jf0, jg, jop = jcurv.shared_primal_hvp(s["jm"].loss_fn, s["jp"], s["jb"])
    tf0, tg, top = curv.shared_primal_hvp(s["tm"].loss_fn, s["tp"], s["tb"])
    np.testing.assert_allclose(float(tf0), float(jf0), rtol=1e-6)
    _assert_tree_close(jg, tg)
    _assert_tree_close(jop(s["jv"]), top(s["tv"]))


def test_grad_reduce_applies_once_per_product(setup):
    s = setup
    calls = []

    def reduce(t):
        calls.append(1)
        return t

    op = curv.make_hvp_op(s["tm"].loss_fn, s["tp"], s["tb"], mode="chunked",
                          chunk_size=CHUNK, grad_reduce=reduce)
    op(s["tv"])
    assert len(calls) == 1


def test_damped_and_chunk_helpers_match_reference(setup):
    s = setup
    jd = jcurv.make_damped(jcurv.make_hvp_op(s["jm"].loss_fn, s["jp"], s["jb"]), 2.5)
    td = curv.make_damped(curv.make_hvp_op(s["tm"].loss_fn, s["tp"], s["tb"]), 2.5)
    _assert_tree_close(jd(s["jv"]), td(s["tv"]))
    jmain, jrem, jn, jr = jcurv.split_chunks(s["jb"], CHUNK)
    tmain, trem, tn, tr = curv.split_chunks(s["tb"], CHUNK)
    assert (tn, tr) == (jn, jr) == (2, 4)
    np.testing.assert_array_equal(tmain["x"].numpy(), np.asarray(jmain["x"]))
    np.testing.assert_array_equal(trem["y"].numpy(), np.asarray(jrem["y"]))
    jval = jcurv.chunked_scalar_fn(s["jm"].loss_fn, s["jb"], CHUNK)(s["jp"])
    tval = curv.chunked_scalar_fn(s["tm"].loss_fn, s["tb"], CHUNK)(s["tp"])
    np.testing.assert_allclose(float(tval), float(jval), rtol=1e-6)
    with pytest.raises(ValueError, match="curvature mode"):
        curv.make_hvp_op(s["tm"].loss_fn, s["tp"], s["tb"], mode="exact")

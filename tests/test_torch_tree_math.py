"""The port's tree algebra against ``repro.core.tree_math``, and the leaf
order of the port's MLP parameter tree against the JAX MLP's."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from torch.utils._pytree import tree_leaves  # noqa: E402

from repro.core import tree_math as jtm  # noqa: E402
from repro.models import build_mlp as jax_build_mlp  # noqa: E402
from repro_torch.core import tree_math as tm  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.models.mlp import MLP, build_mlp  # noqa: E402

DIMS = (16, 32, 4)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _trees(seed, scale=1.0):
    """The same random MLP-shaped tree in both packages."""
    rng = np.random.default_rng(seed)
    tree = [{"b": rng.standard_normal(o).astype(np.float32) * scale,
             "w": rng.standard_normal((i, o)).astype(np.float32) * scale}
            for i, o in zip(DIMS[:-1], DIMS[1:])]
    return jax.tree_util.tree_map(jnp.asarray, tree), params_from_numpy(tree, "cpu")


def _assert_leaves_close(jtree, ttree, rtol, atol):
    jl, tl = jax.tree_util.tree_leaves(jtree), tree_leaves(ttree)
    assert [l.shape for l in jl] == [tuple(l.shape) for l in tl]
    for a, b in zip(jl, tl):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=rtol, atol=atol)


@pytest.mark.parametrize("step", [0, 7])
@pytest.mark.parametrize("scale", [1e-3, 1.0])
def test_pseudo_noise_matches_reference_on_identical_g(step, scale):
    jg, tg = _trees(1, scale)
    # The sin argument reaches ~1e3·|g|; f32 rounds it to ~1e-7 of that.
    _assert_leaves_close(jtm.tree_pseudo_noise(jg, jnp.int32(step)),
                         tm.tree_pseudo_noise(tg, torch.tensor(step, dtype=torch.int32)),
                         rtol=0, atol=1e-6 * max(1.0, 1e4 * scale))


def test_tree_dot_norm_and_axpy_match_reference():
    ja, ta = _trees(2)
    jb, tb = _trees(3)
    np.testing.assert_allclose(float(tm.tree_dot(ta, tb)), float(jtm.tree_dot(ja, jb)),
                               rtol=1e-5)
    np.testing.assert_allclose(float(tm.tree_norm(ta)), float(jtm.tree_norm(ja)), rtol=1e-6)
    _assert_leaves_close(jtm.tree_axpy(0.3, ja, jb), tm.tree_axpy(0.3, ta, tb), 1e-6, 1e-6)
    _assert_leaves_close(jtm.tree_axpy_cast(-2.0, ja, jb),
                         tm.tree_axpy_cast(-2.0, ta, tb), 1e-6, 1e-6)
    _assert_leaves_close(jtm.tree_where(jnp.asarray(False), ja, jb),
                         tm.tree_where(torch.tensor(False), ta, tb), 0, 0)
    assert tm.tree_size(ta) == jtm.tree_size(ja)


def test_mlp_tree_flattens_in_jax_leaf_order():
    jparams = jax_build_mlp(DIMS).init(jax.random.PRNGKey(0))
    port = build_mlp(DIMS, device="cpu").init(torch.Generator().manual_seed(0))
    jshapes = [l.shape for l in jax.tree_util.tree_leaves(jparams)]
    # b before w in every layer, w as (d_in, d_out): JAX's sorted-key order.
    assert [tuple(l.shape) for l in tree_leaves(port)] == jshapes == [
        (32,), (16, 32), (4,), (32, 4)]
    converted = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    for a, b in zip(jax.tree_util.tree_leaves(jparams), tree_leaves(converted)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_mlp_module_forward_matches_functional_logits():
    gen = torch.Generator().manual_seed(4)
    module = MLP(DIMS, generator=gen, device="cpu")
    api = build_mlp(DIMS, device="cpu")
    x = torch.randn(5, DIMS[0], generator=gen)
    torch.testing.assert_close(module(x), api.logits_fn(module.param_tree(), {"x": x}))

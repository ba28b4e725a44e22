"""The port's plain kernel versions and dispatch against the reference's
kernels (``repro.kernels.ref`` and the Pallas kernels in interpret mode).

The CUDA kernels themselves run only on the card; ``chip_smoke.py`` holds
them against these plain versions there.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops, ref as jref  # noqa: E402
from repro_torch.kernels import cg_fused, ops, ref  # noqa: E402

# 65537 = one 64k Pallas block + 1 (the ragged tail); n = 65536 exactly is a
# known failure of the reference's interpret path and is not used here.
NS = [1, 1000, 65_537, 200_000]
ALPHA, GAMMA = 0.37, -1.3


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _vecs(n, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(n).astype(np.float32) for _ in range(3)]


def _close_vec(out, expected, terms):
    """|out − expected| ≤ 1e-5 · Σ|terms| elementwise."""
    bound = 1e-5 * sum(np.abs(t) for t in terms) + 1e-30
    assert np.all(np.abs(np.asarray(out) - np.asarray(expected)) <= bound)


def _close_sum(out, expected, terms, rtol=1e-5):
    """|out − expected| ≤ rtol · Σ|terms| for a reduction, and |out − the
    float64 sum of the same terms| ≤ 1e-5 · Σ|terms|."""
    terms64 = np.asarray(terms, np.float64)
    scale = float(np.sum(np.abs(terms64)))
    assert abs(float(out) - float(np.sum(terms64))) <= 1e-5 * scale
    assert abs(float(out) - float(expected)) <= rtol * scale


def _check(n, seed, jax_x_update, jax_residual_dots, jax_dot2, sum_rtol=1e-5):
    x, p, s = _vecs(n, seed)
    tx, tp, ts = (torch.from_numpy(a) for a in (x, p, s))
    jx, jp, js = (jnp.asarray(a) for a in (x, p, s))

    out = ref.x_update_ref(tx, tp, ts, ALPHA, GAMMA).numpy()
    _close_vec(out, jax_x_update(jx, jp, js, ALPHA, GAMMA),
               [x, ALPHA * p, GAMMA * s])

    r, d1, d2 = ref.residual_dots_ref(tx, tp, ts, GAMMA)
    er, e1, e2 = jax_residual_dots(jx, jp, js, GAMMA)
    _close_vec(r.numpy(), er, [x, GAMMA * p])
    r_np = x - GAMMA * p
    _close_sum(d1, e1, r_np.astype(np.float64) * s, sum_rtol)
    _close_sum(d2, e2, r_np.astype(np.float64) * r_np, sum_rtol)

    u1, u2 = ref.dot2_ref(tx, tp)
    f1, f2 = jax_dot2(jx, jp)
    _close_sum(u1, f1, x.astype(np.float64) * p, sum_rtol)
    _close_sum(u2, f2, p.astype(np.float64) * p, sum_rtol)


@pytest.mark.parametrize("n", NS)
def test_plain_versions_match_jax_ref(n):
    # The reference's sums are ``jnp.vdot``, which XLA's CPU backend
    # accumulates in f32 with a relative error near 4e-5·Σ|terms| at
    # n = 200k (the float64 sum agrees with the port's to 1e-7). So its sums
    # are held at 1e-4·Σ|terms|; the port's own sums are held at 1e-5
    # against the float64 oracle in ``_close_sum``.
    _check(n, n, jref.bicgstab_x_update_ref, jref.bicgstab_residual_dots_ref,
           jref.dot2_ref, sum_rtol=1e-4)


@pytest.mark.parametrize("n", NS)
def test_plain_versions_match_pallas_interpret(n):
    _check(
        n, n + 7,
        lambda *a: jops.bicgstab_x_update(*a, interpret=True),
        lambda *a: jops.bicgstab_residual_dots(*a, interpret=True),
        lambda *a: jops.dot2(*a, interpret=True),
    )


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    ops.reset_launches()
    x, p, s = (torch.from_numpy(a) for a in _vecs(100, 3))
    gamma = torch.tensor(0.5)
    torch.testing.assert_close(ops.bicgstab_x_update(x, p, s, ALPHA, gamma),
                               ref.x_update_ref(x, p, s, ALPHA, gamma), rtol=0, atol=0)
    r, d1, d2 = ops.bicgstab_residual_dots(x, p, s, gamma)
    er, e1, e2 = ref.residual_dots_ref(x, p, s, gamma)
    assert torch.equal(r, er) and torch.equal(d1, e1) and torch.equal(d2, e2)
    assert all(torch.equal(a, b) for a, b in zip(ops.dot2(x, p), ref.dot2_ref(x, p)))
    assert ops.LAUNCHES == {"dot2": 0, "x_update": 0, "residual_dots": 0}


def test_dispatch_raises_for_other_devices():
    u = torch.empty(8, device="meta")
    with pytest.raises(ValueError, match="meta"):
        ops.dot2(u, u)
    with pytest.raises(ValueError, match="meta"):
        ops.bicgstab_x_update(u, u, u, 1.0, 1.0)
    with pytest.raises(ValueError, match="meta"):
        ops.bicgstab_residual_dots(u, u, u, 1.0)


def test_cuda_wrappers_refuse_cpu_tensors_without_building():
    u = torch.ones(4)
    one = torch.ones(1)
    with pytest.raises(ValueError, match="CUDA"):
        cg_fused.dot2(u, u)
    with pytest.raises(ValueError, match="CUDA"):
        cg_fused.x_update(u, u, u, one, one)
    with pytest.raises(ValueError, match="CUDA"):
        cg_fused.residual_dots(u, u, u, one)
    assert cg_fused._ext is None  # nothing was compiled

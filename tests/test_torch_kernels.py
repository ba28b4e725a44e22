"""The port's plain kernel versions and dispatch against the reference's
kernels (``repro.kernels.ref`` and the Pallas kernels in interpret mode).

The CUDA kernels themselves run only on the card; ``chip_smoke.py`` holds
them against these plain versions there.
"""
import functools

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
    prev = torch.get_num_threads(), torch.get_float32_matmul_precision()
    torch.set_num_threads(2)
    torch.set_float32_matmul_precision("highest")
    yield
    torch.set_num_threads(prev[0])
    torch.set_float32_matmul_precision(prev[1])


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


# The reference test's edge shapes: one column, a partial 16k block, one
# block exactly, one block + 1, several blocks; row counts below, at and
# past the reference's row padding of 8.
GRAM_NS = [1, 127, 16_384, 16_385, 70_000]
GRAM_ROWS = [(1, 1), (3, 5), (8, 8), (9, 17)]


@pytest.mark.parametrize("su,sv", GRAM_ROWS)
@pytest.mark.parametrize("n", GRAM_NS)
def test_gram_plain_version_matches_pallas_interpret(n, su, sv):
    """``gram_block_ref`` against ``repro.kernels.ops.gram_block`` in
    interpret mode and a float64 oracle, to 1e-5 of max|G|."""
    rng = np.random.default_rng(n + 31 * su + sv)
    U = rng.standard_normal((su, n)).astype(np.float32)
    V = rng.standard_normal((sv, n)).astype(np.float32)
    got = ref.gram_block_ref(torch.from_numpy(U), torch.from_numpy(V)).numpy()
    want = np.asarray(jops.gram_block(jnp.asarray(U), jnp.asarray(V), interpret=True))
    exact = U.astype(np.float64) @ V.astype(np.float64).T
    scale = float(np.max(np.abs(exact)))
    assert got.shape == (su, sv)
    assert np.max(np.abs(got - exact)) <= 1e-5 * scale
    assert np.max(np.abs(got - want)) <= 1e-5 * scale


def _gram_ring(U, V, nb, tile=128, lanes=32):
    """U @ V.T summed in the order of the kernel (``csrc/cg_fused.cu``
    ``dots_block_partial``): block b takes column tiles b, b + nb, ...; lane
    L of a block its columns 2L, 2L + 1, 64 + 2L, 65 + 2L of each tile, in
    that order, as one f32 fma chain (each fma exact before its one
    rounding); the lanes are added by the shuffle tree (16, 8, 4, 2, 1) and
    the blocks in order."""
    su, n = U.shape
    K = -(-(-(-n // tile)) // nb)
    shape = (K, nb, tile // (2 * lanes), lanes, 2)
    Up = torch.nn.functional.pad(U, (0, K * nb * tile - n)).reshape(su, *shape).double()
    Vp = torch.nn.functional.pad(V, (0, K * nb * tile - n)).reshape(V.shape[0], *shape).double()
    acc = torch.zeros((su, V.shape[0], nb, lanes), dtype=torch.float32)
    for k in range(K):
        for q in range(tile // (2 * lanes)):
            for e in range(2):
                prod = Up[:, None, k, :, q, :, e] * Vp[None, :, k, :, q, :, e]
                acc = (acc.double() + prod).float()
    for off in (16, 8, 4, 2, 1):
        acc = acc[..., :off] + acc[..., off:2 * off]
    out = torch.zeros((su, V.shape[0]), dtype=torch.float32)
    for b in range(nb):
        out = out + acc[:, :, b, 0]
    return out


def _stream_blocks(m, unroll=4, sms=132, resident=132 * 6, threads=256):
    """The grid of ``csrc/cg_fused.cu``'s ``stream_blocks`` for m vectors (on
    an H100: 132 SMs, 6 blocks of 256 threads an SM at 40 registers, 5 at 48
    as ``dot2_single`` has, which caps no grid of ``dot2`` at n ≤ 1,722,293)."""
    per_thread = -(-m // (threads * unroll))
    busy = -(-m // threads)
    b = per_thread if per_thread > sms else min(busy, sms)
    return max(1, min(b, resident))


def _block_tree(v, threads=256):
    """``block_sum2`` on a (..., threads) f32 tensor: the shuffle tree
    (16, 8, 4, 2, 1) in each warp, then the same tree over the warps' sums
    padded to 32 lanes with zeros; the block's sum as (...,)."""
    def warp_tree(w):
        for off in (16, 8, 4, 2, 1):
            w = torch.cat([w[..., :off] + w[..., off:2 * off], w[..., 2 * off:]], -1)
        return w[..., 0]

    warps = warp_tree(v.reshape(*v.shape[:-1], threads // 32, 32))
    pad = torch.zeros(*warps.shape[:-1], 32 - warps.shape[-1], dtype=torch.float32)
    return warp_tree(torch.cat([warps, pad], -1))


def _grid_sum(lanes, nb, threads=256):
    """One dot's (G, 4) f32 lane chains summed as the one-launch kernels sum
    them: (l0 + l1) + (l2 + l3) per thread, ``_block_tree`` per block, then
    the last block's thread i adds slots i, i + threads, ... in order, and
    ``_block_tree``."""
    per_thread = (lanes[:, 0] + lanes[:, 1]) + (lanes[:, 2] + lanes[:, 3])
    part = _block_tree(per_thread.reshape(nb, threads), threads)
    slots = torch.zeros(threads, dtype=torch.float32)
    for i in range(0, nb, threads):
        chunk = part[i:i + threads]
        slots[:chunk.shape[0]] = slots[:chunk.shape[0]] + chunk
    return _block_tree(slots, threads)


def _dot2_single(u, v, nb, off_u=0, off_v=0, threads=256, unroll=4):
    """(<u,v>, <v,v>) summed in the order of the kernel (``csrc/cg_fused.cu``
    ``dot2_single``) with nb blocks, for u and v at element offsets off_u and
    off_v from 16-byte boundaries. Where the offsets agree, the head of h
    elements up to the first boundary is peeled and the body read as 16-byte
    vectors, else the body starts at element 0 (four 4-byte loads a vector,
    the same order). Thread t of the G = nb * threads takes vectors t, t + G,
    ... (``unroll`` a step) into one f32 fma chain per lane, then head
    element t and tail element t into lane 0; ``_grid_sum`` adds the
    lanes."""
    n = u.shape[0]
    h = min((4 - off_u % 4) % 4, n) if off_u % 4 == off_v % 4 else 0
    m, r = (n - h) // 4, (n - h) % 4
    G = nb * threads
    sums = []
    for a, b in ((u, v), (v, v)):
        acc = torch.zeros(G, 4, dtype=torch.float32)
        steps = -(-m // (G * unroll))
        if steps:
            pad = steps * G * unroll * 4 - 4 * m
            body = [torch.nn.functional.pad(t[h:h + 4 * m], (0, pad)).double()
                    .reshape(steps, unroll, G, 4) for t in (a, b)]
            for i in range(steps):
                for k in range(unroll):
                    acc = (acc.double() + body[0][i, k] * body[1][i, k]).float()
        for idx in [list(range(h)), [h + 4 * m + t for t in range(r)]]:
            if idx:
                t = torch.tensor(idx)
                lane = acc[:len(idx), 0].double() + a[t].double() * b[t].double()
                acc[:len(idx), 0] = lane.float()
        sums.append(_grid_sum(acc, nb, threads))
    return sums


@functools.lru_cache(maxsize=None)
def _dot2_case(n):
    """Seeded f32 vectors of length n and the reference's Pallas ``dot2`` on
    them in interpret mode."""
    rng = np.random.default_rng(n + 11)
    u = rng.standard_normal(n).astype(np.float32)
    v = rng.standard_normal(n).astype(np.float32)
    want = [float(w) for w in jops.dot2(jnp.asarray(u), jnp.asarray(v), interpret=True)]
    return u, v, want


@pytest.mark.parametrize("grid", ["h100", "132x8"])
@pytest.mark.parametrize("offsets", [(0, 0), (1, 1), (1, 2)], ids=["aligned", "both-1", "1-2"])
@pytest.mark.parametrize("n", [1, 5, 65_537, 1_722_293])
def test_dot2_single_order_matches_float64_and_pallas_interpret(n, offsets, grid):
    """The order of summation of the one-launch ``dot2`` kernel, emulated in
    torch at the grid ``stream_blocks`` picks on an H100 and at 132 x 8
    blocks, against float64 (1e-6 of Σ|terms|) and against
    ``repro.kernels.ops.dot2`` in interpret mode (1e-5 of Σ|terms|). At
    offsets (1, 1) the head of 3 elements is peeled; at (1, 2) the body
    starts at element 0."""
    u, v, want = _dot2_case(n)
    off_u, off_v = offsets
    h = min((4 - off_u % 4) % 4, n) if off_u % 4 == off_v % 4 else 0
    nb = _stream_blocks((n - h) // 4) if grid == "h100" else 132 * 8
    got = _dot2_single(torch.from_numpy(u), torch.from_numpy(v), nb, off_u, off_v)
    for g, w, terms in zip(got, want, (u.astype(np.float64) * v, v.astype(np.float64) * v)):
        scale = float(np.sum(np.abs(terms)))
        assert g.dtype == torch.float32
        assert abs(float(g) - float(np.sum(terms))) <= 1e-6 * scale
        assert abs(float(g) - w) <= 1e-5 * scale


def _residual_dots_single(s, As, r0s, gamma, nb, offs=(0, 0, 0), threads=256, unroll=2):
    """(r, <r,r0s>, <r,r>) in the order of the kernel (``csrc/cg_fused.cu``
    ``residual_dots_single``) with nb blocks, for s, As and r0s at element
    offsets ``offs`` from 16-byte boundaries; ``r0s=None`` is the aliased
    form (r0s is s itself: the loaded s stands in for it, at s's offset).
    r is s − γ·As rounded once to f32 (the fma the kernel compiles to). Where
    the three offsets agree mod 4, the head of h elements up to the first
    boundary is peeled and the body read as 16-byte vectors, else the body
    starts at element 0 (four 4-byte loads a vector, the same order). Thread
    t of the G = nb * threads takes vectors t, t + G, ... (``unroll`` a step)
    into one f32 fma chain per lane for each dot, then head element t and
    tail element t into lane 0; ``_grid_sum`` adds the lanes."""
    n = s.shape[0]
    off_s, off_a, off_w = offs if r0s is not None else (offs[0], offs[1], offs[0])
    w = s if r0s is None else r0s
    h = min((4 - off_s % 4) % 4, n) if off_s % 4 == off_a % 4 == off_w % 4 else 0
    m, tail = (n - h) // 4, (n - h) % 4
    G = nb * threads
    r = (s.double() - float(gamma) * As.double()).float()
    acc = [torch.zeros(G, 4, dtype=torch.float32) for _ in range(2)]
    steps = -(-m // (G * unroll))
    if steps:
        pad = steps * G * unroll * 4 - 4 * m
        rb, wb = (torch.nn.functional.pad(v[h:h + 4 * m], (0, pad)).double()
                  .reshape(steps, unroll, G, 4) for v in (r, w))
        for i in range(steps):
            for k in range(unroll):
                acc[0] = (acc[0].double() + rb[i, k] * wb[i, k]).float()
                acc[1] = (acc[1].double() + rb[i, k] * rb[i, k]).float()
    for idx in [list(range(h)), [h + 4 * m + t for t in range(tail)]]:
        if idx:
            t = torch.tensor(idx)
            for a, v in zip(acc, (w, r)):
                a[:len(idx), 0] = (a[:len(idx), 0].double()
                                   + r[t].double() * v[t].double()).float()
    return r, _grid_sum(acc[0], nb, threads), _grid_sum(acc[1], nb, threads)


def _residual_blocks(n, offs, grid):
    """The grid of ``residual_dots_single``: ``stream_blocks`` at two
    vectors a thread an iteration, on an H100 (one resident wave of the
    general form's instance: 6 blocks an SM at 40 registers or fewer with
    the 16-byte body, 5 at 48 with the 4-byte body), or 132 x 8 blocks."""
    if grid != "h100":
        return 132 * 8
    vec = offs[0] % 4 == offs[1] % 4 == offs[2] % 4
    h = min((4 - offs[0] % 4) % 4, n) if vec else 0
    return _stream_blocks((n - h) // 4, unroll=2, resident=132 * (6 if vec else 5))


@functools.lru_cache(maxsize=None)
def _residual_case(n):
    """Seeded f32 s, As and r0s of length n, and the reference's Pallas
    ``residual_dots`` on them in interpret mode (r0s read, and r0s = s)."""
    rng = np.random.default_rng(n + 13)
    s, As, w = (rng.standard_normal(n).astype(np.float32) for _ in range(3))
    want = {}
    for key, r0s in (("read", w), ("alias", s)):
        r, d1, d2 = jops.bicgstab_residual_dots(jnp.asarray(s), jnp.asarray(As),
                                                jnp.asarray(r0s), GAMMA, interpret=True)
        want[key] = np.asarray(r), float(d1), float(d2)
    return s, As, w, want


@pytest.mark.parametrize("grid", ["h100", "132x8"])
@pytest.mark.parametrize("offsets", [(0, 0, 0), (1, 1, 1), (1, 2, 0)],
                         ids=["aligned", "all-1", "1-2-0"])
@pytest.mark.parametrize("n", [1, 5, 65_537, 1_722_293])
def test_residual_dots_single_order_matches_float64_and_pallas_interpret(n, offsets, grid):
    """The order of summation of the one-launch ``residual_dots`` kernel,
    emulated in torch at the grid ``stream_blocks`` picks on an H100 and at
    132 x 8 blocks: both dots against float64 sums of the same rounded r
    (1e-6 of Σ|terms|) and against ``repro.kernels.ops.bicgstab_residual_dots``
    in interpret mode (1e-5 of Σ|terms|), r within 1e-5 of |s| + |γ·As|. At
    offsets (1, 1, 1) the head of 3 elements is peeled; at (1, 2, 0) the body
    starts at element 0."""
    s, As, w, want = _residual_case(n)
    nb = _residual_blocks(n, offsets, grid)
    r, d1, d2 = _residual_dots_single(*(torch.from_numpy(a) for a in (s, As, w)), GAMMA, nb,
                                      offsets)
    wr, w1, w2 = want["read"]
    _close_vec(r.numpy(), wr, [s, GAMMA * As])
    r64 = r.double().numpy()
    for g, e, terms in zip((d1, d2), (w1, w2), (r64 * w, r64 * r64)):
        scale = float(np.sum(np.abs(terms)))
        assert g.dtype == torch.float32
        assert abs(float(g) - float(np.sum(terms))) <= 1e-6 * scale
        assert abs(float(g) - e) <= 1e-5 * scale


@pytest.mark.parametrize("offsets", [(0, 0, 0), (1, 1, 1), (1, 2, 0)],
                         ids=["aligned", "all-1", "1-2-0"])
@pytest.mark.parametrize("n", [5, 65_537, 1_722_293])
def test_residual_dots_single_aliased_form_is_the_general_form_on_a_copy(n, offsets):
    """r0s = s (the CG call; the kernel's aliased form, which never reads
    r0s) gives the same bits as r0s = a copy of s at s's offset, and holds
    the reference's Pallas kernel on r0s = s within 1e-5 of Σ|terms|."""
    s, As, _, want = _residual_case(n)
    ts, tA = torch.from_numpy(s), torch.from_numpy(As)
    copy_offs = (offsets[0], offsets[1], offsets[0])
    nb = _residual_blocks(n, copy_offs, "h100")
    alias = _residual_dots_single(ts, tA, None, GAMMA, nb, offsets)
    general = _residual_dots_single(ts, tA, ts.clone(), GAMMA, nb, copy_offs)
    assert all(torch.equal(a, b) for a, b in zip(alias, general))
    wr, w1, w2 = want["alias"]
    _close_vec(alias[0].numpy(), wr, [s, GAMMA * As])
    r64 = alias[0].double().numpy()
    for g, e, terms in zip(alias[1:], (w1, w2), (r64 * s, r64 * r64)):
        assert abs(float(g) - e) <= 1e-5 * float(np.sum(np.abs(terms)))


def _tf32(x):
    """x rounded to TF32 as ``cvt.rna.tf32.f32`` rounds: to nearest on the 13
    dropped bits of the significand, ties away from zero."""
    return ((x.contiguous().view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def _gram_split_tf32(U, V):
    """U @ V.T as three TF32 products (lo·hi + hi·lo, then hi·hi), f32 sums."""
    Uh, Vh = _tf32(U), _tf32(V)
    Ul, Vl = _tf32(U - Uh), _tf32(V - Vh)
    return (Ul @ Vh.T + Uh @ Vl.T) + Uh @ Vh.T


GRAM_SCHEME_NS = [16_385, 70_000]


@pytest.mark.parametrize("su,sv", GRAM_ROWS)
@pytest.mark.parametrize("n", GRAM_SCHEME_NS)
@pytest.mark.parametrize("scheme", ["ffma-ring", "split-tf32"])
def test_gram_numeric_schemes_match_pallas_interpret(scheme, n, su, sv):
    """The kernel's scheme (f32 FMA chains in the ring's order, with 264
    blocks: two on each of an H100's 132 SMs) and the split-TF32 product
    that the kernel could have used instead, emulated in torch, against
    ``repro.kernels.ops.gram_block`` in interpret mode and float64, to 1e-5
    of max|G|."""
    rng = np.random.default_rng(7 * n + 31 * su + sv)
    U = rng.standard_normal((su, n)).astype(np.float32)
    V = rng.standard_normal((sv, n)).astype(np.float32)
    tU, tV = torch.from_numpy(U), torch.from_numpy(V)
    got = (_gram_ring(tU, tV, min(264, -(-n // 128))) if scheme == "ffma-ring"
           else _gram_split_tf32(tU, tV)).numpy()
    want = np.asarray(jops.gram_block(jnp.asarray(U), jnp.asarray(V), interpret=True))
    exact = U.astype(np.float64) @ V.astype(np.float64).T
    scale = float(np.max(np.abs(exact)))
    assert got.shape == (su, sv)
    assert np.max(np.abs(got - exact)) <= 1e-5 * scale
    assert np.max(np.abs(got - want)) <= 1e-5 * scale


def test_plain_tf32_gram_misses_the_gate():
    """One TF32 product (no split) is off by more than 1e-5 of max|G|."""
    rng = np.random.default_rng(5)
    U = rng.standard_normal((9, 70_000)).astype(np.float32)
    V = rng.standard_normal((17, 70_000)).astype(np.float32)
    want = np.asarray(jops.gram_block(jnp.asarray(U), jnp.asarray(V), interpret=True))
    scale = float(np.max(np.abs(want)))
    one = (_tf32(torch.from_numpy(U)) @ _tf32(torch.from_numpy(V)).T).numpy()
    split = _gram_split_tf32(torch.from_numpy(U), torch.from_numpy(V)).numpy()
    assert np.max(np.abs(one - want)) > 10 * 1e-5 * scale
    assert np.max(np.abs(split - want)) <= 1e-5 * scale


@pytest.mark.parametrize("su,sv", [(33, 36), (5, 40), (64, 3), (32, 32)])
def test_gram_row_tiles_assemble_the_whole_gram(su, sv):
    """Blocks with more rows than the kernel takes are cut into row tiles of
    at most GRAM_MAX_ROWS; the tiles assemble U @ V.T exactly (here with the
    plain version standing in for the kernel)."""
    rng = np.random.default_rng(su * sv)
    U = torch.from_numpy(rng.standard_normal((su, 300)).astype(np.float32))
    V = torch.from_numpy(rng.standard_normal((sv, 300)).astype(np.float32))
    calls = []

    def kernel(a, b):
        assert a.shape[0] <= cg_fused.GRAM_MAX_ROWS and b.shape[0] <= cg_fused.GRAM_MAX_ROWS
        assert a.is_contiguous() and b.is_contiguous()
        calls.append(1)
        return ref.gram_block_ref(a, b)

    got = ops.gram_tiles(U, V, kernel)
    assert torch.equal(got, torch.cat([torch.cat([
        ref.gram_block_ref(U[i:i + 32], V[j:j + 32]) for j in range(0, sv, 32)], 1)
        for i in range(0, su, 32)], 0))
    torch.testing.assert_close(got, ref.gram_block_ref(U, V), rtol=1e-5, atol=1e-4)
    assert len(calls) == -(-su // 32) * -(-sv // 32)


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
    U, V = torch.stack([x, p]), torch.stack([s, x, p])
    assert torch.equal(ops.gram_block(U, V), ref.gram_block_ref(U, V))
    assert ops.LAUNCHES == {"dot2": 0, "x_update": 0, "residual_dots": 0, "dots_block": 0,
                            "flash_attention_fwd": 0, "flash_attention_dq": 0,
                            "flash_attention_dkv": 0, "flash_attention_jvp": 0,
                            "flash_decode": 0, "flash_decode_paged": 0, "ssd_intra": 0}


def test_dispatch_raises_for_other_devices():
    u = torch.empty(8, device="meta")
    with pytest.raises(ValueError, match="meta"):
        ops.dot2(u, u)
    with pytest.raises(ValueError, match="meta"):
        ops.bicgstab_x_update(u, u, u, 1.0, 1.0)
    with pytest.raises(ValueError, match="meta"):
        ops.bicgstab_residual_dots(u, u, u, 1.0)
    with pytest.raises(ValueError, match="meta"):
        ops.gram_block(u.reshape(2, 4), u.reshape(2, 4))


def test_cuda_wrappers_refuse_cpu_tensors_without_building():
    u = torch.ones(4)
    one = torch.ones(1)
    with pytest.raises(ValueError, match="CUDA"):
        cg_fused.dot2(u, u)
    with pytest.raises(ValueError, match="CUDA"):
        cg_fused.x_update(u, u, u, one, one)
    with pytest.raises(ValueError, match="CUDA"):
        cg_fused.residual_dots(u, u, u, one)
    with pytest.raises(ValueError, match="CUDA"):
        cg_fused.dots_block(u.reshape(1, 4), u.reshape(1, 4))
    assert cg_fused._ext is None  # nothing was compiled


@pytest.mark.parametrize("shape_u,shape_v,dtype,match", [
    ((33, 8), (2, 8), torch.float32, "rows"),
    ((2, 8), (33, 8), torch.float32, "rows"),
    ((2, 8), (3, 8), torch.float64, "float32"),
    ((8,), (3, 8), torch.float32, "2-D"),
    ((2, 8), (3, 8), torch.float32, "CUDA"),
], ids=["rows-u", "rows-v", "dtype", "ndim", "device"])
def test_dots_block_wrapper_rejects_what_the_kernel_does_not_take(shape_u, shape_v, dtype,
                                                                 match):
    """More than GRAM_MAX_ROWS rows, another dtype, a block that is not 2-D
    or not on the card: the wrapper raises before any build or launch."""
    with pytest.raises((ValueError, TypeError), match=match):
        cg_fused.dots_block(torch.zeros(shape_u, dtype=dtype), torch.zeros(shape_v, dtype=dtype))
    assert cg_fused._ext is None

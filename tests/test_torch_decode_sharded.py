"""The port's sequence-sharded decode (``repro_torch.models.decode_sharded``)
on two gloo processes on the CPU, against the reference's unsharded
``decode_attend`` and the port's unsharded flash-decode route on the same
inputs, as ``tests/test_decode_sharded.py`` holds the reference's: granite's
smoke config (GQA, kv 2), B 2, a cache of 64 slots (the windowed one of 24)
split in halves, with and without a sliding window, and a half-empty cache
whose second rank holds no live slot.

One module-scoped spawn runs every case; each child imports only
``repro_torch``.
"""
import os
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config  # noqa: E402
from repro.models.attention import KVCache, attn_init, decode_attend, init_kv_cache  # noqa: E402
from repro_torch.launch import multiproc  # noqa: E402

# (name, sliding window, positions filled before the decoded token)
CASES = [("rolling", None, 40), ("window24", 24, 40), ("half-empty", None, 20)]
B, MAX_LEN = 2, 64
TOL = 1e-5  # of max|y|, the f32 gate of the decode kernels

WORKER = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels import ops
    from repro_torch.launch import multiproc
    from repro_torch.launch.mesh import make_data_mesh
    from repro_torch.models.attention import KVCache, _qkv_rope, decode_attend
    from repro_torch.models.decode_sharded import sharded_decode_attend

    torch.set_num_threads(1)
    multiproc.initialize_from_env("cpu")
    mesh = make_data_mesh("model")
    r, d = mesh.rank, sys.argv[1]
    for name in sys.argv[2:]:
        f = np.load(f"{d}/{name}.npz")
        window = int(f["window"]) if int(f["window"]) > 0 else None
        cfg = get_smoke_config("granite-3-8b").replace(sliding_window=window)
        p = {}
        for key in f.files:
            if key.startswith("p/"):
                node = p
                *path, leaf = key[2:].split("/")
                for part in path:
                    node = node.setdefault(part, {})
                node[leaf] = torch.from_numpy(f[key])
        full = KVCache(torch.from_numpy(f["k"]), torch.from_numpy(f["v"]),
                       torch.from_numpy(f["pos"]).to(torch.int32))
        Wl = full.k.shape[1] // mesh.size
        own = slice(r * Wl, (r + 1) * Wl)
        shard = KVCache(full.k[:, own].clone(), full.v[:, own].clone(), full.pos[own].clone())
        x, t = torch.from_numpy(f["x"]), int(f["t"])
        y_sh, shard = sharded_decode_attend(p, x, t, shard, cfg, mesh)
        y_full, _ = decode_attend(p, x, t, KVCache(*(c.clone() for c in full)),
                                  cfg.replace(use_flash_attention=True))
        q, _, _ = _qkv_rope(p, x, torch.full((1,), t, dtype=torch.int32), cfg)
        bias = ops.decode_bias(shard.pos, t, window=window)
        o, m, l = ops.flash_decode(q[:, 0].contiguous(), shard.k, shard.v, bias,
                                   return_stats=True)
        np.savez(f"{d}/{name}.rank{r}.npz", y_sh=y_sh.numpy(), y_full=y_full.numpy(),
                 k=shard.k.numpy(), v=shard.v.numpy(), pos=shard.pos.numpy(),
                 o=o.numpy(), m=m.numpy(), l=l.numpy())
    torch.distributed.destroy_process_group()
    assert "jax" not in sys.modules, "a child of the port imported jax"
""")


def _case_inputs(window, npos):
    """The reference test's inputs: attention weights from PRNGKey(0), K/V of
    positions [npos - fill, npos) at their rolling slots from PRNGKey(1)."""
    cfg = get_smoke_config("granite-3-8b").replace(sliding_window=window)
    p = attn_init(jax.random.PRNGKey(0), cfg, jnp.float32)
    cache = init_kv_cache(cfg, B, MAX_LEN, jnp.float32)
    ks = jax.random.split(jax.random.PRNGKey(1), 3)
    Wc = cache.k.shape[1]
    fill = min(npos, Wc)
    ppos = jnp.arange(npos - fill, npos)
    slots = ppos % Wc
    shape = (B, fill, cfg.n_kv_heads, cfg.resolved_head_dim)
    cache = KVCache(k=cache.k.at[:, slots].set(jax.random.normal(ks[0], shape)),
                    v=cache.v.at[:, slots].set(jax.random.normal(ks[1], shape)),
                    pos=cache.pos.at[slots].set(ppos))
    x = jax.random.normal(ks[2], (B, 1, cfg.d_model), jnp.float32)
    t = jnp.asarray(npos, jnp.int32)
    y_ref, c_ref = decode_attend(p, x, t, cache, cfg)
    flat = jax.tree_util.tree_flatten_with_path(p)[0]
    params = {"p/" + "/".join(k.key for k in path): np.asarray(leaf) for path, leaf in flat}
    return dict(params, k=np.asarray(cache.k), v=np.asarray(cache.v), pos=np.asarray(cache.pos),
                x=np.asarray(x), t=npos, window=window or 0), (y_ref, c_ref)


@pytest.fixture(scope="module")
def decoded(tmp_path_factory):
    d = tmp_path_factory.mktemp("decode_sharded")
    (d / "_ds_worker.py").write_text(WORKER)
    refs = {}
    for name, window, npos in CASES:
        inputs, refs[name] = _case_inputs(window, npos)
        np.savez(d / f"{name}.npz", **inputs)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = os.pathsep.join([str(d), env.get("PYTHONPATH", "")])
    multiproc.spawn(2, "_ds_worker", [str(d)] + [c[0] for c in CASES], env=env, timeout_s=240)
    out = {name: [dict(np.load(d / f"{name}.rank{r}.npz")) for r in range(2)]
           for name, _, _ in CASES}
    return out, refs


def _rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("rank", [0, 1])
@pytest.mark.parametrize("case", [c[0] for c in CASES])
def test_sharded_decode_matches_the_reference(decoded, case, rank):
    y_ref = np.asarray(decoded[1][case][0])
    assert _rel(decoded[0][case][rank]["y_sh"], y_ref) <= TOL


@pytest.mark.parametrize("rank", [0, 1])
@pytest.mark.parametrize("case", [c[0] for c in CASES])
def test_sharded_decode_matches_the_unsharded_kernel_route(decoded, case, rank):
    got = decoded[0][case][rank]
    assert _rel(got["y_sh"], got["y_full"]) <= TOL


@pytest.mark.parametrize("rank", [0, 1])
@pytest.mark.parametrize("case", [c[0] for c in CASES])
def test_each_rank_holds_its_half_of_the_updated_cache(decoded, case, rank):
    c_ref = decoded[1][case][1]
    got = decoded[0][case][rank]
    Wl = got["k"].shape[1]
    own = slice(rank * Wl, (rank + 1) * Wl)
    # the reference test's tolerance: the new token's K/V are projected in
    # another framework
    np.testing.assert_allclose(got["k"], np.asarray(c_ref.k)[:, own], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got["v"], np.asarray(c_ref.v)[:, own], rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(got["pos"], np.asarray(c_ref.pos)[own])


def test_a_rank_with_no_live_slot_gives_empty_stats(decoded):
    empty = decoded[0]["half-empty"][1]
    assert (empty["pos"] == -1).all()
    assert (empty["o"] == 0).all() and (empty["m"] == -1e30).all() and (empty["l"] == 0).all()
    live = decoded[0]["half-empty"][0]
    assert (live["l"] > 0).all()

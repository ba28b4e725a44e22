"""Weights across the two packages (the MLP's, and the transformer's nested
stacked trees in f32 and bf16), the port's import isolation, and its device
rule (the ``device="cuda"`` default raises without CUDA)."""
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from repro.models import build_mlp as jax_build_mlp  # noqa: E402
from repro_torch._device import resolve_device  # noqa: E402
from repro_torch.core import hf  # noqa: E402
from repro_torch.data.synthetic import classification_dataset, minibatches  # noqa: E402
from repro_torch.interop import (  # noqa: E402
    batch_from_numpy,
    params_from_numpy,
    params_to_numpy,
)
from repro_torch.models.mlp import MLP, build_mlp  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DIMS = (16, 32, 4)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def test_numpy_round_trip_keeps_values_order_and_dtypes():
    jparams = jax.tree_util.tree_map(
        np.asarray, jax_build_mlp(DIMS).init(jax.random.PRNGKey(0)))
    port = params_from_numpy(jparams, "cpu")
    assert [list(layer) for layer in port] == [["b", "w"], ["b", "w"]]
    back = params_to_numpy(port)
    for a, b in zip(jax.tree_util.tree_leaves(jparams), jax.tree_util.tree_leaves(back)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    batch = batch_from_numpy({"y": np.array([3, 1], np.int32),
                              "x": np.ones((2, 5), np.float32)}, "cpu")
    assert list(batch) == ["x", "y"]
    assert batch["y"].dtype == torch.int64 and batch["x"].dtype == torch.float32


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_transformer_tree_round_trip_keeps_bits_and_leaf_order(dtype):
    from repro.configs import get_smoke_config
    from repro.models import build_model

    cfg = get_smoke_config("qwen1.5-0.5b").replace(dtype=dtype)
    jparams = jax.tree_util.tree_map(np.asarray,
                                     build_model(cfg).init(jax.random.PRNGKey(0)))
    port = params_from_numpy(jparams, "cpu")
    jleaves = jax.tree_util.tree_flatten_with_path(jparams)[0]
    pleaves = jax.tree_util.tree_flatten_with_path(port)[0]
    from torch.utils._pytree import tree_leaves

    assert [jax.tree_util.keystr(k) for k, _ in jleaves] == [
        jax.tree_util.keystr(k) for k, _ in pleaves]
    assert len(tree_leaves(port)) == len(jleaves)
    want = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    assert all(t.dtype == want for t in tree_leaves(port))
    assert tuple(port["blocks"]["b0_attn"]["attn"]["wq"]["w"].shape) == (2, 128, 128)
    back = params_to_numpy(port)
    for (_, a), b in zip(jleaves, jax.tree_util.tree_leaves(back)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a.view(np.uint16) if dtype == "bfloat16" else a,
                                      b.view(np.uint16) if dtype == "bfloat16" else b)


@pytest.mark.parametrize("dtype,n_layers", [("float32", 5), ("bfloat16", 4)],
                         ids=["f32-tail", "bf16-no-tail"])
def test_hybrid_cache_round_trip_keeps_bits_and_types(dtype, n_layers):
    """The zamba hybrid's cache (a KVCache and MambaCaches, ``tail`` None when
    the groups take every layer) crosses both ways bit for bit, with int32
    positions, f32 states and the NamedTuples kept."""
    from repro.configs import get_smoke_config
    from repro.models import build_model
    from repro_torch.interop import hybrid_cache_from_numpy, hybrid_cache_to_numpy
    from repro_torch.models.attention import KVCache
    from repro_torch.models.ssm import MambaCache

    cfg = get_smoke_config("zamba2-7b").replace(dtype=dtype, n_layers=n_layers)
    zeros = build_model(cfg).init_cache(2, 12)
    rng = np.random.default_rng(0)
    jcache = jax.tree_util.tree_map(
        lambda a: (rng.integers(-1, 12, a.shape) if a.dtype == np.int32
                   else rng.standard_normal(a.shape)).astype(a.dtype), zeros)
    port = hybrid_cache_from_numpy(jcache, "cpu")
    assert sorted(port) == ["groups_attn", "groups_mamba", "tail"]
    assert isinstance(port["groups_attn"], KVCache)
    assert isinstance(port["groups_mamba"]["b0_mamba"], MambaCache)
    assert port["groups_attn"].pos.dtype == torch.int32
    assert port["groups_mamba"]["b0_mamba"].state.dtype == torch.float32
    assert port["groups_mamba"]["b0_mamba"].conv.dtype == getattr(torch, dtype)
    assert (port["tail"] is None) == (n_layers % cfg.attn_every == 0)
    back = hybrid_cache_to_numpy(port)
    paths = lambda tree: [jax.tree_util.keystr(k) for k, _ in
                          jax.tree_util.tree_flatten_with_path(tree)[0]]
    assert paths(back) == paths(jcache)
    bits = lambda x: x.view(np.uint16) if x.dtype.name == "bfloat16" else x
    for a, b in zip(jax.tree_util.tree_leaves(jcache), jax.tree_util.tree_leaves(back)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(bits(a), bits(b))


def test_port_never_calls_the_library_attention():
    """scaled_dot_product_attention is the kernels' yardstick in chip_smoke.py,
    never part of the port."""
    src = os.path.join(ROOT, "src", "repro_torch")
    for dirpath, _, files in os.walk(src):
        for name in files:
            if name.endswith((".py", ".cu", ".cpp", ".h")):
                with open(os.path.join(dirpath, name)) as f:
                    assert "scaled_dot_product_attention" not in f.read(), name


def test_port_imports_neither_jax_nor_the_reference():
    code = (
        "import sys\n"
        "import repro_torch.core.hf, repro_torch.core.hvp, repro_torch.models.mlp\n"
        "import repro_torch.interop\n"
        "import repro_torch.kernels.ops, repro_torch.data.synthetic\n"
        "import repro_torch.kernels.flash_ad, repro_torch.models.transformer\n"
        "import repro_torch.launch.train, repro_torch.optim, repro_torch.configs\n"
        "import repro_torch.kernels.ssd_scan, repro_torch.models.ssm, repro_torch.launch.serve\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "             or m == 'repro' or m.startswith('repro.'))\n"
        "assert not bad, bad\n"
        "print('clean')\n"
    )
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"


def test_cuda_default_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default runs on it")
    gen = torch.Generator().manual_seed(0)
    params = build_mlp(DIMS, device="cpu").init(gen)
    cfg = hf.HFConfig()
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        build_mlp(DIMS)
    with pytest.raises(RuntimeError, match="CUDA"):
        MLP(DIMS, generator=gen)
    with pytest.raises(RuntimeError, match="CUDA"):
        classification_dataset(gen, 8, 4, 2)
    with pytest.raises(RuntimeError, match="CUDA"):
        params_from_numpy(params_to_numpy(params))
    with pytest.raises(RuntimeError, match="CUDA"):
        hf.hf_init(params, cfg)
    state = hf.hf_init(params, cfg, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        hf.hf_step(lambda p, b: p[0]["b"].sum(), params, state, {}, {}, cfg)


def test_explicit_device_refuses_tensors_elsewhere():
    with pytest.raises(ValueError, match="device"):
        resolve_device("mps")
    params = [{"b": torch.zeros(2, device="meta"), "w": torch.zeros(3, 2, device="meta")}]
    with pytest.raises(ValueError, match="meta"):
        hf.hf_init(params, hf.HFConfig(), device="cpu")


def test_same_seed_gives_same_data_and_weights():
    a = classification_dataset(torch.Generator().manual_seed(5), 16, 4, 3, device="cpu")
    b = classification_dataset(torch.Generator().manual_seed(5), 16, 4, 3, device="cpu")
    assert torch.equal(a["x"], b["x"]) and torch.equal(a["y"], b["y"])
    batches = list(minibatches(a, 5, seed=1, epochs=2))
    assert len(batches) == 6 and all(x["x"].shape == (5, 4) for x in batches)

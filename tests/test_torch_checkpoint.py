"""The port's durable checkpoints (``repro_torch.checkpoint``): a twin of every
class of ``tests/test_checkpoint.py`` (round trip, corruption detection,
newest-valid fallback, manifest validation, fingerprint, a resume equal to
an uninterrupted run bit for bit), and the two packages' files held
against each other on the same arrays: equal key sets and CRCs, a
reference file (f32 and bf16 leaves) restored in the port bit for bit, a
port file verified (and, in f32, restored) by the reference, and equal
configuration fingerprints.
"""
import glob
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402

from repro import checkpoint as jck  # noqa: E402
from repro.configs import HFOptConfig as JHFOptConfig  # noqa: E402
from repro.core import HFConfig as JHFConfig  # noqa: E402
from repro.data import classification_dataset  # noqa: E402
from repro.models import build_mlp as j_build_mlp  # noqa: E402
from repro_torch.checkpoint import (  # noqa: E402
    CheckpointCorruptError,
    CheckpointError,
    CheckpointMismatchError,
    all_steps,
    config_fingerprint,
    latest_step,
    latest_valid_step,
    restore_checkpoint,
    restore_latest_valid,
    save_checkpoint,
    valid_steps,
    verify_checkpoint,
)
from repro_torch.configs import HFOptConfig  # noqa: E402
from repro_torch.core.hf import HFConfig, hf_init, hf_step  # noqa: E402
from repro_torch.interop import batch_from_numpy, params_from_numpy  # noqa: E402
from repro_torch.launch.faults import corrupt_file  # noqa: E402
from repro_torch.models.mlp import build_mlp  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _np_tree(seed=0):
    rng = np.random.RandomState(seed)
    return {"w": rng.randn(4, 3).astype(np.float32),
            "b": {"x": rng.randn(3).astype(np.float32)}}


def _tree(seed=0):
    return {"w": torch.from_numpy(_np_tree(seed)["w"]),
            "b": {"x": torch.from_numpy(_np_tree(seed)["b"]["x"])}}


def _like(t):
    return {"w": torch.zeros_like(t["w"]), "b": {"x": torch.zeros_like(t["b"]["x"])}}


def _leaves(t):
    return [t["b"]["x"], t["w"]]


def _assert_same(a, b):
    for x, y in zip(_leaves(a), _leaves(b)):
        assert x.dtype == y.dtype
        assert torch.equal(x, y)


class TestRoundtrip:
    def test_bitwise_roundtrip_params_and_opt_state(self, tmp_path):
        params, opt = _tree(0), _tree(1)
        save_checkpoint(str(tmp_path), 7, params, opt, extra={"note": "t"})
        p2, o2, meta = restore_checkpoint(str(tmp_path), 7, _like(params), _like(opt))
        assert meta["step"] == 7 and meta["note"] == "t"
        _assert_same(params, p2)
        _assert_same(opt, o2)

    def test_no_tmp_files_left_behind(self, tmp_path):
        save_checkpoint(str(tmp_path), 1, _tree())
        assert glob.glob(os.path.join(str(tmp_path), "*.tmp")) == []

    def test_verify_clean_checkpoint(self, tmp_path):
        path = save_checkpoint(str(tmp_path), 3, _tree(), fingerprint="abcd", processes=2)
        manifest = verify_checkpoint(path)
        assert manifest["step"] == 3
        assert manifest["fingerprint"] == "abcd"
        assert manifest["processes"] == 2
        assert manifest["checksums"]

    def test_bf16_int_and_bool_leaves_round_trip(self, tmp_path):
        tree = {"h": torch.randn(5, 3, generator=torch.Generator().manual_seed(0)).bfloat16(),
                "step": torch.tensor(4, dtype=torch.int32), "flag": torch.tensor(True)}
        save_checkpoint(str(tmp_path), 1, tree)
        like = {k: torch.zeros_like(v) for k, v in tree.items()}
        got, _, _ = restore_checkpoint(str(tmp_path), 1, like)
        for k, v in tree.items():
            assert got[k].dtype == v.dtype and torch.equal(got[k], v), k

    def test_short_disk_raises_naming_both_sizes(self, tmp_path, monkeypatch):
        import shutil
        from collections import namedtuple

        usage = namedtuple("usage", "total used free")
        monkeypatch.setattr(shutil, "disk_usage", lambda d: usage(10, 10, 1000))
        with pytest.raises(CheckpointError, match="bytes free"):
            save_checkpoint(str(tmp_path), 1, _tree())
        assert all_steps(str(tmp_path)) == []


class TestCorruptionDetection:
    def test_bitflip_detected_by_checksum(self, tmp_path):
        path = save_checkpoint(str(tmp_path), 1, _tree())
        corrupt_file(path)
        with pytest.raises(CheckpointCorruptError):
            verify_checkpoint(path)

    def test_truncated_file_detected(self, tmp_path):
        path = save_checkpoint(str(tmp_path), 1, _tree())
        size = os.path.getsize(path)
        with open(path, "r+b") as f:
            f.truncate(size // 2)
        with pytest.raises(CheckpointCorruptError):
            verify_checkpoint(path)

    def test_missing_manifest_detected(self, tmp_path):
        path = os.path.join(str(tmp_path), "ckpt_00000001.npz")
        np.savez(path, **{"params/w": np.zeros(3, np.float32),
                          "__meta__": json.dumps({"step": 1})})
        with pytest.raises(CheckpointCorruptError, match="manifest"):
            verify_checkpoint(path)

    def test_valid_steps_skips_corrupt(self, tmp_path):
        for s in (1, 2, 3):
            save_checkpoint(str(tmp_path), s, _tree(s))
        corrupt_file(os.path.join(str(tmp_path), "ckpt_00000003.npz"))
        assert all_steps(str(tmp_path)) == [1, 2, 3]
        assert latest_step(str(tmp_path)) == 3
        assert valid_steps(str(tmp_path)) == [1, 2]
        assert latest_valid_step(str(tmp_path)) == 2


class TestNewestValidFallback:
    def test_restore_latest_valid_skips_corrupt_newest(self, tmp_path):
        for s in (1, 2, 3):
            save_checkpoint(str(tmp_path), s, _tree(s))
        corrupt_file(os.path.join(str(tmp_path), "ckpt_00000003.npz"))
        out = restore_latest_valid(str(tmp_path), _like(_tree()))
        assert out is not None
        p2, opt, meta, step = out
        assert step == 2 and meta["step"] == 2 and opt is None
        _assert_same(_tree(2), p2)

    def test_restore_latest_valid_empty_dir(self, tmp_path):
        assert restore_latest_valid(str(tmp_path), _like(_tree())) is None

    def test_all_corrupt_returns_none(self, tmp_path):
        save_checkpoint(str(tmp_path), 1, _tree())
        corrupt_file(os.path.join(str(tmp_path), "ckpt_00000001.npz"))
        assert restore_latest_valid(str(tmp_path), _like(_tree())) is None


class TestManifestValidation:
    def test_fingerprint_mismatch_raises(self, tmp_path):
        save_checkpoint(str(tmp_path), 1, _tree(), fingerprint="aaaa")
        with pytest.raises(CheckpointMismatchError, match="fingerprint"):
            restore_checkpoint(str(tmp_path), 1, _like(_tree()), expect_fingerprint="bbbb")

    def test_process_count_mismatch_raises(self, tmp_path):
        save_checkpoint(str(tmp_path), 1, _tree(), processes=2)
        with pytest.raises(CheckpointMismatchError, match="process"):
            restore_checkpoint(str(tmp_path), 1, _like(_tree()), expect_processes=4)

    def test_matching_manifest_restores(self, tmp_path):
        save_checkpoint(str(tmp_path), 1, _tree(), fingerprint="aaaa", processes=2)
        restore_checkpoint(str(tmp_path), 1, _like(_tree()), expect_fingerprint="aaaa",
                           expect_processes=2)

    def test_latest_valid_does_not_skip_mismatch(self, tmp_path):
        save_checkpoint(str(tmp_path), 1, _tree(), fingerprint="aaaa")
        save_checkpoint(str(tmp_path), 2, _tree(), fingerprint="aaaa")
        with pytest.raises(CheckpointMismatchError):
            restore_latest_valid(str(tmp_path), _like(_tree()), expect_fingerprint="bbbb")

    def test_structure_mismatch_raises(self, tmp_path):
        save_checkpoint(str(tmp_path), 1, _tree())
        with pytest.raises(CheckpointMismatchError, match="structure|leaf"):
            restore_checkpoint(str(tmp_path), 1, {"w": torch.zeros(4, 3),
                                                  "b": {"x": torch.zeros(3)},
                                                  "extra": torch.zeros(2)})
        with pytest.raises(CheckpointMismatchError, match="shape"):
            restore_checkpoint(str(tmp_path), 1, {"w": torch.zeros(2, 2),
                                                  "b": {"x": torch.zeros(3)}})


class TestConfigFingerprint:
    def test_stable_across_dict_order(self):
        a = config_fingerprint({"x": 1, "y": [1, 2], "z": {"k": True}})
        b = config_fingerprint({"z": {"k": True}, "y": [1, 2], "x": 1})
        assert a == b and len(a) == 16

    def test_dataclass_fields_covered(self):
        a = config_fingerprint(HFConfig(solver="gn_cg"))
        b = config_fingerprint(HFConfig(solver="bicgstab"))
        c = config_fingerprint(HFConfig(solver="gn_cg"))
        assert a != b and a == c

    @pytest.mark.parametrize("solver", ["gn_cg", "bicgstab"])
    def test_equal_to_the_reference_on_the_same_run(self, solver):
        def run(opt_cls):
            return dict(arch="qwen1.5-0.5b", smoke=True, opt=opt_cls(name=solver),
                        batch_size=8, seq_len=64)

        assert config_fingerprint(run(HFOptConfig)) == jck.config_fingerprint(run(JHFOptConfig))
        assert config_fingerprint(HFConfig(solver=solver)) == jck.config_fingerprint(
            JHFConfig(solver=solver))


class TestResumeDeterminism:
    """4 straight steps against 2 + checkpoint + restore + 2: the same bits
    in every parameter (λ, the warm start δ and the step counter all
    restored)."""

    def test_resume_matches_uninterrupted(self, tmp_path):
        jm = j_build_mlp((8, 16, 4))
        data = batch_from_numpy(jax.tree_util.tree_map(
            np.asarray, classification_dataset(jax.random.PRNGKey(0), 32, 8, 4)), "cpu")
        params0 = params_from_numpy(jax.tree_util.tree_map(
            np.asarray, jm.init(jax.random.PRNGKey(1))), "cpu")
        model = build_mlp((8, 16, 4), device="cpu")
        cfg = HFConfig(solver="gn_cg", max_cg_iters=4)

        def step(p, s):
            return hf_step(model.loss_fn, p, s, data, data, cfg,
                           model_out_fn=model.logits_fn, out_loss_fn=model.out_loss_fn,
                           device="cpu")

        p, s = params0, hf_init(params0, cfg, device="cpu")
        for _ in range(4):
            p, s, _ = step(p, s)

        q, t = params0, hf_init(params0, cfg, device="cpu")
        for _ in range(2):
            q, t, _ = step(q, t)
        save_checkpoint(str(tmp_path), 2, q, t, fingerprint="f", processes=1)
        like = lambda tree: jax.tree_util.tree_map(torch.zeros_like, tree)  # noqa: E731
        q2, t2, _ = restore_checkpoint(str(tmp_path), 2, like(q), like(t),
                                       expect_fingerprint="f", expect_processes=1)
        assert int(t2.step) == 2 and t2.step.dtype == torch.int32
        for _ in range(2):
            q2, t2, _ = step(q2, t2)
        flat_p = jax.tree_util.tree_leaves(p)
        flat_q = jax.tree_util.tree_leaves(q2)
        assert len(flat_p) == len(flat_q) > 0
        for a, b in zip(flat_p, flat_q):
            assert torch.equal(a, b)


# ---------------------------------------------------- across the packages --
def _mixed_np():
    """f32 and bf16 leaves (the bf16 ones as ml_dtypes arrays, as the
    reference's np.asarray hands them to np.savez)."""
    rng = np.random.RandomState(3)
    return {"blocks": {"w": rng.randn(2, 4, 3).astype(np.float32),
                       "h": rng.randn(2, 5).astype(ml_dtypes.bfloat16)},
            "norm": rng.randn(3).astype(np.float32)}


def _to_torch(tree):
    def conv(a):
        if a.dtype == ml_dtypes.bfloat16:
            return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
        return torch.from_numpy(a.copy())
    return jax.tree_util.tree_map(conv, tree)


def _manifest(path):
    with np.load(path, allow_pickle=False) as z:
        return json.loads(str(z["__manifest__"]))


def test_key_sets_and_crcs_equal_the_reference(tmp_path):
    tree = _mixed_np()
    jpath = jck.save_checkpoint(str(tmp_path / "j"), 1, jax.tree_util.tree_map(jnp.asarray, tree),
                                {"lam": jnp.float32(2.0)}, fingerprint="f", processes=1)
    tpath = save_checkpoint(str(tmp_path / "t"), 1, _to_torch(tree),
                            {"lam": torch.tensor(2.0)}, fingerprint="f", processes=1)
    jm, tm = _manifest(jpath), _manifest(tpath)
    assert set(jm["checksums"]) == set(tm["checksums"]) == {
        "params/blocks/w", "params/blocks/h", "params/norm", "opt/lam"}
    assert jm["checksums"] == tm["checksums"]
    assert {k: v for k, v in jm.items() if k != "checksums"} == {
        k: v for k, v in tm.items() if k != "checksums"}


def test_a_reference_file_restores_in_the_port_bit_for_bit(tmp_path):
    tree = _mixed_np()
    jck.save_checkpoint(str(tmp_path), 5, jax.tree_util.tree_map(jnp.asarray, tree),
                        fingerprint="f", processes=1)
    want = _to_torch(tree)
    like = jax.tree_util.tree_map(torch.zeros_like, want)
    got, _, meta = restore_checkpoint(str(tmp_path), 5, like, expect_fingerprint="f",
                                      expect_processes=1)
    assert meta["step"] == 5
    assert got["blocks"]["h"].dtype == torch.bfloat16
    for a, b in zip(jax.tree_util.tree_leaves(want), jax.tree_util.tree_leaves(got)):
        assert a.dtype == b.dtype and torch.equal(a.view(torch.int16) if a.dtype ==
                                                  torch.bfloat16 else a,
                                                  b.view(torch.int16) if b.dtype ==
                                                  torch.bfloat16 else b)


def test_a_port_file_verifies_and_restores_in_the_reference(tmp_path):
    tree = _mixed_np()
    path = save_checkpoint(str(tmp_path), 4, _to_torch(tree), fingerprint="f", processes=1)
    manifest = jck.verify_checkpoint(path)
    assert manifest["step"] == 4 and manifest["fingerprint"] == "f"
    f32 = {"norm": tree["norm"], "w": tree["blocks"]["w"]}
    save_checkpoint(str(tmp_path / "f32"), 2, _to_torch(f32))
    got, _, _ = jck.restore_checkpoint(str(tmp_path / "f32"), 2,
                                       jax.tree_util.tree_map(jnp.zeros_like, f32))
    for k in f32:
        np.testing.assert_array_equal(np.asarray(got[k]), f32[k])

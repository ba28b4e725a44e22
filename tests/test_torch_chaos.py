"""Chaos twins of ``benchmarks/chaos_check.py`` through the port's train CLI on
the CPU, with the reference's arguments (``BASE_ARGS``, 4 steps, the kill at
step 2) and the ``kill_restart`` and ``corrupt_ckpt`` gates of its
``check``, with bitwise loss equality (a delta of 0.0): a 2-process run
whose rank 1 is killed at step 2 recovers under ``spawn_supervised`` to the
uninterrupted run's losses, and a run whose newest checkpoint is corrupted
resumes from the one before and replays its step to the same loss. The
``nan_batch`` scenario needs float model inputs, which only the vlm family
has (ROADMAP item 18e); the divergence sentinel's ``step_reject`` event is
held in ``tests/test_torch_telemetry.py`` on the MLP's float inputs.

Then ``--telemetry-dir`` on ``serve`` and ``serve_continuous`` (smoke): the
same tokens as without it, one ``request`` span per request, and the
scheduler's counters on every tick.
"""
import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from benchmarks import chaos_check as ref_chaos  # noqa: E402
from repro_torch.checkpoint import (  # noqa: E402
    CheckpointCorruptError,
    latest_step,
    latest_valid_step,
    verify_checkpoint,
)
from repro_torch.launch import multiproc, serve as serve_mod  # noqa: E402
from repro_torch.launch.faults import ENV_FAULTS  # noqa: E402
from repro_torch.obs import telemetry, trace  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH, STEPS, KILL_STEP = ref_chaos.ARCH, ref_chaos.STEPS, ref_chaos.KILL_STEP
BASE_ARGS = [*ref_chaos.BASE_ARGS, "--device", "cpu"]


@pytest.fixture(autouse=True, scope="module")
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _env(faults=None):
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    env.pop(ENV_FAULTS, None)
    if faults:
        env[ENV_FAULTS] = faults
    return env


def _train_cli(args, *, faults=None):
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", *BASE_ARGS, *args],
                       env=_env(faults), capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr


def _losses(path):
    with open(path) as f:
        return {int(m["step"]): m for m in json.load(f)}


def test_kill_restart_recovers_the_uninterrupted_losses(tmp_path):
    """``scenario_kill_restart`` and its gates (``chaos_check.check``)."""
    fault = f"kill@step={KILL_STEP},proc=1"
    base_hist, chaos_hist = tmp_path / "base.json", tmp_path / "chaos.json"
    tel_dir = tmp_path / "telemetry"
    _train_cli(["--arch", ARCH, "--steps", str(STEPS), "--num-processes", "2",
                "--history-out", str(base_hist)])
    restarts = multiproc.spawn_supervised(
        2, "repro_torch.launch.train",
        [*BASE_ARGS, "--arch", ARCH, "--steps", str(STEPS), "--num-processes", "2",
         "--ckpt-dir", str(tmp_path / "ckpt"), "--ckpt-every", "1",
         "--history-out", str(chaos_hist), "--telemetry-dir", str(tel_dir)],
        max_restarts=2, hang_timeout_s=ref_chaos.HANG_TIMEOUT_S, backoff_s=0.1,
        env=_env(fault), log=lambda m: None, timeout_s=240)
    base, resumed = _losses(base_hist), _losses(chaos_hist)
    deltas = {s: abs(base[s]["loss"] - m["loss"]) for s, m in resumed.items()}
    faults = trace.fault_events(trace.load_events(str(tel_dir)))
    kr = {"restarts": restarts, "resumed_steps": sorted(resumed),
          "max_loss_delta": max(deltas.values()), "fault_events": faults}
    # the gates of chaos_check.check for kill_restart
    assert kr["restarts"] >= 1, kr["restarts"]
    assert kr["resumed_steps"], kr
    assert min(kr["resumed_steps"]) <= KILL_STEP, kr["resumed_steps"]
    assert max(kr["resumed_steps"]) == STEPS - 1, kr["resumed_steps"]
    assert kr["max_loss_delta"] <= 1e-6, kr["max_loss_delta"]
    kills = [e for e in kr["fault_events"] if e["kind"] == "kill" and e.get("injected")]
    assert kills and kills[0]["step"] == KILL_STEP, kr["fault_events"]
    # bitwise on the CPU, the whole step too
    assert kr["max_loss_delta"] == 0.0
    for s, m in resumed.items():
        assert (m["loss_new"], m["grad_norm"], m["lambda"]) == (
            base[s]["loss_new"], base[s]["grad_norm"], base[s]["lambda"])
    # the resumed attempt's primary merged a trace of both processes
    assert os.path.exists(tel_dir / "trace.json")
    assert {e["pid"] for e in trace.load_events(str(tel_dir))} == {0, 1}


def test_corrupt_checkpoint_falls_back_and_replays(tmp_path):
    """``scenario_corrupt_ckpt`` and its gates (``chaos_check.check``)."""
    fault = f"corrupt_ckpt@step={STEPS - 1}"
    ckpt_dir = str(tmp_path / "ckpt")
    hist1, hist2 = tmp_path / "run1.json", tmp_path / "run2.json"
    _train_cli(["--arch", ARCH, "--steps", str(STEPS - 1), "--ckpt-dir", ckpt_dir,
                "--ckpt-every", "1", "--history-out", str(hist1)], faults=fault)
    newest, newest_valid = latest_step(ckpt_dir), latest_valid_step(ckpt_dir)
    try:
        verify_checkpoint(os.path.join(ckpt_dir, f"ckpt_{newest:08d}.npz"))
        detected = False
    except CheckpointCorruptError:
        detected = True
    _train_cli(["--arch", ARCH, "--steps", str(STEPS), "--ckpt-dir", ckpt_dir,
                "--ckpt-every", "1", "--history-out", str(hist2)])
    run1, run2 = _losses(hist1), _losses(hist2)
    replay = {s: abs(run1[s]["loss"] - m["loss"]) for s, m in run2.items() if s in run1}
    cc = {"latest_step": newest, "latest_valid_step": newest_valid,
          "corruption_detected": detected, "resume_start": min(run2),
          "replay_steps": sorted(replay), "max_loss_delta": max(replay.values())}
    # the gates of chaos_check.check for corrupt_ckpt
    assert cc["corruption_detected"], cc
    assert cc["latest_valid_step"] is not None
    assert cc["latest_valid_step"] < cc["latest_step"], cc
    assert cc["resume_start"] == cc["latest_valid_step"], cc
    assert cc["replay_steps"], cc
    assert cc["max_loss_delta"] <= 1e-6, cc["max_loss_delta"]
    assert cc["max_loss_delta"] == 0.0
    assert "restore_s" in run2[cc["resume_start"]] and "compile_s" in run1[0]
    assert all(math.isfinite(m["loss"]) for m in run2.values())


# ------------------------------------------------------------- serving --
SERVE_KW = dict(smoke=True, use_flash_attention=True, device="cpu", log_fn=lambda line: None)


def test_serve_with_a_sink_gives_the_same_tokens(tmp_path):
    want, _ = serve_mod.serve("qwen2-1.5b", **SERVE_KW)
    with telemetry.Telemetry(str(tmp_path)) as sink:
        got, stats = serve_mod.serve("qwen2-1.5b", telemetry=sink, **SERVE_KW)
    np.testing.assert_array_equal(got, want)
    evs = trace.load_events(str(tmp_path))
    assert [e["name"] for e in evs if e["ev"] == "span"] == ["prefill", "decode"]
    (tps,) = [e for e in evs if e["ev"] == "counter"]
    assert tps["name"] == "tok_per_s" and tps["value"] == pytest.approx(stats["tok_per_s"])


def test_serve_continuous_with_a_sink(tmp_path):
    kw = dict(n_requests=5, batch_size=2, gen_lens=[16, 4, 9, 16, 2],
              arrival_steps=[0, 0, 3, 5, 30], **SERVE_KW)
    want, _ = serve_mod.serve_continuous("qwen2-1.5b", **kw)
    with telemetry.Telemetry(str(tmp_path)) as sink:
        got, stats = serve_mod.serve_continuous("qwen2-1.5b", telemetry=sink, **kw)
    np.testing.assert_array_equal(got, want)
    evs = trace.load_events(str(tmp_path))
    reqs = [e for e in evs if e["ev"] == "span" and e["name"] == "request"]
    assert sorted(e["req"] for e in reqs) == list(range(5))
    assert all(math.isfinite(e["ttft_s"]) and e["ttft_s"] > 0 for e in reqs)
    assert [e["n_tok"] for e in sorted(reqs, key=lambda e: e["req"])] == kw["gen_lens"]
    for name in ("queue_depth", "pages_free"):
        ticks = [e for e in evs if e["ev"] == "counter" and e["name"] == name]
        assert len(ticks) == stats["steps"], name
    assert [e["value"] for e in evs if e.get("name") == "pages_free"][-1] >= 0


@pytest.mark.parametrize("continuous", [False, True])
def test_serve_cli_writes_a_merged_trace(tmp_path, capsys, continuous):
    d = tmp_path / "tel"
    argv = ["--arch", "qwen2-1.5b", "--flash-attention", "--device", "cpu",
            "--telemetry-dir", str(d)] + (["--continuous", "--n-requests", "3"]
                                          if continuous else [])
    serve_mod.main(argv)
    assert "generated token ids" in capsys.readouterr().out
    doc = json.loads((d / "trace.json").read_text())
    names = {e["name"] for e in doc["traceEvents"] if e.get("ph") == "X"}
    assert names == ({"request"} if continuous else {"prefill", "decode"})

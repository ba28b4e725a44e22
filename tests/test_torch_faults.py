"""The port's fault injection and supervision (``repro_torch.launch.faults``,
``repro_torch.launch.multiproc.spawn_supervised``, the collective watchdog of
``repro_torch.core.collectives``): a twin of ``tests/test_faults.py``
(spec parsing, plan gating, the watchdog, the supervisor's restart loop
with real children through the stdlib ``timeit`` module, whose ``-s`` setup
statement runs arbitrary code under the spawn environment), the watchdog
armed and disarmed around real ``preduce`` calls on a gloo group of one,
and a real 2-rank run on the CPU in which rank 1 sleeps before its
all-reduce and rank 0's watchdog ends it with exit code 87.
"""
import os
import textwrap
import time

import pytest

torch = pytest.importorskip("torch")
import torch.distributed as dist  # noqa: E402

from repro.launch import faults as jfaults  # noqa: E402
from repro_torch.checkpoint import latest_valid_step, save_checkpoint, valid_steps  # noqa: E402
from repro_torch.core import collectives  # noqa: E402
from repro_torch.core.collectives import DataMesh  # noqa: E402
from repro_torch.launch import multiproc  # noqa: E402
from repro_torch.launch.faults import (  # noqa: E402
    ENV_FAULTS,
    KINDS,
    Fault,
    FaultPlan,
    corrupt_file,
    parse_faults,
)


class TestSpecParsing:
    def test_single(self):
        (f,) = parse_faults("kill@step=3,proc=1")
        assert f == Fault(kind="kill", step=3, proc=1)

    def test_multi_and_defaults(self):
        fs = parse_faults("nan_batch@step=2; delay@step=1,secs=0.5,attempt=1 ;")
        assert fs[0] == Fault(kind="nan_batch", step=2, proc=None)
        assert fs[1] == Fault(kind="delay", step=1, secs=0.5, attempt=1)

    def test_spec_roundtrip(self):
        for s in ("kill@step=3,proc=1", "hang@step=0", "delay@step=2,secs=0.25,attempt=2"):
            (f,) = parse_faults(s)
            assert parse_faults(f.spec()) == [f]

    def test_empty(self):
        assert parse_faults("") == []

    @pytest.mark.parametrize("bad", ["explode@step=1", "kill@proc=1", "kill@step=1,when=now",
                                     "kill"])
    def test_bad_specs_raise(self, bad):
        with pytest.raises(ValueError):
            parse_faults(bad)

    def test_same_kinds_and_specs_as_the_reference(self):
        assert KINDS == jfaults.KINDS
        for s in ("kill@step=2,proc=1", "hang@step=2,proc=1,secs=600",
                  "corrupt_ckpt@step=2", "nan_batch@step=1;delay@step=0,secs=0.5,attempt=1"):
            assert [f.spec() for f in parse_faults(s)] == [
                f.spec() for f in jfaults.parse_faults(s)]

    def test_the_port_reads_its_own_variable(self):
        assert ENV_FAULTS == "REPRO_TORCH_FAULTS" != jfaults.ENV_FAULTS


class TestFaultPlan:
    def _kill_calls(self, monkeypatch):
        calls = []
        monkeypatch.setattr(os, "_exit", lambda code: calls.append(code))
        return calls

    def test_proc_filter(self):
        faults = parse_faults("kill@step=1,proc=1;nan_batch@step=2")
        assert [f.kind for f in FaultPlan(faults, process_index=0).faults] == ["nan_batch"]
        assert [f.kind for f in FaultPlan(faults, process_index=1).faults] == [
            "kill", "nan_batch"]

    def test_attempt_gating(self):
        faults = parse_faults("kill@step=1,proc=0")
        assert FaultPlan(faults, 0, attempt=0).active()
        assert not FaultPlan(faults, 0, attempt=1).active()

    def test_from_env_reads_restart_attempt(self, monkeypatch):
        monkeypatch.setenv(ENV_FAULTS, "kill@step=1,proc=0")
        monkeypatch.setenv(multiproc.ENV_RESTART, "1")
        assert not FaultPlan.from_env(0).active()
        monkeypatch.setenv(multiproc.ENV_RESTART, "0")
        assert FaultPlan.from_env(0).active()

    def test_a_reference_spec_does_not_arm_the_port(self, monkeypatch):
        monkeypatch.delenv(ENV_FAULTS, raising=False)
        monkeypatch.setenv(jfaults.ENV_FAULTS, "kill@step=1,proc=0")
        assert not FaultPlan.from_env(0).active()

    def test_kill_fires_once_at_step(self, monkeypatch):
        calls = self._kill_calls(monkeypatch)
        plan = FaultPlan(parse_faults("kill@step=2,proc=0"), 0)
        plan.on_step_begin(0)
        plan.on_step_begin(1)
        assert calls == []
        plan.on_step_begin(2)
        assert calls == [1]
        plan.on_step_begin(2)
        assert calls == [1]

    def test_delay_sleeps(self):
        plan = FaultPlan(parse_faults("delay@step=0,secs=0.1"), 0)
        t0 = time.time()
        plan.on_step_begin(0)
        assert time.time() - t0 >= 0.1

    def test_poison_batch_floats_only(self):
        plan = FaultPlan(parse_faults("nan_batch@step=1"), 0)
        batch = {"tokens": torch.arange(4), "vision": torch.ones(2, 3)}
        assert plan.poison_batch(0, batch) is batch
        out = plan.poison_batch(1, batch)
        assert torch.isnan(out["vision"]).all()
        assert torch.equal(out["tokens"], torch.arange(4))
        assert not torch.isnan(batch["vision"]).any()   # the input is not written

    def test_telemetry_emission(self):
        events = []

        class Sink:
            def emit(self, ev):
                events.append(ev)

        plan = FaultPlan(parse_faults("delay@step=0,secs=0.01"), 3, telemetry=Sink())
        plan.on_step_begin(0)
        assert events and events[0]["ev"] == "fault"
        assert events[0]["kind"] == "delay"
        assert events[0]["injected"] is True
        assert events[0]["proc"] == 3

    def test_corrupt_checkpoint_hits_newest(self, tmp_path):
        save_checkpoint(str(tmp_path), 1, {"w": [1.0, 2.0]})
        save_checkpoint(str(tmp_path), 2, {"w": [3.0, 4.0]})
        plan = FaultPlan(parse_faults("corrupt_ckpt@step=2"), 0)
        path = plan.corrupt_checkpoint(2, str(tmp_path))
        assert path and path.endswith("ckpt_00000002.npz")
        assert valid_steps(str(tmp_path)) == [1]
        assert latest_valid_step(str(tmp_path)) == 1


class TestCorruptFile:
    def test_changes_bytes_not_size(self, tmp_path):
        p = tmp_path / "blob.bin"
        p.write_bytes(bytes(range(256)) * 16)
        before = p.read_bytes()
        corrupt_file(str(p))
        after = p.read_bytes()
        assert len(after) == len(before) and after != before

    def test_same_damage_as_the_reference(self, tmp_path):
        a, b = tmp_path / "a.bin", tmp_path / "b.bin"
        a.write_bytes(bytes(range(256)) * 16)
        b.write_bytes(bytes(range(256)) * 16)
        corrupt_file(str(a))
        jfaults.corrupt_file(str(b))
        assert a.read_bytes() == b.read_bytes()


class TestWatchdog:
    def test_fires_on_stuck_collective(self):
        fired = []
        wd = collectives.Watchdog(0.1, on_timeout=lambda t, w: fired.append(t),
                                  poll_s=0.02).start()
        wd.arm("grad_hvp")
        time.sleep(0.4)
        assert wd.fired and fired == ["grad_hvp"]
        wd.stop()

    def test_no_fire_when_disarmed(self):
        fired = []
        wd = collectives.Watchdog(0.1, on_timeout=lambda t, w: fired.append(t),
                                  poll_s=0.02).start()
        wd.arm("grad_hvp")
        wd.disarm("grad_hvp")
        time.sleep(0.3)
        assert not wd.fired and fired == []
        wd.stop()

    def test_fifo_pairing_per_tag(self):
        fired = []
        wd = collectives.Watchdog(0.15, on_timeout=lambda t, w: fired.append(t),
                                  poll_s=0.02).start()
        wd.arm("loss")
        wd.arm("loss")
        wd.disarm("loss")
        wd.disarm("loss")
        time.sleep(0.3)
        assert not wd.fired
        wd.stop()

    def test_fifo_keeps_the_older_arm(self):
        fired = []
        wd = collectives.Watchdog(0.15, on_timeout=lambda t, w: fired.append(t),
                                  poll_s=0.02).start()
        wd.arm("loss")
        time.sleep(0.1)
        wd.arm("loss")
        wd.disarm("loss")   # pops the older arm; the newer one stays out
        time.sleep(0.4)
        assert wd.fired and fired == ["loss"]
        wd.stop()

    def test_exit_code_constant_matches_launcher(self):
        assert collectives.EXIT_WATCHDOG == multiproc.EXIT_WATCHDOG == 87

    def test_install_arms_only_inside_the_context(self):
        assert collectives._watchdog is None
        with collectives.collective_watchdog(30.0, on_timeout=lambda t, w: None) as wd:
            assert collectives._watchdog is wd
        assert collectives._watchdog is None
        assert wd._stop.is_set()


@pytest.fixture
def gloo_group_of_one(tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}", rank=0,
                            world_size=1)
    try:
        yield DataMesh()
    finally:
        dist.destroy_process_group()


def test_preduce_arms_and_disarms_around_real_all_reduces(gloo_group_of_one):
    """Blocking and started-ahead reduces on a real gloo group: one arm per
    logical reduce (a tree of two dtypes is one), a disarm for each, nothing
    left outstanding; without the watchdog nothing is armed."""
    mesh = gloo_group_of_one
    events = []

    class Probe(collectives.Watchdog):
        def arm(self, tag):
            events.append(("arm", tag))
            super().arm(tag)

        def disarm(self, tag):
            events.append(("disarm", tag))
            super().disarm(tag)

    collectives.preduce(torch.ones(3), mesh, "loss")   # no watchdog installed
    assert events == []
    wd = Probe(30.0, on_timeout=lambda t, w: None, poll_s=1.0)
    collectives._watchdog = wd
    try:
        out = collectives.preduce({"a": torch.ones(3), "b": torch.ones(2, dtype=torch.float64)},
                                  mesh, "grad_hvp")
        h = collectives.preduce_start([torch.full((4,), 2.0)], mesh, "grad_hvp")
        ahead = h.wait()
        collectives.preduce(torch.ones(1), mesh, "loss")
        deadline = time.time() + 5.0   # the started reduce ends on gloo's thread
        while sum(e[0] == "disarm" for e in events) < 3 and time.time() < deadline:
            time.sleep(0.01)
    finally:
        collectives._watchdog = None
    assert torch.equal(out["a"], torch.ones(3)) and torch.equal(ahead[0], torch.full((4,), 2.0))
    arms = [e for e in events if e[0] == "arm"]
    disarms = [e for e in events if e[0] == "disarm"]
    assert [t for _, t in arms] == ["grad_hvp", "grad_hvp", "loss"]
    assert sorted(t for _, t in disarms) == sorted(t for _, t in arms)
    with wd._lock:
        assert all(not q for q in wd._outstanding.values())


WATCHDOG_WORKER = textwrap.dedent("""
    import time
    import torch
    from repro_torch.core import collectives as C
    from repro_torch.launch import multiproc
    from repro_torch.launch.mesh import make_data_mesh

    torch.set_num_threads(1)
    multiproc.initialize_from_env("cpu")
    mesh = make_data_mesh()
    if mesh.rank == 1:
        time.sleep(120)            # the peer that never reaches its all-reduce
    with C.collective_watchdog(1.0):
        C.preduce(torch.ones(3), mesh, "grad_hvp")
    print("the reduce finished", flush=True)
""")


def test_two_rank_watchdog_ends_the_blocked_rank_with_87(tmp_path):
    (tmp_path / "_wd_worker.py").write_text(WATCHDOG_WORKER)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = os.pathsep.join([str(tmp_path), env.get("PYTHONPATH", "")])
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match=r"(?s)process 0: exit 87 \(collective watchdog\)"):
        multiproc.spawn_supervised(2, "_wd_worker", max_restarts=0, poll_s=0.05,
                                   log=lambda m: None, env=env, timeout_s=90)
    assert time.monotonic() - t0 < 90   # far less than the rank's 120 s sleep


_CHILD_SNIPPET = "import os\nattempt = int(os.environ.get('REPRO_TORCH_MULTIPROC_RESTART', '0'))\n"


class TestSpawnSupervised:
    """Real children through the stdlib ``timeit`` module."""

    def _spawn(self, code, **kw):
        return multiproc.spawn_supervised(
            2, "timeit", ["-n", "1", "-r", "1", "-s", code, "pass"],
            backoff_s=0.05, poll_s=0.05, log=lambda m: None, timeout_s=60, **kw)

    def test_clean_run_uses_zero_restarts(self, tmp_path):
        assert self._spawn("pass", max_restarts=2, heartbeat_dir=str(tmp_path)) == 0

    def test_restart_after_worker_death(self, tmp_path):
        code = (_CHILD_SNIPPET + "wid = os.environ['REPRO_TORCH_MULTIPROC_ID']\n"
                "if attempt == 0 and wid == '1': os._exit(9)\n")
        assert self._spawn(code, max_restarts=2, heartbeat_dir=str(tmp_path)) == 1

    def test_budget_exhaustion_raises(self, tmp_path):
        code = _CHILD_SNIPPET + "print('worker gives up', flush=True)\nos._exit(3)\n"
        with pytest.raises(RuntimeError, match=r"(?s)exhausted.*exit 3.*worker gives up"):
            self._spawn(code, max_restarts=1, heartbeat_dir=str(tmp_path))

    def test_hang_detected_by_heartbeat_staleness(self, tmp_path):
        code = _CHILD_SNIPPET + "import time\nif attempt == 0: time.sleep(600)\n"
        t0 = time.time()
        assert self._spawn(code, max_restarts=1, hang_timeout_s=1.5,
                           heartbeat_dir=str(tmp_path)) == 1
        assert time.time() - t0 < 40

    def test_heartbeat_resets_staleness(self, tmp_path):
        code = (_CHILD_SNIPPET + "import time\n"
                "hbd = os.environ.get('REPRO_TORCH_MULTIPROC_HEARTBEAT')\n"
                "wid = os.environ['REPRO_TORCH_MULTIPROC_ID']\n"
                "for i in range(6):\n"
                "    open(os.path.join(hbd, 'hb-p' + wid), 'w').write(str(i))\n"
                "    time.sleep(0.4)\n")
        assert self._spawn(code, max_restarts=1, hang_timeout_s=1.5,
                           heartbeat_dir=str(tmp_path)) == 0

    def test_heartbeat_writer_roundtrip(self, tmp_path, monkeypatch):
        monkeypatch.setenv(multiproc.ENV_HEARTBEAT_DIR, str(tmp_path))
        monkeypatch.setenv(multiproc.ENV_ID, "1")
        multiproc.heartbeat(5)
        hb = tmp_path / "hb-p1"
        assert hb.exists() and hb.read_text().startswith("5 ")

    def test_heartbeat_noop_outside_supervision(self, monkeypatch):
        monkeypatch.delenv(multiproc.ENV_HEARTBEAT_DIR, raising=False)
        multiproc.heartbeat(1)

    def test_wall_clock_limit_tears_down(self, tmp_path):
        t0 = time.time()
        with pytest.raises(RuntimeError, match="timed out after 2 s"):
            multiproc.spawn_supervised(
                2, "timeit", ["-n", "1", "-r", "1", "-s", "import time; time.sleep(600)",
                              "pass"], poll_s=0.05, log=lambda m: None, timeout_s=2.0,
                heartbeat_dir=str(tmp_path))
        assert time.time() - t0 < 30

    def test_own_heartbeat_dir_is_removed(self, monkeypatch, tmp_path):
        monkeypatch.setenv("TMPDIR", str(tmp_path))
        import tempfile
        monkeypatch.setattr(tempfile, "tempdir", None)
        assert self._spawn("pass", max_restarts=0) == 0
        assert list(tmp_path.iterdir()) == []

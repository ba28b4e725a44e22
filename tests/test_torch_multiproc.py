"""The port's launcher (``repro_torch.launch.multiproc``) and meshes
(``repro_torch.launch.mesh``) on the CPU: the children's environment and
free port, ``spawn``'s failures (a failing child, the wall-clock limit),
and ``shard_batch`` / ``replicate`` placement across two gloo processes.
"""
import json
import os
import socket
import textwrap
import time

import pytest

torch = pytest.importorskip("torch")

from repro.launch import mesh as jmesh  # noqa: E402
from repro_torch.core.collectives import DataMesh  # noqa: E402
from repro_torch.launch import mesh, multiproc  # noqa: E402

WORKER = textwrap.dedent("""
    import json, os, sys
    import torch
    from repro_torch.launch import multiproc
    from repro_torch.launch.mesh import make_data_mesh

    torch.set_num_threads(1)
    out = {"active": multiproc.active(),
           "env": {k: os.environ.get(k) for k in (multiproc.ENV_NUM, multiproc.ENV_ID,
                                                  multiproc.ENV_COORD, "GLOO_SOCKET_IFNAME")}}
    dev = multiproc.initialize_from_env("cpu")
    m = make_data_mesh()
    r = m.rank
    out.update(device=str(dev), rank=r, size=m.size, shape=m.shape, primary=multiproc.is_primary())
    batch = {"x": torch.arange(16.0).reshape(8, 2), "y": torch.arange(8)}
    out["shard"] = {k: v.tolist() for k, v in multiproc.shard_batch(batch, m).items()}
    tree = ({"w": torch.full((2, 3), float(r + 1)), "flag": torch.tensor(r == 1),
             "step": torch.tensor(7 * r, dtype=torch.int32)}, "tag")
    mine = tree[0]["w"].clone()
    rep = multiproc.replicate(tree, m)
    out["replicated"] = [rep[0]["w"].tolist(), bool(rep[0]["flag"]), int(rep[0]["step"]),
                         rep[0]["step"].dtype == torch.int32, rep[1]]
    out["input_kept"] = torch.equal(tree[0]["w"], mine)
    print(f"primary says hello from rank {r}", flush=True)
    json.dump(out, open(sys.argv[1] + f"/rank{r}.json", "w"))
    torch.distributed.destroy_process_group()
    assert "jax" not in sys.modules, "a child of the port imported jax"
""")

FAIL = textwrap.dedent("""
    import os, sys, time
    if os.environ["REPRO_TORCH_MULTIPROC_ID"] == "1":
        print("boom: rank 1 gives up", flush=True)
        sys.exit(3)
    time.sleep(float(sys.argv[1]))
""")


def _env(d):
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = os.pathsep.join([str(d), env.get("PYTHONPATH", "")])
    return env


@pytest.fixture(scope="module")
def placed(tmp_path_factory):
    d = tmp_path_factory.mktemp("multiproc")
    (d / "_mp_worker.py").write_text(WORKER)
    multiproc.spawn(2, "_mp_worker", [str(d)], env=_env(d), timeout_s=240)
    return [json.loads((d / f"rank{r}.json").read_text()) for r in range(2)]


def test_outside_a_child_nothing_is_active():
    assert not multiproc.active()
    assert multiproc.initialize_from_env("cpu") is None
    assert multiproc.is_primary()


def test_free_port_can_be_bound():
    port = multiproc._free_port()
    with socket.socket() as s:
        s.bind(("127.0.0.1", port))


@pytest.mark.parametrize("rank", [0, 1])
def test_children_get_the_environment_and_join_one_group(placed, rank):
    s = placed[rank]
    assert s["active"] and s["rank"] == rank and s["size"] == 2 and s["shape"] == {"data": 2}
    assert s["env"][multiproc.ENV_NUM] == "2" and s["env"][multiproc.ENV_ID] == str(rank)
    assert s["env"][multiproc.ENV_COORD] == placed[0]["env"][multiproc.ENV_COORD]
    host, port = s["env"][multiproc.ENV_COORD].split(":")
    assert host == "127.0.0.1" and int(port) > 0
    assert s["env"]["GLOO_SOCKET_IFNAME"] == "lo"
    assert s["device"] == "cpu" and s["primary"] == (rank == 0)


@pytest.mark.parametrize("rank", [0, 1])
def test_shard_batch_gives_each_rank_its_contiguous_slice(placed, rank):
    shard = placed[rank]["shard"]
    rows = list(range(4 * rank, 4 * rank + 4))
    assert shard["y"] == rows
    assert shard["x"] == [[2.0 * i, 2.0 * i + 1] for i in rows]


@pytest.mark.parametrize("rank", [0, 1])
def test_replicate_gives_every_rank_rank_0s_values(placed, rank):
    w, flag, step, int32, tag = placed[rank]["replicated"]
    assert w == [[1.0] * 3] * 2 and flag is False and step == 0 and int32 and tag == "tag"
    assert placed[rank]["input_kept"]


def test_spawn_passes_the_primary_output_on(tmp_path, capsys):
    (tmp_path / "_hello.py").write_text(
        "import os\nprint('hello from', os.environ['REPRO_TORCH_MULTIPROC_ID'], flush=True)\n")
    multiproc.spawn(2, "_hello", env=_env(tmp_path), timeout_s=60)
    out = capsys.readouterr().out
    assert "hello from 0" in out and "hello from 1" not in out


def test_spawn_raises_on_a_failing_child_with_its_log(tmp_path):
    (tmp_path / "_fail.py").write_text(FAIL)
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match=r"(?s)exit codes \[-9, 3\].*boom: rank 1 gives up"):
        multiproc.spawn(2, "_fail", ["120"], env=_env(tmp_path), timeout_s=120)
    assert time.monotonic() - t0 < 60  # the survivor was killed after GRACE_S


def test_spawn_kills_children_past_the_wall_clock_limit(tmp_path):
    (tmp_path / "_sleep.py").write_text("import time\ntime.sleep(120)\n")
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="timed out after 2 s"):
        multiproc.spawn(2, "_sleep", env=_env(tmp_path), timeout_s=2.0)
    assert time.monotonic() - t0 < 60


@pytest.mark.parametrize("rank", [0, 1])
def test_shard_batch_in_process_and_its_divisibility_check(rank):
    m = DataMesh(None, size=2, rank=rank)
    got = multiproc.shard_batch({"a": torch.arange(6)}, m)["a"]
    assert got.tolist() == [3 * rank, 3 * rank + 1, 3 * rank + 2]
    with pytest.raises(ValueError, match="not divisible"):
        multiproc.shard_batch({"a": torch.arange(5)}, m)


@pytest.mark.parametrize("batch", [1, 2, 3, 4, 6, 8])
def test_mesh_helpers_agree_with_the_reference(batch):
    class _JMesh:  # the reference's helpers read axis_names and shape only
        axis_names = ("data",)
        shape = {"data": 2}

    m = DataMesh(None, size=2, rank=0)
    assert mesh.data_axes(m) == jmesh.data_axes(_JMesh()) == ("data",)
    assert mesh.batch_axes_if_divisible(m, batch) == jmesh.batch_axes_if_divisible(_JMesh(), batch)
    assert DataMesh(None, "model", size=3, rank=2).shape == {"model": 3}

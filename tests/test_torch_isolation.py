"""The PyTorch port stands alone: it imports nothing of JAX or of the JAX
package, nor the server packages the machine with the card lacks
(aiohttp, grpc, google.protobuf, prometheus_client), and its entry points
run on the card or raise — none of them drops to the CPU on its own."""
import ast
import os
import pkgutil
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import seaweedfs_tpu_torch
from seaweedfs_tpu_torch.ops import rs
from seaweedfs_tpu_torch.storage import ec

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG_DIR = os.path.dirname(seaweedfs_tpu_torch.__file__)


# JAX and the JAX package; and what the card's machine does not have
FORBIDDEN_ROOTS = ("jax", "jaxlib", "seaweedfs_tpu", "aiohttp", "grpc",
                   "prometheus_client")
FORBIDDEN_PACKAGES = ("google.protobuf",)


def _forbidden(name: str) -> bool:
    root = name.split(".")[0]
    return root in FORBIDDEN_ROOTS or any(
        name == p or name.startswith(p + ".") for p in FORBIDDEN_PACKAGES)


def _port_modules():
    return ["seaweedfs_tpu_torch"] + [
        m.name
        for m in pkgutil.walk_packages([PKG_DIR], prefix="seaweedfs_tpu_torch.")
    ]


def test_forbidden_names():
    assert _forbidden("jax.numpy") and _forbidden("seaweedfs_tpu.ops.rs")
    for name in ("aiohttp", "aiohttp.web", "grpc", "grpc.aio",
                 "google.protobuf", "google.protobuf.message",
                 "prometheus_client"):
        assert _forbidden(name), name
    assert not _forbidden("seaweedfs_tpu_torch.ops.rs")
    assert not _forbidden("google") and not _forbidden("google.cloud")


def test_every_port_module_is_walked():
    """The walk the import checks use reaches every module of the port,
    the device ledger and the scrub's modules among them."""
    mods = set(_port_modules())
    for name in ("seaweedfs_tpu_torch.obs", "seaweedfs_tpu_torch.obs.devledger",
                 "seaweedfs_tpu_torch.obs.config",
                 "seaweedfs_tpu_torch.obs.trace",
                 "seaweedfs_tpu_torch.obs.incident",
                 "seaweedfs_tpu_torch.obs.critpath",
                 "seaweedfs_tpu_torch.obs.tailstore",
                 "seaweedfs_tpu_torch.obs.timeline",
                 "seaweedfs_tpu_torch.obs.profile",
                 "seaweedfs_tpu_torch.obs.slo",
                 "seaweedfs_tpu_torch.utils.devtime",
                 "seaweedfs_tpu_torch.utils.profiling",
                 "seaweedfs_tpu_torch.command.common_args",
                 "seaweedfs_tpu_torch.command.version",
                 "seaweedfs_tpu_torch.ops.rs_resident",
                 "seaweedfs_tpu_torch.storage.store",
                 "seaweedfs_tpu_torch.server.volume",
                 "seaweedfs_tpu_torch.stats.metrics",
                 "seaweedfs_tpu_torch.ingest",
                 "seaweedfs_tpu_torch.ingest.config",
                 "seaweedfs_tpu_torch.ingest.pipeline",
                 "seaweedfs_tpu_torch.ops.rs_ingest",
                 "seaweedfs_tpu_torch.serving.tiering",
                 "seaweedfs_tpu_torch.pb", "seaweedfs_tpu_torch.pb.wire",
                 "seaweedfs_tpu_torch.pb.rpc",
                 "seaweedfs_tpu_torch.pb.server_address",
                 "seaweedfs_tpu_torch.utils.faultpolicy",
                 "seaweedfs_tpu_torch.topology",
                 "seaweedfs_tpu_torch.topology.sequence",
                 "seaweedfs_tpu_torch.topology.node",
                 "seaweedfs_tpu_torch.topology.volume_layout",
                 "seaweedfs_tpu_torch.topology.volume_growth",
                 "seaweedfs_tpu_torch.topology.topology",
                 "seaweedfs_tpu_torch.server.conversions",
                 "seaweedfs_tpu_torch.server.master",
                 "seaweedfs_tpu_torch.server.cluster",
                 "seaweedfs_tpu_torch.command.master",
                 "seaweedfs_tpu_torch.command.shell",
                 "seaweedfs_tpu_torch.operation",
                 "seaweedfs_tpu_torch.operation.assign",
                 "seaweedfs_tpu_torch.operation.lookup",
                 "seaweedfs_tpu_torch.operation.upload",
                 "seaweedfs_tpu_torch.shell",
                 "seaweedfs_tpu_torch.shell.command_env",
                 "seaweedfs_tpu_torch.shell.commands",
                 "seaweedfs_tpu_torch.shell.command_lock",
                 "seaweedfs_tpu_torch.shell.command_ec",
                 "seaweedfs_tpu_torch.shell.command_cluster",
                 "seaweedfs_tpu_torch.shell.command_repair",
                 "seaweedfs_tpu_torch.shell.command_volume",
                 "seaweedfs_tpu_torch.stats.cluster",
                 "seaweedfs_tpu_torch.repair",
                 "seaweedfs_tpu_torch.repair.config",
                 "seaweedfs_tpu_torch.repair.planner",
                 "seaweedfs_tpu_torch.repair.executor",
                 "seaweedfs_tpu_torch.repair.scheduler",
                 "seaweedfs_tpu_torch.parallel",
                 "seaweedfs_tpu_torch.parallel.mesh",
                 "seaweedfs_tpu_torch.parallel.distributed"):
        assert name in mods, name


def test_importing_every_port_module_loads_no_jax():
    """A fresh interpreter that refuses jax, seaweedfs_tpu[.*] and the
    server packages the card's machine lacks imports every port module and
    chip_smoke, and ends with none of them loaded."""
    code = f"""
import importlib, importlib.abc, sys
def bad_name(name):
    return name.split(".")[0] in {FORBIDDEN_ROOTS!r} or any(
        name == p or name.startswith(p + ".") for p in {FORBIDDEN_PACKAGES!r})
class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if bad_name(name):
            raise ImportError("port imported " + name)
sys.meta_path.insert(0, Refuse())
for m in {_port_modules()!r} + ["chip_smoke"]:
    importlib.import_module(m)
bad = [m for m in sys.modules if bad_name(m)]
assert not bad, bad
print("clean", len([m for m in sys.modules if m.startswith("seaweedfs_tpu_torch")]))
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("clean")
    assert int(proc.stdout.split()[1]) >= len(_port_modules())


def test_obs_handlers_run_without_aiohttp():
    """The observability plane imports, and its handlers answer, in an
    interpreter where aiohttp (and JAX, and the JAX package) cannot be
    imported: no handler reaches for it lazily either.  /debug/profile
    takes a real (CPU) capture."""
    code = f"""
import asyncio, importlib.abc, json, os, sys, tempfile
from types import SimpleNamespace
def bad_name(name):
    return name.split(".")[0] in {FORBIDDEN_ROOTS!r} or any(
        name == p or name.startswith(p + ".") for p in {FORBIDDEN_PACKAGES!r})
class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if bad_name(name):
            raise ImportError("port imported " + name)
sys.meta_path.insert(0, Refuse())
from seaweedfs_tpu_torch import obs
from seaweedfs_tpu_torch.obs import incident, profile, tailstore, timeline
def req(**q):
    return SimpleNamespace(query={{k: str(v) for k, v in q.items()}})
async def go():
    t, tok = obs.start_trace("GET /1,ab", "volume")
    obs.finish_trace(t, tok, 200)
    store = tailstore.TailStore(node="n").install()
    out = {{}}
    for name, h, q in (
        ("traces", obs.traces_handler, {{}}),
        ("critpath", obs.critpath_handler(), {{"id": t.trace_id}}),
        ("tail", obs.tail_handler(store), {{}}),
        ("incident", incident.incident_handler, {{}}),
        ("hot", obs.device_hot_handler, {{}}),
        ("profile", obs.profile_handler, {{"seconds": 0.2}}),
    ):
        resp = await h(req(**q))
        out[name] = resp.status
    store.uninstall()
    return out
os.environ["TMPDIR"] = tempfile.mkdtemp()
tempfile.tempdir = None
out = asyncio.run(go())
assert set(out.values()) == {{200}}, out
bad = [m for m in sys.modules if bad_name(m)]
assert not bad, bad
print("clean")
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "clean"


def test_no_jax_import_statements():
    """Static check of every port source and chip_smoke.py (also for the
    server packages the card's machine lacks)."""
    paths = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(PKG_DIR):
        paths += [os.path.join(root, f) for f in files if f.endswith(".py")]
    for path in paths:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            assert not any(_forbidden(n) for n in names), (path, names)


def test_parallel_modules_import_torch_distributed_and_nothing_of_jax():
    """parallel/ (the mesh and the distributed programs) reaches its
    collectives through torch.distributed only: its imports are the
    standard library, numpy, torch and the port."""
    allowed = {"argparse", "contextlib", "functools", "sys", "time",
               "typing", "__future__", "numpy", "torch"}
    for name in ("__init__", "mesh", "distributed"):
        path = os.path.join(PKG_DIR, "parallel", name + ".py")
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                roots = [a.name.split(".")[0] for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                roots = [(node.module or "").split(".")[0]]
            else:
                continue
            assert set(roots) <= allowed, (path, roots)


def test_mesh_entry_points_default_to_cuda(monkeypatch):
    """The mesh's entry points build on the card: without one the default
    cache raises, and the default meshes have no lane."""
    from seaweedfs_tpu_torch.ops import rs_resident
    from seaweedfs_tpu_torch.parallel import mesh as mesh_mod

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="CUDA"):
        rs_resident.DeviceShardCache(mesh_devices=0)
    assert mesh_mod.local_devices() == []
    with pytest.raises(ValueError):
        mesh_mod.make_mesh(1)


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_codec_default_backend_raises_without_cuda(no_cuda):
    with pytest.raises(RuntimeError, match="CUDA"):
        rs.RSCodec()
    with pytest.raises(RuntimeError, match="CUDA"):
        rs.RSCodec(backend="cuda")
    with pytest.raises(ValueError):
        rs.RSCodec(backend="auto")
    assert rs.RSCodec(backend="torch").backend == "torch"


def test_entry_points_default_to_cuda(no_cuda, tmp_path):
    from seaweedfs_tpu_torch.storage.volume import Volume

    v = Volume(str(tmp_path), 1)
    for i in range(1, 30):
        v.write(i, 7, np.random.default_rng(i).bytes(50_000))
    v.close()
    base = str(tmp_path / "1")
    with pytest.raises(RuntimeError, match="CUDA"):
        ec.write_ec_files(base)
    assert not os.path.exists(base + ec.to_ext(0))
    ec.write_ec_files(base, backend="torch")
    ec.write_sorted_file_from_idx(base)
    with pytest.raises(RuntimeError, match="CUDA"):
        ec.verify_ec_files(base)
    os.remove(base + ec.to_ext(0))
    with pytest.raises(RuntimeError, match="CUDA"):
        ec.rebuild_ec_files(base)
    ev = ec.EcVolume(str(tmp_path), 1)
    try:
        for sid in range(1, 14):
            ev.add_shard(sid)
        with pytest.raises(RuntimeError, match="CUDA"):
            ev.read_needle(1)  # needle 1 lives on the missing shard 0
        assert ev.read_needle(1, backend="torch").data == np.random.default_rng(1).bytes(50_000)
    finally:
        ev.close()
    from seaweedfs_tpu_torch.ops import rs_resident

    with pytest.raises(RuntimeError, match="CUDA"):
        rs_resident.DeviceShardCache()
    assert rs_resident.DeviceShardCache(device="cpu").device.type == "cpu"
    # the streaming ingest plane encodes rows on the card by default
    from seaweedfs_tpu_torch.ingest import IngestConfig, IngestPlane
    from seaweedfs_tpu_torch.ops import rs_ingest
    from seaweedfs_tpu_torch.server.volume import VolumeServer

    with pytest.raises(RuntimeError, match="CUDA"):
        rs_ingest.StreamEncoder()
    with pytest.raises(RuntimeError, match="CUDA"):
        IngestPlane(IngestConfig())
    with pytest.raises(RuntimeError, match="CUDA"):
        VolumeServer([], [str(tmp_path / "vs")], port=0)
    with pytest.raises(RuntimeError, match="CUDA"):
        VolumeServer([], [str(tmp_path / "vs")], port=0, ec_backend="torch",
                     ec_ingest=IngestConfig(backend="cuda"))
    assert rs_ingest.StreamEncoder("torch").device


def test_chip_smoke_refuses_without_cuda(tmp_path):
    """chip_smoke.py prints no result and exits non-zero without a CUDA
    device, and also when it stands alone without the port."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), alone)
    for script, cwd in ((os.path.join(REPO, "chip_smoke.py"), REPO),
                        (str(alone), str(tmp_path))):
        proc = subprocess.run(
            [sys.executable, script], cwd=cwd,
            capture_output=True, text=True, timeout=120,
        )
        assert proc.returncode != 0
        assert '"ok"' not in proc.stdout


def test_incident_plane_runs_without_aiohttp_grpc_or_prometheus(tmp_path):
    """The master's SLO engine, incident bundler (its fan-out and a
    profile capture), /debug/critpath fan-out, /debug/timeline,
    /debug/stacks, the push loop and the four cluster.* shell readers, in
    an interpreter where aiohttp, grpc, google.protobuf,
    prometheus_client, JAX and the JAX package cannot be imported."""
    code = f"""
import asyncio, importlib.abc, io, json, os, sys
def bad_name(name):
    return name.split(".")[0] in {FORBIDDEN_ROOTS!r} or any(
        name == p or name.startswith(p + ".") for p in {FORBIDDEN_PACKAGES!r})
class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if bad_name(name):
            raise ImportError("port imported " + name)
sys.meta_path.insert(0, Refuse())
os.environ["SWFS_DEBUG"] = "1"
from seaweedfs_tpu_torch import obs, stats
from seaweedfs_tpu_torch.operation import assign, upload_data
from seaweedfs_tpu_torch.server.cluster import LocalCluster
from seaweedfs_tpu_torch.server.http import Client, HTTPServer, Response
from seaweedfs_tpu_torch.shell import CommandEnv, run_command
pushes = []
async def sink(req):
    pushes.append(req.path.split("/")[3])
    return Response(200)
async def go():
    gw = HTTPServer(sink)
    await gw.start()
    addr = "127.0.0.1:%d" % gw.port
    c = LocalCluster(n_volume_servers=2, base_dir={str(tmp_path)!r},
                     ec_backend="torch",
                     volume_kwargs=dict(metrics_address=addr,
                                        metrics_interval_seconds=1),
                     master_kwargs=dict(
                         metrics_address=addr, metrics_interval_seconds=1,
                         obs_slo=obs.SloConfig(read_p99_ms=1e-4,
                                               read_stage="shard_read",
                                               fast_window_seconds=1.0,
                                               slow_window_seconds=2.0),
                         obs_incident=obs.IncidentConfig(
                             dir={str(tmp_path / "inc")!r},
                             profile_seconds=0.1)))
    await c.start()
    try:
        a = await assign(c.master.advertise_url)
        await upload_data("http://" + a.url + "/" + a.fid, b"x" * 5000, "x")
        host, port = a.url.split(":")
        for _ in range(100):
            cl = Client(host, int(port))
            st, h, body = await cl.request("GET", "/" + a.fid)
            await cl.close()
            assert st == 200 and body == b"x" * 5000
            # a plain volume's read records no shard_read span: observe
            # one into the servers' (co-hosted) stage histogram
            stats.REQUEST_STAGE_SECONDS.labels(stage="shard_read").observe(
                0.01)
            if c.master.incident.bundles_written:
                break
            await asyncio.sleep(0.2)
        assert c.master.incident.bundles_written == 1
        tid = h["X-Seaweed-Trace-Id"].split("-")[0]
        mc = Client(c.master.ip, c.master.port)
        for path in ("/debug/critpath?id=" + tid, "/debug/timeline",
                     "/debug/stacks", "/debug/tail", "/debug/incident"):
            st, _, _ = await mc.request("GET", path)
            assert st == 200, path
        await mc.close()
        env = CommandEnv([c.master.advertise_url], out=io.StringIO())
        for line in ("cluster.slo", "cluster.timeline", "cluster.tail",
                     "cluster.incident.dump"):
            await run_command(env, line)
        return env.out.getvalue()
    finally:
        await c.stop()
        await gw.stop()
out = asyncio.run(go())
assert "incident bundle written" in out and "read_p99" in out, out
assert {{"master", "volumeServer"}} <= set(pushes), pushes
bad = [m for m in sys.modules if bad_name(m)]
assert not bad, bad
print("clean")
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=180,
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert proc.stdout.strip().endswith("clean")


def test_cluster_path_runs_without_grpc_or_protobuf(tmp_path):
    """A master, two volume servers and the shell talk over the port's RPC
    plane in an interpreter where grpc, google.protobuf and aiohttp (and
    JAX, and the JAX package) cannot be imported."""
    code = f"""
import asyncio, importlib.abc, io, sys
def bad_name(name):
    return name.split(".")[0] in {FORBIDDEN_ROOTS!r} or any(
        name == p or name.startswith(p + ".") for p in {FORBIDDEN_PACKAGES!r})
class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if bad_name(name):
            raise ImportError("port imported " + name)
sys.meta_path.insert(0, Refuse())
from seaweedfs_tpu_torch.operation import assign, upload_data
from seaweedfs_tpu_torch.server.cluster import LocalCluster
from seaweedfs_tpu_torch.server.http import Client
from seaweedfs_tpu_torch.shell import CommandEnv, run_command
async def go():
    c = LocalCluster(n_volume_servers=2, base_dir={str(tmp_path)!r},
                     ec_backend="torch")
    await c.start()
    try:
        a = await assign(c.master.advertise_url)
        await upload_data("http://" + a.url + "/" + a.fid, b"x" * 5000, "x")
        host, port = a.url.split(":")
        st, _, body = await Client(host, int(port)).request("GET", "/" + a.fid)
        assert st == 200 and body == b"x" * 5000
        env = CommandEnv([c.master.advertise_url], out=io.StringIO())
        for line in ("lock", "ec.scrub", "unlock"):
            await run_command(env, line)
        return env.out.getvalue()
    finally:
        await c.stop()
out = asyncio.run(go())
assert "locked" in out and "unlocked" in out, out
bad = [m for m in sys.modules if bad_name(m)]
assert not bad, bad
print("clean")
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "clean"

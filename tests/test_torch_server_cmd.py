"""The port's command registry and its all-in-one `server`, against the
JAX package's (tests/test_cli.py's cases): every ported command keeps the
reference's flags, the scaffold templates parse, and `server` and `shell`
run as two processes, with `upload`, `download` and `benchmark` as
processes against the server.  The departures are pinned here:

- `server -ec.backend` takes the port's names (cuda, the default; torch;
  numpy) and refuses `auto`;
- `server -s3` parses and is refused at start, naming ROADMAP A10
  (`server -filer` serves a filer);
- `server` makes no compile-cache call (the kernels take runtime shapes)
  and adds `-master.port.grpc`, `-volume.port.grpc` and `-pulseSeconds`;
- `autocomplete` completes `python -m seaweedfs_tpu_torch`.
"""
import argparse
import asyncio
import inspect
import io
import json
import os
import socket
import subprocess
import sys
import time
import tomllib
import urllib.request
from contextlib import redirect_stdout

import numpy as np
import pytest

from seaweedfs_tpu.command import COMMANDS as REF_COMMANDS
from seaweedfs_tpu_torch.command import COMMANDS
from seaweedfs_tpu_torch.command import server as server_cmd

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORTED = ["autocomplete", "backup", "benchmark", "compact", "download",
          "export", "filer", "filer.backup", "filer.cat", "filer.copy",
          "filer.meta.backup", "filer.meta.tail", "fix", "fsck", "master",
          "master.follower", "scaffold", "server", "shell", "upload",
          "version", "volume"]
# flags the port's server has beyond the reference's
SERVER_EXTRA = {"-master.port.grpc", "-volume.port.grpc", "-pulseSeconds"}


def _options(mod) -> dict:
    p = argparse.ArgumentParser()
    mod.add_args(p)
    return {s: a for a in p._actions for s in a.option_strings
            if s not in ("-h", "--help")}


def _parse(argv):
    p = argparse.ArgumentParser()
    server_cmd.add_args(p)
    return p.parse_args(argv)


def test_registry_holds_the_ported_commands():
    assert sorted(COMMANDS) == PORTED
    for name in PORTED:
        mod = COMMANDS[name]
        assert mod.NAME == name and mod.HELP
        assert callable(mod.add_args) and callable(mod.run)
        assert name in REF_COMMANDS
    out = subprocess.run([sys.executable, "-m", "seaweedfs_tpu_torch", "-h"],
                         cwd=REPO, capture_output=True, text=True, timeout=60)
    for name in PORTED:
        assert name in out.stdout


@pytest.mark.parametrize("name", PORTED)
def test_flags_keep_the_reference_spellings(name):
    port, ref = _options(COMMANDS[name]), _options(REF_COMMANDS[name])
    if name == "server":
        assert set(port) - set(ref) == SERVER_EXTRA
        assert set(ref) <= set(port)
    elif name == "volume":
        assert set(ref) - set(port) <= {"-disk"}
    elif name in ("master", "master.follower", "shell", "version"):
        assert set(ref) <= set(port)
    else:
        assert set(port) == set(ref)
    for flag in set(port) & set(ref):
        if flag == "-ec.backend":
            continue  # the port's backend names (below)
        assert port[flag].dest == ref[flag].dest, flag
        if name not in ("master", "volume", "master.follower"):
            assert port[flag].default == ref[flag].default, flag


def test_server_ec_backend_takes_the_ports_names():
    assert _parse([]).ec_backend == "cuda"
    for backend in ("cuda", "torch", "numpy"):
        assert _parse(["-ec.backend", backend]).ec_backend == backend
    with redirect_stdout(io.StringIO()), pytest.raises(SystemExit):
        _parse(["-ec.backend", "auto"])


@pytest.mark.parametrize("flag", ["-filer", "-s3"])
def test_server_refuses_filer_and_s3_at_start(flag, tmp_path):
    """`-s3` is refused at start, naming A10.  `-filer` serves: `run`
    starts a master, a volume server and a filer built from the filer
    command's own parser, and the filer takes a PUT and answers its GET."""
    if flag == "-s3":
        args = _parse([flag, "-ec.backend", "torch"])
        with pytest.raises(SystemExit, match="A10"):
            server_cmd.build_servers(args)
        with pytest.raises(SystemExit, match="A10"):
            asyncio.run(server_cmd.run(args))
        return
    from seaweedfs_tpu_torch.server.http import Client

    ports = []
    for _ in range(5):
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            ports.append(s.getsockname()[1])
    mp, mg, vp, vg, fp = ports
    args = _parse(["-filer", "-filer.port", str(fp), "-filer.db",
                   str(tmp_path / "filer.db"), "-dir", str(tmp_path),
                   "-ec.backend", "torch", "-master.port", str(mp),
                   "-master.port.grpc", str(mg), "-volume.port", str(vp),
                   "-volume.port.grpc", str(vg), "-pulseSeconds", "1"])
    data = np.random.default_rng(4).bytes(300_000)

    async def go():
        task = asyncio.create_task(server_cmd.run(args))
        cl = Client("127.0.0.1", fp)
        try:
            for _ in range(300):
                assert not task.done(), task
                try:
                    st, _, body = await cl.request("PUT", "/s/x.bin",
                                                   body=data)
                    if st == 201:
                        break
                except (ConnectionError, OSError):
                    await cl.close()
                await asyncio.sleep(0.1)
            assert st == 201, body
            st, _, got = await cl.request("GET", "/s/x.bin")
            assert st == 200 and got == data
        finally:
            await cl.close()
            task.cancel()
            await asyncio.gather(task, return_exceptions=True)

    asyncio.run(go())
    assert os.path.getsize(tmp_path / "filer.db") > 0


def test_server_builds_both_servers_without_a_compile_cache(tmp_path):
    """-ec.deviceCacheMB goes to the volume server's cache, with no
    compile-cache call before it (the reference's server warms one);
    -volumeSizeLimitMB past 32 GB switches to 5-byte offsets, as `master`
    does."""
    from seaweedfs_tpu_torch.storage import types

    assert "compile_cache" not in inspect.getsource(server_cmd)
    assert "compile_cache_for_volume_dirs" in inspect.getsource(
        REF_COMMANDS["server"])
    args = _parse(["-dir", str(tmp_path), "-ec.backend", "torch",
                   "-ec.deviceCacheMB", "64", "-volume.max", "5",
                   "-master.port", "0", "-volume.port", "0",
                   "-pulseSeconds", "1"])
    ms, vs = server_cmd.build_servers(args)
    assert vs.store.ec_device_cache is not None
    assert vs.store.ec_device_cache.device.type == "cpu"
    assert vs.masters == [ms.advertise_url]
    assert vs.pulse_seconds == ms.pulse_seconds == 1
    assert [loc.max_volume_count for loc in vs.store.locations] == [5]
    assert types.OFFSET_SIZE == 4
    try:
        server_cmd.build_servers(_parse([
            "-dir", str(tmp_path), "-ec.backend", "torch",
            "-volumeSizeLimitMB", str(40 * 1024)]))
        assert types.OFFSET_SIZE == 5
    finally:
        types.set_offset_size(4)


def test_scaffold_templates_parse():
    from seaweedfs_tpu.command import scaffold as ref_scaffold
    from seaweedfs_tpu_torch.command import scaffold

    assert sorted(scaffold.TEMPLATES) == sorted(ref_scaffold.TEMPLATES)
    for which, text in scaffold.TEMPLATES.items():
        assert tomllib.loads(text) == tomllib.loads(
            ref_scaffold.TEMPLATES[which])
        assert text == ref_scaffold.TEMPLATES[which].replace(
            "seaweedfs_tpu/", "seaweedfs_tpu_torch/")
    out = io.StringIO()
    with redirect_stdout(out):
        asyncio.run(scaffold.run(argparse.Namespace(which="security")))
    assert out.getvalue() == scaffold.TEMPLATES["security"]


def test_autocomplete_names_the_port():
    """The departure: the script completes `python -m
    seaweedfs_tpu_torch` and the port's commands; otherwise it is the
    reference's script."""
    def script(commands, mod):
        out = io.StringIO()
        with redirect_stdout(out):
            asyncio.run(mod.run(argparse.Namespace()))
        return out.getvalue().replace(" ".join(sorted(commands)), "<names>")

    port = script(COMMANDS, COMMANDS["autocomplete"])
    ref = script(REF_COMMANDS, REF_COMMANDS["autocomplete"])
    assert 'python -m seaweedfs_tpu_torch "$@"' in port
    assert "complete -F _seaweedfs_tpu_torch seaweedfs_tpu_torch" in port
    assert "seaweedfs_tpu " not in port and "seaweedfs_tpu(" not in port
    assert port == ref.replace("seaweedfs_tpu", "seaweedfs_tpu_torch")
    piped = subprocess.run(
        f"{sys.executable} -m seaweedfs_tpu_torch autocomplete | head -1",
        shell=True, cwd=REPO, capture_output=True, text=True, timeout=60)
    assert piped.stdout == "# bash completion for seaweedfs_tpu_torch\n"
    assert "Traceback" not in piped.stderr


def _free_ports(n):
    socks = [socket.socket() for _ in range(n)]
    for s in socks:
        s.bind(("127.0.0.1", 0))
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports


def _cli(*args, timeout=120):
    return subprocess.run([sys.executable, "-m", "seaweedfs_tpu_torch",
                           *args], cwd=REPO, capture_output=True, text=True,
                          timeout=timeout)


def test_server_and_shell_as_two_processes(tmp_path):
    """`server -ec.backend torch` as one process, the master and its
    volume server in it; then `upload`, `download`, `benchmark` and
    `shell -c` as processes against it."""
    mp, mg, vp, vg = _free_ports(4)
    master = f"127.0.0.1:{mp}.{mg}"
    proc = subprocess.Popen(
        [sys.executable, "-m", "seaweedfs_tpu_torch", "server",
         "-dir", str(tmp_path / "data"), "-master.port", str(mp),
         "-master.port.grpc", str(mg), "-volume.port", str(vp),
         "-volume.port.grpc", str(vg), "-volume.max", "16",
         "-ec.backend", "torch", "-pulseSeconds", "1"],
        cwd=REPO, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
    try:
        deadline = time.time() + 60
        while True:
            try:
                with urllib.request.urlopen(
                        f"http://127.0.0.1:{mp}/dir/status", timeout=2) as r:
                    topo = json.loads(r.read())["Topology"]
                nodes = [n["id"] for dc in topo["data_centers"]
                         for rk in dc["racks"] for n in rk["nodes"]]
                if nodes == [f"127.0.0.1:{vp}"]:
                    break
            except OSError:
                pass
            assert proc.poll() is None, proc.stderr.read().decode()[-3000:]
            assert time.time() < deadline, "the volume server did not register"
            time.sleep(0.2)

        src = tmp_path / "hello.bin"
        src.write_bytes(np.random.default_rng(20519).bytes(30_000))
        up = _cli("upload", str(src), "-master", master,
                  "-collection", "cli")
        assert up.returncode == 0, up.stderr
        fid = json.loads(up.stdout)[0]["fid"]
        down = _cli("download", fid, "-master", master, "-dir",
                    str(tmp_path / "dl"))
        assert down.returncode == 0, down.stderr
        assert (tmp_path / "dl" / fid.replace(",", "_")).read_bytes() == \
            src.read_bytes()
        bench = _cli("benchmark", "-master", master, "-c", "4", "-n", "32",
                     "-size", "1024", "-collection", "bench")
        assert bench.returncode == 0, bench.stderr
        assert bench.stdout.count("Completed requests:      32") == 2
        assert bench.stdout.count("Failed requests:         0") == 2
        time.sleep(1.5)  # a pulse carries the bench volumes' sizes
        sh = _cli("shell", "-master", master, "-c",
                  "cluster.check; collection.list; volume.list")
        assert sh.returncode == 0, sh.stdout + sh.stderr
        assert "1/1 volume servers reachable" in sh.stdout
        assert "  bench" in sh.stdout and "  cli" in sh.stdout
        assert f"dc1/r1/127.0.0.1:{vp}" in sh.stdout or \
            f"/127.0.0.1:{vp}" in sh.stdout
        bad = _cli("shell", "-master", master, "-c",
                   f"volume.server.leave -node 127.0.0.1:{vg}")
        assert bad.returncode == 1 and "lock" in bad.stdout
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=20)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()

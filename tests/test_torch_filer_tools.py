"""The port's `filer` command and its tools against the JAX package's: the
flags keep the reference's spellings, and `filer.copy`, `filer.cat`,
`filer.meta.tail`, `filer.meta.backup` and `filer.backup` (the `local`
backend type) do the same work on either package's cluster, with clocks
masked.  A metadata backup written by either package's tool is read by
the other's.  The departures are pinned: `-notifySpool` and `-notifyMq`
exit at start (their notifiers wait for replication/ and mq/), and so does
`-encryptVolumeData` on a machine without `cryptography` (the reference
fails on its first write); `python -m seaweedfs_tpu_torch filer` starts
without importing torch.
"""
import argparse
import asyncio
import builtins
import io
import json
import os
import sqlite3
import subprocess
import sys
from unittest import mock

import numpy as np
import pytest

from seaweedfs_tpu.command import COMMANDS as REF_COMMANDS
from seaweedfs_tpu_torch.command import COMMANDS

from test_torch_filer_server import _Side, _both

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = ["filer", "filer.backup", "filer.cat", "filer.copy",
         "filer.meta.backup", "filer.meta.tail"]


def _options(mod) -> dict:
    p = argparse.ArgumentParser()
    mod.add_args(p)
    return {a.dest: (sorted(a.option_strings), a.default, a.choices,
                     a.nargs, type(a).__name__)
            for a in p._actions if a.dest != "help"}


@pytest.mark.parametrize("name", TOOLS)
def test_tool_flags_keep_the_reference_spellings(name):
    assert _options(COMMANDS[name]) == _options(REF_COMMANDS[name])


def _parse(mod, argv):
    p = argparse.ArgumentParser()
    mod.add_args(p)
    return p.parse_args(argv)


def _local_tree(root):
    rng = np.random.default_rng(7)
    files = {"a.bin": rng.bytes(70_000), "b.txt": b"hello\n" * 300,
             "sub/c.bin": rng.bytes(1_500_000), "sub/skip.log": b"x"}
    for rel, data in files.items():
        path = os.path.join(root, "tree", rel)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "wb") as f:
            f.write(data)
    return files


async def _run_tool(side, name, argv, stdout=None):
    mods = COMMANDS if side.kind == "port" else REF_COMMANDS
    mod = mods[name]
    buf = io.BytesIO()
    out = io.TextIOWrapper(buf, encoding="utf-8")
    with mock.patch.object(sys, "stdout", out):
        await mod.run(_parse(mod, argv))
        out.flush()
    return buf.getvalue()


def _mirrored(target, files) -> list:
    """(path under `target`, equal to the local file) of what a backup
    wrote, its progress file aside."""
    out = []
    for root, _, names in os.walk(target):
        for n in names:
            if n.startswith(".filer_backup"):
                continue
            path = os.path.join(root, n)
            with open(path, "rb") as f:
                out.append((os.path.relpath(path, target), f.read() == files[
                    os.path.relpath(path, os.path.join(target, "tree"))]))
    return sorted(out)


def test_tools_match_the_reference(tmp_path):
    files = _local_tree(str(tmp_path))

    async def tools(side):
        filer = f"{side.f.ip}:{side.f.port}.{side.f.grpc_port}"
        url = f"http://{side.f.ip}:{side.f.port}"
        out = []
        text = await _run_tool(side, "filer.copy", [
            str(tmp_path / "tree"), f"{url}/in/", "-include", "*.*"])
        out.append(text.decode().replace(str(tmp_path), "<tmp>")
                   .replace(url, "<url>"))
        st, _, body = await side.http("GET", "/in/tree/sub/?limit=10")
        out.append([e["FullPath"] for e in json.loads(body)["Entries"]])
        for rel in ("a.bin", "sub/c.bin"):
            got = await _run_tool(side, "filer.cat", [f"{url}/in/tree/{rel}"])
            out.append(got == files[rel])
        await side.http("DELETE", "/in/tree/b.txt")

        text = await _run_tool(side, "filer.meta.tail", [
            "-filer", filer, "-timeAgo", "1h", "-timeoutSec", "1.5",
            "-pathPrefix", "/in"])
        events = [json.loads(line) for line in text.decode().splitlines()]
        for ev in events:
            ev["ts_ns"] = 0
        out.append(events)

        store = str(tmp_path / f"{side.kind}-meta.sqlite")
        text = await _run_tool(side, "filer.meta.backup", [
            "-filer", filer, "-store", store, "-oneTime"])
        out.append(text.decode().replace(store, "<store>"))
        db = sqlite3.connect(store)
        out.append([r[0] for r in db.execute(
            "SELECT full_path FROM meta ORDER BY full_path")])
        db.close()

        target = str(tmp_path / f"{side.kind}-backup")
        text = await _run_tool(side, "filer.backup", [
            "-filer", filer, "-path", "/in", "-dir", target, "-oneTime"])
        out.append(text.decode().replace(target, "<target>"))
        out.append(await asyncio.to_thread(_mirrored, target, files))

        remote = tmp_path / f"{side.kind}-remote"
        remote.mkdir()
        backend = __import__(("seaweedfs_tpu_torch" if side.kind == "port"
                              else "seaweedfs_tpu") + ".storage.backend",
                             fromlist=["x"])
        backend.configure({"local.bk": {"type": "local", "dir": str(remote)}})
        try:
            await _run_tool(side, "filer.backup", [
                "-filer", filer, "-path", "/in", "-remote", "local.bk/pre",
                "-oneTime"])
        finally:
            backend.clear_registry()
        out.append(sorted(os.path.relpath(os.path.join(r, n), remote)
                          for r, _, ns in os.walk(remote) for n in ns))
        return out

    got = asyncio.run(_both(tmp_path, tools))
    assert got["port"] == got["ref"]
    assert got["port"][2] and got["port"][3]


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_a_meta_backup_written_by_either_package_is_read_by_the_other(
        tmp_path, writer):
    from seaweedfs_tpu.command import filer_meta_backup as ref_mb
    from seaweedfs_tpu_torch.command import filer_meta_backup as port_mb

    reader = port_mb if writer == "ref" else ref_mb

    async def backup(side):
        filer = f"{side.f.ip}:{side.f.port}.{side.f.grpc_port}"
        await side.http("PUT", "/m/x.bin", {}, b"abc" * 100)
        await side.http("POST", "/m/d/")
        store = str(tmp_path / "meta.sqlite")
        await _run_tool(side, "filer.meta.backup",
                        ["-filer", filer, "-store", store, "-oneTime"])
        db = reader.open_store(store)
        e = reader.restore_entry(db, "/m/x.bin")
        d = reader.restore_entry(db, "/m/d")
        db.close()
        return e.name, e.attributes.file_size, len(e.chunks), d.is_directory

    side = _Side(writer, str(tmp_path / writer))

    async def go():
        await side.start()
        try:
            return await backup(side)
        finally:
            await side.stop()

    assert asyncio.run(go()) == ("x.bin", 300, 1, True)


@pytest.mark.parametrize("flag", ["-notifySpool", "-notifyMq"])
def test_filer_refuses_the_notifiers_at_start(flag):
    from seaweedfs_tpu_torch.command import filer as filer_cmd

    args = _parse(filer_cmd, [flag, "x"])
    with pytest.raises(SystemExit, match="A10"):
        filer_cmd.build_filer_server(args)


def test_encrypt_volume_data_without_cryptography_exits_at_start():
    from seaweedfs_tpu_torch.command import filer as filer_cmd
    from seaweedfs_tpu_torch.server.filer import FilerServer

    real_import = builtins.__import__

    def no_cryptography(name, *a, **kw):
        if name.startswith("cryptography"):
            raise ImportError(f"No module named {name!r}")
        return real_import(name, *a, **kw)

    args = _parse(filer_cmd, ["-encryptVolumeData"])
    with mock.patch.object(builtins, "__import__", no_cryptography):
        with pytest.raises(SystemExit, match="cryptography"):
            filer_cmd.build_filer_server(args)
        with pytest.raises(RuntimeError, match="cryptography"):
            FilerServer(masters=["127.0.0.1:1"], cipher=True)
    # with the package the flag builds a filer that encrypts its chunks
    fs = filer_cmd.build_filer_server(args)
    assert fs.cipher


def test_filer_starts_without_torch(tmp_path):
    code = ("import sys, seaweedfs_tpu_torch.command as c, argparse\n"
            "from seaweedfs_tpu_torch.command import filer\n"
            "p = argparse.ArgumentParser(); filer.add_args(p)\n"
            f"a = p.parse_args(['-store', 'native', '-db', {str(tmp_path / 'kv')!r}])\n"
            "fs = filer.build_filer_server(a)\n"
            "import seaweedfs_tpu_torch.shell, seaweedfs_tpu_torch.command.filer_backup\n"
            "print('torch' in sys.modules, 'jax' in sys.modules)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["False", "False"]

"""The port's host commands against the JAX package's: `fix`, `compact`,
`export`, `fsck` (offline, on volumes both packages write from the same
seeded needles with the clock frozen, so the files start as the same
bytes), and `upload`, `download`, `benchmark` and `backup` against each
package's `LocalCluster`, as tests/test_cli_tools.py drives the
reference's.  Each pair must print the same lines (addresses, cookies,
rates and cursors masked) and leave the same bytes: the rebuilt `.idx`,
the compacted `.dat`, the tar archive, the downloaded file, the backed-up
needles.
"""
import argparse
import asyncio
import contextlib
import hashlib
import io
import json
import os
import re
import shutil
import tarfile
from unittest import mock

import numpy as np
import pytest

from seaweedfs_tpu.command import COMMANDS as REF_COMMANDS
from seaweedfs_tpu.pb import Stub as RefStub
from seaweedfs_tpu.pb import channel as ref_channel
from seaweedfs_tpu.pb import volume_server_pb2 as ref_vpb
from seaweedfs_tpu.server.cluster import LocalCluster as RefCluster
from seaweedfs_tpu.storage.volume import Volume as RefVolume
from seaweedfs_tpu_torch.command import COMMANDS as PORT_COMMANDS
from seaweedfs_tpu_torch.operation import upload_data
from seaweedfs_tpu_torch.pb import Stub as PortStub
from seaweedfs_tpu_torch.pb import channel as port_channel
from seaweedfs_tpu_torch.pb import volume_server_pb2 as port_vpb
from seaweedfs_tpu_torch.server.cluster import LocalCluster as PortCluster
from seaweedfs_tpu_torch.server.http import fetch
from seaweedfs_tpu_torch.storage.volume import Volume as PortVolume

SEED = 20419
FROZEN = 1_760_000_000.0
PKG = {"ref": (REF_COMMANDS, RefVolume), "port": (PORT_COMMANDS, PortVolume)}


def _frozen():
    stack = contextlib.ExitStack()
    stack.enter_context(mock.patch("time.time", return_value=FROZEN))
    stack.enter_context(mock.patch("time.time_ns",
                                   return_value=int(FROZEN * 1e9)))
    return stack


def _run_cmd(kind, name, argv):
    """One command of `kind`'s package, as `python -m <package> name argv`
    runs it: -> (stdout, SystemExit message or None)."""
    mod = PKG[kind][0][name]
    p = argparse.ArgumentParser()
    mod.add_args(p)
    args = p.parse_args(argv)
    out = io.StringIO()
    exited = None
    with contextlib.redirect_stdout(out):
        try:
            asyncio.run(mod.run(args))
        except SystemExit as e:
            exited = str(e.code)
    return out.getvalue(), exited


async def _run_cmd_async(kind, name, argv):
    mod = PKG[kind][0][name]
    p = argparse.ArgumentParser()
    mod.add_args(p)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        await mod.run(p.parse_args(argv))
    return out.getvalue()


def _sha(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def _volume(kind, d, vid, payloads, deletes=(), names=None):
    """A volume of `kind`'s package in `d`, from the same needles."""
    os.makedirs(d, exist_ok=True)
    with _frozen():
        v = PKG[kind][1](d, vid)
        for nid, data in payloads.items():
            v.write(nid, 0xBEEF, data, name=(names or {}).get(nid, b""))
        for nid in deletes:
            v.delete(nid, 0xBEEF)
        v.close()
    return v


def _payloads(n, seed, lo=400, hi=6000):
    rng = np.random.default_rng(seed)
    return {i: rng.bytes(int(rng.integers(lo, hi))) for i in range(1, n + 1)}


@pytest.mark.parametrize("kind", ["ref", "port"])
def test_fix_rebuilds_idx_like_the_reference(tmp_path, kind):
    """Both packages' `fix` on the same volume whose .idx was overwritten:
    the same line, the same rebuilt .idx, the .dat untouched; the other
    package reads the result (the live needles, needle 3 deleted)."""
    payloads = _payloads(29, SEED)
    seen = {}
    for side in ("ref", "port"):
        d = str(tmp_path / side)
        v = _volume(side, d, 5, payloads, deletes=[3])
        with open(v.idx_path, "wb") as f:
            f.write(b"garbage!" * 10)
        dat = _sha(v.dat_path)
        out, _ = _run_cmd(side, "fix", ["-dir", d, "-volumeId", "5"])
        assert _sha(v.dat_path) == dat  # the repair leaves the data alone
        seen[side] = (out, _sha(v.idx_path), dat)
    assert seen["port"] == seen["ref"]
    # every record of the .dat counts: needle 3's write and its tombstone
    assert seen["ref"][0] == "volume 5 (default): reindexed 29 needles, 1 tombstones\n"
    # the rebuilt volume reads back in `kind`'s package
    v2 = PKG[kind][1](str(tmp_path / "port"), 5)
    try:
        for nid, data in payloads.items():
            if nid == 3:
                with pytest.raises(KeyError):
                    v2.read(nid)
            else:
                assert v2.read(nid, 0xBEEF).data == data
        assert len(v2.nm) == len(payloads) - 1
        assert v2.garbage_ratio > 0
    finally:
        v2.close()


def test_compact_matches_the_reference(tmp_path):
    payloads = _payloads(19, SEED + 1, 5000, 5001)
    seen = {}
    for side in ("ref", "port"):
        d = str(tmp_path / side)
        v = _volume(side, d, 9, payloads, deletes=range(1, 15))
        before = os.path.getsize(v.dat_path)
        with _frozen():
            out, _ = _run_cmd(side, "compact", ["-dir", d, "-volumeId", "9"])
        after = os.path.getsize(v.dat_path)
        assert after < before
        seen[side] = (out, _sha(v.dat_path), _sha(v.idx_path))
    assert seen["port"] == seen["ref"]
    assert "garbage ratio" in seen["ref"][0]
    v2 = PortVolume(str(tmp_path / "port"), 9)
    try:
        for nid in range(15, 20):
            assert v2.read(nid, 0xBEEF).data == payloads[nid]
    finally:
        v2.close()


@pytest.mark.parametrize("deleted", [False, True])
def test_export_matches_the_reference(tmp_path, deleted):
    payloads = {1: b"alpha contents", 2: b"beta contents",
                **_payloads(5, SEED + 2)}
    payloads = {i + 1: d for i, d in enumerate(payloads.values())}
    names = {1: b"alpha.txt", 4: b"../../etc/passwd"}
    seen = {}
    for side in ("ref", "port"):
        d = str(tmp_path / side)
        _volume(side, d, 11, payloads, deletes=[1], names=names)
        tar = str(tmp_path / f"{side}.tar")
        argv = ["-dir", d, "-volumeId", "11", "-o", tar]
        out, _ = _run_cmd(side, "export", argv + (["-deleted"] if deleted
                                                  else []))
        with tarfile.open(tar) as t:
            members = [(m.name, m.size, m.mtime,
                        hashlib.sha256(t.extractfile(m).read()).hexdigest())
                       for m in t.getmembers()]
        seen[side] = (out.replace(tar, "<tar>"), members, _sha(tar))
    assert seen["port"] == seen["ref"]
    names_out = [m[0] for m in seen["ref"][1]]
    assert "2_beef/b_2" in names_out
    assert all("/" not in n.split("/", 1)[1] for n in names_out)
    assert ("1_beef/alpha.txt" in names_out) == deleted


def test_fsck_matches_the_reference(tmp_path):
    payloads = _payloads(5, SEED + 3, 800, 801)
    seen = {}
    for side in ("ref", "port"):
        d = str(tmp_path / side)
        v = _volume(side, d, 13, payloads)
        ok = _run_cmd(side, "fsck", ["-dir", d, "-volumeId", "13"])
        with open(v.idx_path, "rb") as f:
            bad = bytearray(f.read())
        bad[0:8] = (0xDEAD).to_bytes(8, "big")
        with open(v.idx_path, "wb") as f:
            f.write(bytes(bad))
        corrupt = _run_cmd(side, "fsck", ["-dir", d, "-volumeId", "13"])
        out, exited = _run_cmd(side, "fsck", ["-dir", d, "-volumeId", "99"])
        seen[side] = (ok, corrupt, (out, exited.replace(d, "<dir>")))
    assert seen["port"] == seen["ref"]
    assert seen["ref"][0] == ("volume 13 (default): OK, 5 needles\n", None)
    assert "CORRUPT" in seen["ref"][1][0] and seen["ref"][1][1]
    assert seen["ref"][2][1].startswith("no matching volumes")


def test_fsck_verify_index_integrity_matches(tmp_path):
    """storage/needle_map.py's verify_index_integrity, copied into the
    port: the same count on a sound volume, the same refusal on an entry
    whose size is off."""
    from seaweedfs_tpu.storage.needle_map import \
        verify_index_integrity as ref_verify
    from seaweedfs_tpu_torch.storage.needle_map import \
        verify_index_integrity as port_verify

    payloads = _payloads(7, SEED + 4)
    v = _volume("port", str(tmp_path), 3, payloads, deletes=[2])
    assert port_verify(v.dat_path, v.idx_path, 3) == ref_verify(
        v.dat_path, v.idx_path, 3) == 6
    with open(v.idx_path, "r+b") as f:
        f.seek(12)  # the first entry's size
        f.write((77).to_bytes(4, "big"))
    errs = []
    for verify in (ref_verify, port_verify):
        with pytest.raises(ValueError) as e:
            verify(v.dat_path, v.idx_path, 3)
        errs.append(str(e.value))
    assert errs[0] == errs[1]


# ------------------------------------------------------- against a cluster


async def _cluster(kind, base):
    if kind == "port":
        c = PortCluster(n_volume_servers=1, base_dir=base, pulse_seconds=1,
                        ec_backend="torch")
    else:
        c = RefCluster(base_dir=base, n_volume_servers=1, pulse_seconds=1)
    await c.start()
    return c


def test_upload_download_round_trip_matches_the_reference(tmp_path):
    """`upload` then `download` through each package's own cluster: the
    same JSON and lines (fids masked), the same bytes back."""
    src = tmp_path / "hello.bin"
    src.write_bytes(np.random.default_rng(SEED + 5).bytes(20_000))
    seen = {}

    async def go(kind):
        c = await _cluster(kind, str(tmp_path / kind / "c"))
        try:
            master = c.master.advertise_url
            out = await _run_cmd_async(kind, "upload", [str(src), "-master",
                                                        master])
            res = json.loads(out)
            fid = res[0]["fid"]
            outdir = tmp_path / kind / "dl"
            got = await _run_cmd_async(kind, "download", [
                fid, "-master", master, "-dir", str(outdir)])
            body = (outdir / fid.replace(",", "_")).read_bytes()
            vs = c.volume_servers[0]
            text = (out + got).replace(vs.url, "<vs>").replace(
                str(outdir), "<dir>")
            for r in res:
                text = text.replace(r["fid"], "<fid>").replace(
                    r["fid"].replace(",", "_"), "<file>")
            return text, body
        finally:
            await c.stop()

    for kind in ("ref", "port"):
        seen[kind] = asyncio.run(go(kind))
    assert seen["ref"][1] == seen["port"][1] == src.read_bytes()
    assert seen["port"][0] == seen["ref"][0]


def test_benchmark_matches_the_reference(tmp_path):
    """`benchmark -c 4 -n 64 -size 2048` against each package's cluster:
    the same report with the rates masked, 0 errors, every write and read
    counted."""
    def mask(text):
        text = re.sub(r"(per second|Transfer rate):\s+[\d.]+", r"\1: <r>",
                      text)
        return re.sub(r"(max\): ).*", r"\1<ms>", text)

    async def go(kind):
        c = await _cluster(kind, str(tmp_path / kind))
        try:
            return await _run_cmd_async(kind, "benchmark", [
                "-master", c.master.advertise_url, "-c", "4", "-n", "64",
                "-size", "2048"])
        finally:
            await c.stop()

    seen = {kind: mask(asyncio.run(go(kind))) for kind in ("ref", "port")}
    assert seen["port"] == seen["ref"]
    assert "Completed requests:      64" in seen["ref"]
    assert seen["ref"].count("Failed requests:         0") == 2


def _backup_blobs(n, seed):
    rng = np.random.default_rng(seed)
    return [(f"1,{i + 1:x}{int(rng.integers(0, 1 << 32)):08x}",
             rng.bytes(int(rng.integers(1000, 4000)))) for i in range(n)]


def test_backup_incremental_matches_the_reference(tmp_path):
    """`backup` of volume 1 from each package's one-server cluster: a full
    copy, an increment of one write and one delete, then a full resync
    after the source's vacuum; the same lines (cursors masked) and the
    same needles in the backup each time."""
    blobs = _backup_blobs(10, SEED + 6)
    extra = _backup_blobs(11, SEED + 6)[10]

    def mask(text):
        return re.sub(r"\d{6,}", "<ns>", text).replace(str(tmp_path), "<t>")

    async def go(kind):
        base = str(tmp_path / kind)
        c = await _cluster(kind, os.path.join(base, "c"))
        vs = c.volume_servers[0]
        stub_cls, chan, vpb = ((PortStub, port_channel, port_vpb)
                               if kind == "port"
                               else (RefStub, ref_channel, ref_vpb))
        stub = stub_cls(chan(vs.grpc_url), vpb, "VolumeServer")
        server = f"{vs.ip}:{vs.port}.{vs.grpc_port}"
        bdir = os.path.join(base, "bak")
        argv = ["-server", server, "-volumeId", "1", "-dir", bdir]
        outs, states = [], []

        def backed_up():
            v = PKG[kind][1](bdir, 1)
            try:
                return sorted((n, hashlib.sha256(bytes(v.read(n).data))
                               .hexdigest()) for n, _, _ in v.nm.items())
            finally:
                v.close()

        try:
            await stub.AllocateVolume(vpb.AllocateVolumeRequest(
                volume_id=1, replication="000"))
            for fid, data in blobs:
                await upload_data(f"http://{vs.url}/{fid}", data, "b.bin")
            outs.append(await _run_cmd_async(kind, "backup", argv))
            states.append(backed_up())
            await upload_data(f"http://{vs.url}/{extra[0]}", extra[1],
                              "b.bin")
            status, _, _ = await fetch(vs.url, "DELETE", f"/{blobs[0][0]}")
            assert status in (200, 202)
            outs.append(await _run_cmd_async(kind, "backup", argv))
            states.append(backed_up())
            await asyncio.to_thread(vs.store.vacuum_volume, 1)
            outs.append(await _run_cmd_async(kind, "backup", argv))
            states.append(backed_up())
        finally:
            await c.stop()
        return [mask(o.replace(bdir, "<bak>")) for o in outs], states

    seen = {kind: asyncio.run(go(kind)) for kind in ("ref", "port")}
    assert seen["port"] == seen["ref"]
    outs, states = seen["ref"]
    assert "applied 10 records" in outs[0]
    assert "applied 2 records" in outs[1]  # incremental: the write + delete
    assert "full resync" in outs[2]
    want = sorted((int(f.split(",")[1][:-8], 16),
                   hashlib.sha256(d).hexdigest())
                  for f, d in blobs[1:] + [extra])
    assert states[1] == states[2] == want


def test_offline_tools_read_each_others_volumes(tmp_path):
    """A volume the reference wrote, fixed, compacted and fsck'd by the
    port's commands, and the port's export of it equal to the
    reference's."""
    payloads = _payloads(12, SEED + 7)
    d = str(tmp_path / "v")
    _volume("ref", d, 21, payloads, deletes=[2, 5])
    out, _ = _run_cmd("port", "fix", ["-dir", d, "-volumeId", "21"])
    assert out == "volume 21 (default): reindexed 12 needles, 2 tombstones\n"
    with _frozen():
        _run_cmd("port", "compact", ["-dir", d, "-volumeId", "21"])
    assert _run_cmd("port", "fsck", ["-dir", d])[0] == (
        "volume 21 (default): OK, 10 needles\n")
    copy = str(tmp_path / "copy")
    shutil.copytree(d, copy)
    tars = []
    for kind, where in (("ref", d), ("port", copy)):
        tar = str(tmp_path / f"{kind}.tar")
        _run_cmd(kind, "export", ["-dir", where, "-volumeId", "21", "-o",
                                  tar])
        tars.append(_sha(tar))
    assert tars[0] == tars[1]

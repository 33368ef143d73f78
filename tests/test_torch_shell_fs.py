"""The port's `fs.*` verbs and `volume.fsck` against the JAX package's,
each shell over its own package's cluster with the same tree written
through the filer: the same commands print the same text, with file ids,
addresses and clocks masked.  `volume.fsck` runs on a clean tree, then
with an orphan (a needle uploaded to the volume outside the filer) and a
broken reference (a chunk's needle deleted on its server).
"""
import asyncio
import json
import re

import numpy as np
import pytest

from test_torch_filer_server import _Side, _both

_MASKS = [
    (re.compile(r"\b\d+,[0-9a-f]{4,}\b"), "<fid>"),
    (re.compile(r"references \d+,[0-9a-f]+ "), "references <needle> "),
    (re.compile(r"127\.0\.0\.1:\d+(\.\d+)?"), "<addr>"),
    (re.compile(r"\d{4}-\d\d-\d\d \d\d:\d\d(:\d\d)?"), "<time>"),
    (re.compile(r"(mtime|crtime|modified_ts_ns): \d+"), r"\1: <t>"),
    (re.compile(r'(cipher_key|e_tag): "[^"]*"'), r'\1: <k>'),
]


def _mask(text: str) -> str:
    for rx, repl in _MASKS:
        text = rx.sub(repl, text)
    return text


async def _tree(side):
    rng = np.random.default_rng(11)
    for path, data in (("/t/a.bin", rng.bytes(40_000)),
                       ("/t/b.txt", b"line\n" * 2000),
                       ("/t/big.bin", rng.bytes(2_200_000)),
                       ("/t/sub/c.bin", rng.bytes(900)),
                       ("/t/sub/deeper/d.bin", rng.bytes(12_345))):
        st, _, _ = await side.http("PUT", path, {}, data)
        assert st == 201


async def _run(side, lines):
    """Each line's output, masked."""
    out = []
    for line in lines:
        side.out.seek(0)
        side.out.truncate()
        try:
            await side.sh(line)
        except Exception as e:  # noqa: BLE001 — the verb's refusal is output
            side.out.write(f"error: {type(e).__name__}: {e}\n")
        out.append((line, _mask(side.out.getvalue())))
    return out


async def _one_volume(side, collection):
    """Grow exactly one volume of `collection` (the filer's), so that every
    chunk lands on it: vid 1 on both clusters, whatever each master's
    random start among writable volumes would have picked."""
    from seaweedfs_tpu_torch.server.http import fetch

    m = side.c.master
    st, _, body = await fetch(
        f"{m.ip}:{m.port}", "GET", f"/vol/grow?count=1&collection={collection}")
    assert st == 200, body
    assert json.loads(body)["vids"] == [1], body


def test_fs_verbs_match_the_reference(tmp_path):
    async def verbs(side):
        await _one_volume(side, "fsv")
        await _tree(side)
        save = str(tmp_path / f"{side.kind}-meta.bin")
        out = await _run(side, [
            "fs.ls /t", "fs.ls -l /t", "fs.ls /nope", "fs.du /t", "fs.du",
            "fs.tree /t", "fs.cat /t/b.txt", "fs.cat /t/none",
            "fs.mkdir /t/new/dir", "fs.mkdir /t/new/dir", "fs.mkdir /t/a.bin",
            "fs.mv /t/sub/c.bin /t/new/c2.bin", "fs.ls /t/new",
            "fs.cd /t/sub", "fs.pwd", "fs.ls", "fs.cd ..", "fs.pwd",
            "fs.cd /nope", "fs.meta.cat /t/a.bin", "fs.meta.cat /t/sub",
            "fs.meta.cat /t/none",
            f"fs.meta.save -o {save} /t", "fs.rm -r /t/new", "fs.rm /t/sub",
            "fs.rm /t/none", "fs.ls /t",
            f"fs.meta.load -i {save}", "fs.ls /t", "fs.du /t",
            "fs.verify /t", "fs.verify -v /t/sub",
            "fs.configure",
            "fs.configure -locationPrefix /t/ro/ -readOnly -collection c1",
            "fs.configure -locationPrefix /t/ro/ -readOnly -apply",
            "fs.configure -locationPrefix /t/ro/ -ttl 1d -apply",
            "fs.configure -locationPrefix /t/ro/ -delete -apply",
            "fs.meta.change.volume.id -from 1 -to 9 /t",
            "lock", "fs.meta.change.volume.id -from 1 -to 9 /t/sub", "unlock",
        ])
        return [(line.replace(save, "<save>"), text.replace(save, "<save>"))
                for line, text in out]

    got = asyncio.run(_both(tmp_path, verbs, collection="fsv"))
    for (line, port), (_, ref) in zip(got["port"], got["ref"]):
        assert port == ref, line
    assert len(got["port"]) == len(got["ref"])
    # every chunk is on vid 1, so the locked dry run lists /t/sub's file
    assert "/t/sub/deeper/d.bin: volume 1 -> 9" in got["port"][-2][1]


def test_volume_fsck_matches_the_reference(tmp_path):
    async def fsck(side):
        await _tree(side)
        await asyncio.sleep(1.2)  # a pulse lists the volumes' files
        out = await _run(side, ["volume.fsck", "lock", "volume.fsck",
                                "volume.fsck -cutoffMinutes 0"])
        # an orphan: a needle uploaded outside the filer
        a = await side.f._assign()
        upload = __import__(("seaweedfs_tpu_torch" if side.kind == "port"
                             else "seaweedfs_tpu") + ".operation.upload",
                            fromlist=["x"]).upload_data
        await upload(f"http://{a.url}/{a.fid}", b"orphan" * 100, "o.bin")
        # a broken reference: one chunk's needle deleted on its server
        d = (await side.stub.LookupDirectoryEntry(side.pb.LookupDirectoryEntryRequest(
            directory="/t", name="big.bin"))).entry
        fid = d.chunks[1].file_id
        urls = await side.f._lookup_urls(fid)
        host = urls[0].split("/")[2]
        from seaweedfs_tpu_torch.server.http import fetch

        st, _, _ = await fetch(host, "DELETE", "/" + fid)
        assert st < 300
        await asyncio.sleep(1.2)
        out += await _run(side, [
            "volume.fsck -cutoffMinutes 0",
            "volume.fsck",  # the orphan is recent: skipped
            "volume.fsck -cutoffMinutes 0 -reallyDeleteFromVolume",
            "volume.fsck -cutoffMinutes 0", "unlock"])
        return out

    got = asyncio.run(_both(tmp_path, fsck))
    # the volumes are walked in their servers' order, which the two
    # clusters' placements make differ: compare each output's lines as a set
    for (line, port), (_, ref) in zip(got["port"], got["ref"]):
        assert sorted(port.splitlines()) == sorted(ref.splitlines()), line
    assert len(got["port"]) == len(got["ref"])
    assert "1 orphan needles" in got["port"][4][1]
    assert "1 broken references" in got["port"][4][1]
    assert "0 orphan needles" in got["port"][7][1]
    assert "(1 purged)" in got["port"][6][1]

"""operation/{submit,delete}.py against in-process clusters of both
packages: submit_data stores a blob and returns a fid whose GET is
byte-equal, and delete_files counts what it deleted as the reference's
does (a second delete of the same fid, and a fid of a volume no server
holds, included).  With a write-JWT key, both verbs carry the master's
token (Assign's for the upload, LookupVolume's for the delete)."""
import asyncio

import numpy as np
import pytest

from seaweedfs_tpu import operation as ref_op
from seaweedfs_tpu.operation import delete as ref_delete
from seaweedfs_tpu.repair import RepairConfig
from seaweedfs_tpu.server.cluster import LocalCluster as RefCluster
from seaweedfs_tpu_torch import operation as port_op
from seaweedfs_tpu_torch.operation import delete as port_delete
from seaweedfs_tpu_torch.repair import RepairConfig as PortRepairConfig
from seaweedfs_tpu_torch.server.cluster import LocalCluster as PortCluster
from seaweedfs_tpu_torch.server.http import Client


def _cluster(kind, base, key):
    if kind == "port":
        return PortCluster(n_volume_servers=1, base_dir=base,
                           ec_backend="torch", jwt_signing_key=key,
                           master_kwargs={"ec_repair": PortRepairConfig(
                               enabled=False)})
    return RefCluster(n_volume_servers=1, base_dir=base,
                      jwt_signing_key=key,
                      master_kwargs={"ec_repair": RepairConfig(enabled=False)})


async def _get(url):
    host, _, rest = url[len("http://"):].partition("/")
    h, p = host.rsplit(":", 1)
    c = Client(h, int(p))
    try:
        st, _, body = await c.request("GET", "/" + rest)
    finally:
        await c.close()
    return st, body


async def _script(kind, base, key) -> dict:
    op = port_op if kind == "port" else ref_op
    delete = port_delete if kind == "port" else ref_delete
    c = _cluster(kind, base, key)
    await c.start()
    out = {}
    try:
        master = c.master.advertise_url
        blobs = [np.random.default_rng(i).bytes(n)
                 for i, n in enumerate((10, 4000, 130_000))]
        fids = [await op.submit_data(master, b, f"b{i}.bin",
                                     "application/x-test")
                for i, b in enumerate(blobs)]
        reads = []
        for fid in fids:
            urls = await op.lookup_file_id(master, fid)
            reads.append(await _get(urls[0]))
        out["reads"] = [(st, body == b) for (st, body), b in zip(reads, blobs)]
        out["delete_two"] = await delete.delete_files(master, fids[:2])
        out["delete_again"] = await delete.delete_files(
            master, fids[:1] + ["99,01deadbeef"])
        out["delete_one"] = await delete.delete_file(master, fids[2])
        out["after"] = [(await _get(
            (await op.lookup_file_id(master, fid))[0]))[0] for fid in fids]
    finally:
        await c.stop()
    return out


@pytest.mark.parametrize("key", ["", "t0psecret"])
def test_submit_and_delete_match_the_reference(tmp_path, key):
    ref = asyncio.run(_script("ref", str(tmp_path / "ref"), key))
    port = asyncio.run(_script("port", str(tmp_path / "port"), key))
    assert ref["reads"] == [(200, True)] * 3
    assert ref["delete_two"] == 2 and ref["delete_one"] is True
    assert ref["after"] == [404, 404, 404]
    assert port == ref

"""The master's client rpcs and HTTP paths in the port, against the
reference's after the same writes.

On each package's single-master LocalCluster with two volume servers
(tests/test_torch_cluster.py's `_Side`: volume 1 filled with the same
seeded blobs under a frozen clock), then two volumes grown in collection
`pics`: Statistics (all, and one collection), CollectionList,
ListClusterNodes (a MasterClient of each package registered as a filer),
RaftListClusterServers, /cluster/status, /submit, /col/delete,
CollectionDelete, and the shell's cluster.ps and cluster.raft.ps.  Then
three masters of each package: RaftListClusterServers, /cluster/status
and cluster.raft.ps on every master.  Answers are compared exactly, with
server addresses, the raft term and clocks masked.

One departure is pinned (ROADMAP §C): the reference's /submit re-posts
the body under aiohttp's bare mime type, without the multipart boundary,
and its volume server stores an empty needle, which a GET answers 404;
the port's stores the file.
"""
import asyncio
import io
import json
import random
import re

from seaweedfs_tpu.pb import Stub as RefStub
from seaweedfs_tpu.pb import channel as ref_channel
from seaweedfs_tpu.pb import master_pb2 as ref_mpb
from seaweedfs_tpu.wdclient import MasterClient as RefMasterClient
from seaweedfs_tpu_torch.operation.upload import multipart_body
from seaweedfs_tpu_torch.pb import Stub as PortStub
from seaweedfs_tpu_torch.pb import channel as port_channel
from seaweedfs_tpu_torch.pb import master_pb2 as port_mpb
from seaweedfs_tpu_torch.server.http import fetch
from seaweedfs_tpu_torch.wdclient import MasterClient

WAIT_S = 30.0
SEED = 18


def _imports():
    from test_torch_cluster import _blobs, _Side
    from test_torch_master_ha import Group, wait_for

    return _blobs, _Side, Group, wait_for


async def mrpc(kind, grpc_url, method, **fields):
    stub_cls, chan, mpb = ((PortStub, port_channel, port_mpb)
                           if kind == "port"
                           else (RefStub, ref_channel, ref_mpb))
    stub = stub_cls(chan(grpc_url), mpb, "Seaweed")
    return await getattr(stub, method)(
        getattr(mpb, f"{method}Request")(**fields))


async def http(url, method, path, headers=None, body=b""):
    status, hdrs, data = await fetch(url, method, path, headers=headers,
                                     body=body, timeout=WAIT_S)
    ctype = hdrs.get("Content-Type", "")
    return status, (json.loads(data) if "json" in ctype else data)


def _mask(obj, urls: dict):
    """Every address in `obj` (strings, nested) replaced by its name."""
    text = json.dumps(obj, sort_keys=True)
    for url, name in sorted(urls.items(), key=lambda kv: -len(kv[0])):
        text = text.replace(url, name)
    return json.loads(text)


def _servers(resp):
    return {"term": resp.term,
            "servers": [(s.id, s.is_leader) for s in resp.cluster_servers]}


async def _one_master(kind, base, blobs) -> dict:
    _, _Side, _, wait_for = _imports()
    side = _Side("port" if kind == "port" else "ref", base, n=2)
    seen = {}
    await side.start()
    mc = None
    try:
        master = side.c.master
        await side.allocate_and_fill(blobs)
        # the growth's placement and the layouts' pick from the same seed
        master.topo.growth.rng.seed(SEED)
        random.seed(SEED)
        seen["grow"] = await http(master.url, "GET",
                                  "/vol/grow?collection=pics&count=2")
        await side.settle()
        for col in ("", "pics"):
            seen[f"statistics_{col}"] = (await mrpc(
                kind, master.grpc_url, "Statistics",
                collection=col)).SerializeToString()
        seen["collections"] = (await mrpc(
            kind, master.grpc_url, "CollectionList")).SerializeToString()

        mc = (MasterClient if kind == "port" else RefMasterClient)(
            [master.advertise_url], client_type="filer",
            client_address="127.0.0.1:18888")
        await mc.start()
        await mc.wait_connected(WAIT_S)
        await wait_for(lambda: master.cluster_nodes, "the filer registered")
        for ctype in ("", "filer", "broker"):
            resp = await mrpc(kind, master.grpc_url, "ListClusterNodes",
                              client_type=ctype)
            seen[f"nodes_{ctype}"] = [
                (n.address, n.client_type, n.created_at_ns > 0)
                for n in resp.cluster_nodes]
        await wait_for(lambda: mc.vid_map.lookup(1), "vid 1 in the client")
        seen["client_vid1"] = [l.url for l in mc.vid_map.lookup(1)]

        seen["raft"] = _servers(await mrpc(
            kind, master.grpc_url, "RaftListClusterServers"))
        seen["status"] = await http(master.url, "GET", "/cluster/status")

        payload, ctype = multipart_body(b"submitted " * 64, "s.txt",
                                        "text/plain", False)
        status, sub = await http(master.url, "POST", "/submit",
                                 {"Content-Type": ctype}, payload)
        seen["submit"] = (status, sorted(sub))
        seen["submit_get"] = (await http(
            sub["fileUrl"].split("/")[0], "GET", "/" + sub["fid"]))
        seen["submit_answer"] = {k: sub[k] for k in ("name", "size")}

        await side.sh("cluster.ps")
        await side.sh("cluster.raft.ps")
        seen["shell"] = side.out.getvalue()

        seen["col_delete"] = await http(master.url, "GET",
                                        "/col/delete?collection=pics")
        await side.settle()
        seen["collections_after"] = (await mrpc(
            kind, master.grpc_url, "CollectionList")).SerializeToString()
        seen["pics_held_after"] = sorted(
            vid for vs in side.c.volume_servers for vid in (2, 3)
            if vs.store.find_volume(vid) is not None)
        seen["collection_delete_rpc"] = (await mrpc(
            kind, master.grpc_url, "CollectionDelete",
            name="nothing")).SerializeToString()
        urls = {master.advertise_url: "M0", master.url: "M0"}
        for i, vs in enumerate(side.c.volume_servers):
            urls[vs.url] = f"vs{i}"
        return _mask(seen_text(seen), urls)
    finally:
        if mc is not None:
            await mc.stop()
        await side.stop()


def seen_text(seen: dict) -> dict:
    """`seen` with bytes as hex and the shell's term and free-slot counts
    left as they are (they are the same on both sides)."""
    out = {}
    for k, v in seen.items():
        if isinstance(v, bytes):
            v = v.hex()
        elif isinstance(v, tuple):
            v = [x.hex() if isinstance(x, bytes) else x for x in v]
        out[k] = v
    return out


def test_client_rpcs_and_http_paths_match_the_reference(tmp_path):
    _blobs, _, _, _ = _imports()
    blobs = _blobs()
    ref = asyncio.run(_one_master("ref", str(tmp_path / "ref"), blobs))
    port = asyncio.run(_one_master("port", str(tmp_path / "port"), blobs))

    # the case did what it says, on the reference side
    assert ref["grow"][0] == 200 and ref["grow"][1]["count"] == 2
    assert ref["nodes_filer"] == [["127.0.0.1:18888", "filer", True]]
    assert ref["nodes_broker"] == []
    assert ref["client_vid1"] == ["vs0"]
    assert ref["raft"] == {"term": 1, "servers": [["M0", True]]}
    assert "pics" in bytes.fromhex(ref["collections"]).decode()
    assert "pics" not in bytes.fromhex(ref["collections_after"]).decode()
    assert ref["pics_held_after"] == []
    assert ref["col_delete"] == [200, {"deleted": "pics"}]

    # the departure: the reference stores an empty needle, the port the file
    sub_ref, sub_port = ref.pop("submit_answer"), port.pop("submit_answer")
    get_ref, get_port = ref.pop("submit_get"), port.pop("submit_get")
    assert sub_ref == {"name": "", "size": 0}
    assert sub_port["name"] == "s.txt" and sub_port["size"] > 0
    assert get_port == [200, (b"submitted " * 64).hex()]
    assert get_ref[0] == 404

    for key in ref:
        assert port[key] == ref[key], key


async def _three_masters(kind, tmp_path) -> dict:
    _, _, Group, _ = _imports()
    g = Group(kind, tmp_path)
    await g.start()
    try:
        leader = await g.leader()
        # every master has heard from the leader
        await g_wait(g, leader)
        # masters named by role: the leader, then the followers in order
        # (which master wins an election is the timers' doing)
        order = [leader] + [m for m in g.masters if m is not leader]
        names = {}
        for i, m in enumerate(order):
            names[m.advertise_url] = names[m.url] = ["L", "F1", "F2"][i]
        seen = {}
        for i, m in enumerate(order):
            resp = await mrpc(kind, f"127.0.0.1:{m.grpc_port}",
                              "RaftListClusterServers")
            # the listing is this master, then its peers in -peers order
            seen[f"raft_{i}"] = [(s.id, s.is_leader)
                                 for s in resp.cluster_servers]
            seen[f"term_{i}"] = resp.term == leader.raft.term
            seen[f"status_{i}"] = await http(m.url, "GET", "/cluster/status")
            out = io.StringIO()
            g_env = g.pkg["env"]([m.advertise_url], out=out)
            await g.pkg["run"](g_env, "cluster.raft.ps")
            lines = re.sub(r"term: \d+", "term: <n>",
                           out.getvalue()).splitlines()
            seen[f"shell_{i}"] = lines
        seen = _mask(seen, names)
        for i in range(3):
            seen[f"raft_{i}"] = [seen[f"raft_{i}"][0],
                                 sorted(seen[f"raft_{i}"][1:])]
            seen[f"shell_{i}"] = seen[f"shell_{i}"][:2] + sorted(
                seen[f"shell_{i}"][2:])
            st = seen[f"status_{i}"][1]
            st["Peers"] = sorted(st["Peers"])
        return seen
    finally:
        await g.stop()


async def g_wait(g, leader):
    _, _, _, wait_for = _imports()
    await wait_for(lambda: all(m.raft.leader_id == leader.raft.id
                               and m.raft.term == leader.raft.term
                               for m in g.masters), "every master follows")


def test_raft_listing_on_three_masters_matches_the_reference(tmp_path):
    ref = asyncio.run(_three_masters("ref", tmp_path))
    port = asyncio.run(_three_masters("port", tmp_path))
    assert ref["raft_0"] == [["L", True], [["F1", False], ["F2", False]]]
    assert all(ref[f"term_{i}"] for i in range(3))
    assert port == ref

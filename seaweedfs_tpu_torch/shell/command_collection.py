"""collection.* commands (reference: weed/shell/command_collection_*.go;
a copy of seaweedfs_tpu/shell/command_collection.py over the master's
CollectionList and CollectionDelete rpcs)."""
from ..pb import master_pb2
from .commands import command, parse_flags


@command("collection.list")
async def cmd_collection_list(env, args):
    """list collections"""
    resp = await env.master_stub.CollectionList(
        master_pb2.CollectionListRequest(
            include_normal_volumes=True, include_ec_volumes=True
        )
    )
    for c in resp.collections:
        env.write(f"  {c.name}")
    env.write(f"{len(resp.collections)} collections")


@command("collection.delete")
async def cmd_collection_delete(env, args):
    """-collection <name> : delete all volumes of a collection"""
    env.confirm_is_locked()
    flags = parse_flags(args)
    name = flags.get("collection", flags.get(""))
    if not name:
        raise ValueError("usage: collection.delete -collection <name>")
    await env.master_stub.CollectionDelete(
        master_pb2.CollectionDeleteRequest(name=name)
    )
    env.write(f"deleted collection {name}")

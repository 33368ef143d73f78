"""`filer.meta.backup` — continuously back up filer METADATA to a local
SQLite file (reference: weed/command/filer_meta_backup.go).  A full
snapshot seeds the store, then the metadata subscription keeps it
current; the last applied timestamp is stored in the same file, so
restarts resume instead of re-snapshotting (use -restart to force).

A copy of seaweedfs_tpu/command/filer_meta_backup.py over the port's RPC
plane: the SQLite file either package writes, the other reads."""
from __future__ import annotations

NAME = "filer.meta.backup"
HELP = "back up filer metadata into a local SQLite file, then follow"


def add_args(p) -> None:
    p.add_argument("-filer", required=True, help="filer host:port")
    p.add_argument("-path", default="/", help="filer subtree")
    p.add_argument("-store", required=True, help="local sqlite file")
    p.add_argument(
        "-restart", action="store_true", help="drop progress and resnapshot"
    )
    p.add_argument(
        "-oneTime", action="store_true",
        help="stop after the snapshot instead of tailing forever",
    )


def open_store(path: str):
    import sqlite3

    db = sqlite3.connect(path)
    db.execute(
        "CREATE TABLE IF NOT EXISTS meta (full_path TEXT PRIMARY KEY, entry BLOB)"
    )
    db.execute(
        "CREATE TABLE IF NOT EXISTS progress (k TEXT PRIMARY KEY, ts_ns INTEGER)"
    )
    return db


def restore_entry(db, full_path: str):
    """-> filer_pb2.Entry or None (used by tests and a future restore tool)."""
    from ..pb import filer_pb2

    row = db.execute(
        "SELECT entry FROM meta WHERE full_path = ?", (full_path,)
    ).fetchone()
    return filer_pb2.Entry.FromString(row[0]) if row else None


async def run(args) -> None:
    import time

    from ..pb import Stub, channel, filer_pb2, server_address

    root = "/" + args.path.strip("/") if args.path != "/" else "/"
    db = open_store(args.store)
    if args.restart:
        db.execute("DELETE FROM meta")
        db.execute("DELETE FROM progress")
        db.commit()
    row = db.execute("SELECT ts_ns FROM progress WHERE k = 'since'").fetchone()
    since_ns = row[0] if row else 0

    stub = Stub(
        channel(server_address.grpc_address(args.filer)),
        filer_pb2,
        "SeaweedFiler",
    )

    def put(full_path: str, entry) -> None:
        db.execute(
            "INSERT OR REPLACE INTO meta (full_path, entry) VALUES (?, ?)",
            (full_path, entry.SerializeToString()),
        )

    async def snapshot(directory: str) -> int:
        from ..filer.client import list_all_entries

        n = 0
        for e in await list_all_entries(stub, directory):
            full = f"{directory.rstrip('/')}/{e.name}"
            put(full, e)
            n += 1
            if e.is_directory:
                n += await snapshot(full)
        return n

    if since_ns == 0:
        start_ns = time.time_ns()
        n = await snapshot(root)
        db.execute(
            "INSERT OR REPLACE INTO progress (k, ts_ns) VALUES ('since', ?)",
            (start_ns,),
        )
        db.commit()
        since_ns = start_ns
        print(f"snapshot: {n} entries into {args.store}")
    if args.oneTime:
        db.close()
        return

    print(f"following metadata on {args.filer} from ts {since_ns}")
    async for ev in stub.SubscribeMetadata(
        filer_pb2.SubscribeMetadataRequest(
            client_name="filer.meta.backup",
            path_prefix=root if root != "/" else "",
            since_ns=since_ns,
        )
    ):
        note = ev.event_notification
        if note.HasField("old_entry"):
            db.execute(
                "DELETE FROM meta WHERE full_path = ?",
                (f"{ev.directory.rstrip('/')}/{note.old_entry.name}",),
            )
        if note.HasField("new_entry"):
            new_dir = note.new_parent_path or ev.directory
            put(f"{new_dir.rstrip('/')}/{note.new_entry.name}", note.new_entry)
        db.execute(
            "INSERT OR REPLACE INTO progress (k, ts_ns) VALUES ('since', ?)",
            (ev.ts_ns,),
        )
        db.commit()

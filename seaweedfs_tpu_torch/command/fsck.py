"""`fsck` — verify volume index/data integrity offline
(reference: weed/storage volume_checking.go's checks, surfaced the way
`weed fix`/fsck tooling is; a copy of seaweedfs_tpu/command/fsck.py)."""
from __future__ import annotations

NAME = "fsck"
HELP = "verify .idx entries point at matching .dat records"


def add_args(p) -> None:
    p.add_argument("-dir", default=".", help="data directory")
    p.add_argument(
        "-volumeId", dest="volume_id", type=int, default=-1,
        help="volume to check (-1 = every volume in -dir)",
    )
    p.add_argument("-collection", default="")


async def run(args) -> None:
    import glob
    import os

    from ..storage.disk_location import parse_base_name
    from ..storage.needle_map import verify_index_integrity
    from ..storage.super_block import SUPER_BLOCK_SIZE, SuperBlock
    from ..storage.volume import Volume

    targets = []
    for dat in sorted(glob.glob(os.path.join(args.dir, "*.dat"))):
        parsed = parse_base_name(os.path.basename(dat)[: -len(".dat")])
        if parsed is None:
            continue
        collection, vid = parsed
        if args.volume_id != -1 and vid != args.volume_id:
            continue
        if args.collection and collection != args.collection:
            continue
        targets.append((collection, vid))
    if not targets:
        raise SystemExit(f"no matching volumes under {args.dir}")
    bad = 0
    import asyncio

    for collection, vid in targets:
        base = Volume.base_name(args.dir, vid, collection)

        # the whole per-volume check runs in one to_thread: the index
        # sweep is a per-needle seek/read pass over the .dat file, far
        # more loop-blocking than the 8-byte superblock read before it
        def _check(path=base):
            with open(path + ".dat", "rb") as f:
                sb = SuperBlock.from_bytes(f.read(SUPER_BLOCK_SIZE))
            return verify_index_integrity(
                path + ".dat", path + ".idx", sb.version
            )

        try:
            n = await asyncio.to_thread(_check)
            print(f"volume {vid} ({collection or 'default'}): OK, {n} needles")
        except ValueError as e:
            bad += 1
            print(f"volume {vid} ({collection or 'default'}): CORRUPT — {e}")
    if bad:
        raise SystemExit(f"{bad} corrupt volume(s); run `fix` to rebuild .idx")

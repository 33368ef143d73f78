"""`fix` — rebuild a volume's .idx from its .dat
(reference: weed/command/fix.go; a copy of seaweedfs_tpu/command/fix.py).

A dedicated full-scan rebuild: every record in .dat order feeds the new
index — live records as entries, tombstones as deletes — and the .dat
itself is NEVER modified (crash-tail recovery truncates; an offline
repair tool must not).  A torn/corrupt tail stops the scan with a
warning, leaving the remaining bytes in place.
"""
from __future__ import annotations

NAME = "fix"
HELP = "rebuild .idx files by scanning .dat volumes"


def add_args(p) -> None:
    p.add_argument("-dir", default=".", help="data directory")
    p.add_argument(
        "-volumeId", dest="volume_id", type=int, default=-1,
        help="volume to fix (-1 = every volume in -dir)",
    )
    p.add_argument("-collection", default="")


def rebuild_idx(dat_path: str, idx_path: str) -> tuple[int, int]:
    """Scan dat_path and write a fresh idx_path.  Returns
    (live_needles, tombstones)."""
    import os

    from ..storage import idx as idx_mod
    from ..storage import needle as needle_mod
    from ..storage import types as t
    from ..storage.needle import Needle
    from ..storage.super_block import SUPER_BLOCK_SIZE, SuperBlock

    size = os.path.getsize(dat_path)
    live = dead = 0
    with open(dat_path, "rb") as f, open(idx_path + ".tmp", "wb") as xf:
        sb = SuperBlock.from_bytes(f.read(SUPER_BLOCK_SIZE))
        offset = SUPER_BLOCK_SIZE
        while offset + t.NEEDLE_HEADER_SIZE <= size:
            f.seek(offset)
            hdr = f.read(t.NEEDLE_HEADER_SIZE)
            _, nid, nsize = Needle.parse_header(hdr)
            if t.size_is_valid(nsize):
                total = needle_mod.actual_size(nsize, sb.version)
                if offset + total > size:
                    print(f"  warning: torn record at {offset}; stopping scan")
                    break
                xf.write(idx_mod.pack_entry(nid, offset, nsize))
                live += 1
            else:
                total = needle_mod.actual_size(0, sb.version)
                if offset + total > size:
                    break
                xf.write(idx_mod.pack_entry(nid, 0, t.TOMBSTONE_FILE_SIZE))
                dead += 1
            offset += total
    os.replace(idx_path + ".tmp", idx_path)
    return live, dead


async def run(args) -> None:
    import glob
    import os

    from ..storage.disk_location import parse_base_name
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
    for collection, vid in targets:
        base = Volume.base_name(args.dir, vid, collection)
        live, dead = rebuild_idx(base + ".dat", base + ".idx")
        print(
            f"volume {vid} ({collection or 'default'}): "
            f"reindexed {live} needles, {dead} tombstones"
        )

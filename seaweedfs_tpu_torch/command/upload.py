"""`upload` — assign fids and upload local files
(reference: weed/command/upload.go; a copy of
seaweedfs_tpu/command/upload.py over the port's operation/assign.py and
operation/upload.py)."""
from __future__ import annotations

import json
import os

NAME = "upload"
HELP = "upload local files via master assign"


def add_args(p) -> None:
    p.add_argument("files", nargs="+", help="local files to upload")
    p.add_argument(
        "-master", dest="master", default="127.0.0.1:9333", help="master host:port"
    )
    p.add_argument("-collection", default="")
    p.add_argument("-replication", default="")
    p.add_argument("-ttl", default="")


async def run(args) -> None:
    import mimetypes

    from ..operation import assign, upload_data
    from ..utils.aiofile import read_file_bytes

    results = []
    for path in args.files:
        data = await read_file_bytes(path)
        a = await assign(
            args.master,
            collection=args.collection,
            replication=args.replication,
            ttl=args.ttl,
        )
        mime = mimetypes.guess_type(path)[0] or ""
        await upload_data(
            f"http://{a.url}/{a.fid}",
            data,
            filename=os.path.basename(path),
            mime=mime,
            jwt=a.auth,
        )
        results.append(
            {"fileName": os.path.basename(path), "fid": a.fid,
             "url": f"{a.url}/{a.fid}", "size": len(data)}
        )
    print(json.dumps(results, indent=2))

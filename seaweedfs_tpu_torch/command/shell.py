"""`shell` — the admin shell (reference: weed/command/shell.go).

    python3 -m seaweedfs_tpu_torch shell -master 127.0.0.1:9333 \\
        -c "lock; ec.encode -volumeId 3; unlock"

reads `;`- or newline-separated commands from `-c`, else from stdin (one
command a line, prompting when stdin is a terminal).  The first failing
command ends the session with exit status 1, after the admin lock, if
held, is released.  The commands are those of shell/commands.py.
"""
from __future__ import annotations

import sys

NAME = "shell"
HELP = "admin shell (lock, ec.encode, ec.rebuild, ec.scrub, ...)"


def add_args(p) -> None:
    p.add_argument(
        "-master", dest="masters", default="127.0.0.1:9333",
        help="comma-separated master servers (host:port or host:port.grpcport)",
    )
    p.add_argument(
        "-c", dest="commands", default=None,
        help="commands to run, separated by ';' (default: read stdin)",
    )


async def run(args) -> None:
    from ..shell import run_script

    masters = [m.strip() for m in args.masters.split(",") if m.strip()]
    if args.commands is not None:
        lines = args.commands.replace(";", "\n").splitlines()
        ok = await run_script(masters, lines)
    else:
        ok = await run_script(masters, None)
    if not ok:
        sys.exit(1)

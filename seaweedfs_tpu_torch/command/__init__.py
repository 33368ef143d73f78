"""CLI command registry of the port (reference: weed/command/command.go).

Each command module exposes NAME, HELP, add_args(parser), and async
run(args).  `python -m seaweedfs_tpu_torch <command> ...` dispatches here.
The port's commands: the servers `master`, `master.follower`, `volume`,
`filer` and `server` (a master, a volume server and, with `-filer`, a
filer in one process); `shell`; the offline volume tools `fix`, `fsck`,
`compact` and `export`; the clients `backup`, `upload`, `download` and
`benchmark`; the filer tools `filer.cat`, `filer.copy`, `filer.meta.tail`,
`filer.meta.backup` and `filer.backup`; and `scaffold`, `autocomplete`
and `version`.  S3, WebDAV, mount, the queue and the replicating filer
tools wait for the rest of the namespace and gateway layers (ROADMAP A10).
"""
from __future__ import annotations

import argparse
import asyncio
import sys

from . import (
    autocomplete,
    backup,
    benchmark,
    compact,
    download,
    export,
    filer,
    filer_backup,
    filer_cat,
    filer_copy,
    filer_meta_backup,
    filer_meta_tail,
    fix,
    fsck,
    master,
    master_follower,
    scaffold,
    server,
    shell,
    upload,
    version,
    volume,
)

COMMANDS = {
    m.NAME: m
    for m in (
        master, master_follower, volume, filer, server, shell, fix, fsck,
        compact, filer_cat, filer_copy, filer_meta_tail, filer_meta_backup,
        filer_backup,
        export, backup, upload, download, benchmark, scaffold, autocomplete,
        version,
    )
}


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="seaweedfs_tpu_torch",
        description="SeaweedFS-compatible storage on PyTorch/CUDA",
    )
    # global profiling flags before the subcommand (reference: every weed
    # command honors -cpuprofile/-memprofile via grace/pprof)
    p.add_argument(
        "-cpuprofile", default="", help="write a cProfile dump here on exit"
    )
    p.add_argument(
        "-memprofile", default="",
        help="write tracemalloc top allocations here on exit",
    )
    sub = p.add_subparsers(dest="command", metavar="command")
    for name, mod in sorted(COMMANDS.items()):
        mod.add_args(sub.add_parser(name, help=mod.HELP))
    return p


def main(argv: list[str] | None = None) -> int:
    p = parser()
    args = p.parse_args(sys.argv[1:] if argv is None else argv)
    if not args.command:
        p.print_help()
        return 2
    from ..utils import profiling

    profiling.maybe_start(args)
    # process-wide mutual TLS from security.toml [tls] (the reference
    # loads the same file for every command)
    from ..security import tls as tls_mod

    tls_mod.configure(tls_mod.from_security_toml())
    try:
        asyncio.run(COMMANDS[args.command].run(args))
    except KeyboardInterrupt:
        pass
    except BrokenPipeError:
        # only stdout-streaming commands (autocomplete) treat a closed pipe
        # (head, less) as success; for a server it is a real failure
        if not getattr(COMMANDS[args.command], "STDOUT_STREAM", False):
            raise
        # the exit-time stdout flush would hit the same broken fd
        import os

        devnull = os.open(os.devnull, os.O_WRONLY)
        os.dup2(devnull, sys.stdout.fileno())
    return 0

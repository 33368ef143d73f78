"""CLI command registry of the port (reference: weed/command/command.go).

Each command module exposes NAME, HELP, add_args(parser), and async
run(args).  `python -m seaweedfs_tpu_torch <command> ...` dispatches here.
The port's commands: `master`, `volume`, `shell` and `version`.
"""
from __future__ import annotations

import argparse
import asyncio
import sys

from . import master, shell, version, volume

COMMANDS = {m.NAME: m for m in (master, shell, version, volume)}


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
    try:
        asyncio.run(COMMANDS[args.command].run(args))
    except KeyboardInterrupt:
        pass
    return 0

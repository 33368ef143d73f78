"""Shell command registry (reference: weed/shell/commands.go).

A command is an async function `cmd(env, args: list[str])` registered under
its dotted name; `help` text comes from the docstring.  The port registers
the modules it has ported: lock/unlock, the EC verbs (ec.encode,
ec.rebuild, ec.scrub, ec.balance, ec.decode), the repair plane's
volume.repair.status / pause / resume, cluster.health, cluster.slo,
cluster.timeline, cluster.tail, cluster.incident.dump, and the readers of
the device planes (volume.device.status, volume.device.attribution,
volume.tier.status, volume.ingest.status, volume.trace,
volume.trace.why).  The other cluster.* and volume.* commands wait for
ROADMAP A4c-5 and A4c-6, fsck for A4c-6, and fs, s3, mq and remote for
A10.
"""
from __future__ import annotations

import shlex
from typing import Awaitable, Callable

from .command_env import CommandEnv

CommandFn = Callable[[CommandEnv, list[str]], Awaitable[None]]

COMMANDS: dict[str, CommandFn] = {}


def command(name: str):
    def register(fn: CommandFn) -> CommandFn:
        COMMANDS[name] = fn
        return fn

    return register


def parse_flags(args: list[str]) -> dict[str, str]:
    """Go-style flags: -name value | -name=value | -bool (value 'true')."""
    out: dict[str, str] = {}
    i = 0
    while i < len(args):
        a = args[i]
        if a.startswith("-"):
            key = a.lstrip("-")
            if "=" in key:
                key, _, val = key.partition("=")
                out[key] = val
            elif i + 1 < len(args) and not args[i + 1].startswith("-"):
                out[key] = args[i + 1]
                i += 1
            else:
                out[key] = "true"
        else:
            out.setdefault("", a)
        i += 1
    return out


async def run_command(env: CommandEnv, line: str) -> None:
    parts = shlex.split(line.strip())
    if not parts:
        return
    name, args = parts[0], parts[1:]
    if name in ("help", "?"):
        for cmd in sorted(COMMANDS):
            doc = (COMMANDS[cmd].__doc__ or "").strip().splitlines()
            env.write(f"  {cmd:<28} {doc[0] if doc else ''}")
        return
    fn = COMMANDS.get(name)
    if fn is None:
        raise ValueError(f"unknown command {name!r}; type 'help'")
    await fn(env, args)


# import side-effect registration
from . import command_cluster  # noqa: E402,F401
from . import command_ec  # noqa: E402,F401
from . import command_lock  # noqa: E402,F401
from . import command_repair  # noqa: E402,F401
from . import command_volume  # noqa: E402,F401

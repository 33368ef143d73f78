"""Admin shell (reference: weed/shell/; the port of seaweedfs_tpu/shell/).

`weed shell` equivalent: commands registered in commands.COMMANDS,
executed against a CommandEnv holding master stubs and the exclusive admin
lock.  Usable programmatically (the tests call run_command), as a script
(run_script: the `shell` command's `-c` and piped stdin) or interactively
via repl().
"""
from .command_env import CommandEnv, TopoNode
from .commands import COMMANDS, run_command

__all__ = ["CommandEnv", "TopoNode", "COMMANDS", "run_command", "repl",
           "run_script"]


async def repl(masters: list[str]) -> None:
    """Interactive loop (shell_liner.go:28)."""
    import asyncio
    import sys

    env = CommandEnv(masters)
    env.write("seaweedfs-tpu shell; 'help' lists commands, Ctrl-D exits")
    while True:
        sys.stdout.write("> ")
        sys.stdout.flush()
        line = await asyncio.to_thread(sys.stdin.readline)
        if not line:
            break
        try:
            await run_command(env, line)
        except Exception as e:  # noqa: BLE001 — REPL survives command errors
            env.write(f"error: {e}")
    await env.release_lock()


async def run_script(masters: list[str], lines: list[str] | None) -> bool:
    """Run commands in order, stopping at the first failure (printed as
    `error: ...`).  `lines` None reads them from stdin (a terminal gets the
    interactive repl instead).  The admin lock is released at the end
    either way.  -> True when every command succeeded."""
    import sys

    from ..pb import close_all_channels

    if lines is None:
        if sys.stdin.isatty():
            await repl(masters)
            await close_all_channels()
            return True
        lines = sys.stdin.read().splitlines()
    env = CommandEnv(masters)
    ok = True
    try:
        for line in lines:
            if not line.strip() or line.lstrip().startswith("#"):
                continue
            try:
                await run_command(env, line)
            except Exception as e:  # noqa: BLE001 — reported, then stop
                env.write(f"error: {e}")
                ok = False
                break
    finally:
        try:
            await env.release_lock()
        finally:
            await close_all_channels()
    return ok

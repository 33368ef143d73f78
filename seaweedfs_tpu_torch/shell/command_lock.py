"""lock / unlock — the exclusive admin lease every destructive command
requires (reference: weed/shell/command_lock_unlock.go; a copy of
seaweedfs_tpu/shell/command_lock.py)."""
from .commands import command


@command("lock")
async def cmd_lock(env, args):
    """acquire the exclusive admin lock"""
    await env.acquire_lock()
    env.write("locked")


@command("unlock")
async def cmd_unlock(env, args):
    """release the admin lock"""
    await env.release_lock()
    env.write("unlocked")

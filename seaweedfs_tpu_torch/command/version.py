"""`version` — print the framework version (port of
seaweedfs_tpu/command/version.py: the torch build and its CUDA in place of
JAX's version)."""
from __future__ import annotations

NAME = "version"
HELP = "print version"


def add_args(p) -> None:
    pass


async def run(args) -> None:
    import torch

    from .. import __version__

    print(f"seaweedfs-tpu-torch {__version__} (torch {torch.__version__}, "
          f"cuda {torch.version.cuda})")

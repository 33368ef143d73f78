"""`autocomplete` — emit a bash completion script for the CLI
(reference: weed/command/autocomplete.go installs fish/bash/zsh
completion; a copy of seaweedfs_tpu/command/autocomplete.py: the script
prints to stdout and the user sources it).  The script completes the
port's own commands and names `python -m seaweedfs_tpu_torch`."""
from __future__ import annotations

NAME = "autocomplete"
HELP = "print a bash completion script for python -m seaweedfs_tpu_torch"
STDOUT_STREAM = True  # piping into head/less is expected


def add_args(p) -> None:
    pass


async def run(args) -> None:
    from . import COMMANDS

    names = " ".join(sorted(COMMANDS))
    # bash keys completion specs on the command's FIRST word, so
    # `python -m seaweedfs_tpu_torch` can't carry a spec directly — the
    # script ships a `seaweedfs_tpu_torch` wrapper function and completes
    # THAT
    print(
        f"""# bash completion for seaweedfs_tpu_torch
# install:  python -m seaweedfs_tpu_torch autocomplete > ~/.seaweedfs_tpu_torch-completion
#           echo 'source ~/.seaweedfs_tpu_torch-completion' >> ~/.bashrc
seaweedfs_tpu_torch() {{
    python -m seaweedfs_tpu_torch "$@"
}}
_seaweedfs_tpu_torch() {{
    local cur=${{COMP_WORDS[COMP_CWORD]}}
    if [ $COMP_CWORD -eq 1 ]; then
        COMPREPLY=( $(compgen -W "{names}" -- "$cur") )
    fi
}}
complete -F _seaweedfs_tpu_torch seaweedfs_tpu_torch"""
    )

"""`scaffold` — print commented config templates
(reference: weed/command/scaffold.go + command/scaffold/*.toml; a copy of
seaweedfs_tpu/command/scaffold.py whose template names the port's
config module)."""
from __future__ import annotations

NAME = "scaffold"
HELP = "print a commented TOML config template"

# Only templates whose keys are actually consumed belong here — an
# operator tuning a scaffolded knob must see an effect (security.toml is
# read by utils/config.py jwt_signing_key/jwt_expires_sec; the filer store
# and master growth knobs are CLI flags, not config files, for now).
TEMPLATES = {
    "security": """\
# security.toml — discovered in ./, ~/.seaweedfs/, /etc/seaweedfs/
# (seaweedfs_tpu_torch/utils/config.py; reference weed/util/config.go)

[jwt.signing]
# When set, the master signs a JWT for every assigned fid and volume
# servers reject writes/deletes without a valid matching token.
key = ""
# Seconds an issued write token stays valid.
expires_after_seconds = 10

[tls]
# When all three are set, EVERY gRPC surface (master/volume/filer/raft/
# mq) serves mutual TLS and every client presents this certificate
# (reference weed/security/tls.go).
ca = ""
cert = ""
key = ""

[access]
# IPs / CIDR ranges allowed to reach the public HTTP planes; empty =
# open (reference weed/security/guard.go white_list).
white_list = []
""",
}


def add_args(p) -> None:
    p.add_argument(
        "-config", dest="which", default="security",
        choices=sorted(TEMPLATES),
    )


async def run(args) -> None:
    print(TEMPLATES[args.which], end="")

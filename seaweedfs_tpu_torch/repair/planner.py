"""Pure repair planning: cluster EC census -> prioritized work list.

No sockets, no clocks — the scheduler feeds it a snapshot (shard
locations from the master's topology, corrupt-shard scrub verdicts,
stale nodes from the telemetry plane) and gets back `RepairJob`s in
execution order.  Keeping the policy pure is what makes the priority
rules unit-testable without a cluster:

  * a volume ONE shard from data loss (exactly DATA_SHARDS healthy
    shards left) jumps the whole queue — the next failure is
    unrecoverable, so nothing else matters more;
  * below that, most-shards-missing first (the reference operator's
    instinct in `ec.rebuild`, made explicit);
  * corrupt shards count as LOST for severity (their bytes cannot be
    trusted as rebuild input), and shards held only by STALE nodes
    count as lost too (the node may be gone; redundancy must be
    re-established elsewhere) — execution prefers fresh holders, but a
    stale node is SUSPECT, not certified dead: its shards ride the job
    as `rescue` sources, so a volume whose fresh survivors alone are
    under DATA_SHARDS can still be saved by copying off the suspect
    while it answers;
  * volumes where even fresh + stale copies can't reach DATA_SHARDS
    are flagged unrecoverable and NOT queued: burning repair attempts
    on them would starve volumes that can still be saved;
  * mesh pods are a failure domain: members of one
    multi-process pod serve a single residency mesh and
    degrade together, so a volume whose healthy survivors have
    collapsed into ONE pod is one correlated host failure from loss —
    it is escalated to critical even when the raw healthy count still
    shows slack (`node_pods` maps holder url -> pod id; clusters
    without pods pass nothing and plan exactly as before).
"""
from __future__ import annotations

from dataclasses import dataclass, field

from ..storage.ec import DATA_SHARDS, TOTAL_SHARDS


@dataclass
class RepairJob:
    """One volume's planned repair."""

    vid: int
    collection: str
    # shards to re-establish: truly absent + corrupt + stale-held
    missing: list[int]
    # the corrupt subset of `missing`, with the node still holding the
    # bad bytes (sid -> node_url): the executor drops these BEFORE the
    # rebuild so the bad shard can't be gathered as rebuild input
    corrupt: dict[int, str] = field(default_factory=dict)
    # stale-held shards (sid -> stale holder url): suspect copies the
    # executor re-establishes by COPYING onto a fresh node while the
    # suspect still answers (and may gather as rebuild input when
    # fresh survivors alone are under DATA_SHARDS)
    rescue: dict[int, str] = field(default_factory=dict)
    # healthy shard count backing the rebuild (live + uncorrupted)
    healthy: int = 0
    critical: bool = False  # one more loss = data loss
    reason: str = "shard_loss"  # shard_loss | corrupt | stale_node
    # every healthy survivor sits inside ONE mesh pod: a single
    # correlated host failure (any pod member dying) is data loss, so
    # the job escalates to critical regardless of raw healthy count
    pod_exposed: bool = False

    def sort_key(self) -> tuple:
        # critical first; then most missing; vid tiebreak for determinism
        return (not self.critical, -len(self.missing), self.vid)


@dataclass
class PlanResult:
    jobs: list[RepairJob]
    unrecoverable: list[RepairJob]
    healthy_vids: list[int]


def plan(
    shard_map: dict[int, dict[int, str]],
    collections: dict[int, str] | None = None,
    corrupt: dict[int, dict[int, str]] | None = None,
    stale_nodes: set[str] | frozenset[str] = frozenset(),
    node_pods: dict[str, str] | None = None,
) -> PlanResult:
    """`shard_map`: vid -> {shard_id -> holder url} (the master's EC
    census); `corrupt`: vid -> {shard_id -> holder url} scrub verdicts;
    `stale_nodes`: telemetry-stale holder urls; `node_pods`: holder
    url -> mesh-pod id ("", absent = not in a pod) — the host
    failure domain."""
    collections = collections or {}
    corrupt = corrupt or {}
    node_pods = node_pods or {}
    jobs: list[RepairJob] = []
    dead: list[RepairJob] = []
    healthy_vids: list[int] = []
    for vid in sorted(set(shard_map) | set(corrupt)):
        shards = shard_map.get(vid, {})
        bad = dict(corrupt.get(vid, {}))
        stale_held = {
            sid: url for sid, url in shards.items()
            if url in stale_nodes and sid not in bad
        }
        healthy = [
            sid for sid in shards
            if sid not in bad and sid not in stale_held
        ]
        missing = sorted(
            sid for sid in range(TOTAL_SHARDS) if sid not in healthy
        )
        if not missing:
            healthy_vids.append(vid)
            continue
        if bad:
            reason = "corrupt"
        elif stale_held:
            reason = "stale_node"
        else:
            reason = "shard_loss"
        # pod-exposure check: the pods holding the healthy survivors.
        # All of them inside one non-"" pod = one correlated host
        # failure from loss (pod members degrade together)
        healthy_pods = {node_pods.get(shards[sid], "") for sid in healthy}
        pod_exposed = bool(
            healthy and healthy_pods != {""} and len(healthy_pods) == 1
        )
        job = RepairJob(
            vid=vid,
            collection=collections.get(vid, ""),
            missing=missing,
            corrupt=bad,
            rescue=dict(sorted(stale_held.items())),
            healthy=len(healthy),
            critical=len(healthy) <= DATA_SHARDS or pod_exposed,
            reason=reason,
            pod_exposed=pod_exposed,
        )
        if len(healthy) + len(stale_held) < DATA_SHARDS:
            dead.append(job)
        else:
            jobs.append(job)
    jobs.sort(key=RepairJob.sort_key)
    dead.sort(key=RepairJob.sort_key)
    return PlanResult(jobs=jobs, unrecoverable=dead, healthy_vids=healthy_vids)

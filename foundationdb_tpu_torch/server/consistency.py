"""Consistency checker: every replica of every shard must agree.

Ref parity: fdbserver/workloads/ConsistencyCheck.actor.cpp — walk the
shard map, read each shard's contents from every storage server in its
team at one consistent version, and compare exactly; also audit the
shard-map metadata itself (sorted unique boundaries, team sizes, teams
pointing at live-or-known storages). The reference runs this as a
simulation workload after every fault scenario and as an operator tool
(consistencycheck in fdbcli); here it is ``Cluster.consistency_check()``,
which tests call after kill and recruit rounds.

The per-shard replica comparison is ``consistencyscan.
compare_shard_batch`` — the SAME code path the continuous background
scanner (server/consistencyscan.py) walks in bounded batches, so the
one-shot check and the always-on scan can never disagree about what
"consistent" means.

Returns a list of human-readable error strings — empty means consistent.
"""

from foundationdb_tpu_torch.server.consistencyscan import (
    SYSTEM_END, compare_shard_batch,
)

__all__ = ["SYSTEM_END", "consistency_check"]


def consistency_check(cluster, max_keys_per_shard=None):
    errors = []
    version = cluster.sequencer.committed_version
    smap = cluster.dd.map

    # ── shard-map metadata audit ──
    bounds = smap.boundaries
    if bounds[0] != b"":
        errors.append(f"shard map does not start at b'': {bounds[0]!r}")
    for i in range(1, len(bounds)):
        if bounds[i - 1] >= bounds[i]:
            errors.append(
                f"shard boundaries not strictly increasing at {i}: "
                f"{bounds[i-1]!r} >= {bounds[i]!r}"
            )
    n_storages = len(cluster.storages)
    for i, team in enumerate(smap.teams):
        if not team:
            errors.append(f"shard {i} has an empty team")
        if len(set(team)) != len(team):
            errors.append(f"shard {i} team has duplicates: {team}")
        for sid in team:
            if not 0 <= sid < n_storages:
                errors.append(f"shard {i} references unknown storage {sid}")

    # ── replica data comparison, shard by shard (the shared core) ──
    for i in range(len(smap)):
        begin, end = smap.shard_range(i)
        end = SYSTEM_END if end is None else end
        res = compare_shard_batch(
            cluster, i, begin, end, smap.teams[i], version,
            limit=max_keys_per_shard,
        )
        errors.extend(res.errors)
    return errors

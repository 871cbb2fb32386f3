"""System keyspace layout: cluster metadata stored as ordinary keys.

Ref parity: fdbclient/SystemData.cpp — the shard map persists in the
``\\xff/keyServers/`` range (one row per shard boundary whose value
names the owning team) and the configuration under ``\\xff/conf/``.
Because the map lives in the database, its rows ride the same tlog →
storage pipeline as user data, and WAL recovery restores the placement
instead of resetting to full replication.
"""

import json
import struct

KEY_SERVERS_PREFIX = b"\xff/keyServers/"
KEY_SERVERS_END = b"\xff/keyServers0"  # '0' = '/'+1
CONF_REPLICATION = b"\xff/conf/replication"
# the region configuration row (ref: DatabaseConfiguration's region
# blocks); regions are not ported, so nothing reads it yet
CONF_REGIONS = b"\xff/conf/regions"
# the database lock uid (ref: databaseLockedKey): persisted so that the
# lock survives recovery
DB_LOCKED = b"\xff/dbLocked"

# commit idempotency ids (ref: fdbclient/IdempotencyId.actor.cpp, the
# idempotencyIdKeys range): one row per recently committed idempotent
# transaction, id → commit version, written in the same batch as the
# commit's mutations, so the row's presence at a later read version
# proves the commit applied; the proxy clears rows past the retention
IDMP_PREFIX = b"\xff\x02/idmp/"
IDMP_END = b"\xff\x02/idmp0"


def idmp_key(idempotency_id):
    return IDMP_PREFIX + idempotency_id


def pack_version(v):
    return struct.pack(">q", v)


def unpack_version(b):
    return struct.unpack(">q", b)[0]


def encode_shard_map(shard_map):
    """ShardMap → [(key, value)] rows: one row per shard, keyed by its
    begin boundary, valued by its team and sampled size (storage ids
    are stable across recovery: storages are built in engine order)."""
    return [(KEY_SERVERS_PREFIX + begin,
             json.dumps({"team": shard_map.teams[i],
                         "size": shard_map.sizes[i]}).encode())
            for i, begin in enumerate(shard_map.boundaries)]


def decode_shard_map(rows):
    """[(key, value)] rows → (boundaries, teams, sizes), or None when no
    map was persisted or it is torn (no row at b"")."""
    if not rows:
        return None
    boundaries, teams, sizes = [], [], []
    for k, v in rows:
        if not k.startswith(KEY_SERVERS_PREFIX):
            continue
        meta = json.loads(v.decode())
        boundaries.append(k[len(KEY_SERVERS_PREFIX):])
        teams.append([int(s) for s in meta["team"]])
        sizes.append(int(meta.get("size", 0)))
    if not boundaries or boundaries[0] != b"":
        return None
    return boundaries, teams, sizes

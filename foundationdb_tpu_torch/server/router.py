"""Storage router: the client-side view of a partitioned storage tier.

Ref parity: what NativeAPI's key-range → storage-server-interface cache
plus LoadBalance do for the reference client (fdbclient/NativeAPI
getKeyLocation / fdbrpc/LoadBalance.actor.h): every read names a key or
range, the shard map names the owning team, and the request goes to one
replica of that team — with range reads and key-selector walks stitched
across shard boundaries in key order.

The router exposes the same read surface as a single StorageServer —
selector resolution and range reads come from the shared
RangeReadInterface (storage.py) over a cross-shard merged iterator —
so the transaction layer is placement-agnostic: full replication is
just the one-shard case.
"""

from foundationdb_tpu_torch.core.errors import FDBError, err
from foundationdb_tpu_torch.server.storage import RangeReadInterface


class StorageRouter(RangeReadInterface):
    def __init__(self, storages, shard_map, rr_counter):
        self.storages = storages
        self.map = shard_map
        self._rr = rr_counter  # shared round-robin counter (cluster-owned)

    def _pick(self, team):
        """One LIVE replica of a team (ref: LoadBalance — spread reads,
        route around detected-dead interfaces). With every replica dead
        the read fails retryable; recruitment brings one back."""
        live = [sid for sid in team if self.storages[sid].alive]
        if not live:
            raise err("process_behind")
        return self.storages[live[next(self._rr) % len(live)]]

    def storage_for(self, key):
        return self._pick(self.map.team_for(key))

    # ── single-storage invariants preserved across the tier ──
    def _check_version(self, version):
        """Cheap global bounds; the authoritative floor check is per
        consulted storage inside _iter_live, because floors diverge the
        moment a joiner ingests a shard (its floor rises to the source's)
        — a read between two floors must fail TOO_OLD on the raised-floor
        shard, never silently omit its keys."""
        live = [s for s in self.storages if s.alive]
        if not live:
            raise err("process_behind")
        if version < min(s.oldest_version for s in live):
            raise err("transaction_too_old")
        if version > max(s.version for s in live):
            raise err("future_version")

    @property
    def version(self):
        return min(s.version for s in self.storages)

    # ── point ops ──
    def get(self, key, version):
        return self.storage_for(key).get(key, version)

    def read_batch(self, ops):
        """Multiplexed multi-op serve across the tier: point gets
        group per owning storage (one lock crossing per storage per
        batch — StorageServer.read_batch), ranges/selectors serve
        per-op (they may stitch shards). Per-op FDBError slots, never
        batch-fatal — a dead replica fails only its own keys."""
        out = [None] * len(ops)
        groups = {}  # team -> [(index, op)] — ONE replica pick per
        # team per batch (picking per key would round-robin a team's
        # replicas and split the batch into singletons)
        for i, op in enumerate(ops):
            if op[0] == "g":
                try:
                    team = self.map.team_for(op[1])
                except FDBError as e:
                    out[i] = e
                    continue
                groups.setdefault(tuple(team), []).append((i, op))
            else:
                out[i] = self._serve_one(op)
        for team, members in groups.items():
            try:
                st = self._pick(team)
            except FDBError as e:
                for i, _ in members:
                    out[i] = e
                continue
            slots = st.read_batch([op for _, op in members])
            for (i, _), slot in zip(members, slots):
                out[i] = slot
        return out

    def _serve_one(self, op):
        try:
            if op[0] == "r":
                return [
                    (k, v) for k, v in self.get_range(
                        op[1], op[2], op[3], limit=op[4], reverse=op[5]
                    )
                ]
            if op[0] == "s":
                return self.resolve_selector(op[1], op[2])
            raise err("client_invalid_operation")
        except FDBError as e:
            return e

    def watch(self, key, seen_value):
        """Registered on the key's current owner. A shard relocation
        fires affected watches spuriously (the mover's analog of the
        reference erroring watches with wrong_shard_server), so watchers
        re-read rather than hang on a storage that stopped receiving
        the key's mutations."""
        return self.storage_for(key).watch(key, seen_value)

    # ── cross-shard merged iteration (feeds RangeReadInterface) ──
    def _iter_live(self, begin, end, version, reverse=False):
        idxs = self.map.shards_overlapping(begin, end)
        if reverse:
            idxs = list(reversed(idxs))
        for i in idxs:
            sb, se = self.map.shard_range(i)
            b = max(begin, sb)
            if end is None:
                e = se
            elif se is None:
                e = end
            else:
                e = min(end, se)
            storage = self._pick(self.map.teams[i])
            storage._check_version(version)
            yield from storage._iter_live(b, e, version, reverse=reverse)

"""Data distribution: shard map, splits/merges, and team rebalancing.

Ref parity: fdbserver/DataDistribution.actor.cpp + DDTracker/DDQueue —
the reference divides the keyspace into contiguous shards, tracks each
shard's size via storage-server byte samples, splits shards that grow
past the split threshold, merges runs of small shards, and enqueues
RelocateShard moves so every storage team carries a fair share.

The port's is the reference package's control loop, host-side (this is
metadata work; it has no place on the card): a ``ShardMap`` of boundary
→ team, byte accounting fed by the commit proxy, and a ``rebalance()``
round the cluster's caller pumps.
Replication: a shard's team is a list of storage ids; moves copy the
shard's data to the destination before flipping the map, so reads at
old versions keep working (the reference's fetchKeys + TSS-free path).
"""

import bisect

from foundationdb_tpu_torch.utils.trace import TraceEvent


class ShardMap:
    """Contiguous partition of the keyspace: boundaries[i] owns
    [boundaries[i], boundaries[i+1]). boundaries[0] is always b"".

    Per-shard byte accounting lives here (not beside it) so splits and
    merges — wherever they are invoked from — can never desync the
    metadata from the boundaries.

    Ref: keyServers / shardBoundaries in the system keyspace.
    """

    def __init__(self, teams=None):
        self.boundaries = [b""]
        self.teams = [list(teams[0]) if teams else [0]]
        self.sizes = [0]  # sampled bytes per shard
        self.last_keys = [None]  # most recent write per shard

    @classmethod
    def restore(cls, boundaries, teams, sizes=None):
        """Rebuild from persisted system-keyspace rows (ref: reading
        keyServers at recovery)."""
        m = cls()
        m.boundaries = list(boundaries)
        m.teams = [list(t) for t in teams]
        m.sizes = list(sizes) if sizes else [0] * len(boundaries)
        m.last_keys = [None] * len(boundaries)
        return m

    def team_for(self, key):
        return self.teams[bisect.bisect_right(self.boundaries, key) - 1]

    def shard_index(self, key):
        return bisect.bisect_right(self.boundaries, key) - 1

    def shard_range(self, i):
        end = self.boundaries[i + 1] if i + 1 < len(self.boundaries) else None
        return self.boundaries[i], end

    def shards_overlapping(self, begin, end):
        """Indices of shards intersecting [begin, end)."""
        i = self.shard_index(begin)
        out = []
        while i < len(self.boundaries):
            b = self.boundaries[i]
            if end is not None and b >= end:
                break
            out.append(i)
            i += 1
        return out

    def split(self, i, at):
        b, e = self.shard_range(i)
        if not (b < at and (e is None or at < e)):
            raise ValueError(f"split point {at!r} outside shard [{b!r}, {e!r})")
        self.boundaries.insert(i + 1, at)
        self.teams.insert(i + 1, list(self.teams[i]))
        half = self.sizes[i] // 2
        self.sizes[i] -= half
        self.sizes.insert(i + 1, half)
        self.last_keys.insert(i + 1, self.last_keys[i])

    def merge(self, i):
        """Merge shard i+1 into shard i (teams must match)."""
        if i + 1 >= len(self.boundaries):
            raise ValueError("no right neighbor to merge")
        if self.teams[i] != self.teams[i + 1]:
            raise ValueError("cannot merge shards on different teams")
        del self.boundaries[i + 1]
        del self.teams[i + 1]
        self.sizes[i] += self.sizes.pop(i + 1)
        self.last_keys.pop(i + 1)

    def assign(self, i, team):
        self.teams[i] = list(team)

    def __len__(self):
        return len(self.boundaries)


class DataDistributor:
    """The DD control loop over a cluster's storage servers.

    The commit proxy calls ``note_write(key, nbytes)`` per mutation
    (the analog of storage byte sampling); ``rebalance()`` runs one
    round of split / merge / move decisions and returns the moves it
    performed, each as (shard_range, old_team, new_team).
    """

    def __init__(self, storages, shard_map=None, replication=1,
                 max_shard_bytes=250_000, min_shard_bytes=10_000):
        self.storages = storages
        self.replication = min(replication, len(storages))
        self.map = shard_map or ShardMap(
            teams=[list(range(self.replication))]
        )
        self.max_shard_bytes = max_shard_bytes
        self.min_shard_bytes = min_shard_bytes
        self.excluded = set()  # storages being drained (ref: fdbcli exclude)

    def storage_owns_nothing(self, sid):
        """True when no shard's team includes sid — safe to remove."""
        return all(sid not in team for team in self.map.teams)

    def drain_excluded(self):
        """Relocate every shard off excluded storages (ref: DD honoring
        the excluded-servers list: exclusion drains, then the operator
        removes the process). Returns the moves performed this round;
        callers poll storage_owns_nothing to learn when a drain is done."""
        moves = []
        for i, team in enumerate(list(self.map.teams)):
            bad = [s for s in team if s in self.excluded]
            if not bad:
                continue
            load = self.team_bytes()
            candidates = sorted(
                (
                    s for s in range(len(self.storages))
                    if s not in team and s not in self.excluded
                    and self.storages[s].alive
                ),
                key=load.__getitem__,
            )
            if len(candidates) < len(bad):
                continue  # not enough healthy storages; drain stalls
            new_team = [
                s if s not in self.excluded else candidates.pop(0)
                for s in team
            ]
            if self._relocate(i, team, new_team):
                moves.append((self.map.shard_range(i), team, new_team))
        return moves

    def note_write(self, key, nbytes):
        i = self.map.shard_index(key)
        self.map.sizes[i] += nbytes
        self.map.last_keys[i] = key

    def note_clear_range(self, begin, end):
        for i in self.map.shards_overlapping(begin, end):
            self.map.sizes[i] = max(0, self.map.sizes[i] // 2)

    def team_bytes(self):
        out = [0] * len(self.storages)
        for size, team in zip(self.map.sizes, self.map.teams):
            for s in team:
                out[s] += size
        return out

    def rebalance(self):
        moves = []
        self._split_large()
        self._merge_small()
        moves.extend(self.drain_excluded())
        moves.extend(self._move_for_balance())
        return moves

    # ── splits (ref: shardSplitter) ──
    def _split_large(self):
        i = 0
        while i < len(self.map):
            if self.map.sizes[i] > self.max_shard_bytes:
                at = self._split_point(i)
                if at is not None:
                    self.map.split(i, at)
                    TraceEvent("DDShardSplit").detail(
                        index=i, at=at, bytes=self.map.sizes[i] * 2).log()
                    i += 1
            i += 1

    def _split_point(self, i):
        """Median key of the shard from a LIVE owning storage's data."""
        b, e = self.map.shard_range(i)
        team = self.map.teams[i]
        live = [s for s in team if self.storages[s].alive]
        if not live:
            return None  # split waits until recruitment revives an owner
        storage = self.storages[live[0]]
        keys = [k for k, _ in storage.read_range(
            b, e, storage.version, limit=1001)]
        if len(keys) < 2:
            return None
        at = keys[len(keys) // 2]
        return at if b < at else None

    # ── merges (ref: shardMerger) ──
    def _merge_small(self):
        # hysteresis: whatever the configured floor, never merge two
        # shards whose combined size would immediately re-trip the split
        # threshold's neighborhood — otherwise one rebalance() round
        # splits and the next line merges it back, forever
        threshold = min(self.min_shard_bytes, self.max_shard_bytes // 4)
        i = 0
        while i + 1 < len(self.map):
            if (
                self.map.sizes[i] + self.map.sizes[i + 1] < threshold
                and self.map.teams[i] == self.map.teams[i + 1]
            ):
                self.map.merge(i)
            else:
                i += 1

    # ── moves (ref: BgDDMountainChopper / ValleyFiller) ──
    def _move_for_balance(self):
        if len(self.storages) < 2:
            return []
        moves = []
        for _ in range(2):  # bounded moves per round, like DD's queue
            load = self.team_bytes()
            hot = max(range(len(load)), key=load.__getitem__)
            # coldest NON-excluded candidate: a draining storage reads 0
            # bytes and would otherwise be the global min forever,
            # stalling balancing for every healthy storage
            eligible = [
                s for s in range(len(load)) if s not in self.excluded
            ]
            if len(eligible) < 2:
                break
            cold = min(eligible, key=load.__getitem__)
            diff = load[hot] - load[cold]
            if diff < self.max_shard_bytes:
                break
            # biggest shard on `hot` but not `cold` that strictly improves
            # balance (size < diff, else the move just flips the skew)
            cands = [
                i for i, team in enumerate(self.map.teams)
                if hot in team and cold not in team and self.map.sizes[i] < diff
            ]
            if not cands:
                break
            i = max(cands, key=self.map.sizes.__getitem__)
            old_team = list(self.map.teams[i])
            new_team = [cold if s == hot else s for s in old_team]
            if not self._relocate(i, old_team, new_team):
                break  # dead participant: retry after recruitment
            moves.append((self.map.shard_range(i), old_team, new_team))
        return moves

    def _relocate(self, i, old_team, new_team):
        """Copy shard data to joining storages, then flip the map entry
        (ref: fetchKeys then the keyServers commit). Refuses (returns
        False, map untouched) when no live source exists or a joiner is
        dead — exporting a corpse's frozen overlay would install stale
        data under the new map, and a dead joiner's ingest dies with it
        at recruitment."""
        b, e = self.map.shard_range(i)
        live_src = [s for s in old_team if self.storages[s].alive]
        joining = [s for s in new_team if s not in old_team]
        leaving = [s for s in old_team if s not in new_team]
        if not live_src or any(not self.storages[s].alive for s in joining):
            return False
        src = self.storages[live_src[0]]
        if joining:
            export = src.export_shard(b, e)  # one snapshot, k joiners
            for sid in joining:
                self.storages[sid].ingest_shard(b, e, export)
        self.map.assign(i, new_team)
        for sid in leaving:
            # wake watchers parked on the departing replica; they re-read
            # and re-register via the router against the new owner
            self.storages[sid].fire_watches_in_range(b, e)
        TraceEvent("DDRelocateShard").detail(
            begin=b, end=e, old=old_team, new=new_team).log()
        return True

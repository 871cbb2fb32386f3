"""Coordinators: the quorum-replicated cluster-state store.

Ref parity: fdbserver/Coordination.actor.cpp + LeaderElection — a small
set of coordinator processes store the cluster's bootstrap state (who
the current cluster controller / transaction system generation is)
behind a disk-Paxos-like protocol: a value is *the* cluster state iff a
majority of coordinators hold it at the highest ballot.

Ours implements single-decree Paxos per generation slot over
file-backed coordinator states (the reference's OnDemandStore), exposed
as the two operations recovery actually needs:

* ``read_quorum()`` — the highest-generation state any majority holds.
* ``write_quorum(state)`` — commit a new cluster state; fails without a
  live majority (coordinators can be marked down, e.g. by simulation
  fault injection).

Recovery (server/cluster.py) uses this the way the reference's master
recovery does: read the old transaction-system generation from the
coordinated state, lock it by writing generation+1 (a compare-and-swap
on the generation), and only then recruit the new transaction system.
"""

import json
import os
import threading

from foundationdb_tpu_torch.utils.backoff import Backoff


class CoordinatorDown(Exception):
    pass


class GenerationConflict(Exception):
    """A CAS write found a different generation already committed — a
    competing recovery won the slot (ref: the coordinated-state lock
    making concurrent master recoveries mutually exclusive)."""

    def __init__(self, prior):
        super().__init__(f"coordinated state moved: {prior!r}")
        self.prior = prior


class _BallotOutdated(Exception):
    """A majority is reachable but promised a higher ballot (another
    proposer, or our own pre-restart incarnation). Retryable."""


class Coordinator:
    """One coordinator replica: a ballot-versioned register on disk.

    Ref: Coordination.actor.cpp's LocalConfigStore / OnDemandStore.
    """

    def __init__(self, path=None):
        self._lock = threading.Lock()
        self.path = path
        self.alive = True
        self.promised = 0  # highest ballot promised (Paxos phase 1)
        self.accepted_ballot = 0  # ballot of the accepted value
        self.accepted = None  # the accepted cluster state (JSON-able)
        if path and os.path.exists(path):
            with open(path) as f:
                saved = json.load(f)
            self.promised = saved["promised"]
            self.accepted_ballot = saved["accepted_ballot"]
            self.accepted = saved["accepted"]

    def _persist(self):
        if not self.path:
            return
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(
                {
                    "promised": self.promised,
                    "accepted_ballot": self.accepted_ballot,
                    "accepted": self.accepted,
                },
                f,
            )
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.path)

    # ── Paxos phase 1: prepare(ballot) → promise + prior accepted ──
    def prepare(self, ballot):
        with self._lock:
            if not self.alive:
                raise CoordinatorDown()
            if ballot <= self.promised:
                return (False, self.promised, None, 0)
            self.promised = ballot
            self._persist()
            return (True, ballot, self.accepted, self.accepted_ballot)

    # ── Paxos phase 2: accept(ballot, value) ──
    def accept(self, ballot, value):
        with self._lock:
            if not self.alive:
                raise CoordinatorDown()
            if ballot < self.promised:
                return False
            self.promised = ballot
            self.accepted_ballot = ballot
            self.accepted = value
            self._persist()
            return True

    def read(self):
        with self._lock:
            if not self.alive:
                raise CoordinatorDown()
            return (self.accepted_ballot, self.accepted)


class CoordinationQuorum:
    """Client view of the coordinator set (ref: ClientCoordinators).

    All proposals route through here; ballot numbers are made unique per
    proposer by striding (proposer_id + k * n_proposers), the standard
    Paxos ballot partitioning.
    """

    def __init__(self, coordinators, proposer_id=0, n_proposers=1):
        if not coordinators:
            raise ValueError("need at least one coordinator")
        self.coordinators = list(coordinators)
        self.proposer_id = proposer_id
        self.n_proposers = max(1, n_proposers)
        self._ballot = proposer_id

    @classmethod
    def local(cls, n=3, dir_path=None):
        """An in-process quorum of n coordinators (simulation deployment)."""
        if dir_path:
            os.makedirs(dir_path, exist_ok=True)
        coords = [
            Coordinator(
                os.path.join(dir_path, f"coordinator-{i}.json")
                if dir_path
                else None
            )
            for i in range(n)
        ]
        return cls(coords)

    @property
    def quorum_size(self):
        return len(self.coordinators) // 2 + 1

    def _next_ballot(self):
        self._ballot += self.n_proposers
        return self._ballot

    def read_quorum(self):
        """Highest accepted state visible to a majority, or None.

        A read must go through phase 1 to be linearizable (a bare read
        of accepted values could see a stale majority mid-write); this
        is the reference's openDatabase-from-coordinators path.
        """
        value, _ = self._prepare_retrying()
        return value

    def write_quorum(self, state, expect_generation=None):
        """Commit ``state`` as the new cluster state via full Paxos.

        With ``expect_generation``, the write is a compare-and-swap: each
        round's phase 1 re-reads the highest accepted state, and if its
        generation no longer matches, GenerationConflict is raised — so
        two concurrent recoveries that both read generation g cannot both
        commit g+1 (whichever loses the ballot race observes the winner's
        value when it retries). Without it, the slot is overwritten
        unconditionally.

        Raises CoordinatorDown if no majority is reachable. Returns the
        ballot at which the state was committed.
        """
        # ballot races with other proposers: retry with a tiny jittered
        # backoff — two proposers in lockstep re-race every round
        # forever; jittered sleeps break the symmetry (flow Backoff)
        cas_backoff = Backoff(initial_s=0.001, max_s=0.05)
        for attempt in range(10):
            if attempt:
                cas_backoff.sleep()
            prior, ballot = self._prepare_retrying()
            if expect_generation is not None:
                prior_gen = (prior or {}).get("generation", 0)
                if prior_gen != expect_generation:
                    raise GenerationConflict(prior)
            acks = 0
            for c in self.coordinators:
                try:
                    if c.accept(ballot, state):
                        acks += 1
                except CoordinatorDown:
                    pass
            if acks >= self.quorum_size:
                return ballot
        raise CoordinatorDown("could not commit cluster state (ballot races)")

    def _prepare_retrying(self, attempts=10):
        backoff = Backoff(initial_s=0.001, max_s=0.05)
        for attempt in range(attempts):
            if attempt:
                backoff.sleep()  # desynchronize competing proposers
            try:
                return self._prepare_round()
            except _BallotOutdated:
                continue  # _prepare_round already jumped our ballot
        raise CoordinatorDown("ballot races exhausted retries")

    def _prepare_round(self):
        ballot = self._next_ballot()
        promises = 0
        reachable = 0
        best = (0, None)
        max_promised = 0
        for c in self.coordinators:
            try:
                ok, promised, accepted, accepted_ballot = c.prepare(ballot)
            except CoordinatorDown:
                continue
            reachable += 1
            max_promised = max(max_promised, promised)
            if ok:
                promises += 1
                if accepted is not None and accepted_ballot > best[0]:
                    best = (accepted_ballot, accepted)
        if promises < self.quorum_size:
            if max_promised > self._ballot:
                # jump past the competing (or pre-restart) ballot
                k = (max_promised - self.proposer_id) // self.n_proposers + 1
                self._ballot = self.proposer_id + k * self.n_proposers
            if reachable >= self.quorum_size:
                raise _BallotOutdated()
            raise CoordinatorDown(
                f"only {reachable}/{len(self.coordinators)} coordinators "
                f"reachable (need {self.quorum_size})"
            )
        return best[1], ballot

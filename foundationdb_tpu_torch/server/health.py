"""The recovery-state timeline: each transaction-system recovery's phase
breakdown, in a bounded ring the cluster owns.

Ref parity: the recovery_state section of status json and the master
recovery trace events operators graph. ``Cluster._recover_txn_system``
marks each phase after its work: fence (quiesce the old roles and read
the log frontier), cas (win the generation at the coordinators),
recruit (new sequencer, resolvers and proxies), replay (the proxies'
state re-derived), accept (old roles released, commits flow). The
latency prober and the health verdict are not ported.
"""

import time

RECOVERY_PHASES = ("fence", "cas", "recruit", "replay", "accept")


class RecoveryTimeline:
    """Bounded ring of recovery records; survives every recovery it
    records."""

    MAX_RECORDS = 16

    def __init__(self, clock=time.time):
        self.records = []
        self.count = 0  # recoveries ever (the ring forgets, this doesn't)
        self.clock = clock

    def begin(self, trigger, clock_advance=None):
        return _RecoveryRecorder(self, trigger, clock_advance)

    def last_recovery_ms(self):
        return self.records[-1]["total_ms"] if self.records else 0.0

    def snapshot(self):
        return {
            "count": self.count,
            "last_recovery_ms": self.last_recovery_ms(),
            "records": [dict(r) for r in self.records],
        }


class _RecoveryRecorder:
    """One recovery's phase stopwatch. ``clock_advance`` is a
    simulation's hook (each mark consumes a simulated tick); None
    measures real elapsed time."""

    def __init__(self, timeline, trigger, clock_advance):
        self._timeline = timeline
        self._advance = clock_advance
        started = timeline.clock()
        self._last = started
        self.record = {
            "generation": None,
            "trigger": trigger,
            "started_at": round(started, 6),
            "phases": {},
            "total_ms": 0.0,
        }

    def phase(self, name):
        """Close the phase that just ran."""
        if self._advance is not None:
            self._advance()
        now = self._timeline.clock()
        self.record["phases"][name] = round((now - self._last) * 1000, 3)
        self._last = now

    def finish(self, generation, recovered_version):
        self.record["generation"] = generation
        self.record["recovered_version"] = recovered_version
        self.record["total_ms"] = round(
            sum(self.record["phases"].values()), 3)
        tl = self._timeline
        tl.count += 1
        tl.records.append(self.record)
        del tl.records[: -tl.MAX_RECORDS]

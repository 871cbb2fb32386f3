"""Sequencer (Master): the cluster's version authority.

Ref parity: fdbserver/masterserver.actor.cpp getVersion — hands out
strictly increasing commit versions, each a fixed step past the last
(deterministic; the reference's wall-clock advance is not ported). Every
grant also names the version granted just before it (the reference's
GetCommitVersionReply.prevVersion).
"""

import threading


class SequencerDown(Exception):
    """The version authority is dead; GRVs and commits fail retryably."""


class Sequencer:
    def __init__(self, start_version=0):
        self.alive = True
        self._committed = start_version
        self._last_granted = start_version
        self._mu = threading.Lock()

    def kill(self):
        self.alive = False

    def next_commit_versions(self, k, min_advance=1000):
        """Grant ``k`` consecutive chained versions atomically: returns
        [(prev, v), ...] where each ``prev`` is the version granted just
        before ``v``. A backlog takes its whole run in one call."""
        if not self.alive:
            raise SequencerDown()
        with self._mu:
            if not self.alive:  # the kill raced the lock
                raise SequencerDown()
            out = []
            for _ in range(k):
                prev = self._last_granted
                v = prev + min_advance
                self._last_granted = v
                out.append((prev, v))
            return out

    def report_committed(self, version):
        """The proxy reports a batch committed (logged and applied)."""
        if version > self._committed:
            self._committed = version

    @property
    def committed_version(self):
        return self._committed

"""Transaction log: the ordered record of committed mutations, in memory.

Ref parity: fdbserver/TLogServer.actor.cpp — commit proxies push
version-ordered mutation batches; the log pops what storage has made
durable. The write-ahead file, peeks by storage workers, recovery and
the replicated log system are not ported yet.
"""

import bisect


class TLogDown(Exception):
    """This log is dead."""


class TLog:
    def __init__(self):
        self._log = []  # [(version, mutations)] in version order
        self.alive = True
        self.pushes = 0
        self.mutations = 0

    def push(self, version, mutations):
        if not self.alive:
            raise TLogDown()
        if self._log and version <= self._log[-1][0]:
            raise ValueError("tlog push out of order")
        self._log.append((version, mutations))
        self.pushes += 1
        self.mutations += len(mutations)

    def kill(self):
        self.alive = False

    def pop(self, up_to_version):
        """Discard records <= up_to_version (durable downstream)."""
        del self._log[:bisect.bisect_right(self._log, up_to_version,
                                           key=lambda r: r[0])]

    def status(self):
        return {"alive": self.alive, "retained_records": len(self._log),
                "pushes": self.pushes, "mutations": self.mutations}

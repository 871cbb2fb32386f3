"""Jittered exponential backoff — the client retry loop's delay policy.

Ref parity: flow's ``Backoff`` — the delay starts small, grows by a
factor per failure, caps at a maximum, resets on success, and is
jittered so clients retrying against the same process do not re-arrive
in lockstep.
"""

import random
import time


class Backoff:
    def __init__(self, initial_s=0.01, max_s=1.0, growth=2.0, jitter=0.1):
        if growth < 1.0:
            raise ValueError(f"growth must be >= 1.0, got {growth}")
        self.initial_s = float(initial_s)
        self.max_s = float(max_s)
        self.growth = float(growth)
        self.jitter = float(jitter)
        self._current = self.initial_s
        self.attempts = 0  # failures seen since the last reset

    @property
    def current(self):
        """The next un-jittered delay."""
        return min(self._current, self.max_s)

    def delay(self):
        """Next jittered delay in seconds; advances the schedule."""
        base = min(self._current, self.max_s)
        self._current = min(self._current * self.growth, self.max_s)
        self.attempts += 1
        if self.jitter <= 0.0:
            return base
        u = random.random()
        return base * (1.0 + self.jitter * (2.0 * u - 1.0))

    def sleep(self):
        """Take the next backoff sleep; returns the delay slept."""
        d = self.delay()
        if d > 0.0:
            time.sleep(d)
        return d

    def reset(self):
        self._current = self.initial_s
        self.attempts = 0

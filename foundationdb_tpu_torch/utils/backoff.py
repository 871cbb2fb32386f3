"""Jittered exponential backoff — the one retry-delay policy.

Ref parity: flow's ``Backoff`` (flow/genericactors.actor.h) — delay
starts small, grows by a factor per failure, caps at a max, resets on
success, and is jittered so a fleet of clients retrying against the
same recovering process doesn't re-arrive in lockstep. Every retry
sleep in the repo routes through this class; ad-hoc ``time.sleep`` of
a hand-grown delay variable is a flowlint finding (FL001's
manual-backoff extension).

Jitter rides the ``"backoff-jitter"`` named deterministic stream
(core/deterministic.py), so same-seed sims draw identical retry
schedules and production gets real desynchronization for free.

The module-level retry counter (``retry_count()``) is a cheap,
lock-guarded tally of every jittered sleep actually taken.
"""

import time

from foundationdb_tpu_torch.core import deterministic
from foundationdb_tpu_torch.utils import lockdep

_JITTER_STREAM = "backoff-jitter"

_count_lock = lockdep.lock("backoff._count_lock")
_retries = 0


def retry_count():
    """Cumulative process-wide count of backoff sleeps taken."""
    with _count_lock:
        return _retries


def _note_retry():
    global _retries
    with _count_lock:
        _retries += 1


class Backoff:
    """Exponential backoff with seeded jitter, cap, reset-on-success.

    ``delay()`` returns the next jittered delay and advances the
    schedule; ``sleep()`` additionally takes the sleep and bumps the
    process retry counter. ``reset()`` re-arms the schedule after a
    success, matching flow's ``Backoff::onSuccess``.
    """

    def __init__(self, initial_s=0.01, max_s=1.0, growth=2.0,
                 jitter=0.1):
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
        """The next un-jittered delay (what ``delay()`` would base on)."""
        return min(self._current, self.max_s)

    def delay(self):
        """Next jittered delay in seconds; advances the schedule."""
        base = min(self._current, self.max_s)
        self._current = min(self._current * self.growth, self.max_s)
        self.attempts += 1
        if self.jitter <= 0.0:
            return base
        # uniform in [1-j, 1+j): desynchronizes a retrying fleet while
        # keeping the expected delay equal to the un-jittered schedule
        u = deterministic.rng(_JITTER_STREAM).random()
        return base * (1.0 + self.jitter * (2.0 * u - 1.0))

    def sleep(self):
        """Take the next backoff sleep; returns the delay slept."""
        d = self.delay()
        _note_retry()
        if d > 0.0:
            time.sleep(d)
        return d

    def reset(self):
        """Success: the next failure starts from ``initial_s`` again."""
        self._current = self.initial_s
        self.attempts = 0

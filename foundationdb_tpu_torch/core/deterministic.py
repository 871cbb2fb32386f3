"""Named random streams: the seam that makes client-visible entropy
replayable.

Ref parity: flow's ``deterministicRandom()`` (flow/IRandom.h), which the
reference's simulation seeds: each caller draws from a stream named for
its purpose (``rng("idempotency-id")``). Unseeded, a stream is seeded
from OS entropy; ``seed(s)`` re-seeds every stream, present and future,
to ``f"{s}:{name}"``, so two processes seeded alike draw the same ids.
``unseed()`` returns to OS entropy.

``now()`` is the injected clock (the wall clock unless ``set_clock``
swapped it): the region streamer's cadence and its lag in milliseconds
read it, so a test that sets one clock on both packages gets the same
lag. The simulator (sim/simulation.py) seeds the streams and sets its
step clock at every cluster build; ``Simulation.close`` puts the wall
clock back through ``registry().reset_clock()``.
"""

import random
import time

from foundationdb_tpu_torch.utils import lockdep


class _Streams:
    def __init__(self):
        self._lock = lockdep.lock("DeterminismRegistry._lock")
        self._streams = {}
        self._seed = None  # None: OS entropy
        self.clock = time.time

    def rng(self, name):
        with self._lock:
            stream = self._streams.get(name)
            if stream is None:
                stream = (random.Random() if self._seed is None
                          else random.Random(f"{self._seed}:{name}"))
                self._streams[name] = stream
            return stream

    def seed(self, master_seed):
        with self._lock:
            self._seed = master_seed
            for name, stream in self._streams.items():
                stream.seed(f"{master_seed}:{name}")

    def unseed(self):
        with self._lock:
            self._seed = None
            for stream in self._streams.values():
                stream.seed()

    @property
    def seeded(self):
        return self._seed is not None

    def reset_clock(self):
        """Back to the wall clock."""
        self.clock = time.time


_streams = _Streams()


def rng(name):
    """The named stream (one ``random.Random`` per name)."""
    return _streams.rng(name)


def registry():
    """The process's one registry: its streams, ``seeded`` and clock."""
    return _streams


def token_bytes(n, name="token"):
    """``n`` random bytes from the named stream (idempotency ids). Not
    for cryptographic material."""
    return rng(name).getrandbits(8 * n).to_bytes(n, "big")


def seed(master_seed):
    _streams.seed(master_seed)


def unseed():
    _streams.unseed()


def now():
    """The injected clock (``time.time`` unless ``set_clock`` swapped it)."""
    return _streams.clock()


def set_clock(fn):
    _streams.clock = fn

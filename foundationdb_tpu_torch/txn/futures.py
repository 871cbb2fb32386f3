"""Read futures.

Ref parity: fdbclient/NativeAPI.actor.cpp serves every read through
futures — ``Transaction::get`` returns ``Future<Optional<Value>>`` and
the blocking form waits on it. In the in-process cluster a read is
settled when it is issued; the future defers the transaction's per-read
bookkeeping (the read conflict range, the read-your-writes fold) to the
first ``wait()``, as in the JAX package. The read batcher of remote
connections is not ported yet.
"""


class FutureValue:
    """One settled read: its value, or the FDBError it raised. An
    optional ``finalize(value, error)`` runs once, on the first
    ``wait()``, and its result is what ``wait()`` returns from then on."""

    __slots__ = ("_value", "_error", "_finalize")

    def __init__(self, value=None, error=None, finalize=None):
        self._value = value
        self._error = error
        self._finalize = finalize

    def wait(self):
        fin, self._finalize = self._finalize, None
        if self._error is not None:
            if fin is not None:
                fin(None, self._error)
            raise self._error
        if fin is not None:
            self._value = fin(self._value, None)
        return self._value


class FutureRange(FutureValue):
    """A FutureValue resolving to list[(key, value)]."""

    __slots__ = ()

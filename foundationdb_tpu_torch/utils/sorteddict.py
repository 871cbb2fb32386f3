"""SortedDict: a map whose keys can also be walked in order over a range
(``irange``), as the storage overlay and the memory engine need.

The ordered keys live in a list of sorted chunks, each at most
``2 * LOAD`` long, with the largest key of each chunk beside it: an
insert or delete bisects to its chunk and moves at most one chunk's
worth of pointers, so a million-key store takes single inserts and
deletes in microseconds, and a range walk is lazy, chunk by chunk.
Value updates of existing keys touch only the dict. Callers do not
mutate the map while they walk it (they take ``list(irange(...))``
first).
"""

from bisect import bisect_left, bisect_right, insort

LOAD = 512


class SortedDict:
    __slots__ = ("_data", "_chunks", "_maxes")

    def __init__(self):
        self._data = {}
        self._chunks = []  # sorted lists of keys, in key order
        self._maxes = []  # the last key of each chunk

    def __len__(self):
        return len(self._data)

    def __contains__(self, key):
        return key in self._data

    def __getitem__(self, key):
        return self._data[key]

    def get(self, key, default=None):
        return self._data.get(key, default)

    def __setitem__(self, key, value):
        if key not in self._data:
            self._add_key(key)
        self._data[key] = value

    def __delitem__(self, key):
        del self._data[key]
        maxes = self._maxes
        i = bisect_left(maxes, key)
        chunk = self._chunks[i]
        del chunk[bisect_left(chunk, key)]
        if chunk:
            maxes[i] = chunk[-1]
        else:
            del self._chunks[i]
            del maxes[i]

    def _add_key(self, key):
        maxes = self._maxes
        if not maxes:
            self._chunks.append([key])
            maxes.append(key)
            return
        i = bisect_left(maxes, key)
        if i == len(maxes):
            i -= 1
            self._chunks[i].append(key)
            maxes[i] = key
        else:
            insort(self._chunks[i], key)
        chunk = self._chunks[i]
        if len(chunk) > 2 * LOAD:
            half = chunk[LOAD:]
            del chunk[LOAD:]
            self._chunks.insert(i + 1, half)
            maxes[i] = chunk[-1]
            maxes.insert(i + 1, half[-1])

    def _position(self, key, right):
        """(chunk, offset) of the first key >= ``key`` (> when
        ``right``); (number of chunks, 0) past the end."""
        find = bisect_right if right else bisect_left
        i = find(self._maxes, key)
        if i == len(self._maxes):
            return i, 0
        return i, find(self._chunks[i], key)

    def irange(self, minimum=None, maximum=None, inclusive=(True, True),
               reverse=False):
        """Keys in [minimum, maximum] (each end closed or open as
        ``inclusive`` says; None = unbounded), in order or reversed."""
        lo = (0, 0) if minimum is None else self._position(
            minimum, right=not inclusive[0])
        hi = (len(self._chunks), 0) if maximum is None else self._position(
            maximum, right=inclusive[1])
        if lo >= hi:
            return iter(())
        return self._walk(lo, hi, reverse)

    def _walk(self, lo, hi, reverse):
        (i0, j0), (i1, j1) = lo, hi
        last = i1 if j1 else i1 - 1
        spans = range(last, i0 - 1, -1) if reverse else range(i0, last + 1)
        for i in spans:
            chunk = self._chunks[i]
            part = chunk[j0 if i == i0 else 0: j1 if i == i1 else len(chunk)]
            yield from (reversed(part) if reverse else part)

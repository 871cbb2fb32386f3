"""Per-transaction resolution statuses — single source of truth.

Ref: ConflictBatch::TransactionCommitted / TransactionConflict /
TransactionTooOld in fdbserver/SkipList.cpp.
"""

COMMITTED = 0
CONFLICT = 1
TOO_OLD = 2

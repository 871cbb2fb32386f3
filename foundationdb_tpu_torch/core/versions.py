"""Version offsets on the device.

FDB versions are signed 64-bit integers advancing at ~1e6 per wall second
(ref: SERVER_KNOBS->VERSIONS_PER_SECOND). The resolver keeps them on the
device as uint32 *offsets* from a rolling host-held ``base_version``: the
5-second MVCC window spans only 5e6 versions, so 32 bits give ~70 minutes
of headroom between rebases.
"""

VERSIONS_PER_SECOND = 1_000_000
MAX_READ_TRANSACTION_LIFE_VERSIONS = 5 * VERSIONS_PER_SECOND
# Rebase the device window well before uint32 offsets can wrap.
REBASE_THRESHOLD = 1 << 30

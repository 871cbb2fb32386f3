"""Resolver knobs.

``resolver_backend="cuda"`` packs batches into device tensors and runs
ops/conflict.py's step on a CUDA device (or on the CPU when the
Resolver is given ``device="cpu"``); ``"cpu"`` runs the exact host
ConflictSet (resolver/skiplist.py).
"""

import dataclasses


@dataclasses.dataclass
class Knobs:
    resolver_backend: str = "cuda"  # "cuda" | "cpu" (exact host set)
    batch_txn_capacity: int = 1024  # T: txns per resolver batch
    point_reads_per_txn: int = 4  # PR
    point_writes_per_txn: int = 4  # PW
    range_reads_per_txn: int = 2  # RR
    range_writes_per_txn: int = 2  # RW
    hash_table_bits: int = 22  # point-write version table: 2^bits entries
    range_ring_capacity: int = 4096  # recent range-write ring (exact lane)
    coarse_buckets_bits: int = 14  # 2^bits contiguous key buckets
    ring_partition_bits: int = 0  # only the flat ring (0) is ported
    key_limbs: int = 8  # 4*L bytes of exact key prefix on device
    # the ring lanes through the hand-written CUDA kernel (ops/ring.py):
    # "auto" = on for a CUDA device, "on" = always (its plain version on
    # CPU tensors), "off" = always the plain torch lanes
    ring_kernel: str = "auto"
    # the whole accept step (ring check + intra-batch conflicts + greedy
    # acceptance) through the CUDA kernels of ops/accept.py; same
    # tri-state, and "auto" also stays off for shapes the kernel does
    # not take (txns > 1024). Subsumes ring_kernel when engaged.
    accept_kernel: str = "auto"


DEFAULT_KNOBS = Knobs()

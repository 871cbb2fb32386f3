"""Knobs — tunable constants, mirroring flow/Knobs.h / fdbclient/Knobs.h.

``resolver_backend="cuda"`` packs batches into device tensors and runs
ops/conflict.py's step on a CUDA device (or on the CPU when the
Resolver is given ``device="cpu"``); ``"cpu"`` runs the exact host
ConflictSet (resolver/skiplist.py) and ``"native"`` its C++ twin
(native/conflict_set.cpp). The other knobs are those the
database's commit path and client read, with the JAX package's defaults.
"""

import dataclasses


@dataclasses.dataclass
class Knobs:
    # --- resolver ---
    # "cuda" | "cpu" (exact host set) | "native" (its C++ twin)
    resolver_backend: str = "cuda"
    batch_txn_capacity: int = 1024  # T: txns per resolver batch
    point_reads_per_txn: int = 4  # PR
    point_writes_per_txn: int = 4  # PW
    range_reads_per_txn: int = 2  # RR
    range_writes_per_txn: int = 2  # RW
    hash_table_bits: int = 22  # point-write version table: 2^bits entries
    range_ring_capacity: int = 4096  # recent range-write ring (exact lane)
    coarse_buckets_bits: int = 14  # 2^bits contiguous key buckets
    # accepts 0 only, the flat ring (the JAX package's bucket-partitioned
    # ring has no port); kept for the configs and clients that name it
    ring_partition_bits: int = 0
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
    # lane ownership of a multi-lane resolver (Cluster(n_resolvers=k),
    # resolver/meshresolver.py): accepts "range" only, which routes each
    # packed entry on the host to the lane(s) owning its key range
    # (packing.ShardRouter) and runs the compacted per-lane step
    resolver_sharding: str = "range"

    # --- commit path ---
    # "flat": the client pre-encodes conflict ranges into columnar limb
    # blobs (core/flatpack.py) and the proxy and packer consume them
    # without per-txn Python; "legacy" keeps the TxnRequest path. Flat
    # engages per batch only when every request carries blobs of the
    # resolver's width and the resolver accepts them.
    commit_pack_path: str = "flat"
    # proxy-side intra-batch scheduling (server/scheduler.py): reorder a
    # batch host-side so reads resolve before the writes they overlap.
    # On by default, as in the reference; False commits in arrival order.
    commit_batch_scheduling: bool = True
    # client-side transaction repair (txn/repair.py): on a 1020 that
    # carries the conflicting ranges and the rejecting commit version,
    # re-read only the conflicting keys at that version and replay the
    # recorded op log (nothing changed) or re-run the body from the
    # verified read cache, without a GRV and without a backoff. On by
    # default, as in the reference
    txn_repair: bool = True
    # repair rounds in a row before a conflicted transaction falls back
    # to the cold restart (fresh GRV, backoff): the livelock bound
    txn_repair_max_rounds: int = 4

    # --- distributed tracing (utils/span.py) ---
    # fraction of transactions that carry a sampled trace (0: tracing
    # off; Cluster.set_tracing(enabled=True) turns it to 0.01). The
    # draws ride the seeded "span-sample" stream
    tracing_sample_rate: float = 0.0
    # a commit window that outlives this bound emits a promoted
    # ``commit.window`` span even when none of its txns was sampled
    tracing_slow_commit_ms: float = 200.0

    # --- workload attribution (utils/heatmap.py) ---
    # conflict heat charged where the proxy rejects a txn, read and
    # write heat sampled at the storage servers
    workload_sampling: bool = True
    # each heatmap coalesces adjacent ranges to at most this many buckets
    heatmap_max_buckets: int = 64
    # decay half-life on the injected clock: old heat fades
    heatmap_half_life_s: float = 30.0
    # one sampled storage access in this many on average (draws from
    # the "key-sample" stream); the charge weight scales by the stride
    storage_sample_every: int = 16

    # --- cluster doctor (server/health.py) ---
    # the latency prober's GRV → read → commit probe transactions; a
    # thread-mode cluster runs it on a daemon thread, other pipelines
    # call maybe_probe() themselves
    health_probe_enabled: bool = True
    health_probe_interval_s: float = 1.0
    # doctor thresholds: probe p99 (the flight recorder's SLO dump and
    # tools/doctor.py), the longest acceptable recovery (tools/doctor.py),
    # storage durability lag (the storage_lag degraded reason)
    doctor_probe_p99_ms: float = 1000.0
    doctor_recovery_ms: float = 30_000.0
    doctor_lag_versions: int = 5_000_000

    # --- metrics history and flight recorder (utils/timeseries.py) ---
    # one window per cadence samples every registry, heatmap, device
    # profile, the ratekeeper and the verdict into bounded rings; a
    # thread-mode cluster collects on a daemon thread, other pipelines
    # call maybe_collect()
    history_enabled: bool = True
    history_cadence_s: float = 1.0
    history_windows: int = 64  # per-metric ring depth
    history_heat_top: int = 8  # hot-range rows kept per dimension
    # the flight recorder dumps on a verdict change, a recovery or a
    # probe-SLO breach: the last flight_windows windows and the trace
    # tail, in memory and (flight_dir set) as sorted-key JSON files
    flight_windows: int = 16
    flight_trace_tail: int = 64
    flight_max_dumps: int = 8
    flight_dir: str = ""
    # a probe p99 rising over this many windows by this much in all
    # degrades the verdict (probe_trend)
    doctor_trend_windows: int = 3
    doctor_trend_min_rise_pct: float = 5.0

    # --- continuous consistency scan (server/consistencyscan.py) ---
    # the replica auditor walks the shard map in bounded batches at
    # pinned versions; a thread-mode cluster scans on a daemon thread,
    # other pipelines call maybe_scan()
    consistency_scan_enabled: bool = True
    consistency_scan_interval_s: float = 0.25
    consistency_scan_batch_keys: int = 256
    # the next batch waits until the last one's bytes drained at this
    # rate (0: unpaced)
    scan_rate_bytes_per_s: float = 2_000_000.0
    # tools/doctor.py --scan: a completed round older than this, or any
    # confirmed inconsistency, exits 1
    doctor_scan_max_round_age_s: float = 600.0

    # --- multi-region replication (server/region.py) ---
    # the satellite streamer drains the primary log at most once per
    # interval (jittered off the "region-stream" deterministic stream);
    # thread-mode clusters drive it from a daemon loop, others call
    # maybe_stream() or stream_now()
    region_stream_interval_s: float = 0.05
    # replication lag (versions) before the doctor's ``region_lag``, and
    # the longest acceptable region failover (tools/doctor.py)
    doctor_region_lag_versions: int = 2_000_000
    doctor_region_failover_ms: float = 60_000.0

    # --- per-tag auto-throttling (server/ratekeeper.py) ---
    # admission share above which a tag is throttled even without
    # global pressure (ref: TagThrottler's standalone busy-tag policy;
    # the under-pressure path is always on). 1.0 turns the standalone
    # path off: a share never exceeds 1.0
    tag_throttle_busyness: float = 1.0

    # --- versions / MVCC ---
    max_read_transaction_life_versions: int = 5_000_000

    # --- transaction limits (ref: fdbclient/Knobs.h CLIENT_KNOBS) ---
    key_size_limit: int = 10_000
    value_size_limit: int = 100_000
    transaction_size_limit: int = 10_000_000

    # --- retry loop (ref: CLIENT_KNOBS backoff) ---
    max_retry_delay_s: float = 1.0
    initial_backoff_s: float = 0.01
    backoff_growth: float = 2.0

    # --- proxy batching (server/batcher.py, server/grv.py) ---
    commit_batch_interval_s: float = 0.0005
    grv_batch_interval_s: float = 0.0005
    # backlog groups in flight at once in a thread pipeline: group N+1
    # packs and dispatches its resolve while group N logs and applies.
    # 1 = the serial loop; manual mode always runs 1.
    commit_pipeline_depth: int = 2
    # a proxy-fleet version-gate turn unclaimed this long means a peer
    # died between its grant and its advance: 1021, and the proxy kills
    # itself (server/proxy.py GateTimeout)
    gate_timeout_s: float = 60.0

    # --- read batching (txn/futures.py) ---
    # a remote connection's outstanding async reads coalesce into one
    # read_batch RPC of at most max_keys ops; window_ms is an optional
    # linger after the flusher wakes (0: send what is queued). Manual
    # pipelines flush inside submit, for determinism
    read_batch_max_keys: int = 128
    read_batch_window_ms: float = 0.0
    # CPython thread-switch interval of a server process
    # (tools/fdbserver.py): a read-RPC thread waiting on the GIL behind a
    # commit batch waits out the slice, 5 ms at the interpreter default
    server_switch_interval_s: float = 0.0005

    # --- RPC deadlines and the failure monitor (rpc/transport.py,
    #     rpc/failuremon.py, rpc/service.py) ---
    # every remote call carries its class's deadline, enforced by the
    # client reader's sweep: an expired commit-class call answers
    # commit_unknown_result (1021), the other classes process_behind
    # (1037). The commit deadline also bounds the batcher's
    # stranded-batch watchdog (two deadlines plus a grace)
    rpc_deadline_read_s: float = 5.0
    rpc_deadline_grv_s: float = 5.0
    rpc_deadline_commit_s: float = 15.0
    rpc_deadline_admin_s: float = 30.0
    # per-endpoint health memory (ref: fdbrpc/FailureMonitor.actor.cpp):
    # a deadline or a reset marks the endpoint failed and the read router
    # skips it, probing half-open with exponential spacing
    failure_monitor: bool = True
    # keepalive pings on idle client links (jittered off the
    # "ping-cadence" stream); 0 turns the pinger off
    rpc_ping_interval_s: float = 2.0
    # a non-empty seed wraps every new client socket of the process in
    # the seeded fault injector (rpc/chaos.py); "" never imports it
    rpc_chaos_seed: str = ""

    # --- simulation ---
    # process-global BUGGIFY default (sim/buggify.py): `buggify` arms
    # the module-level BUGGIFY singleton at import (Simulation always
    # builds its own seeded instance regardless); `buggify_prob` is the
    # default per-evaluation fire probability for sites that do not
    # pass an explicit fire_p.
    buggify: bool = False
    buggify_prob: float = 0.05


DEFAULT_KNOBS = Knobs()

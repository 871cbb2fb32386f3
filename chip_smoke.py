"""Drive the PyTorch/CUDA Resolver on one card and hold its kernels to
their plain versions.

    python3 chip_smoke.py

Phases:
  1. the card's name and power limit (nvidia-smi);
  2. build csrc/*.cu with nvcc (one process per source, in parallel) and
     print ptxas' registers and shared memory per kernel;
  3. at the default widths (T=1024, W=9, KR=4096), each kernel against its
     plain PyTorch version on the card, on inputs taken from a Resolver's
     own history, with the ring 40% full and after it has wrapped:
     ring_hits in point (Q=4096) and range (Q=2048) mode, fused_accept on
     a Zipfian mixed batch and on a high-conflict batch, and with the
     ring 40% full also on a pipeline-sized batch (33 live txns of 1024)
     and on resolve_many's zero-txn pad batch, accept_sweep on those
     batches' conflict matrices (against jacobi_accept); kernel
     and plain times (``ms``, ``plain_ms``) by CUDA events around
     back-to-back calls, which include the host's cost of each call;
  4. the main path: Resolver() with default knobs (accept kernel on,
     the native packer built by g++ at first use, as in the reference),
     precompiled (every step captured, timed apart), through resolve (12
     batches) and two resolve_many backlogs (depth 12) on YCSB-A,
     range-heavy and mixed streams of 1024-txn batches;
     launch counts are zeroed just before and read just after; then each
     stream's host pack ms by the native and by the numpy packer (their
     22 fields bit-equal), compiled step ms alone, and its busy share;
     after phase 6, each stream's resolve drive again on fresh resolvers
     with each packer, native/numpy/numpy/native in one run (statuses
     equal), so the packers' resolve rates are compared within one call;
  5. the ring-kernel path: the mixed stream again with accept_kernel="off",
     ring_kernel="on", counted the same way;
  6. each phase-3 call's device time by torch.profiler: by kernel
     (``parts_ms``), in all (``device_ms``), and the plain version's
     (``plain_device_ms``); after the timed drives of 4 and 5 (which also
     profile only after their drives), so the main path's drives run
     before any profiler session;
  7. the first batches of each stream replayed on Resolver(device="cpu"):
     statuses and all 12 state fields must be equal;
  8. the database, its launch counts zeroed first: Cluster() on the card
     with default knobs, preloaded with CLUSTER_PRELOAD ``user%08d`` rows
     of YCSB's 1 KB records through commit_batch, then
     CLUSTER_CLIENT_TXNS client transactions (db.run: a get_range of 8
     keys and a set, Zipfian keys; enough calls for a p99), a scripted
     OCC pair that must fail with 1020, and the range-heavy and mixed
     streams as client commit requests, 12 batches of 1024 through
     commit_batch and one backlog of 12 through commit_batches (committed
     txns/s, per-batch commit latency p50 / p99 and the slowest of the
     12 batches for each); fused_accept
     must have launched; then, after the counts are read, where a
     commit_batch call spends its time (host ms by stage, the card's
     busy share); then a card cluster and a CPU cluster, given the same
     small preload and the same first mixed batches, must give the same
     outcomes, rows and resolver state;
  9. the batching commit pipeline, its launch counts zeroed first:
     Cluster(commit_pipeline="thread") on the card with default knobs
     (depth 2, batch cap 1024, 0.5 ms window); PIPE_PRELOAD ``user%08d``
     rows of 1 KB from PIPE_CLIENTS threads of 100-row db.run
     transactions; then PIPE_TXNS mako-style transactions (BASELINE
     config 3: GRV, get, set of a 100-byte field, Zipfian keys) and
     PIPE_TXNS range-heavy ones (config 5's shapes: an 8-key get_range
     and a 4-key clear_range) on the same threads, the range stream
     once more with the batch cap at PIPE_SMALL_CAP so windows split
     into backlog groups that pipeline (fused_accept must launch and
     groups must pipeline); for each stream committed txns/s, retries,
     client and submit→settle latency, batch sizes, the pipeline's
     effective depth and stage means; a 3-proxy fleet's exact
     read-modify-write counters; one deterministic _run_batch on a card
     and a CPU thread cluster: outcomes, rows and state must be equal.
     Transaction repair is on (the reference's default client path):
     each stream's repair_attempts / repair_commits / repair_fallbacks,
     repair_attempts > 0 on mako, and a scripted conflict (read k,
     another txn rewrites k with its value, write k) that must get the
     conflicting range and conflict_version and then commit on a
     verbatim replay, its body run once;
 10. the lane-sharded resolver (BASELINE config 5's 3 Resolvers), launch
     counts zeroed first (fused_accept and ring_hits must launch 0 times,
     as the reference runs no Pallas kernel on the mesh or the
     partitioned ring; accept_sweep accepts over their conflict
     matrix): (a) Cluster(n_resolvers=3) on the card in "range" mode,
     CLUSTER_PRELOAD rows, the range-heavy stream as client requests,
     12 commit_batch then one commit_batches of 12 (committed txns/s,
     per-batch p50 / p99 / slowest, the router's per-lane entries and
     chunk factors, the card memory of the lanes' state); (b) the same
     in "hash" mode at a smaller preload and depth; (c) a card and a CPU
     3-lane cluster in both modes, the same small preload and first
     range-heavy and mixed batches: outcomes, rows and state equal;
     (d) Resolver(ring_partition_bits=2) on the range-heavy and mixed
     streams (12 resolve, one resolve_many of 12), then a CPU replay;
 11. (run after 7) the compiled step against the eager step: for each
     stream of phase 4 and the ring route, a Resolver whose steps are
     graph replays and a twin whose steps are ops/conflict.resolve_batch
     run eagerly on a second state on the card take the same batches (12
     resolve, a resolve_many of 12, then 6 resolve under torch.profiler;
     each Resolver precompiled first, so the drive captures nothing):
     statuses and all 12 state fields must be equal; for each, resolved
     txns/s, p50 / p99 ms a batch, host ms a dispatch, the card's busy
     share, captures and replays;
 12. durability and recovery, modelled on the FoundationDB ``ssd``
     engine (the sqlite B-tree, server/kvstore.py) under three
     replicated logs, fsync on, in a temporary directory: (a)
     RECOVERY_PRELOAD rows of 1 KB, made durable in the engine, then 12
     range-heavy commit_batch calls (committed txns/s, p50 / p99 a
     batch; fused_accept must launch), one log killed and 2 batches more,
     the cluster dropped without a close and reopened on the same files:
     the seconds to recover (construction to the first committed batch),
     every acknowledged row read back, the generation one higher, a
     pre-crash read version answered 1007, later commits as graph
     replays; (b) 64 client threads of db.run read-modify-write
     increments on Cluster(commit_pipeline="thread") while the commit
     proxy, the sequencer and the proxy again die, each recovered by one
     detect_and_recruit round: each recovery's timeline ms, the first
     commit after it, the card memory after it (the third within 5% of
     the first: dead resolvers keep no graphs), the errors the clients
     rode out (1021 among them) and exact counters; (c) a card and a CPU
     durable cluster given the same preload, batches, dead log, crash,
     reopen and recoveries: outcomes, rows, generations and all 12 state
     fields equal;
 13. the range-heavy stream through Cluster(resolver_backend="native",
     n_resolvers=3) and through the Python host sets ("cpu", 3) on a
     NATIVE_PRELOAD history: equal outcomes and rows, committed txns/s
     for both, the sub-resolve pool's overlap (sub-resolve ms over the
     pool's wall ms); then the native fleet alone on NATIVE_FULL_PRELOAD
     rows (of BASELINE config 5's 1M): its rate and overlap; no kernel
     launch;
 14. double replication, the ratekeeper and system keys, its launch and
     graph counts zeroed first: FoundationDB's ``double`` mode
     (Cluster(n_storage=3, replication=2, n_tlogs=3), in memory) on the
     card; (a) REPL_PRELOAD rows of 1 KB through commit_batch, then
     rebalance() until a round neither moves nor splits a shard (shards,
     moves, team bytes, seconds a round), and the native 3-resolver
     fleet's ranges derived from the map (a read from before a bound
     move answers 1007); (b) the range-heavy stream, 12 commit_batch
     calls and a backlog of 12 (committed txns/s, p50 / p99, and
     against phase 8's), fused_accept launched, a batch's host stage
     split with the routing, the tagged log push and each storage's
     apply; (c) sampled keys and shards read from every replica of
     their team, equal to each other and to the router, here and after
     (d); the size estimate against the preloaded bytes, split points;
     (d) storage 1 killed (its reads served by the other replica),
     recruited from the log holding only the rows it owns (its tagged
     peek equal to its owned mutations), then storage 2 excluded and
     drained; (e) RK_CLIENTS threads of increments on a thread pipeline
     cluster, unthrottled and with target_tps at RK_SHARE of that rate:
     granted GRVs/s within 25% of the target, 1213 for a quota tag and
     never for untagged clients; (f) the lock: a plain commit 1038, a
     lock-aware one commits, after unlocking a plain one commits; (g)
     automatic-idempotency increments on IDMP_COUNTERS counters with one
     batch's log quorum lost and one reply lost: exact counters; (h) a
     WAL-backed double cluster dropped without a close and reopened:
     the shard map, the replication and the lock restored; (i) a card
     and a CPU cluster given the phase's script at TWIN_PRELOAD rows:
     outcomes, rows per storage, the map, admissions under one injected
     clock and the 12 state fields equal;
 15. regions, change feeds, configure() and tenants, its launch and graph
     counts zeroed first, on the JAX region tests' layout (2 storages, 3
     logs, {"primary": "east", "remote": "west", "satellites": 1}) in
     memory: (a) REGION_PRELOAD rows of 1 KB, then configure(regions=)
     with a sync satellite (the seed's rows and seconds), the
     range-heavy stream through 12 commit_batch calls and a backlog of
     12 (committed txns/s, p50 / p99, against phase 8's), a batch's host
     stage split with sync_push; fused_accept launched, every dispatch a
     replay, no sync miss, no lag; (b) a change feed over a sixteenth of
     the keyspace, registered before (a)'s commits: its entries equal
     the committed requests' mutations clipped to it, by version; popped,
     a read from below gets 1007; (c) the whole primary region killed,
     one detect_and_recruit round: the failover ms, the generation one
     higher, every row of (a) read back from the promoted storages, a
     read version from before 1007, the first commit after it a replay
     without a capture, card memory within 5%; (d) an async satellite
     on a fresh cluster: lag during a backlog, none after stream_now(),
     every commit at or below the frontier kept across a failover; (e)
     configure() on (c)'s promoted cluster: 3 lanes (accept_sweep, no
     fused_accept), 1 (fused_accept again), 3 again (card memory within
     5% of the first 3-lane resize's), 1, commit_proxies=3, the same
     call (no recovery), regions off (the row cleared), each resize's
     recovery ms and first commit; (f) TENANTS tenants in mode
     "required" on a WAL-backed thread pipeline: range-heavy shaped
     db.run transactions in them from 64 threads (committed txns/s,
     fused_accept launched), a plain write 2130, a quota's 1213 for its
     tenant only, a restart restoring the mode, the quota and the region
     row; (g) a card and a CPU cluster given the phase's script at
     REGION_TWIN_PRELOAD rows: outcomes, rows per storage, the feed, the
     region status and the 12 state fields equal;
 16. observability, its launch and graph counts zeroed first, on phase
     14's deployment (``double`` replication on 3 storages and 3 logs)
     as a thread pipeline whose latency prober, history collector and
     consistency scanner run on their daemon threads, tracing at
     OBS_TRACING_RATE: (a) OBS_PRELOAD rows of 1 KB and the map settled
     at OBS_SHARD_BYTES a shard,
     every step precompiled, then OBS_TXNS range-heavy db.run
     transactions on 64 threads and an OCC pair: the verdict healthy,
     probes with a commit band, at least 3 history windows, a whole scan
     round with no inconsistency, hot ranges in all three dimensions,
     spans emitted, the device profile's fused_accept route count equal
     to the live batches its dispatches served and to fused_accept's
     launches over the drive less the backlog scans' pads (the script
     tallies each dispatch's route and slots), every fallback cause 0,
     its compiles equal to the graph captures, the roles' latency bands
     and the profile's walls a dispatch; (b) a transaction-system
     recovery and OBS_RECOVERY_TXNS more: committed, started, the
     profile's dispatches and the probes never go back, card memory
     within 5%; (c) a row written on one replica past the commit path:
     the scanner confirms it, the verdict turns degraded with
     data_inconsistent, consistency_check() lists it (both clean
     before); (d) on a sync cluster, OBS_SMOKE_PAIRS interleaved pairs
     of 12-batch range-heavy commit_batch runs with every module on and
     with every module's switch off (tracing at 0): the medians and
     their ratio, printed, not gated; then a pipelined group's
     dispatch under set_sync_debug_mode("error");
     (e) a card and a CPU cluster given the phase's script on a sync
     pipeline at OBS_TWIN_PRELOAD rows under a clock that moves only
     where the script ticks it: the status documents equal apart from
     each resolver's device and graphs and the process-wide trace
     counters. The phase's seconds and the script's are printed.

Every Resolver step runs as a CUDA graph replay (ops/conflict.StaticStep).
Each of phases 4, 5, 8, 9, 10, 12, 14, 15 and 16 zeroes the graph counts with the
launch counts and checks after its drive that it captured, that every
dispatch was a replay, and that no resolver step ran eagerly on the
card (a wrapper counts calls of the eager steps on card tensors outside
a capture); phase 11's twin is the only eager step on the card. A
recovered resolver takes its predecessor's captured steps.

Any failure raises and the script exits non-zero; without a card it exits
non-zero before printing any result. The line before the last is
{"kernels": [...]}; the last is {"ok": true, "device": {...}}.
"""

import contextlib
import gc
import hashlib
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

SEED = 0
RESOLVE_BATCHES = 12  # per stream, one resolve() each
BACKLOG = 12
STREAM_BATCHES = RESOLVE_BATCHES + 2 * BACKLOG  # then two resolve_many
REPLAY_BATCHES = 4
CLUSTER_PRELOAD = 1_000_000  # workloads.NKEYS rows of 1 KB
CLUSTER_CLIENT_TXNS = 512  # a p99 over 512 calls is the 6th slowest
CLUSTER_BATCHES = 12  # per stream through commit_batch, then one backlog
CLUSTER_REPLAY_PRELOAD = 2048
SHARDED_LANES = 3  # BASELINE config 5: "3 Resolvers sharded"
HASH_PRELOAD = 100_000  # phase 10b's preload
HASH_BATCHES = 4  # phase 10b: commit_batch calls, then a backlog as deep
PARTITION_BITS = 2  # phase 10d: 4 sub-rings of 1024
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
# no integer peak is published for the CUDA cores; the non-tensor
# float32 rate is the fastest rate any 32-bit scalar op could retire at,
# so dividing by it keeps the bound a lower bound
SCALAR_OPS_PER_S = 67e12


def log(*a):
    print(*a, flush=True)


EAGER_STEPS = [0]  # eager resolver steps on the card outside a capture


def count_eager_steps():
    """Wrap ops/conflict's eager steps so that each call on card tensors
    outside a StaticStep's capture (its warm-up on a scratch state, or
    the capture itself) counts in EAGER_STEPS."""
    from foundationdb_tpu_torch.ops import conflict as ck

    for name in ("resolve_batch", "resolve_batch_presharded"):
        def counted(state, *a, _fn=getattr(ck, name), **kw):
            if state.window_start.device.type == "cuda" and not ck.capturing():
                EAGER_STEPS[0] += 1
            return _fn(state, *a, **kw)

        setattr(ck, name, counted)


def reset_counts():
    """Zero the launch, graph and eager-step counts before a path."""
    from foundationdb_tpu_torch.ops import _kernels
    from foundationdb_tpu_torch.ops import conflict as ck

    _kernels.reset_launches()
    ck.reset_graph_counts()
    EAGER_STEPS[0] = 0


def graph_report(label):
    """The graph counts of the path just driven. Fails unless it
    captured, every step it dispatched on the card was a replay, and no
    resolver step ran eagerly on the card."""
    from foundationdb_tpu_torch.ops import conflict as ck

    g = dict(ck.graph_counts, eager_steps=EAGER_STEPS[0])
    log(f"[{label}] graphs: {g['captures']} captures, {g['replays']} replays "
        f"of {g['dispatches']} dispatches, {g['eager_steps']} eager steps "
        "on the card")
    assert g["captures"] > 0 and g["dispatches"] > 0, (label, g)
    assert g["replays"] == g["dispatches"], (label, g)
    assert g["eager_steps"] == 0, (label, g)
    return g


def cuda_ms(fn, reps):
    """Mean milliseconds per call, warmed, by CUDA events around calls
    launched back to back: for a chain of torch ops this includes the
    gaps the host leaves between them."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def io_bytes(*ts):
    """Bytes the function must move for these tensors, each once: a limb,
    hash or version is a uint32 quantity (4 bytes; the port holds them
    zero-extended in int64, which the bound does not charge), a mask or
    an output bit one byte."""
    return sum(t.numel() * (1 if t.dtype == torch.bool else 4) for t in ts)


def bound_ms(nb, ops):
    t_bytes = nb / HBM_BYTES_PER_S * 1e3
    t_ops = ops / SCALAR_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def lex_depth(a, b):
    """Limbs a lexicographic compare of a and b reads: up to and
    including the first that differs."""
    prefix = torch.cumprod((a == b).to(torch.int64), dim=-1).sum(-1)
    return torch.clamp(prefix + 1, max=a.shape[-1])


def ring_ops(qlo, qhi, rv, active, rb, re, ring_v, ring_m, point):
    """Integer ops the ring walk needs on these inputs: a live/newer test
    per (query, entry) pair up to the query's first hit, and for live
    newer entries the limb compares the two bounds need (the second
    only when the first passes)."""
    from foundationdb_tpu_torch.ops.intervals import lex_lt

    KR = ring_v.shape[0]
    total = 0
    idx = torch.arange(KR, device=qlo.device)
    for c in range(0, qlo.shape[0], 256):
        lo, hi = qlo[c:c + 256, None], qhi[c:c + 256, None]
        ln = ring_m[None] & (ring_v[None] > rv[c:c + 256, None])
        if point:
            first = ~lex_lt(lo, rb[None])
            d = lex_depth(lo, rb[None]) + first * lex_depth(lo, re[None])
            ov = first & lex_lt(lo, re[None])
        else:
            first = lex_lt(lo, re[None])
            d = lex_depth(lo, re[None]) + first * lex_depth(hi, rb[None])
            ov = first & lex_lt(rb[None], hi)
        hit = ov & ln
        stop = torch.where(hit.any(1), hit.to(torch.int8).argmax(1), KR - 1)
        walked = (idx[None] <= stop[:, None]) & active[c:c + 256, None]
        total += int((walked * (2 + d * ln)).sum())
    return total


def accept_ops(state, batch, a0):
    """Integer ops of the accept step on these inputs, for the admissible
    txns (a0) only, as no other txn can change an accepted bit: the ring
    walk of their live read slots, the pair tiles (every pair w < r of
    them, every hash pair, and the limb compares of every live slot pair
    of the interval lanes) and one test per txn for the sweep."""
    T = a0.shape[0]
    W = batch.pr_key.shape[-1]
    ring = (state.ring_b, state.ring_e, state.ring_v, state.ring_mask)
    PR, PW = batch.pr_key.shape[1], batch.pw_key.shape[1]
    RR, RW = batch.rr_b.shape[1], batch.rw_b.shape[1]
    rvq = batch.rv[:, None]
    ops = ring_ops(batch.pr_key.reshape(-1, W), batch.pr_key.reshape(-1, W),
                   rvq.expand(T, PR).reshape(-1),
                   (batch.pr_mask & a0[:, None]).reshape(-1), *ring,
                   point=True)
    ops += ring_ops(batch.rr_b.reshape(-1, W), batch.rr_e.reshape(-1, W),
                    rvq.expand(T, RR).reshape(-1),
                    (batch.rr_mask & a0[:, None]).reshape(-1), *ring,
                    point=False)
    upper = torch.ones((T, T), dtype=torch.bool, device=batch.rv.device).triu(1)
    upper &= a0[:, None] & a0[None, :]
    ops += int(upper.sum()) * PW * PR
    lanes = []  # (writer keys lo/hi, writer mask, reader lo/hi, reader mask)
    for s1 in range(PW):
        for s2 in range(RR):
            lanes.append((batch.pw_key[:, s1], batch.pw_key[:, s1],
                          batch.pw_mask[:, s1], batch.rr_b[:, s2],
                          batch.rr_e[:, s2], batch.rr_mask[:, s2]))
    for s1 in range(RW):
        for s2 in range(PR):
            lanes.append((batch.rw_b[:, s1], batch.rw_e[:, s1],
                          batch.rw_mask[:, s1], batch.pr_key[:, s2],
                          batch.pr_key[:, s2], batch.pr_mask[:, s2]))
        for s2 in range(RR):
            lanes.append((batch.rw_b[:, s1], batch.rw_e[:, s1],
                          batch.rw_mask[:, s1], batch.rr_b[:, s2],
                          batch.rr_e[:, s2], batch.rr_mask[:, s2]))
    for wlo, whi, wm, rlo, rhi, rm in lanes:
        live = upper & wm[:, None] & rm[None, :]
        d = lex_depth(wlo[:, None], rlo[None]) + lex_depth(whi[:, None],
                                                           rhi[None])
        ops += int((d * live).sum())
    return ops + T


def phase_build():
    from foundationdb_tpu_torch.ops import _kernels

    secs = _kernels.build()
    log(f"[build] nvcc for {', '.join(_kernels.SOURCES)} in {secs:.1f} s")
    for name in _kernels.SOURCES:
        for line in _kernels.build_logs.get(name, "").splitlines():
            if "registers" in line or "Compiling entry" in line or "spill" in line:
                log(f"[ptxas {name}] {line.strip()}")
    for name in _kernels.SOURCES:
        _kernels.lib(name)


def dynamic_smem(p):
    """Bytes of dynamic shared memory each kernel's launch asks for (the
    sizes fdb_ring_hits and fdb_fused_accept pass; ptxas reports only
    static shared memory: 16 bytes of warp words in each ring walk, 0
    elsewhere)."""
    W, T = p.key_width, p.txns
    nw = (T + 31) // 32
    ring_walk = 4 * 32 * (2 * W + 2)  # lex.cuh ring_walk_smem_bytes
    # accept.cu pairs_smem_words: 32 txns a side, a 4-word prefix per key,
    # a hash and a mask per point slot, a mask per range slot
    PR, PW = p.point_reads, p.point_writes
    RR, RW = p.range_reads, p.range_writes
    pairs = 4 * 32 * (4 * (PR + 2 * RR + PW + 2 * RW) + 2 * PR + RR + 2 * PW
                      + RW)
    return {"ring_hits_kernel": ring_walk, "accept_ring_kernel": ring_walk,
            "accept_pairs_kernel": pairs, "accept_pack_kernel": 0,
            # accept.cu sweep_smem_words: 4 word arrays and the staged rows
            "accept_sweep_kernel": 4 * (4 * nw + nw * (T | 1))}


FULL_RING_BATCHES = 24  # mixed batches after which the 4096-entry ring has wrapped
PIPELINE_LIVE = 33  # live txns of a pipeline-sized batch (phase 9: 12-33 a batch)


def kernel_inputs():
    """Two histories of a Resolver driven by Zipfian mixed batches, each
    with the next mixed batch and a high-conflict batch at the same
    versions (the same mix over 64 hot keys), on the Resolver's device:
    after 8 batches (the ring 40% full) and after FULL_RING_BATCHES (the
    ring has wrapped and every slot is live, as in a resolver's steady
    state). Read versions lag up to 5000 versions (about five batches),
    so the ring holds entries newer than them and the ring lanes really
    hit. After 8 batches also two sparse batches at the same versions:
    the first PIPELINE_LIVE txns of the next mixed batch (the size of a
    pipeline batch), and the zero-txn pad batch resolve_many adds to a
    backlog. Returns the params and [(label, state, {case: batch})]."""
    from foundationdb_tpu_torch import workloads
    from foundationdb_tpu_torch.convert import batch_from_numpy
    from foundationdb_tpu_torch.resolver.resolver import Resolver

    r = Resolver()
    n = FULL_RING_BATCHES + 1
    stream = workloads.mixed(n, seed=SEED + 1, lag=5000)
    hot = workloads.mixed(n, seed=SEED + 2, nkeys=64, lag=5000)

    def packed(b):
        return batch_from_numpy(r.packer.pack(b[0], r.base_version, *b[1:]),
                                r.device)

    histories = []
    for i, (txns, cv, ws) in enumerate(stream[:-1]):
        r.resolve(txns, cv, ws)
        if i + 1 in (8, FULL_RING_BATCHES):
            state = type(r.state)(*(f.clone() for f in r.state))
            nxt = stream[i + 1]
            batches = {"zipfian mixed": packed(nxt),
                       "high-conflict": packed(hot[i + 1])}
            label = ", full ring"
            if i + 1 == 8:
                label = ""
                batches[f"{PIPELINE_LIVE} live of {r.params.txns}"] = packed(
                    (nxt[0][:PIPELINE_LIVE], *nxt[1:]))
                batches["pad batch"] = batch_from_numpy(
                    r.packer.pack_empty(r.base_version, *nxt[1:]), r.device)
            histories.append((label, state, batches))
    return r.params, histories


def kernel_cases():
    """Each case of phase 3: a dict with the kernel's name, the case's
    label, ``fn`` (the wrapper's call), ``plain`` (its plain version's
    call) and ``cost`` (a call giving the bound's bytes and ops)."""
    from foundationdb_tpu_torch.ops import accept
    from foundationdb_tpu_torch.ops.accept import (
        conflict_matrix,
        fused_accept,
        fused_accept_plain,
        jacobi_accept,
    )
    from foundationdb_tpu_torch.ops.ring import ring_hits, ring_hits_plain

    # chip_ab.py probes older trees with these cases: those before the
    # sweep have no accept_sweep to hold
    sweep_accept = getattr(accept, "sweep_accept", None)

    params, histories = kernel_inputs()
    T, W = params.txns, params.key_width
    cases = []
    for suffix, state, batches in histories:
        zipf = batches["zipfian mixed"]
        ring = (state.ring_b, state.ring_e, state.ring_v, state.ring_mask)
        log(f"[inputs{suffix}] T={T} W={W} KR={state.ring_v.shape[0]} live "
            f"ring entries={int(state.ring_mask.sum())}")
        for mode, lo, hi, mask in (
                ("point", zipf.pr_key, zipf.pr_key, zipf.pr_mask),
                ("range", zipf.rr_b, zipf.rr_e, zipf.rr_mask)):
            S = lo.shape[1]
            args = (lo.reshape(T * S, W), hi.reshape(T * S, W),
                    zipf.rv[:, None].expand(T, S).reshape(-1).contiguous(),
                    *ring)
            point = mode == "point"

            def cost(args=args, point=point, ring=ring):
                active = torch.ones_like(args[2], dtype=torch.bool)
                ops = ring_ops(*args[:3], active, *ring, point=point)
                # point mode reads the key once (qhi is qlo and unread)
                reads = args[:1] + args[2:] if point else args
                return io_bytes(*reads) + args[0].shape[0], ops  # + hit bits

            cases.append(dict(
                kernel="ring_hits", case=f"{mode} Q={T * S}{suffix}",
                fn=lambda a=args, p=point: ring_hits(*a, point_mode=p),
                plain=lambda a=args, p=point: ring_hits_plain(*a, point_mode=p),
                plain_reps=5, cost=cost))
        for label, b in batches.items():
            a0 = b.txn_mask & ~(b.rv < state.window_start)

            def cost(state=state, b=b, a0=a0):
                # the tensors fdb_fused_accept reads, and the accepted bits
                nb = io_bytes(a0, b.rv, b.pw_hash, b.pw_mask, b.pw_key,
                              b.pr_hash, b.pr_mask, b.pr_key, b.rr_b, b.rr_e,
                              b.rr_mask, b.rw_b, b.rw_e, b.rw_mask,
                              state.ring_b, state.ring_e, state.ring_v,
                              state.ring_mask)
                return nb + T, accept_ops(state, b, a0)

            cases.append(dict(
                kernel="fused_accept", case=label + suffix,
                fn=lambda s=state, b=b, a=a0: fused_accept(s, b, params, a),
                plain=lambda s=state, b=b, a=a0: fused_accept_plain(
                    s, b, params, a),
                plain_reps=3, cost=cost))
            if sweep_accept is None:
                continue
            # the plain routes' acceptance over this batch's conflict matrix
            O = conflict_matrix(b, params)
            cases.append(dict(
                kernel="accept_sweep", case=label + " O" + suffix,
                fn=lambda a=a0, O=O: sweep_accept(a, O),
                plain=lambda a=a0, O=O: jacobi_accept(a, O),
                plain_reps=5, cost=lambda a=a0, O=O: sweep_cost(a, O)))
    return params, cases


def sweep_cost(a0, O):
    """accept_sweep's bytes (a0 and O read once, the accepted bits
    written) and ops (one ballot word per 32 pairs, one candidate test
    per txn, and a word OR per accepted row per word), from the accepted
    count of these inputs."""
    from foundationdb_tpu_torch.ops.accept import jacobi_accept

    T = a0.shape[0]
    nw = (T + 31) // 32
    accepted = int(jacobi_accept(a0, O).sum())
    return io_bytes(a0, O) + T, T * nw + T + accepted * nw


def phase_kernels():
    """Each kernel against its plain version on every case of
    kernel_cases, and both timed by CUDA events around back-to-back
    calls. Returns the cases by kernel, each with its call for
    phase_parts."""
    params, cases = kernel_cases()
    log("[smem] dynamic shared memory per block at these widths: " + ", ".join(
        f"{k} {v} B" for k, v in dynamic_smem(params).items()))
    results = {"ring_hits": [], "fused_accept": [], "accept_sweep": []}
    for c in cases:
        got, want = c["fn"](), c["plain"]()
        torch.cuda.synchronize()
        err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
        mism = int((got != want).sum())
        ms = cuda_ms(c["fn"], 20)
        pms = cuda_ms(c["plain"], c["plain_reps"])
        nb, ops = c["cost"]()
        bms, by = bound_ms(nb, ops)
        results[c["kernel"]].append(dict(
            case=c["case"], hits=int(got.sum()), mismatches=mism,
            max_abs_err=err, ms=ms, plain_ms=pms, bound_ms=bms, bound_by=by,
            ops=ops, fn=c["fn"], plain=c["plain"],
            plain_reps=c["plain_reps"]))
        log(f"[{c['kernel']} {c['case']}] hits/accepted={int(got.sum())} "
            f"mismatches={mism} kernel {ms:.4f} ms plain {pms:.4f} ms "
            f"bound {bms:.5f} ms ({by})")
    return results


def phase_parts(results):
    """Each phase-3 case's device ms per call by kernel (``parts_ms``),
    their sum (``device_ms``) and the plain version's device ms
    (``plain_device_ms``), all by torch.profiler."""
    for name, cases in results.items():
        names = PARTS[name]
        for c in cases:
            c["parts_ms"] = kernel_parts(c.pop("fn"), 20, names)
            c["device_ms"] = sum(c["parts_ms"].values())
            c["plain_device_ms"] = kernel_parts(
                c.pop("plain"), c.pop("plain_reps"), ())["other"]
            log(f"[parts {name} {c['case']}] device ms per call "
                f"{c['device_ms']:.4f} (" + ", ".join(
                    f"{k} {v:.4f}" for k, v in c["parts_ms"].items())
                + f"); plain {c['plain_device_ms']:.4f}")


# the kernels of one fused_accept / accept_sweep call, by profiler name
ACCEPT_PARTS = ("accept_ring_kernel", "accept_pairs_kernel",
                "accept_sweep_kernel")
SWEEP_PARTS = ("accept_pack_kernel", "accept_sweep_kernel")
PARTS = {"fused_accept": ACCEPT_PARTS, "accept_sweep": SWEEP_PARTS,
         "ring_hits": ("ring_hits_kernel",)}


def kernel_parts(fn, reps, names, tries=5):
    """Device ms per call of each kernel whose profiler name starts with
    one of ``names``, and of all other device work together ("other": for
    a wrapper, the memset that clears the hit bytes), over ``reps``
    warmed calls of ``fn`` under torch.profiler. The profiler now and
    then loses a kernel's events, so a profile in which a named kernel
    shows fewer than ``reps`` launches is taken again; fails after
    ``tries`` such profiles."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = dict.fromkeys((*names, "other"), 0.0)
        seen = dict.fromkeys(names, 0)
        for e in prof.key_averages():
            n = next((n for n in names if e.key.startswith(n)), "other")
            us[n] += getattr(e, "self_device_time_total", 0)
            if n in seen:
                seen[n] += e.count
        if all(c == reps for c in seen.values()):
            return {n: v / reps / 1e3 for n, v in us.items()}
        log(f"[parts] profile lost events: {seen} of {reps}; again")
    raise RuntimeError(f"kernel launches in the profile: {seen}, not {reps}")


def drive(r, stream):
    """resolve() for the first RESOLVE_BATCHES, then resolve_many backlogs
    of BACKLOG; returns statuses, per-batch resolve wall ms, and each
    backlog's wall ms."""
    out, walls, backlog_ms = [], [], []
    for txns, cv, ws in stream[:RESOLVE_BATCHES]:
        t0 = time.perf_counter()
        out.append(r.resolve(txns, cv, ws))
        walls.append((time.perf_counter() - t0) * 1e3)
    for i in range(RESOLVE_BATCHES, len(stream), BACKLOG):
        t0 = time.perf_counter()
        out.extend(r.resolve_many(stream[i:i + BACKLOG]))
        torch.cuda.synchronize()
        backlog_ms.append((time.perf_counter() - t0) * 1e3)
    return out, walls, backlog_ms


def step_split(r, stream, use_fast):
    """Host pack ms per batch, by the resolver's native packer (the
    default) and by the numpy packer, whose arrays must be bit-equal;
    and the compiled step's ms per batch alone: the step (its batch copy
    and its replay) by CUDA events over the packed batches, compiled
    anew over a copy of the history and captured before the timing;
    then a profiled run of the same steps (device_profile)."""
    from foundationdb_tpu_torch.ops import conflict as ck
    from foundationdb_tpu_torch.resolver.packing import BatchPacker

    packer, params = (r._fast_packer, r._fast_params) if use_fast else (
        r.packer, r.params)
    assert packer._native is not None, "the resolver packs natively"
    numpy_packer = BatchPacker(params, use_native=False)
    pack_ms = {}
    for label, p in (("native", packer), ("numpy", numpy_packer)):
        t0 = time.perf_counter()
        out = [p.pack(t, r.base_version, cv, ws) for t, cv, ws in stream]
        pack_ms[label] = (time.perf_counter() - t0) * 1e3 / len(stream)
        if label == "native":
            packed = out
    for a, b in zip(packed, out):
        for f, x, y in zip(a._fields, a, b):
            x, y = np.asarray(x), np.asarray(y)
            assert x.dtype == y.dtype and np.array_equal(x, y), \
                f"native and numpy packs differ in {f}"
    step = ck.make_resolve_fn(params, type(r.state)(*(f.clone()
                                                      for f in r.state)))
    step.run(packed[0])  # the capture
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for b in packed:
        step.run(b)
    end.record()
    torch.cuda.synchronize()
    return pack_ms, start.elapsed_time(end) / len(packed), device_profile(
        lambda: [step.run(b) for b in packed])


PACKER_ORDER = ("native", "numpy", "numpy", "native")  # phase 4's A/B


def phase_packers(streams):
    """Phase 4's resolve drive with each packer in one run: per stream,
    fresh precompiled resolvers that pack natively (the default) or with
    numpy, driven over the same batches in PACKER_ORDER; every drive's
    statuses must be equal. Returns each packer's resolve txns/s and p50
    ms per drive. Outside the main path's counts (phase_main took them)."""
    from foundationdb_tpu_torch.core.options import Knobs
    from foundationdb_tpu_torch.resolver.packing import BatchPacker
    from foundationdb_tpu_torch.resolver.resolver import Resolver

    report = {}
    for name, stream in streams.items():
        n1 = sum(len(t) for t, _, _ in stream[:RESOLVE_BATCHES])
        got = {k: dict(resolve_txns_per_s=[], resolve_p50_ms=[])
               for k in PACKER_ORDER}
        first = None
        for kind in PACKER_ORDER:
            r = Resolver(Knobs())
            if kind == "numpy":
                r.packer = BatchPacker(r.params, use_native=False)
                if r._fast_packer is not None:
                    r._fast_packer = BatchPacker(r._fast_params,
                                                 use_native=False)
            r.precompile()
            out, walls, _ = drive(r, stream)
            r.release()
            first = first or out
            assert out == first, f"{name}: the {kind} packer's statuses differ"
            got[kind]["resolve_txns_per_s"].append(n1 / (sum(walls) / 1e3))
            got[kind]["resolve_p50_ms"].append(float(np.percentile(walls, 50)))
        report[name] = got
        log(f"[main {name}] resolve by packer, one run, order "
            f"{'/'.join(PACKER_ORDER)}: " + "; ".join(
                f"{k} " + ", ".join(f"{v:.0f}" for v in
                                    got[k]["resolve_txns_per_s"])
                + " txns/s (p50 " + ", ".join(
                    f"{v:.3f}" for v in got[k]["resolve_p50_ms"]) + " ms)"
                for k in got) + "; statuses equal")
    return report


def device_profile(fn, top=4):
    """Where one run of ``fn`` spends the card's time, by torch.profiler:
    the device's busy share of the host wall time (every kernel and copy,
    synchronised at the end) and the kernels that take most of it. Only
    device activity is traced: with host ops traced too, each torch op's
    device time would count twice, under the op and under its kernel."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_name = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", 0)
        if us > 0:
            by_name[e.key] = by_name.get(e.key, 0) + us
    busy_us = sum(by_name.values())
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return dict(busy_share=busy_us / wall_us, busy_ms=busy_us / 1e3,
                wall_ms=wall_us / 1e3,
                top=[(name.split("(")[0][:48], us / busy_us)
                     for name, us in ranked])


def phase_main(streams, knobs, label, reset=True):
    from foundationdb_tpu_torch.core.status import COMMITTED
    from foundationdb_tpu_torch.ops import _kernels
    from foundationdb_tpu_torch.resolver.resolver import Resolver

    report = {}
    resolvers = {}
    if reset:
        reset_counts()
    for name, stream in streams.items():
        r = Resolver(knobs)
        t0 = time.perf_counter()
        keys = r.precompile()  # a server's start-up: every capture
        precompile_s = time.perf_counter() - t0
        out, walls, backlog_ms = drive(r, stream)
        ntx = sum(len(t) for t, _, _ in stream)
        n1 = sum(len(t) for t, _, _ in stream[:RESOLVE_BATCHES])
        flat = [s for b in out for s in b]
        assert len(flat) == ntx and all(s in (0, 1, 2) for s in flat)
        report[name] = dict(
            txns=ntx, committed=flat.count(COMMITTED),
            resolve_txns_per_s=n1 / (sum(walls) / 1e3),
            resolve_many_txns_per_s=(ntx - n1) / (sum(backlog_ms) / 1e3),
            resolve_p50_ms=float(np.percentile(walls, 50)),
            resolve_p99_ms=float(np.percentile(walls, 99)),
            backlog_ms=backlog_ms, precompile_s=precompile_s,
            precompiled=len(keys), graphs=r.status()["graphs"],
        )
        resolvers[name] = (r, out)
        log(f"[{label} {name}] precompiled {len(keys)} steps in "
            f"{precompile_s:.3f} s; then {ntx} txns, committed "
            f"{report[name]['committed']}; resolve "
            f"{report[name]['resolve_txns_per_s']:.0f} txns/s (p50 "
            f"{report[name]['resolve_p50_ms']:.3f} ms, p99 "
            f"{report[name]['resolve_p99_ms']:.3f} ms per batch); "
            f"resolve_many(depth {BACKLOG}) "
            f"{report[name]['resolve_many_txns_per_s']:.0f} txns/s (backlogs "
            + ", ".join(f"{ms:.3f}" for ms in backlog_ms) + " ms)")
    launches = dict(_kernels.launches)
    if reset:
        report["graphs"] = graph_report(label)
    for name, (r, _) in resolvers.items():
        use_fast = r._fast_packer is not None and not r._range_history
        pack_ms, step_ms, prof = step_split(r, streams[name][:8], use_fast)
        report[name].update(host_pack_ms=pack_ms["native"],
                            host_pack_numpy_ms=pack_ms["numpy"],
                            device_step_ms=step_ms, step_profile=prof)
        log(f"[{label} {name}] host pack {pack_ms['native']:.3f} ms native "
            f"(numpy {pack_ms['numpy']:.3f} ms, the 22 arrays bit-equal) vs "
            f"compiled step {step_ms:.3f} ms per batch "
            f"({'fast' if use_fast else 'full'} variant)")
        log(f"[{label} {name}] 8 steps: device busy {prof['busy_ms']:.3f} ms "
            f"of {prof['wall_ms']:.3f} ms wall ({prof['busy_share']:.1%}); "
            "top " + ", ".join(f"{n} {s:.1%}" for n, s in prof["top"]))
    log(f"[{label}] launches {launches}")
    return report, launches


def phase_replay(streams, knobs=None, label="replay"):
    """The first batches of each stream on the card and on the CPU: the
    statuses and the state must be equal."""
    from foundationdb_tpu_torch.convert import state_to_numpy
    from foundationdb_tpu_torch.core.options import DEFAULT_KNOBS
    from foundationdb_tpu_torch.resolver.resolver import Resolver

    knobs = knobs or DEFAULT_KNOBS
    for name, stream in streams.items():
        gpu, cpu = Resolver(knobs), Resolver(knobs, device="cpu")
        first = stream[:REPLAY_BATCHES]
        got = [gpu.resolve(*b) for b in first[:2]] + gpu.resolve_many(first[2:])
        want = [cpu.resolve(*b) for b in first[:2]] + cpu.resolve_many(first[2:])
        assert got == want, f"{name}: statuses differ between card and CPU"
        for f, a, b in zip(gpu.state._fields, state_to_numpy(gpu.state),
                           state_to_numpy(cpu.state)):
            assert np.array_equal(a, b), f"{name}: state field {f} differs"
        log(f"[{label} {name}] {REPLAY_BATCHES} batches: card == CPU "
            f"(statuses and 12 state fields)")


def _outcomes(results):
    """Each request's commit version, or ("error", code)."""
    from foundationdb_tpu_torch.core.errors import FDBError

    return [("error", r.code) if isinstance(r, FDBError) else r
            for r in results]


def phase_cluster(streams):
    """The database on the card (phase 8): preload, then client
    transactions, the OCC pair and the two streams through the commit
    proxy, with the kernel launch counts of that traffic."""
    from foundationdb_tpu_torch import workloads
    from foundationdb_tpu_torch.core.errors import FDBError
    from foundationdb_tpu_torch.ops import _kernels
    from foundationdb_tpu_torch.server.cluster import Cluster

    reset_counts()
    c = Cluster()
    limbs = c.knobs.key_limbs
    proxy = c.commit_proxy
    t0 = time.perf_counter()
    for reqs in workloads.preload_requests(
            CLUSTER_PRELOAD, limbs, batch=c.knobs.batch_txn_capacity, seed=SEED):
        assert all(isinstance(v, int) for v in proxy.commit_batch(reqs))
    preload_s = time.perf_counter() - t0
    log(f"[cluster] preloaded {CLUSTER_PRELOAD} rows of "
        f"{workloads.FIELDS * workloads.FIELD_BYTES} B through commit_batch "
        f"in {preload_s:.1f} s ({CLUSTER_PRELOAD / preload_s:.0f} rows/s)")
    gc.collect()
    report = dict(preload_rows=CLUSTER_PRELOAD, preload_s=preload_s)
    db = c.database()
    rng = np.random.default_rng(SEED + 3)
    ids = workloads.zipfian_sampler(CLUSTER_PRELOAD, workloads.THETA, rng)(
        CLUSTER_CLIENT_TXNS).tolist()

    def client_txn(tr, i):
        rows = tr.get_range(workloads.user_key(i), workloads.user_key(i + 8))
        tr.set(workloads.user_key(i), rows[0][1][:workloads.FIELD_BYTES] * 2)
        return len(rows)

    walls = []
    for i in ids:
        t0 = time.perf_counter()
        n = db.run(lambda tr, i=i: client_txn(tr, i))
        walls.append((time.perf_counter() - t0) * 1e3)
        assert n == min(8, CLUSTER_PRELOAD - i), (i, n)
    report["client"] = dict(
        txns=len(ids), txns_per_s=len(ids) / (sum(walls) / 1e3),
        p50_ms=float(np.percentile(walls, 50)),
        p99_ms=float(np.percentile(walls, 99)), max_ms=max(walls))
    log(f"[cluster client] {len(ids)} db.run txns (get_range of 8 + set): "
        f"{report['client']['txns_per_s']:.0f} txns/s, p50 "
        f"{report['client']['p50_ms']:.3f} ms, p99 "
        f"{report['client']['p99_ms']:.3f} ms, max "
        f"{report['client']['max_ms']:.3f} ms per txn")
    k = workloads.user_key(ids[0])
    t1, t2 = db.create_transaction(), db.create_transaction()
    t1.get(k)
    t2.set(k, b"t2")
    t2.commit()
    t1.set(workloads.user_key(ids[0] + 1), b"t1")
    try:
        t1.commit()
        raise AssertionError("the OCC pair's second commit succeeded")
    except FDBError as e:
        assert e.code == 1020, e.code
    log("[cluster occ] the reader whose key was overwritten failed with 1020")
    value = b"u" * workloads.FIELD_BYTES
    for name in ("range_heavy", "mixed"):
        report[name] = proxy_stream(c, streams[name], CLUSTER_BATCHES,
                                    CLUSTER_BATCHES, value,
                                    f"cluster {name}")
    launches = dict(_kernels.launches)
    report["graphs"] = graph_report("cluster")
    assert proxy.pack_flat_batches > 0
    assert c.storage.version == c.sequencer.committed_version
    # a committed write reads back: the last client txn's set
    i = ids[-1]
    assert db[workloads.user_key(i)] is not None
    report.update(launches=launches, flat_batches=proxy.pack_flat_batches,
                  legacy_batches=proxy.pack_legacy_batches,
                  flat_fallbacks=c.resolvers[0].counters["flat_fallbacks"])
    log(f"[cluster] launches {launches}; flat batches "
        f"{proxy.pack_flat_batches}, legacy {proxy.pack_legacy_batches}, "
        f"flat fallbacks {c.resolvers[0].counters['flat_fallbacks']}")
    assert launches["fused_accept"] > 0, "fused_accept never launched"
    for name in ("range_heavy", "mixed"):
        batches = streams[name][2 * CLUSTER_BATCHES:
                                2 * CLUSTER_BATCHES + SPLIT_BATCHES]
        report[name]["stage_split"] = split = commit_stage_split(
            c, [lambda t=t, cv=cv: workloads.commit_requests(
                t, cv, c.sequencer.committed_version, limbs, value)
                for t, cv, _ in batches])
        log(f"[cluster {name}] {SPLIT_BATCHES} commit_batch calls, host ms "
            "per batch: " + ", ".join(
                f"{k} {v:.3f}" for k, v in split["host_ms"].items())
            + f" of {split['wall_ms']:.3f} wall; device busy "
            f"{split['device_busy_ms']:.3f} ms per batch "
            f"({split['device_busy_share']:.1%})")
    c.close()
    del c, db
    gc.collect()
    return report, launches


def proxy_stream(c, stream, n_single, n_backlog, value, label,
                 keep_outcomes=False):
    """A stream's batches as client commit requests: ``n_single``
    commit_batch calls, then one commit_batches of the next
    ``n_backlog``. Committed txns/s, per-batch latency p50 / p99 /
    slowest, and the backlog's latency (and with ``keep_outcomes`` every
    request's outcome, under "outcomes")."""
    from foundationdb_tpu_torch import workloads

    proxy, limbs = c.commit_proxy, c.knobs.key_limbs

    def requests(b):
        txns, cv, _ = b
        return workloads.commit_requests(
            txns, cv, c.sequencer.committed_version, limbs, value)

    walls, outs = [], []
    for b in stream[:n_single]:
        reqs = requests(b)
        t0 = time.perf_counter()
        outs.append(_outcomes(proxy.commit_batch(reqs)))
        walls.append((time.perf_counter() - t0) * 1e3)
    backlog = [requests(b) for b in stream[n_single:n_single + n_backlog]]
    t0 = time.perf_counter()
    back = [_outcomes(r) for r in proxy.commit_batches(backlog)]
    backlog_ms = (time.perf_counter() - t0) * 1e3
    ok = [sum(isinstance(v, int) for b in o for v in b)
          for o in (outs, back)]
    codes = {v[1] for b in outs + back for v in b if isinstance(v, tuple)}
    assert codes <= {1020, 1007}, codes
    r = dict(
        commit_batch_txns=sum(map(len, outs)),
        commit_batch_committed=ok[0],
        commit_batch_committed_per_s=ok[0] / (sum(walls) / 1e3),
        commit_batch_p50_ms=float(np.percentile(walls, 50)),
        # of 12 samples, the p99 lies between the two slowest
        commit_batch_p99_ms=float(np.percentile(walls, 99)),
        commit_batch_max_ms=max(walls),
        commit_batches_txns=sum(map(len, back)),
        commit_batches_committed=ok[1],
        commit_batches_committed_per_s=ok[1] / (backlog_ms / 1e3),
        commit_batches_ms=backlog_ms)
    if keep_outcomes:
        r["outcomes"] = outs + back
    log(f"[{label}] commit_batch x{n_single}: "
        f"{r['commit_batch_committed']} of {r['commit_batch_txns']} "
        f"committed, {r['commit_batch_committed_per_s']:.0f} committed "
        f"txns/s, p50 {r['commit_batch_p50_ms']:.3f} ms, p99 "
        f"{r['commit_batch_p99_ms']:.3f} ms, max "
        f"{r['commit_batch_max_ms']:.3f} ms of {len(walls)} batches; "
        f"commit_batches (one backlog of {n_backlog}): "
        f"{r['commit_batches_committed']} of {r['commit_batches_txns']} "
        f"committed, {r['commit_batches_committed_per_s']:.0f} committed "
        f"txns/s, every batch's latency {backlog_ms:.3f} ms")
    return r


SPLIT_BATCHES = 6  # per stream, for the stage split after the timed drives


def commit_stage_split(c, batches, extra_sites=None):
    """Where a commit_batch call spends its time, over ``batches`` (each
    a call that builds a batch's requests, outside the timed calls)
    after the timed drives: host ms per batch in the
    scheduler, the batch build, the resolver (pack, copy, device step
    and the status copy back), and the finalize (results, tlog push,
    storage apply, the apply also alone), by timers around those
    methods; and the card's busy time over the same calls by
    torch.profiler (device events only)."""
    from torch.profiler import ProfilerActivity, profile

    proxy, resolver, storage = c.commit_proxy, c.resolvers[0], c.storage
    sites = {"schedule": (proxy, "_maybe_schedule"),
             "build": (proxy, "_build_txns"),
             "resolve": (resolver, "resolve"),
             "finalize": (proxy, "_finalize_batch"),
             "storage_apply": (storage, "apply"), **(extra_sites or {})}
    spent = dict.fromkeys(sites, 0.0)

    def timed(name, fn):
        def call(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                spent[name] += time.perf_counter() - t0
        return call

    for name, (obj, attr) in sites.items():
        setattr(obj, attr, timed(name, getattr(obj, attr)))
    try:
        wall = 0.0
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for make in batches:
                reqs = make()
                t0 = time.perf_counter()
                proxy.commit_batch(reqs)  # ends in the statuses' copy back
                wall += time.perf_counter() - t0
    finally:
        for obj, attr in sites.values():
            delattr(obj, attr)  # the instance wrapper; the method is back
    busy_us = sum(getattr(e, "self_device_time_total", 0)
                  for e in prof.key_averages())
    n = len(batches)
    return dict(host_ms={k: v * 1e3 / n for k, v in spent.items()},
                wall_ms=wall * 1e3 / n, device_busy_ms=busy_us / 1e3 / n,
                device_busy_share=busy_us / 1e6 / wall)


def phase_cluster_replay(streams):
    """A card cluster and a CPU cluster with the same preload and the same
    first mixed batches (two commit_batch calls, then a backlog of two):
    outcomes, rows and the 12 state fields must be equal."""
    from foundationdb_tpu_torch import workloads
    from foundationdb_tpu_torch.convert import state_to_numpy
    from foundationdb_tpu_torch.server.cluster import Cluster

    def drive(c):
        limbs = c.knobs.key_limbs
        out = []
        for reqs in workloads.preload_requests(
                CLUSTER_REPLAY_PRELOAD, limbs,
                batch=c.knobs.batch_txn_capacity, seed=SEED):
            out.append(_outcomes(c.commit_proxy.commit_batch(reqs)))

        def requests(b):
            return workloads.commit_requests(
                b[0], b[1], c.sequencer.committed_version, limbs, b"r")

        first = streams["mixed"][:REPLAY_BATCHES]
        for b in first[:2]:
            out.append(_outcomes(c.commit_proxy.commit_batch(requests(b))))
        out += [_outcomes(r) for r in c.commit_proxy.commit_batches(
            [requests(b) for b in first[2:]])]
        return out, c.database().get_range(b"", b"\xff"), state_to_numpy(
            c.resolvers[0].state)

    gpu, cpu = drive(Cluster()), drive(Cluster(device="cpu"))
    assert gpu[0] == cpu[0], "cluster outcomes differ between card and CPU"
    assert gpu[1] == cpu[1], "cluster rows differ between card and CPU"
    for f, a, b in zip(type(gpu[2])._fields, gpu[2], cpu[2]):
        assert np.array_equal(a, b), f"cluster state field {f} differs"
    log(f"[cluster replay] preload {CLUSTER_REPLAY_PRELOAD} rows + "
        f"{REPLAY_BATCHES} mixed batches: card == CPU ({len(gpu[1])} rows, "
        f"outcomes and 12 state fields)")


def lanes_report(c):
    """The lane fleet's router balance and the card memory its state
    holds (the lanes' global arrays, int64 for uint32 quantities)."""
    r = c.resolvers[0]
    routed = r._router is not None
    return dict(lanes=r.n_lanes, sharding=r.sharding,
                lane_entries=r.lane_entries.tolist() if routed else None,
                split_chunks=({str(k): v for k, v in sorted(r.split_chunks.items())}
                              if routed else None),
                state_bytes=sum(t.numel() * t.element_size() for t in r.state),
                state_device=str(r.state.ht.device))


def phase_sharded(streams):
    """Phase 10a and 10b: Cluster(n_resolvers=3) on the card in "range"
    and "hash" mode. Launch counts are zeroed first and read last, over
    10a-10d: no kernel may launch on these paths."""
    from foundationdb_tpu_torch import workloads
    from foundationdb_tpu_torch.ops import _kernels
    from foundationdb_tpu_torch.server.cluster import Cluster

    reset_counts()
    report = {}
    value = b"u" * workloads.FIELD_BYTES
    for mode, rows, depth in (("range", CLUSTER_PRELOAD, CLUSTER_BATCHES),
                              ("hash", HASH_PRELOAD, HASH_BATCHES)):
        c = Cluster(n_resolvers=SHARDED_LANES, resolver_sharding=mode)
        assert len(c.resolvers) == 1 and c.resolvers[0].n_lanes == SHARDED_LANES
        t0 = time.perf_counter()
        for reqs in workloads.preload_requests(
                rows, c.knobs.key_limbs, batch=c.knobs.batch_txn_capacity,
                seed=SEED):
            assert all(isinstance(v, int)
                       for v in c.commit_proxy.commit_batch(reqs))
        preload_s = time.perf_counter() - t0
        gc.collect()
        r = dict(preload_rows=rows, preload_s=preload_s)
        log(f"[sharded {mode}] Cluster(n_resolvers={SHARDED_LANES}, "
            f"resolver_sharding={mode!r}): preloaded {rows} rows in "
            f"{preload_s:.3f} s ({rows / preload_s:.0f} rows/s)")
        r["range_heavy"] = proxy_stream(
            c, streams["range_heavy"], depth, depth, value,
            f"sharded {mode} range_heavy")
        r.update(lanes_report(c))
        limbs = c.knobs.key_limbs
        batches = streams["range_heavy"][2 * depth:2 * depth + SPLIT_BATCHES]
        router = c.resolvers[0]._router
        r["stage_split"] = split = commit_stage_split(
            c, [lambda t=t, cv=cv: workloads.commit_requests(
                t, cv, c.sequencer.committed_version, limbs, value)
                for t, cv, _ in batches],
            {"route": (router, "split")} if router is not None else None)
        log(f"[sharded {mode}] {SPLIT_BATCHES} commit_batch calls, host ms "
            "per batch: " + ", ".join(
                f"{k} {v:.3f}" for k, v in split["host_ms"].items())
            + f" of {split['wall_ms']:.3f} wall; device busy "
            f"{split['device_busy_ms']:.3f} ms per batch "
            f"({split['device_busy_share']:.1%})")
        assert c.storage.version == c.sequencer.committed_version
        assert c.database()[workloads.user_key(rows - 1)] is not None
        routed = (f"router lane entries {r['lane_entries']}, chunk factors "
                  f"{r['split_chunks']}; " if r["lane_entries"] else "")
        log(f"[sharded {mode}] {routed}lanes' state {r['state_bytes']} "
            f"bytes on {r['state_device']}")
        c.close()
        del c
        gc.collect()
        report[mode] = r
    return report


def phase_sharded_replay(streams):
    """Phase 10c: a card and a CPU 3-lane cluster in each mode, the same
    small preload, the first range-heavy and mixed batches through
    commit_batch and the next two through one commit_batches: outcomes,
    rows and the 12 state fields must be equal."""
    from foundationdb_tpu_torch import workloads
    from foundationdb_tpu_torch.convert import state_to_numpy
    from foundationdb_tpu_torch.server.cluster import Cluster

    for mode in ("range", "hash"):
        def drive(device):
            c = Cluster(device=device, n_resolvers=SHARDED_LANES,
                        resolver_sharding=mode)
            limbs = c.knobs.key_limbs
            out = []
            for reqs in workloads.preload_requests(
                    CLUSTER_REPLAY_PRELOAD, limbs,
                    batch=c.knobs.batch_txn_capacity, seed=SEED):
                out.append(_outcomes(c.commit_proxy.commit_batch(reqs)))

            def requests(b):
                return workloads.commit_requests(
                    b[0], b[1], c.sequencer.committed_version, limbs, b"r")

            rh, mx = streams["range_heavy"], streams["mixed"]
            for b in (rh[0], mx[0]):
                out.append(_outcomes(c.commit_proxy.commit_batch(requests(b))))
            out += [_outcomes(r) for r in c.commit_proxy.commit_batches(
                [requests(rh[1]), requests(mx[1])])]
            res = (out, c.database().get_range(b"", b"\xff"),
                   state_to_numpy(c.resolvers[0].state))
            c.close()
            return res

        gpu, cpu = drive(None), drive("cpu")
        assert gpu[0] == cpu[0], f"{mode}: outcomes differ between card and CPU"
        assert gpu[1] == cpu[1], f"{mode}: rows differ between card and CPU"
        for f, a, b in zip(type(gpu[2])._fields, gpu[2], cpu[2]):
            assert np.array_equal(a, b), f"{mode}: state field {f} differs"
        log(f"[sharded replay {mode}] preload {CLUSTER_REPLAY_PRELOAD} rows + "
            f"2 range-heavy and 2 mixed batches on {SHARDED_LANES} lanes: "
            f"card == CPU ({len(gpu[1])} rows, outcomes and 12 state fields)")


def phase_partitioned(streams):
    """Phase 10d: Resolver(ring_partition_bits=2) on the card over the
    range-heavy and mixed streams (12 resolve, one resolve_many of 12),
    then a CPU replay of their first batches."""
    from foundationdb_tpu_torch.core.options import Knobs

    knobs = Knobs(ring_partition_bits=PARTITION_BITS)
    part = {name: streams[name][:RESOLVE_BATCHES + BACKLOG]
            for name in ("range_heavy", "mixed")}
    report, _ = phase_main(part, knobs, "partitioned", reset=False)
    phase_replay(part, knobs, "partitioned replay")
    return report


PIPE_PRELOAD = 1_000_000  # BASELINE config 2's key count, 1 KB rows
PIPE_PRELOAD_ROWS = 100  # rows per blind-set preload transaction
PIPE_CLIENTS = 64  # client threads (BASELINE config 3: 64 clients)
# per client stream: 78 transactions a thread (20,032 until phase 16
# came: this cut and phase 13's native preload pay for its time)
PIPE_TXNS = 4_992
FLEET_PROXIES = 3
FLEET_INCREMENTS = 200  # read-modify-write increments per thread
FLEET_COUNTERS = 16
PIPE_REPLAY_REQUESTS = 128  # 8 chunks of 16: two pipelined groups of 4
PIPE_SMALL_CAP = 16  # requests per chunk in the pipelined range stream
# the cap-16 stream's depth: under transaction repair its hot-range
# conflicts resubmit without a backoff and the stream ran 220 s at
# 20,032 transactions on an H100 (PERF.md §6); a quarter of those keeps the
# run near 7 minutes
PIPE_SMALL_CAP_TXNS = 5_056  # 79 transactions a thread
CLIENT_DEADLINE_S = 400  # a client stream that outlasts this has hung
# phases 9-15 measure their thread pipelines without the prober, the
# history collector and the scanner, as before those existed; phase 16
# runs them
QUIET = dict(health_probe_enabled=False, history_enabled=False,
             consistency_scan_enabled=False)


def run_clients(n, body):
    """``body(i)`` on ``n`` daemon threads started together; returns the
    wall seconds. Raises the first client error, or if a thread hangs."""
    import threading

    errors = []
    start = threading.Barrier(n + 1)
    deadline = time.monotonic() + CLIENT_DEADLINE_S

    def run(i):
        try:
            start.wait(60)
            body(i)
        except BaseException as e:
            errors.append(e)

    ts = [threading.Thread(target=run, args=(i,), daemon=True)
          for i in range(n)]
    for t in ts:
        t.start()
    start.wait(60)
    t0 = time.perf_counter()
    for t in ts:
        t.join(max(0.0, deadline - time.monotonic()))
    wall = time.perf_counter() - t0
    if any(t.is_alive() for t in ts):
        raise RuntimeError("a client thread hung")
    if errors:
        raise errors[0]
    return wall


def repair_counts(c):
    """The transaction-repair outcomes the clients reported to the commit
    proxy (a fleet's first member)."""
    return dict(c._inner_proxies()[0].repair_counts)


def pipeline_report(c, wall, txns, walls_ms, retries, launches0, repair0,
                    label):
    """One client stream's numbers: committed txns/s, retries (body
    reruns), repair outcomes, client latency, the batcher's submit→settle
    latency, batch sizes, the pipeline's effective depth and stage
    split, and the kernel launches of the stream."""
    from foundationdb_tpu_torch.ops import _kernels

    bp = c.commit_proxy
    summ = bp.stage_summary()
    r = dict(
        txns=txns, wall_s=wall, committed_txns_per_s=txns / wall,
        conflicts_retried=retries,
        repair={k: v - repair0[k] for k, v in repair_counts(c).items()},
        client_p50_ms=float(np.percentile(walls_ms, 50)),
        client_p99_ms=float(np.percentile(walls_ms, 99)),
        batches=bp.batches_committed,
        mean_batch=bp.txns_batched / max(bp.batches_committed, 1),
        max_batch=bp.max_batch_seen,
        launches={k: v - launches0[k] for k, v in _kernels.launches.items()},
        stages=summ)
    log(f"[pipeline {label}] {txns} txns on {PIPE_CLIENTS} threads in "
        f"{wall:.3f} s: {r['committed_txns_per_s']:.1f} committed txns/s, "
        f"{retries} body reruns, repair {r['repair']}; client p50 "
        f"{r['client_p50_ms']:.3f} "
        f"/ p99 {r['client_p99_ms']:.3f} ms; submit->settle p50 "
        f"{summ['commit_e2e_p50_ms']:.3f} / p99 {summ['commit_e2e_p99_ms']:.3f}"
        f" ms; {r['batches']} batches, mean {r['mean_batch']:.2f} txns, max "
        f"{r['max_batch']}; pipeline depth effective "
        f"{summ['pipeline_depth_effective']} over {summ['pipelined_groups']} "
        f"pipelined groups; stage ms pack {summ['stage_pack_ms']}, dispatch "
        f"{summ['stage_dispatch_ms']}, resolve {summ['stage_resolve_ms']}, "
        f"apply {summ['stage_apply_ms']}; launches {r['launches']}")
    return r


def timed_client_stream(c, db, make_txn, txns=None):
    """``txns`` transactions (PIPE_TXNS by default), txns / PIPE_CLIENTS
    on each thread: ``make_txn(i, j)`` gives thread i's j-th transaction
    body. Returns the report's raw inputs."""
    from foundationdb_tpu_torch.ops import _kernels

    per = (txns or PIPE_TXNS) // PIPE_CLIENTS
    walls = [[] for _ in range(PIPE_CLIENTS)]
    retries = [0] * PIPE_CLIENTS

    def client(i):
        for j in range(per):
            fn = make_txn(i, j)
            tries = [0]

            def body(tr):
                tries[0] += 1
                return fn(tr)

            t0 = time.perf_counter()
            db.run(body)
            walls[i].append((time.perf_counter() - t0) * 1e3)
            retries[i] += tries[0] - 1

    c.commit_proxy.reset_stats()
    launches0 = dict(_kernels.launches)
    repair0 = repair_counts(c)
    wall = run_clients(PIPE_CLIENTS, client)
    return wall, per * PIPE_CLIENTS, [w for ws in walls for w in ws], \
        sum(retries), launches0, repair0


def phase_pipeline():
    """Phase 9: the batching commit pipeline on the card. Launch counts
    are zeroed at the start and read at the end."""
    from foundationdb_tpu_torch import workloads
    from foundationdb_tpu_torch.ops import _kernels
    from foundationdb_tpu_torch.server.cluster import Cluster

    reset_counts()
    report = {}
    c = Cluster(commit_pipeline="thread", **QUIET)
    db = c.database()
    bp = c.commit_proxy
    log(f"[pipeline] Cluster(commit_pipeline='thread') on {c.device}: depth "
        f"{bp.pipeline_depth}, batch cap {bp.max_batch}, interval "
        f"{bp.interval_s * 1e3} ms")
    n_txn = PIPE_PRELOAD // PIPE_PRELOAD_ROWS

    def preload(i):
        for t in range(i, n_txn, PIPE_CLIENTS):
            start = t * PIPE_PRELOAD_ROWS
            vals = workloads.records(PIPE_PRELOAD_ROWS, seed=SEED + start)

            def load(tr, start=start, vals=vals):
                for k, v in enumerate(vals):
                    tr.set(workloads.user_key(start + k), v)

            db.run(load)

    launches0 = dict(_kernels.launches)
    wall = run_clients(PIPE_CLIENTS, preload)
    report["preload"] = dict(
        rows=PIPE_PRELOAD, txns=n_txn, wall_s=wall,
        rows_per_s=PIPE_PRELOAD / wall, batches=bp.batches_committed,
        mean_batch=bp.txns_batched / max(bp.batches_committed, 1),
        max_batch=bp.max_batch_seen,
        launches={k: v - launches0[k] for k, v in _kernels.launches.items()},
        stages=bp.stage_summary())
    r = report["preload"]
    log(f"[pipeline preload] {PIPE_PRELOAD} rows of "
        f"{workloads.FIELDS * workloads.FIELD_BYTES} B as {n_txn} "
        f"{PIPE_PRELOAD_ROWS}-row db.run txns on {PIPE_CLIENTS} threads in "
        f"{wall:.3f} s ({r['rows_per_s']:.1f} rows/s); {r['batches']} "
        f"batches, mean {r['mean_batch']:.2f} txns, max {r['max_batch']}; "
        f"launches {r['launches']}")
    assert db[workloads.user_key(PIPE_PRELOAD - 1)] is not None
    gc.collect()

    field = workloads.FIELD_BYTES
    cdf = workloads.zipfian_cdf(PIPE_PRELOAD, workloads.THETA)

    def sampler(seed):
        return workloads.zipfian_sampler(
            PIPE_PRELOAD, workloads.THETA, np.random.default_rng(seed), cdf)

    mako_keys = [sampler(SEED + 100 + i) for i in range(PIPE_CLIENTS)]

    def mako(i, j):
        # BASELINE config 3: GRV, get, set of a 100-byte field, Zipfian
        k = workloads.user_key(int(mako_keys[i](1)[0]))
        new = bytes([65 + (i + j) % 26]) * field

        def txn(tr):
            v = tr.get(k)
            tr.set(k, new + v[field:])

        return txn

    report["mako"] = pipeline_report(
        c, *timed_client_stream(c, db, mako), "mako")
    # the reference's default client path: hot-key conflicts repair
    assert report["mako"]["repair"]["repair_attempts"] > 0, \
        "no transaction repair on the mako stream"

    range_keys = [sampler(SEED + 200 + i) for i in range(PIPE_CLIENTS)]

    def range_txn(i, j):
        # BASELINE config 5's shapes: an 8-key scan and a 4-key clear
        a, b = (int(x) for x in range_keys[i](2))

        def txn(tr):
            rows = tr.get_range(workloads.user_key(a), workloads.user_key(a + 8))
            tr.clear_range(workloads.user_key(b), workloads.user_key(b + 4))
            return len(rows)

        return txn

    report["range"] = pipeline_report(
        c, *timed_client_stream(c, db, range_txn), "range")
    assert report["range"]["launches"]["fused_accept"] > 0, \
        "fused_accept never launched on the range-heavy client stream"
    # at the 1024-request cap, 64 synchronous clients never queue more
    # than one chunk, so no backlog group forms; with the cap at 16 their
    # commits fill several chunks a window and the groups pipeline
    bp.max_batch = PIPE_SMALL_CAP
    report["range_cap16"] = pipeline_report(
        c, *timed_client_stream(c, db, range_txn, PIPE_SMALL_CAP_TXNS),
        f"range, cap {PIPE_SMALL_CAP}")
    r = report["range_cap16"]
    assert r["launches"]["fused_accept"] > 0, \
        "fused_accept never launched on the pipelined range-heavy stream"
    assert r["stages"]["pipelined_groups"] > 0, \
        "no group took the pipelined route"
    report["repair_repro"] = repair_repro(c)
    assert c.storage.version == c.sequencer.committed_version
    c.close()
    del c, db, bp
    gc.collect()

    report["fleet"] = phase_fleet()
    report["replay"] = phase_pipeline_replay()
    launches = dict(_kernels.launches)
    log(f"[pipeline] launches {launches}")
    report["graphs"] = graph_report("pipeline")
    return report, launches


def repair_repro(c):
    """Phase 9.3: the conflict the port once answered without repair
    information, on the card cluster: A reads k, another txn rewrites k
    with the same value, A writes k and commits. The 1020 must carry
    k's range and the rejecting version, and the retry loop must commit
    A on a verbatim replay, its body run once."""
    from foundationdb_tpu_torch.core.errors import FDBError

    db = c.database()
    k = b"repair/k"
    db[k] = b"1"
    runs, seen = [], []
    a = db.create_transaction()

    def body(tr):
        runs.append(tr.get(k))
        tr[k] = b"A"
        if len(runs) == 1:
            db[k] = b"1"  # a concurrent same-value rewrite after the read

    r0 = repair_counts(c)
    while True:
        try:
            if not a.repair_ready:
                body(a)
            a.commit()
            break
        except FDBError as e:
            seen.append((e.code, e.conflicting_key_ranges, e.conflict_version))
            a.on_error(e)
    counts = {n: v - r0[n] for n, v in repair_counts(c).items()}
    assert seen and seen[0][0] == 1020, seen
    assert seen[0][1] == [(k, k + b"\x00")] and seen[0][2] is not None, seen
    assert len(seen) == 1 and runs == [b"1"], (seen, runs)
    assert db[k] == b"A"
    assert counts == {"repair_attempts": 1, "repair_commits": 1,
                      "repair_fallbacks": 0}, counts
    log(f"[pipeline repair] 1020 with conflicting ranges {seen[0][1]} at "
        f"conflict_version {seen[0][2]}; committed on a verbatim replay, "
        f"body run {len(runs)} time; counters {counts}")
    return dict(error=[seen[0][0], [list(map(bytes.hex, r)) for r in seen[0][1]],
                       seen[0][2]], body_runs=len(runs), counters=counts)


def phase_fleet():
    """Phase 9.4: a 3-proxy fleet on the card; 64 threads of exact
    read-modify-write increments on 16 counters."""
    from foundationdb_tpu_torch.server.cluster import Cluster

    c = Cluster(commit_pipeline="thread", n_commit_proxies=FLEET_PROXIES,
                **QUIET)
    db = c.database()
    keys = [b"counter%02d" % i for i in range(FLEET_COUNTERS)]
    retries = [0] * PIPE_CLIENTS

    def client(i):
        for j in range(FLEET_INCREMENTS):
            k = keys[(i * 7 + j) % FLEET_COUNTERS]
            tries = [0]

            def inc(tr):
                tries[0] += 1
                v = tr[k]
                tr[k] = b"%d" % ((int(v) if v is not None else 0) + 1)

            db.run(inc)
            retries[i] += tries[0] - 1

    wall = run_clients(PIPE_CLIENTS, client)
    total = sum(int(db[k]) for k in keys)
    want = PIPE_CLIENTS * FLEET_INCREMENTS
    cp = c.commit_proxy
    out = dict(increments=want, total=total, wall_s=wall,
               committed_per_s=want / wall, retries=sum(retries),
               per_member=[p.commit_count for p in cp.inners],
               stages=cp.stage_summary())
    log(f"[pipeline fleet] {FLEET_PROXIES} proxies, {PIPE_CLIENTS} threads x "
        f"{FLEET_INCREMENTS} increments on {FLEET_COUNTERS} counters: total "
        f"{total} of {want} in {wall:.3f} s ({out['committed_per_s']:.1f} "
        f"increments/s, {out['retries']} retries); commits per member "
        f"{out['per_member']}")
    assert total == want, f"fleet counters {total} != {want}"
    assert all(n > 0 for n in out["per_member"])
    c.close()
    return out


def pipeline_stream(c, n):
    """``n`` CommitRequests in user keyspace reaching every verdict:
    blind writes, read-modify-writes of one hot key at one read version
    (one commits, the rest conflict), 8-key range reads over keys the
    stream writes, 4-key clears, and a read version older than the
    window (1007). Built after a few commits through the cluster."""
    from foundationdb_tpu_torch import workloads
    from foundationdb_tpu_torch.core.mutations import Mutation, Op

    db = c.database()
    uk = workloads.user_key
    limbs = c.knobs.key_limbs
    db[uk(0)] = b"hot"
    rv_old = c.grv_proxy.get_read_version()
    for i in range(12):
        db[uk(900_000 + i)] = b"pad"
    rv = c.grv_proxy.get_read_version()
    rng = np.random.default_rng(SEED + 9)
    out = []
    for i in range(n):
        kind = i % 8
        k = uk(1 + int(rng.integers(0, 4 * n)))
        pt = [(k, k + b"\x00")]
        if kind == 7:
            out.append(workloads._request(rv_old, [Mutation(Op.SET, k, b"s")],
                                          [(uk(0), uk(0) + b"\x00")], pt, limbs))
        elif kind in (2, 3):
            out.append(workloads._request(
                rv, [Mutation(Op.SET, uk(0), b"h%d" % i)],
                [(uk(0), uk(0) + b"\x00")], [(uk(0), uk(0) + b"\x00")], limbs))
        elif kind == 4:
            s = 1 + int(rng.integers(0, 4 * n))
            out.append(workloads._request(rv, [Mutation(Op.SET, k, b"r")],
                                          [(uk(s), uk(s + 8))], pt, limbs))
        elif kind == 5:
            s = 1 + int(rng.integers(0, 4 * n))
            out.append(workloads._request(
                rv, [Mutation(Op.CLEAR_RANGE, uk(s), uk(s + 4))], [],
                [(uk(s), uk(s + 4))], limbs))
        else:
            out.append(workloads._request(rv, [Mutation(Op.SET, k, b"v")], [],
                                          pt, limbs))
    return out


def phase_pipeline_replay():
    """Phase 9.5: one deterministic _run_batch of pipeline_stream on a
    card thread cluster and a CPU thread cluster, depth 2, four chunks a
    group: outcomes, rows and the 12 state fields must be equal."""
    from foundationdb_tpu_torch.convert import state_to_numpy
    from foundationdb_tpu_torch.core.errors import FDBError
    from foundationdb_tpu_torch.server.batcher import CommitFuture
    from foundationdb_tpu_torch.server.cluster import Cluster

    def drive(device):
        c = Cluster(device=device, commit_pipeline="thread", **QUIET,
                    commit_batch_max=16, commit_pipeline_depth=2,
                    max_read_transaction_life_versions=12_000)
        try:
            bp = c.commit_proxy
            reqs = pipeline_stream(c, PIPE_REPLAY_REQUESTS)
            bp._backlog_target = 4
            pairs = [(r, CommitFuture(bp)) for r in reqs]
            bp._run_batch(pairs)
            bp.drain_pipeline()
            out = [f.result(timeout=300) for _, f in pairs]
            return ([("error", r.code) if isinstance(r, FDBError) else r
                     for r in out], bp.stages.count("apply"),
                    c.database().get_range(b"", b"\xff"),
                    state_to_numpy(c.resolvers[0].state))
        finally:
            c.close()

    gpu, cpu = drive(None), drive("cpu")
    assert gpu[0] == cpu[0], "pipeline outcomes differ between card and CPU"
    assert gpu[2] == cpu[2], "pipeline rows differ between card and CPU"
    for f, a, b in zip(type(gpu[3])._fields, gpu[3], cpu[3]):
        assert np.array_equal(a, b), f"pipeline state field {f} differs"
    codes = {o[1] for o in gpu[0] if isinstance(o, tuple)}
    assert {1007, 1020} <= codes and gpu[1] >= 2, (codes, gpu[1])
    log(f"[pipeline replay] {PIPE_REPLAY_REQUESTS} requests, chunks of 16, "
        f"depth 2, {gpu[1]} pipelined groups: card == CPU (outcomes with "
        f"codes {sorted(codes)}, {len(gpu[2])} rows, 12 state fields)")
    return dict(requests=PIPE_REPLAY_REQUESTS, pipelined_groups=gpu[1],
                codes=sorted(codes))


GRAPH_BATCHES = RESOLVE_BATCHES + BACKLOG  # per route, then the profiled ones
GRAPH_PROFILE_BATCHES = 6


class EagerSteps:
    """A Resolver's compiled steps swapped for ops/conflict.resolve_batch
    run eagerly on the card, batch by batch, on that Resolver's own
    state: the twin the compiled step is held to, with the Resolver's
    packing, variants and pad widths."""

    def __init__(self, r):
        self.r = r

    def run(self, key, batch, make_step):
        from foundationdb_tpu_torch.convert import batch_from_numpy
        from foundationdb_tpu_torch.ops import conflict as ck

        use_fast, B = key
        params = self.r._fast_params if use_fast else self.r.params
        # copied as the eager Resolver did: a backlog without the stream
        # synchronisation, a single batch with it
        b = batch_from_numpy(batch, self.r.device, non_blocking=B > 1)
        if B == 1:
            return ck.resolve_batch(self.r.state, b, params)[0]
        return torch.stack([ck.resolve_batch(
            self.r.state, type(b)(*(f[i] for f in b)), params)[0]
            for i in range(B)])

    def prepare(self, key, batch, make_step):
        pass  # nothing to compile

    def stats(self):
        return {}


def timed_dispatches(r):
    """Host ms of each step dispatch of ``r`` (the batch copy and the
    replay; for the eager twin, the copy and the step's launch chain),
    by a timer around its step cache's run, appended to the list
    returned."""
    walls = []
    run = r._steps.run

    def timed(*a):
        t0 = time.perf_counter()
        try:
            return run(*a)
        finally:
            walls.append((time.perf_counter() - t0) * 1e3)

    r._steps.run = timed
    return walls


def phase_graphs(streams):
    """Phase 11: the compiled step against the eager step on the card,
    for phase 4's streams and the ring route."""
    from foundationdb_tpu_torch.convert import state_to_numpy
    from foundationdb_tpu_torch.core.options import Knobs
    from foundationdb_tpu_torch.ops import conflict as ck
    from foundationdb_tpu_torch.resolver.resolver import Resolver

    report = {}
    routes = [(name, {}, name) for name in streams] + [
        ("mixed", dict(accept_kernel="off", ring_kernel="on"),
         "mixed, ring route")]
    for name, kw, label in routes:
        stream = streams[name][:GRAPH_BATCHES + GRAPH_PROFILE_BATCHES]
        timed, profiled = stream[:GRAPH_BATCHES], stream[GRAPH_BATCHES:]
        n1 = sum(len(t) for t, _, _ in timed[:RESOLVE_BATCHES])
        nmany = sum(len(t) for t, _, _ in timed[RESOLVE_BATCHES:])
        rows, outs, resolvers = {}, {}, {}
        for kind in ("captured", "eager"):
            r = Resolver(Knobs(**kw))
            if kind == "eager":
                r._steps = EagerSteps(r)
            r.precompile()
            dispatch_ms = timed_dispatches(r)
            ck.reset_graph_counts()
            EAGER_STEPS[0] = 0
            out, walls, backlog_ms = drive(r, timed)
            prof_out = []
            prof = device_profile(lambda r=r: prof_out.extend(
                r.resolve(*b) for b in profiled))
            # the timer wrapper closes over the cache's own method: drop
            # it, so the cache is freed by reference count, not by a
            # collection in a later timed drive
            del r._steps.run
            outs[kind] = out + prof_out
            resolvers[kind] = r
            rows[kind] = dict(
                resolve_txns_per_s=n1 / (sum(walls) / 1e3),
                resolve_many_txns_per_s=nmany / (sum(backlog_ms) / 1e3),
                resolve_p50_ms=float(np.percentile(walls, 50)),
                resolve_p99_ms=float(np.percentile(walls, 99)),
                host_dispatch_p50_ms=float(np.percentile(dispatch_ms, 50)),
                dispatches=len(dispatch_ms),
                busy_share=prof["busy_share"], busy_ms=prof["busy_ms"],
                profile_wall_ms=prof["wall_ms"], top=prof["top"])
            if kind == "captured":
                g = dict(ck.graph_counts, eager_steps=EAGER_STEPS[0])
                rows[kind].update(graphs=g, cache=r.status()["graphs"])
                # every capture happened in precompile, before the drive
                assert g["eager_steps"] == 0 and g["captures"] == 0, g
                assert g["replays"] == g["dispatches"] == len(dispatch_ms), g
            else:
                rows[kind]["eager_steps"] = EAGER_STEPS[0]
                assert EAGER_STEPS[0] > 0
        assert outs["captured"] == outs["eager"], \
            f"{label}: captured and eager statuses differ"
        for f, a, b in zip(ck.ResolverState._fields,
                           state_to_numpy(resolvers["captured"].state),
                           state_to_numpy(resolvers["eager"].state)):
            assert np.array_equal(a, b), f"{label}: state field {f} differs"
        report[label] = rows
        c, e = rows["captured"], rows["eager"]
        log(f"[graphs {label}] {len(stream)} batches, captured == eager "
            "(statuses and 12 state fields); " + "; ".join(
                f"{kind}: resolve {x['resolve_txns_per_s']:.0f} txns/s (p50 "
                f"{x['resolve_p50_ms']:.3f} / p99 {x['resolve_p99_ms']:.3f} ms"
                f" a batch), resolve_many {x['resolve_many_txns_per_s']:.0f} "
                f"txns/s, host {x['host_dispatch_p50_ms']:.3f} ms a dispatch "
                f"(p50 of {x['dispatches']}), card busy {x['busy_share']:.1%}"
                for kind, x in (("captured", c), ("eager", e)))
            + f"; replays {c['graphs']['replays']}, captures (all in "
            f"precompile) {c['cache']['captures']}")
    return report


RECOVERY_PRELOAD = 100_000  # BASELINE config 2 has 1M rows: cut tenfold so
# the fsynced three-log preload and its WAL replay fit the run's time
RECOVERY_BATCHES = 12  # range-heavy commit_batch calls before the crash,
# then SPLIT_BATCHES // 2 for the stage split
RECOVERY_AFTER_KILL = 2  # batches acked by 2 of 3 logs
RECOVERY_AFTER = 4  # batches after the reopen, the first one timed
RECOVERY_CLIENTS = 64  # BASELINE config 3's 64 clients
RECOVERY_INCREMENTS = 100  # read-modify-write increments per thread
RECOVERY_COUNTERS = 16
RECOVERY_KILLS = ("commit_proxy", "sequencer", "commit_proxy")
NATIVE_PRELOAD = 16_384  # phase 13's native-against-Python check: the
# Python host sets' checks grow with the history (3.3 s a batch at a
# 100,000-row preload); the native sets alone then run on
# NATIVE_FULL_PRELOAD rows
# config 5's 1M rows cut tenfold, as phases 10b and 14-16 hold: the 1M
# preload through the host fleet took 77-99 s, which phase 16's time
# is paid from (PERF.md section 6, PR 12)
NATIVE_FULL_PRELOAD = 100_000


def durable_cluster(d, **kw):
    """Phase 12's deployment: the ``ssd`` engine (sqlite B-tree) under
    three replicated logs, every push and engine commit fsynced, the
    coordinators' state on disk, all in directory ``d``."""
    from foundationdb_tpu_torch.server.cluster import Cluster
    from foundationdb_tpu_torch.server.kvstore import open_engine

    os.makedirs(d, exist_ok=True)
    return Cluster(
        wal_path=os.path.join(d, "wal"), n_tlogs=3, fsync=True,
        storage_engines=[open_engine("sqlite", os.path.join(d, "kv"),
                                     fsync=True)],
        coordination_dir=os.path.join(d, "coordinators"), **kw)


def rows_digest(c):
    """(rows, sha256 of every key and value) at the storage's version."""
    s = c.storage
    rows = s.get_range(b"", b"\xff", s.version)
    h = hashlib.sha256()
    for k, v in rows:
        h.update(len(k).to_bytes(4, "big") + k + len(v).to_bytes(4, "big")
                 + v)
    return len(rows), h.hexdigest()


def commit_walls(c, batches, value):
    """Each stream batch as client requests through commit_batch:
    (outcomes, wall ms of each call)."""
    from foundationdb_tpu_torch import workloads

    outs, walls = [], []
    for txns, cv, _ in batches:
        reqs = workloads.commit_requests(
            txns, cv, c.sequencer.committed_version, c.knobs.key_limbs, value)
        t0 = time.perf_counter()
        outs.append(_outcomes(c.commit_proxy.commit_batch(reqs)))
        walls.append((time.perf_counter() - t0) * 1e3)
    return outs, walls


def preload(c, n):
    from foundationdb_tpu_torch import workloads

    t0 = time.perf_counter()
    for reqs in workloads.preload_requests(
            n, c.knobs.key_limbs, batch=c.knobs.batch_txn_capacity,
            seed=SEED):
        assert all(isinstance(v, int)
                   for v in c.commit_proxy.commit_batch(reqs))
    return time.perf_counter() - t0


def stale_commit(c, rv):
    """A read and a write at read version ``rv``: its error code."""
    from foundationdb_tpu_torch.core.errors import FDBError

    tr = c.database().create_transaction()
    tr.set_read_version(rv)
    tr.get(b"user%08d" % 0)
    tr.set(b"stale", b"x")
    try:
        tr.commit()
        return "committed"
    except FDBError as e:
        return e.code


def phase_recovery_restart(stream, d):
    """Phase 12a: a cold restart of the durable cluster on the card."""
    from foundationdb_tpu_torch import workloads
    from foundationdb_tpu_torch.ops import _kernels

    value = b"r" * 100
    reset_counts()
    c = durable_cluster(d)
    gen0 = c.generation
    preload_s = preload(c, RECOVERY_PRELOAD)
    t0 = time.perf_counter()
    c.storage.flush()  # the preload into the engine's B-tree
    flush_s = time.perf_counter() - t0
    outs, walls = commit_walls(c, stream[:RECOVERY_BATCHES], value)
    ok = sum(isinstance(v, int) for b in outs for v in b)
    before = dict(_kernels.launches)
    log(f"[recovery restart] preloaded {RECOVERY_PRELOAD} rows of 1 KB "
        f"with fsync on 3 logs in {preload_s:.3f} s, into the sqlite "
        f"engine in {flush_s:.3f} s; {RECOVERY_BATCHES} range-heavy "
        f"commit_batch calls: {ok} committed, "
        f"{ok / (sum(walls) / 1e3):.1f} committed txns/s, p50 "
        f"{np.percentile(walls, 50):.3f} ms, p99 "
        f"{np.percentile(walls, 99):.3f} ms a batch (fsync on)")
    assert before["fused_accept"] > 0, "fused_accept never launched"
    # where a fsynced commit_batch spends its time, after the timed drive
    i = RECOVERY_BATCHES + SPLIT_BATCHES // 2
    wal_sites = {f"wal_append_{n}": (log, "_wal_append")
                 for n, log in enumerate(c.tlog.logs)}
    split = commit_stage_split(
        c, [lambda t=t, cv=cv: workloads.commit_requests(
            t, cv, c.sequencer.committed_version, c.knobs.key_limbs, value)
            for t, cv, _ in stream[RECOVERY_BATCHES:i]],
        extra_sites=dict(wal_sites, tlog_push=(c.tlog, "push")))
    log(f"[recovery restart] {SPLIT_BATCHES // 2} commit_batch calls, host "
        "ms per batch: " + ", ".join(
            f"{k} {v:.3f}" for k, v in split["host_ms"].items())
        + f" of {split['wall_ms']:.3f} wall; device busy "
        f"{split['device_busy_ms']:.3f} ms per batch "
        f"({split['device_busy_share']:.1%})")
    rv_old = c.sequencer.committed_version  # a read version the crash fences
    c.tlog.kill(0)
    more, _ = commit_walls(c, stream[i:i + RECOVERY_AFTER_KILL], value)
    assert any(isinstance(v, int) for b in more for v in b)
    last = c.sequencer.committed_version
    acked = rows_digest(c)
    g_before = graph_report("recovery restart, before the crash")
    del c  # a crash: no close, the files as they lie
    gc.collect()

    reset_counts()
    t0 = time.perf_counter()
    c = durable_cluster(d)
    construct_s = time.perf_counter() - t0
    assert c.generation == gen0 + 1, (gen0, c.generation)
    assert rows_digest(c) == acked, "an acknowledged write was lost"
    assert c.sequencer.committed_version == last
    i += RECOVERY_AFTER_KILL
    first, first_ms = commit_walls(c, stream[i:i + 1], value)
    recover_s = construct_s + first_ms[0] / 1e3
    code = stale_commit(c, rv_old)
    assert code == 1007, f"a pre-crash read version got {code}"
    after, walls_after = commit_walls(c, stream[i + 1:i + RECOVERY_AFTER],
                                      value)
    launches = dict(_kernels.launches)
    g_after = graph_report("recovery restart, after the reopen")
    assert launches["fused_accept"] > 0, "fused_accept never launched"
    log(f"[recovery restart] killed log 0, committed {RECOVERY_AFTER_KILL} "
        f"batches on 2 of 3 logs, dropped the cluster; reopened in "
        f"{construct_s:.3f} s ({c.recovered_records} log records), first "
        f"committed batch {first_ms[0]:.3f} ms: {recover_s:.3f} s to recover; "
        f"{acked[0]} rows read back equal; generation {gen0} -> "
        f"{c.generation}; a pre-crash read version got {code}; "
        f"{RECOVERY_AFTER - 1} more batches p50 "
        f"{np.percentile(walls_after, 50):.3f} ms; launches {launches}")
    c.close()
    return dict(preload_rows=RECOVERY_PRELOAD, preload_s=preload_s,
                flush_s=flush_s, committed=ok,
                committed_txns_per_s=ok / (sum(walls) / 1e3),
                p50_ms=float(np.percentile(walls, 50)),
                p99_ms=float(np.percentile(walls, 99)),
                reopen_s=construct_s, first_batch_ms=first_ms[0],
                stage_split=split,
                recover_s=recover_s, rows=acked[0], generations=[gen0, gen0 + 1],
                stale_code=code, launches_before=before, launches=launches,
                graphs=[g_before, g_after])


def phase_txn_recovery():
    """Phase 12b: 64 client threads of read-modify-write increments on a
    thread-pipeline cluster on the card while the commit proxy, then the
    sequencer, then the proxy again die, each followed by one
    detect_and_recruit round."""
    import threading

    from foundationdb_tpu_torch.ops import _kernels
    from foundationdb_tpu_torch.server.cluster import Cluster
    from foundationdb_tpu_torch.txn.transaction import Transaction

    reset_counts()
    c = Cluster(commit_pipeline="thread", **QUIET)
    db = c.database()
    keys = [b"counter%02d" % i for i in range(RECOVERY_COUNTERS)]
    total = RECOVERY_CLIENTS * RECOVERY_INCREMENTS
    done = [0]
    codes = {}
    mu = threading.Lock()
    on_error = Transaction.on_error

    def counted(tr, e):
        with mu:
            codes[e.code] = codes.get(e.code, 0) + 1
        return on_error(tr, e)

    def client(i):
        for j in range(RECOVERY_INCREMENTS):
            k = keys[(i * 7 + j) % RECOVERY_COUNTERS]

            def inc(tr):
                v = tr[k]
                tr[k] = b"%d" % ((int(v) if v is not None else 0) + 1)

            db.run(inc)
            with mu:
                done[0] += 1

    recoveries = []
    Transaction.on_error = counted
    try:
        threads = [threading.Thread(target=client, args=(i,), daemon=True)
                   for i in range(RECOVERY_CLIENTS)]
        t_start = time.perf_counter()
        for t in threads:
            t.start()
        for n, role in enumerate(RECOVERY_KILLS):
            while done[0] < (n + 1) * total // (len(RECOVERY_KILLS) + 1):
                time.sleep(0.001)
            if role == "sequencer":
                c.sequencer.kill()
            else:
                c._commit_target().kill()
            time.sleep(0.05)  # commits queue against the dead role
            events = c.detect_and_recruit()
            assert events == [("txn-system", 0)], events
            rec = c.recovery_timeline.records[-1]
            t0 = time.perf_counter()
            db[b"probe%d" % n] = b"x"
            first_ms = (time.perf_counter() - t0) * 1e3
            torch.cuda.synchronize()
            recoveries.append(dict(
                killed=role, generation=rec["generation"],
                total_ms=rec["total_ms"], phases_ms=rec["phases"],
                first_commit_ms=first_ms,
                allocated_bytes=torch.cuda.memory_allocated()))
            log(f"[recovery txn-system] {role} killed at {done[0]} of "
                f"{total} increments; recovery {rec['total_ms']} ms "
                f"{rec['phases']}, generation {rec['generation']}; first "
                f"commit after it {first_ms:.3f} ms; card memory allocated "
                f"{recoveries[-1]['allocated_bytes']} B")
        deadline = time.monotonic() + CLIENT_DEADLINE_S
        for t in threads:
            t.join(max(0.0, deadline - time.monotonic()))
        assert not any(t.is_alive() for t in threads), "a client hung"
        wall = time.perf_counter() - t_start
    finally:
        Transaction.on_error = on_error
    counters = sum(int(db[k]) for k in keys)
    launches = dict(_kernels.launches)
    graphs = graph_report("recovery txn-system")
    log(f"[recovery txn-system] {RECOVERY_CLIENTS} threads x "
        f"{RECOVERY_INCREMENTS} increments in {wall:.3f} s "
        f"({total / wall:.1f} committed increments/s) across "
        f"{len(recoveries)} recoveries: counters {counters} of {total}; "
        f"errors the clients rode out {dict(sorted(codes.items()))}")
    assert counters == total, f"counters {counters} != {total}"
    assert codes.get(1021, 0) > 0, "no queued commit failed 1021"
    m0, m2 = recoveries[0]["allocated_bytes"], recoveries[-1]["allocated_bytes"]
    assert abs(m2 - m0) <= 0.05 * m0, \
        f"card memory after the third recovery {m2} B vs the first {m0} B"
    c.close()
    return dict(increments=total, wall_s=wall,
                increments_per_s=total / wall, counters=counters,
                client_errors={str(k): v for k, v in codes.items()},
                recoveries=recoveries, launches=launches, graphs=graphs)


def recovery_replay(device, d, stream):
    """Phase 12c's script: preload, batches, a dead log, a crash and a
    reopen, a fenced read, a dead proxy and a dead sequencer each
    recovered. Outcomes, rows, generations and the resolver state."""
    from foundationdb_tpu_torch import workloads
    from foundationdb_tpu_torch.convert import state_to_numpy

    value = b"c"
    c = durable_cluster(d, device=device)
    out = [c.generation]
    preload(c, CLUSTER_REPLAY_PRELOAD)
    c.storage.flush()
    out += commit_walls(c, stream[:2], value)[0]
    rv_old = c.sequencer.committed_version
    c.tlog.kill(0)
    out += commit_walls(c, stream[2:3], value)[0]
    del c
    gc.collect()
    c = durable_cluster(d, device=device)
    out += [c.generation, stale_commit(c, rv_old)]
    out += commit_walls(c, stream[3:4], value)[0]
    c._commit_target().kill()
    out.append(c.detect_and_recruit())
    out += commit_walls(c, stream[4:5], value)[0]
    c.sequencer.kill()
    out.append(c.detect_and_recruit())
    reqs = [workloads.commit_requests(t, cv, c.sequencer.committed_version,
                                      c.knobs.key_limbs, value)
            for t, cv, _ in stream[5:7]]
    out += [_outcomes(r) for r in c.commit_proxy.commit_batches(reqs)]
    out.append([(r["generation"], r["recovered_version"])
                for r in c.recovery_timeline.records])
    rows = c.database().get_range(b"", b"\xff")
    state = state_to_numpy(c.resolvers[0].state)
    c.close()
    return out, rows, state


def phase_recovery(stream):
    """Phase 12: durability and recovery on the card."""
    with tempfile.TemporaryDirectory() as d:
        report = dict(restart=phase_recovery_restart(
            stream, os.path.join(d, "restart")))
    report["txn_system"] = phase_txn_recovery()
    # the launches of phase 12's path: 12a on both sides of the crash,
    # 12b (12c's runs are comparisons)
    launches = {k: (report["restart"]["launches_before"][k]
                    + report["restart"]["launches"][k]
                    + report["txn_system"]["launches"][k])
                for k in report["txn_system"]["launches"]}
    with tempfile.TemporaryDirectory() as d:
        gpu = recovery_replay(None, os.path.join(d, "card"), stream)
        cpu = recovery_replay("cpu", os.path.join(d, "cpu"), stream)
    assert gpu[0] == cpu[0], "recovery outcomes differ between card and CPU"
    assert gpu[1] == cpu[1], "recovery rows differ between card and CPU"
    for f, a, b in zip(type(gpu[2])._fields, gpu[2], cpu[2]):
        assert np.array_equal(a, b), f"recovery state field {f} differs"
    log(f"[recovery replay] preload {CLUSTER_REPLAY_PRELOAD} rows, 7 "
        "range-heavy batches, a dead log, a crash and reopen, a fenced "
        "read, a dead proxy and a dead sequencer recovered: card == CPU "
        f"({len(gpu[1])} rows, outcomes, generations {gpu[0][-1]} and 12 "
        "state fields)")
    log(f"[recovery] launches {launches}")
    return report, launches


def native_fleet(backend, rows, stream, value):
    """Cluster(resolver_backend=backend, n_resolvers=3) preloaded with
    ``rows`` rows, then the stream through proxy_stream, each resolver's
    sub-resolves and each fan-out timed: the report with the pool's
    overlap, the outcomes and the rows left."""
    from foundationdb_tpu_torch.server.cluster import Cluster

    c = Cluster(resolver_backend=backend, n_resolvers=SHARDED_LANES)
    preload_s = preload(c, rows)
    proxy = c._commit_target()
    # each sub-resolve's (start, end), one list a resolver (each runs on
    # a pool thread), and each fan-out's (start, end)
    subs = [[] for _ in c.resolvers]
    fans = []

    def timed(fn, spans):
        def call(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                spans.append((t0, time.perf_counter()))
        return call

    for res, spans in zip(c.resolvers, subs):
        res.resolve = timed(res.resolve, spans)
    proxy._resolve = timed(proxy._resolve, fans)
    label = f"native {backend} x{SHARDED_LANES}, {rows} rows"
    r = proxy_stream(c, stream, CLUSTER_BATCHES, CLUSTER_BATCHES, value,
                     label, keep_outcomes=True)
    outcomes = r.pop("outcomes")
    left = c.database().get_range(b"", b"\xff")
    # a fan-out's pool wall: its first sub-resolve's start to its last
    # one's end (the clipping before them is host Python)
    sub = sum(t1 - t0 for spans in subs for t0, t1 in spans)
    pool = sum(max(spans[n][1] for spans in subs)
               - min(spans[n][0] for spans in subs)
               for n in range(len(fans)))
    fan = sum(t1 - t0 for t0, t1 in fans)
    r.update(preload_rows=rows, preload_s=preload_s,
             sub_resolve_ms=sub * 1e3, pool_wall_ms=pool * 1e3,
             fan_out_ms=fan * 1e3, overlap=sub / pool)
    log(f"[{label}] preloaded in {preload_s:.3f} s; {SHARDED_LANES} host "
        f"resolvers on the pool: sub-resolves {r['sub_resolve_ms']:.3f} ms "
        f"over {r['pool_wall_ms']:.3f} ms of pool wall (overlap "
        f"{r['overlap']:.3f}); the fan-outs with their clipping "
        f"{r['fan_out_ms']:.3f} ms")
    c.close()
    return r, outcomes, left


def phase_native(stream):
    """Phase 13: the range-heavy stream through three host resolvers on
    the proxy's sub-resolve pool, native (C++) and Python sets, on a
    NATIVE_PRELOAD history: equal outcomes and rows; then the native
    sets alone on NATIVE_FULL_PRELOAD rows; no kernel launch in either."""
    from foundationdb_tpu_torch.ops import _kernels
    from foundationdb_tpu_torch.ops import conflict as ck

    reset_counts()
    value = b"n" * 100
    report, seen = {}, {}
    for backend in ("native", "cpu"):
        r, outcomes, left = native_fleet(backend, NATIVE_PRELOAD, stream,
                                         value)
        report[backend], seen[backend] = r, (outcomes, left)
    assert seen["native"][0] == seen["cpu"][0], \
        "native and Python host resolvers gave different outcomes"
    assert seen["native"][1] == seen["cpu"][1], \
        "native and Python host resolvers left different rows"
    log(f"[native] outcomes and {len(seen['cpu'][1])} rows equal")
    report["native_full"], _, left = native_fleet(
        "native", NATIVE_FULL_PRELOAD, stream, value)
    report["native_full"]["rows_left"] = len(left)
    launches = dict(_kernels.launches)
    assert not any(launches.values()), launches
    assert ck.graph_counts["dispatches"] == 0, dict(ck.graph_counts)
    log(f"[native] launches {launches}")
    report["launches"] = launches
    return report


# ── phase 14: double replication, the ratekeeper and system keys ──
REPL_STORAGE = 3  # FoundationDB's ``double`` mode: 2 copies, 3 storages
REPL_COPIES = 2
REPL_TLOGS = 3
REPL_PRELOAD = 100_000  # config 2's 1M rows cut tenfold, as in phase 12a:
# at 1M the phase took 121-150 s on the card's machines, over its budget
REPL_MAX_ROUNDS = 60  # rebalance rounds before the map must have settled
REPL_SAMPLE_KEYS = 64
REPL_SAMPLE_RANGES = 16
REPL_RANGE_KEYS = 64
RK_CLIENTS = 64
RK_WARMUP_S = 1.0  # the token bucket starts full: its first second is
RK_WINDOW_S = 4.0  # a burst, so the rate is read over the window after it
RK_SHARE = 0.25
IDMP_COUNTERS = 16
IDMP_ROUNDS = 4  # increments of each counter
RESTART_PRELOAD = 8192
TWIN_PRELOAD = 2048


def repl_cluster(device=None, **kw):
    """Phase 14's deployment: ``double`` replication (2 copies of each
    shard) on 3 storage servers and 3 logs, in memory, no fsync."""
    from foundationdb_tpu_torch.server.cluster import Cluster

    return Cluster(device=device, n_storage=REPL_STORAGE,
                   replication=REPL_COPIES, n_tlogs=REPL_TLOGS, **kw)


def settle_map(c, cap=REPL_MAX_ROUNDS):
    """rebalance() until a round neither moves nor splits a shard: the
    rounds' (moves, seconds) and the shard counts."""
    rounds = []
    for _ in range(cap):
        n = len(c.dd.map)
        t0 = time.perf_counter()
        moves = c.rebalance()
        rounds.append((len(moves), time.perf_counter() - t0))
        if not moves and len(c.dd.map) == n:
            return rounds
    raise AssertionError(f"the shard map did not settle in {cap} rounds")


def replica_check(c, rng, label):
    """Sampled keys, and ranges of REPL_RANGE_KEYS keys cut at the shard
    boundaries they cross, read from every replica of their team at one
    version: all equal, and equal to the router's read."""
    from foundationdb_tpu_torch import workloads

    v = c.sequencer.committed_version
    smap = c.dd.map
    n_rows = 0
    for i in rng.integers(0, REPL_PRELOAD, REPL_SAMPLE_KEYS).tolist():
        k = workloads.user_key(i)
        vals = {c.storages[s].get(k, v) for s in smap.team_for(k)}
        assert len(vals) == 1, (label, k)
        assert c.router.get(k, v) in vals, (label, k)
    starts = rng.integers(0, REPL_PRELOAD - REPL_RANGE_KEYS,
                          REPL_SAMPLE_RANGES).tolist()
    for i in starts:
        b, e = workloads.user_key(i), workloads.user_key(i + REPL_RANGE_KEYS)
        rows = []
        for j in smap.shards_overlapping(b, e):
            sb, se = smap.shard_range(j)
            lo, hi = max(b, sb), (e if se is None else min(e, se))
            reads = [c.storages[s].get_range(lo, hi, v)
                     for s in smap.teams[j]]
            assert all(r == reads[0] for r in reads), (label, lo, hi)
            rows += reads[0]
        assert c.router.get_range(b, e, v) == rows, (label, b, e)
        n_rows += len(rows)
    log(f"[replication {label}] {REPL_SAMPLE_KEYS} keys and "
        f"{REPL_SAMPLE_RANGES} ranges of {REPL_RANGE_KEYS} keys ({n_rows} "
        "rows) read back equal from every replica of their team and the "
        "router")
    return n_rows


def owned_only(c, sid):
    """Storage ``sid`` holds user rows of the shards it owns only."""
    s = c.storages[sid]
    smap = c.dd.map
    keys = [k for k, _ in s.get_range(b"", b"\xff", s.version)]
    assert all(sid in smap.team_for(k) for k in keys), sid
    return len(keys)


def phase_replication_route(c):
    """14a: preload, then rebalance until the map settles."""
    from foundationdb_tpu_torch import workloads

    preload_s = preload(c, REPL_PRELOAD)
    rounds = settle_map(c)
    tb = c.dd.team_bytes()
    secs = [s for _, s in rounds]
    r = dict(preload_rows=REPL_PRELOAD, preload_s=preload_s,
             rounds=len(rounds), moves=sum(m for m, _ in rounds),
             shards=len(c.dd.map), team_bytes=tb,
             round_s_mean=float(np.mean(secs)), round_s_max=max(secs))
    log(f"[replication rebalance] {REPL_PRELOAD} rows of "
        f"{workloads.FIELDS * workloads.FIELD_BYTES} B preloaded on "
        f"{REPL_STORAGE} storages x {REPL_COPIES} copies in {preload_s:.3f} s;"
        f" {r['rounds']} rebalance rounds, {r['moves']} moves, "
        f"{r['shards']} shards; team bytes max {max(tb)} / min {min(tb)}; "
        f"{r['round_s_mean']:.4f} s a round (max {r['round_s_max']:.4f})")
    return r


def phase_replication_native(stream):
    """14a, the host fleet: update_resolver_ranges on the native
    3-resolver fleet of phase 13's shape derives each resolver's range
    from the shard map's bytes, and a bound move fences the history."""
    from foundationdb_tpu_torch.core.errors import FDBError

    c = repl_cluster(resolver_backend="native", n_resolvers=SHARDED_LANES)
    preload(c, NATIVE_PRELOAD)
    proxy = c._commit_target()
    assert proxy.resolver_bounds is None  # the even split until DD runs
    rv_old = c.sequencer.committed_version
    settle_map(c)
    bounds = proxy.resolver_bounds
    assert bounds is not None and len(bounds) == SHARDED_LANES - 1, bounds
    code = stale_commit(c, rv_old)
    assert code == 1007, f"a read from before the bound move got {code}"
    outs, walls = commit_walls(c, stream[:CLUSTER_BATCHES], b"n")
    ok = sum(isinstance(v, int) for b in outs for v in b)
    assert ok > 0 and not any(isinstance(v, FDBError) for b in outs
                              for v in b)
    log(f"[replication native] {NATIVE_PRELOAD} rows, {len(c.dd.map)} "
        f"shards: resolver bounds {[b.decode() for b in bounds]}; a read "
        f"from before the move got {code}; {CLUSTER_BATCHES} range-heavy "
        f"batches: {ok} committed, {ok / (sum(walls) / 1e3):.1f} committed "
        "txns/s")
    c.close()
    return dict(bounds=[b.decode() for b in bounds], stale_code=code,
                committed_txns_per_s=ok / (sum(walls) / 1e3))


def phase_replication_commits(c, stream, value):
    """14b: the range-heavy stream on the card through the routed,
    tagged commit path; a batch's host stage split."""
    from foundationdb_tpu_torch import workloads
    from foundationdb_tpu_torch.ops import _kernels

    f0 = _kernels.launches["fused_accept"]
    r = proxy_stream(c, stream, CLUSTER_BATCHES, CLUSTER_BATCHES, value,
                     "replication range_heavy")
    r["fused_accept"] = _kernels.launches["fused_accept"] - f0
    assert r["fused_accept"] > 0, "fused_accept never launched"
    proxy = c.commit_proxy
    sites = {"route": (proxy, "_route"), "tlog_push": (c.tlog, "push"),
             **{f"storage_apply_{i}": (s, "apply")
                for i, s in enumerate(c.storages) if i}}
    i = 2 * CLUSTER_BATCHES
    r["stage_split"] = split = commit_stage_split(
        c, [lambda t=t, cv=cv: workloads.commit_requests(
            t, cv, c.sequencer.committed_version, c.knobs.key_limbs, value)
            for t, cv, _ in stream[i:i + SPLIT_BATCHES]], extra_sites=sites)
    log(f"[replication range_heavy] fused_accept launches {r['fused_accept']};"
        f" {SPLIT_BATCHES} commit_batch calls, host ms per batch: "
        + ", ".join(f"{k} {v:.3f}" for k, v in split["host_ms"].items())
        + f" of {split['wall_ms']:.3f} wall (storage_apply is storage 0's);"
        f" device busy {split['device_busy_ms']:.3f} ms per batch "
        f"({split['device_busy_share']:.1%})")
    return r


def phase_replication_failures(c, stream, value, rng):
    """14d: a storage dies (its teams served by the other replica), is
    recruited from the log keeping only what it owns (the tagged peek
    carries exactly that), then storage 2 is excluded and drained."""
    from foundationdb_tpu_torch import workloads

    sid = 1
    probe = [workloads.user_key(i)
             for i in rng.integers(0, REPL_PRELOAD, REPL_SAMPLE_KEYS).tolist()]
    v = c.sequencer.committed_version
    before = [c.router.get(k, v) for k in probe]
    c.storages[sid].kill()
    assert [c.router.get(k, v) for k in probe] == before
    v_kill = c.sequencer.committed_version
    outs, _ = commit_walls(c, stream[:2], value)
    smap = c.dd.map
    tagged = c.tlog.peek(v_kill, tag=sid)
    full = c.tlog.peek(v_kill)
    assert [(v, [(m.op, m.key, m.param) for m in ms]) for v, ms in tagged] \
        == [(v, [(m.op, m.key, m.param) for m in ms
                 if c._storage_owns(smap, sid, m)]) for v, ms in full]
    t0 = time.perf_counter()
    events = c.detect_and_recruit()
    recruit_s = time.perf_counter() - t0
    assert events == [("storage", sid)], events
    held = owned_only(c, sid)
    replica_check(c, rng, "after the recruitment")
    t0 = time.perf_counter()
    moves = c.exclude_storage(2)
    rounds = 1
    while not c.storage_drained(2):
        assert rounds < REPL_MAX_ROUNDS, "storage 2 never drained"
        moves += c.rebalance()
        rounds += 1
    drain_s = time.perf_counter() - t0
    replica_check(c, rng, "after the drain")
    r = dict(killed=sid, recruit_s=recruit_s, recruit_rows=held,
             tagged_records=len(tagged), drain_rounds=rounds,
             drain_moves=len(moves), drain_s=drain_s,
             team_bytes=c.dd.team_bytes())
    log(f"[replication failures] storage {sid} killed: {len(probe)} reads "
        f"served by the other replica, {len(outs)} batches committed without"
        f" it; recruited in {recruit_s:.3f} s from the log, holding "
        f"{held} user rows, all of its own shards (its tagged peek of "
        f"{len(tagged)} records = the owned mutations); storage 2 excluded "
        f"and drained in {rounds} rounds, {len(moves)} moves, "
        f"{drain_s:.3f} s; team bytes {r['team_bytes']}")
    c.include_storage(2)
    return r


def rk_run(target_tps, tagged=4, quota=1.0):
    """RK_CLIENTS threads of read-modify-write increments on a thread
    pipeline cluster; the first ``tagged`` threads tag their txns
    "quota" with an operator quota. The GRVs granted per second over
    RK_WINDOW_S after RK_WARMUP_S, and the errors each group rode out."""
    import threading

    from foundationdb_tpu_torch.txn.transaction import Transaction

    c = repl_cluster(commit_pipeline="thread", target_tps=target_tps,
                     **QUIET)
    c.set_tag_quota("quota", quota)
    db = c.database()
    stop = threading.Event()
    codes = {"tagged": {}, "untagged": {}}
    mu = threading.Lock()
    on_error = Transaction.on_error

    def counted(tr, e):
        group = "tagged" if tr._tags else "untagged"
        with mu:
            codes[group][e.code] = codes[group].get(e.code, 0) + 1
        return on_error(tr, e)

    def client(i):
        k = b"rk%02d" % (i % IDMP_COUNTERS)

        def inc(tr):
            if i < tagged:
                tr.options.set_tag("quota")
            v = tr[k]
            tr[k] = b"%d" % ((int(v) if v is not None else 0) + 1)

        while not stop.is_set():
            db.run(inc)

    Transaction.on_error = counted
    try:
        ts = [threading.Thread(target=client, args=(i,), daemon=True)
              for i in range(RK_CLIENTS)]
        for t in ts:
            t.start()
        time.sleep(RK_WARMUP_S)
        g0, t0 = c.grv_proxy.grv_count, time.perf_counter()
        time.sleep(RK_WINDOW_S)
        g1, t1 = c.grv_proxy.grv_count, time.perf_counter()
        stop.set()
        for t in ts:
            t.join(CLIENT_DEADLINE_S)
        assert not any(t.is_alive() for t in ts), "a client hung"
    finally:
        Transaction.on_error = on_error
    rk = c.ratekeeper
    r = dict(target_tps=target_tps, grv_per_s=(g1 - g0) / (t1 - t0),
             errors={g: {str(k): v for k, v in d.items()}
                     for g, d in codes.items()},
             throttled=rk.throttled_count,
             tag_throttled=rk.tag_throttled_count)
    c.close()
    return r


def phase_ratekeeper():
    """14e: the GRV rate unthrottled, then with target_tps at RK_SHARE
    of it: granted GRVs/s within 25% of the target, 1213 for the quota
    tag only."""
    free = rk_run(None, tagged=0)
    target = RK_SHARE * free["grv_per_s"]
    held = rk_run(target)
    ratio = held["grv_per_s"] / target
    log(f"[ratekeeper] {RK_CLIENTS} threads of read-modify-write "
        f"increments: unthrottled {free['grv_per_s']:.1f} GRVs/s; "
        f"target_tps {target:.1f}: {held['grv_per_s']:.1f} GRVs/s granted "
        f"({ratio:.3f} of the target); 1037s ridden out "
        f"{held['errors']['untagged'].get('1037', 0)} untagged, "
        f"{held['errors']['tagged'].get('1037', 0)} tagged; 1213s "
        f"{held['errors']['tagged'].get('1213', 0)} tagged (quota 1 tps), "
        f"{held['errors']['untagged'].get('1213', 0)} untagged")
    assert 0.75 <= ratio <= 1.25, ratio
    assert held["errors"]["tagged"].get("1213", 0) > 0
    assert held["errors"]["untagged"].get("1213", 0) == 0
    return dict(unthrottled=free, throttled=held, ratio=ratio)


def lock_script(c):
    """14f: plain commits 1038 under the lock, lock-aware ones pass."""
    from foundationdb_tpu_torch.core.errors import FDBError

    db = c.database()

    def write(aware):
        tr = db.create_transaction()
        if aware:
            tr.options.set_lock_aware()
        tr[b"locktest"] = b"%d" % aware
        try:
            tr.commit()
            return "committed"
        except FDBError as e:
            return e.code

    c.lock_database(b"phase14")
    out = [write(False), write(True)]
    c.unlock_database()
    out.append(write(False))
    return out


def idmp_script(c):
    """14g: automatic-idempotency increments of IDMP_COUNTERS counters;
    one batch loses the log quorum (two of three logs die for its push,
    rejoining after: a 1021, nothing applied) and one reply is lost after
    the commit applied (a 1021 the id's row resolves)."""
    from foundationdb_tpu_torch.core.errors import FDBError

    db = c.database()
    tlog, proxy = c.tlog, c.commit_proxy
    push, commit = tlog.push, proxy.commit
    calls = {"push": 0, "commit": 0, "unknown": 0}

    def quorum_lost_once(version, mutations, tags=None):
        calls["push"] += 1
        if calls["push"] != 5:
            return push(version, mutations, tags=tags)
        tlog.kill(1)
        tlog.kill(2)
        try:
            return push(version, mutations, tags=tags)
        finally:
            tlog.revive(1)
            tlog.revive(2)

    def reply_lost_once(req):
        res = commit(req)
        calls["commit"] += 1
        if calls["commit"] == 11 and isinstance(res, int):
            calls["unknown"] += 1
            return FDBError(1021)
        return res

    keys = [b"idmp%02d" % i for i in range(IDMP_COUNTERS)]
    tlog.push, proxy.commit = quorum_lost_once, reply_lost_once
    try:
        for _ in range(IDMP_ROUNDS):
            for k in keys:
                def inc(tr, k=k):
                    tr.options.set_automatic_idempotency()
                    v = tr[k]
                    tr[k] = b"%d" % ((int(v) if v is not None else 0) + 1)
                db.run(inc)
    finally:
        del tlog.push, proxy.commit
    counters = [int(db[k]) for k in keys]
    s = c.storage
    ids = len(s.get_range(b"\xff\x02/idmp/", b"\xff\x02/idmp0", s.version))
    return counters, ids, calls


def restart_script(device, d):
    """14h: a WAL-backed double cluster, rebalanced and locked, dropped
    without a close and reopened: the map, the replication and the lock
    come back from \\xff/keyServers/, \\xff/conf/replication and
    \\xff/dbLocked."""
    c = repl_cluster(device, wal_path=os.path.join(d, "wal"),
                     coordination_dir=os.path.join(d, "coordinators"))
    c.dd.max_shard_bytes = 64_000
    preload(c, RESTART_PRELOAD)
    settle_map(c)
    c.lock_database(b"restart")
    want = (list(c.dd.map.boundaries), [list(t) for t in c.dd.map.teams])
    del c  # a crash: no close
    gc.collect()
    c = repl_cluster(device, wal_path=os.path.join(d, "wal"),
                     coordination_dir=os.path.join(d, "coordinators"))
    got = (list(c.dd.map.boundaries), [list(t) for t in c.dd.map.teams])
    out = [got == want, c.replication, c.lock_uid(), stale_commit(c, 0)]
    c.unlock_database()
    out.append(len(want[0]))
    c.close()
    return out


def twin_script(device, stream):
    """14i: the phase's script at TWIN_PRELOAD rows (with smaller
    shards, so that the map splits): outcomes, rows per storage, the
    map, the ratekeeper's admissions under one injected clock and the
    resolver state."""
    from foundationdb_tpu_torch import workloads
    from foundationdb_tpu_torch.convert import state_to_numpy
    from foundationdb_tpu_torch.core import deterministic

    c = repl_cluster(device)
    c.dd.max_shard_bytes = 64_000
    out = []
    for reqs in workloads.preload_requests(
            TWIN_PRELOAD, c.knobs.key_limbs, batch=256, seed=SEED):
        out.append(_outcomes(c.commit_proxy.commit_batch(reqs)))
    out.append([m for m, _ in settle_map(c)])
    out += commit_walls(c, stream[:2], b"t")[0]
    c.storages[1].kill()
    out += commit_walls(c, stream[2:3], b"t")[0]
    out.append(c.detect_and_recruit())
    out.append(c.exclude_storage(2))
    out += commit_walls(c, stream[3:4], b"t")[0]
    out.append(lock_script(c))
    deterministic.seed(SEED)  # both twins draw the same idempotency ids
    try:
        out.append(idmp_script(c)[:2])
    finally:
        deterministic.unseed()
    rows = [s.get_range(b"", b"\xff\xff", s.version) for s in c.storages]
    smap = (list(c.dd.map.boundaries), [list(t) for t in c.dd.map.teams])
    state = state_to_numpy(c.resolvers[0].state)
    c.close()
    clock = [0.0]
    c = repl_cluster(device, target_tps=40.0, rk_clock=lambda: clock[0])
    c.set_tag_quota("quota", 3.0)
    rk = []
    for i in range(120):
        clock[0] += 0.004
        tr = c.database().create_transaction()
        if i % 3 == 0:
            tr.options.set_tag("quota")
        try:
            tr.get_read_version()
            rk.append("granted")
        except Exception as e:
            rk.append(e.code)
    c.close()
    return out, rows, smap, rk, state


def phase_replication(stream):
    """Phase 14 on the card; its launch and graph counts are zeroed at
    its start and read before the CPU twin."""
    from foundationdb_tpu_torch.ops import _kernels

    value = b"d" * 100
    rng = np.random.default_rng(SEED + 14)
    report = {}
    reset_counts()
    c = repl_cluster()
    report["rebalance"] = phase_replication_route(c)
    est = [c.database().create_transaction().get_estimated_range_size_bytes(
        b"", b"\xff")]
    chunks = len(c.range_split_points(b"", b"\xff", 10_000_000)) - 1
    report["native"] = phase_replication_native(stream)
    report["commits"] = phase_replication_commits(c, stream, value)
    report["sample_rows"] = replica_check(c, rng, "after the commits")
    est.append(c.database().create_transaction()
               .get_estimated_range_size_bytes(b"", b"\xff"))
    preloaded = REPL_PRELOAD * (len(b"user00000000") + 1000)
    log(f"[replication estimates] estimated bytes of the whole range "
        f"{est[0]} after the preload against {preloaded} preloaded, "
        f"{est[1]} after the range-heavy batches (DD halves a shard's "
        f"sample at each clear range over it); {chunks} split-point chunks "
        "of 10 MB after the preload")
    report.update(estimated_bytes=est, preloaded_bytes=preloaded,
                  split_chunks=chunks)
    i = 2 * CLUSTER_BATCHES + SPLIT_BATCHES
    report["failures"] = phase_replication_failures(
        c, stream[i:i + 2], value, rng)
    lock = lock_script(c)
    assert lock == [1038, "committed", "committed"], lock
    counters, ids, calls = idmp_script(c)
    assert counters == [IDMP_ROUNDS] * IDMP_COUNTERS, counters
    assert calls["unknown"] == 1 and calls["push"] >= 5, calls
    log(f"[replication lock] plain commit under the lock {lock[0]}, "
        f"lock-aware {lock[1]}, plain after unlock {lock[2]}")
    log(f"[replication idempotency] {IDMP_COUNTERS} counters x {IDMP_ROUNDS} "
        f"automatic-idempotency increments with a lost log quorum and a "
        f"lost reply: counters {counters}, exact; {ids} id rows")
    report.update(lock=lock, idmp=dict(counters=counters, id_rows=ids))
    c.close()
    del c
    gc.collect()
    report["ratekeeper"] = phase_ratekeeper()
    with tempfile.TemporaryDirectory() as d:
        restart = restart_script(None, d)
    assert restart[:4] == [True, REPL_COPIES, b"restart", 1038], restart
    log(f"[replication restart] dropped without a close and reopened: "
        f"{restart[4]} shards and their teams, replication {restart[1]}, "
        f"the lock {restart[2]!r} restored; a plain commit got {restart[3]}")
    report["restart"] = dict(map_restored=restart[0],
                             replication=restart[1],
                             lock_uid=restart[2].decode(),
                             plain_commit=restart[3], shards=restart[4])
    launches = dict(_kernels.launches)
    report["graphs"] = graph_report("replication")
    log(f"[replication] launches {launches}")
    gpu = twin_script(None, stream)
    cpu = twin_script("cpu", stream)
    for name, a, b in zip(("outcomes", "rows", "shard map", "admissions"),
                          gpu[:4], cpu[:4]):
        assert a == b, f"replication {name} differ between card and CPU"
    for f, a, b in zip(type(gpu[4])._fields, gpu[4], cpu[4]):
        assert np.array_equal(a, b), f"replication state field {f} differs"
    log(f"[replication replay] {TWIN_PRELOAD} rows, rebalance, 4 range-heavy"
        f" batches, a dead and recruited storage, an exclusion, the lock, "
        f"idempotent increments, {len(gpu[3])} GRVs under one clock: card "
        f"== CPU ({sum(map(len, gpu[1]))} rows over {REPL_STORAGE} storages,"
        f" {len(gpu[2][0])} shards, admissions, 12 state fields)")
    report["launches"] = launches
    return report, launches



# ── phase 15: regions, change feeds, configure() and tenants ──
REGION_STORAGE = 2  # the JAX region tests' layout, in memory
REGION_TLOGS = 3
REGIONS = {"primary": "east", "remote": "west", "satellites": 1}
REGION_PRELOAD = 100_000  # config 2's 1M rows cut tenfold, as in phase 14
REGION_ASYNC_PRELOAD = 8192  # (d)'s fresh cluster
REGION_RESIZE_BATCHES = 4  # (e): range-heavy batches on the 3 lanes


def region_stream_batches():
    """Range-heavy batches phase 15 commits on its main cluster: (a)'s
    timed drive and stage split, (c)'s first commit and (e)'s."""
    return (2 * CLUSTER_BATCHES + SPLIT_BATCHES + 1
            + 2 * REGION_RESIZE_BATCHES + 7)
FEED_ID = b"sixteenth"
TENANTS = 64
TENANT_ROWS = 64  # rows preloaded in each tenant
TENANT_TXNS = 4096  # (f): db.run transactions over the 64 client threads
TENANT_QUOTA_TRIES = 16
REGION_TWIN_PRELOAD = 2048
REGION_MEMORY_SLACK = 0.05


def region_cluster(device=None, mode="sync", **kw):
    """Phase 15's deployment: 2 storage servers and 3 logs in the
    primary region, one satellite log in the remote region."""
    from foundationdb_tpu_torch.server.cluster import Cluster

    if mode is not None:
        kw["regions"] = dict(REGIONS, satellite_mode=mode)
    return Cluster(device=device, n_storage=REGION_STORAGE,
                   n_tlogs=REGION_TLOGS, **kw)


def kill_primary_region(c):
    """Every primary process dies in one event: the storages, every log
    replica, the resolvers and the transaction system."""
    for s in c.storages:
        s.kill()
    for i in range(len(c.tlog.logs)):
        c.tlog.kill(i)
    for r in c.resolvers:
        r.kill()
    c.sequencer.kill()
    c._commit_target().kill()


def storage_digests(c, version):
    """Each storage's (rows, sha256 of its user rows) at ``version``."""
    out = []
    for s in c.storages:
        h = hashlib.sha256()
        rows = s.get_range(b"", b"\xff", version)
        for k, v in rows:
            h.update(len(k).to_bytes(4, "big") + k + len(v).to_bytes(4, "big")
                     + v)
        out.append((len(rows), h.hexdigest()))
    return out


def card_bytes():
    torch.cuda.synchronize()
    return torch.cuda.memory_allocated()


def feed_range():
    from foundationdb_tpu_torch import workloads

    return workloads.user_key(0), workloads.user_key(workloads.NKEYS // 16)


def expected_feed(batches, outcomes, value, limbs):
    """What the feed must hold: the mutations of the committed requests,
    clipped to its range, by commit version (each version's mutations
    sorted: the batch scheduler may commit a batch's requests in
    another order than they were sent)."""
    from foundationdb_tpu_torch import workloads
    from foundationdb_tpu_torch.core.mutations import Op

    lo, hi = feed_range()
    by_v = {}
    for (txns, cv, _), outs in zip(batches, outcomes):
        reqs = workloads.commit_requests(txns, cv, cv, limbs, value)
        for req, o in zip(reqs, outs):
            if not isinstance(o, int):
                continue
            for m in req.mutations:
                hit = (m.key < hi and lo < m.param
                       if m.op == Op.CLEAR_RANGE else lo <= m.key < hi)
                if hit:
                    by_v.setdefault(o, []).append(
                        (m.op.value, m.key, m.param))
    return [(v, sorted(ms)) for v, ms in sorted(by_v.items())]


def feed_entries(db, end_version=None):
    return [(v, sorted((m.op.value, m.key, m.param) for m in ms))
            for v, ms in db.read_change_feed(FEED_ID, 0, end_version)]


def region_sync_arm(c, stream, value):
    """15(a) and (b): the sync satellite attached after the preload by
    configure(), the feed registered, the range-heavy stream through
    commit_batch and a backlog; the feed against the committed
    mutations, then popped."""
    from foundationdb_tpu_torch import workloads
    from foundationdb_tpu_torch.ops import _kernels

    preload_s = preload(c, REGION_PRELOAD)
    db = c.database()
    db.register_change_feed(FEED_ID, *feed_range())
    t0 = time.perf_counter()
    shape = c.configure(regions=dict(REGIONS, satellite_mode="sync"))
    attach_s = time.perf_counter() - t0
    reg = c.regions
    seed_v, seed_muts = reg.satellite.peek(0)[0]
    attach = dict(preload_rows=REGION_PRELOAD, preload_s=preload_s,
                  attach_s=attach_s, seed_version=seed_v,
                  seed_rows=len(seed_muts),
                  recovery_ms=c.recovery_timeline.records[-1]["total_ms"],
                  shape=shape)
    assert len(seed_muts) >= REGION_PRELOAD, len(seed_muts)
    log(f"[regions attach] {REGION_PRELOAD} rows preloaded in "
        f"{preload_s:.3f} s; configure(regions=sync) in {attach_s:.3f} s "
        f"(its recovery {attach['recovery_ms']} ms): a seed of "
        f"{len(seed_muts)} rows at version {seed_v}")
    f0 = _kernels.launches["fused_accept"]
    n = 2 * CLUSTER_BATCHES
    r = proxy_stream(c, stream, CLUSTER_BATCHES, CLUSTER_BATCHES, value,
                     "regions sync", keep_outcomes=True)
    outcomes = r.pop("outcomes")
    r["fused_accept"] = _kernels.launches["fused_accept"] - f0
    assert r["fused_accept"] > 0, "fused_accept never launched"
    last_v = max(v for b in outcomes for v in b if isinstance(v, int))
    got = feed_entries(db, last_v)
    want = expected_feed(stream[:n], outcomes, value, c.knobs.key_limbs)
    assert got == want, "the change feed differs from the commits"
    mid = got[len(got) // 2][0]
    db.pop_change_feed(FEED_ID, mid)
    code = None
    try:
        db.read_change_feed(FEED_ID, 0)
    except Exception as e:
        code = e.code
    assert code == 1007, code
    feed = dict(entries=len(got), mutations=sum(len(m) for _, m in got),
                popped_at=mid, read_below=code)
    log(f"[regions feed] {len(got)} versions, {feed['mutations']} mutations "
        "in the feed's sixteenth of the keyspace, equal to the committed "
        f"requests' mutations clipped to it; popped at {mid}: a read from "
        f"below got {code}")
    assert reg.sync_misses == 0 and reg.lag_versions() == 0, reg.status()
    sites = {"sync_push": (reg, "sync_push"), "tlog_push": (c.tlog, "push"),
             "storage_apply_1": (c.storages[1], "apply")}
    r["stage_split"] = split = commit_stage_split(
        c, [lambda t=t, cv=cv: workloads.commit_requests(
            t, cv, c.sequencer.committed_version, c.knobs.key_limbs, value)
            for t, cv, _ in stream[n:n + SPLIT_BATCHES]], extra_sites=sites)
    log(f"[regions sync] {SPLIT_BATCHES} commit_batch calls, host ms per "
        "batch: " + ", ".join(f"{k} {v:.3f}"
                              for k, v in split["host_ms"].items())
        + f" of {split['wall_ms']:.3f} wall; device busy "
        f"{split['device_busy_ms']:.3f} ms per batch "
        f"({split['device_busy_share']:.1%}); sync misses "
        f"{reg.sync_misses}, lag {reg.lag_versions()} versions")
    assert reg.sync_misses == 0 and reg.lag_versions() == 0, reg.status()
    return attach, r, feed


def region_failover_arm(c, stream, value, rv_old):
    """15(c): the whole primary region dies; one detect_and_recruit()
    round promotes the remote one on the card."""
    from foundationdb_tpu_torch.ops import conflict as ck

    v = c.sequencer.committed_version
    before = storage_digests(c, v)
    gen0, mem0 = c.generation, card_bytes()
    kill_primary_region(c)
    t0 = time.perf_counter()
    events = c.detect_and_recruit()
    failover_ms = (time.perf_counter() - t0) * 1e3
    assert events == [("region-failover", 0)], events
    assert c.generation == gen0 + 1, (gen0, c.generation)
    rec = c.recovery_timeline.records[-1]
    assert rec["trigger"] == "region_failover", rec
    after = storage_digests(c, v)
    assert after == before, "an acknowledged row was lost in the failover"
    code = stale_commit(c, rv_old)
    assert code == 1007, f"a read from before the failover got {code}"
    caps = ck.graph_counts["captures"]
    outs, walls = commit_walls(c, stream[:1], value)
    assert ck.graph_counts["captures"] == caps, "a capture after the failover"
    mem1 = card_bytes()
    assert abs(mem1 - mem0) <= REGION_MEMORY_SLACK * mem0, (mem0, mem1)
    st = c.regions.status()
    r = dict(failover_ms=failover_ms, recovery_ms=rec["total_ms"],
             phases_ms=rec["phases"], generation=c.generation,
             rows=[n for n, _ in after], stale_code=code,
             first_commit_ms=walls[0],
             first_commit_committed=sum(isinstance(o, int) for o in outs[0]),
             memory_before=mem0, memory_after=mem1, status=st)
    log(f"[regions failover] primary region killed: detect_and_recruit "
        f"{failover_ms:.3f} ms (timeline {rec['total_ms']} ms "
        f"{rec['phases']}), generation {gen0} -> {c.generation}; rows "
        f"{r['rows']} equal to the primary's at {v}; a read from before "
        f"got {code}; first commit after it {walls[0]:.3f} ms, a replay "
        f"(captures unchanged); card memory {mem0} -> {mem1} B")
    return r


def region_async_arm(stream, value):
    """15(d): an async satellite on a fresh cluster: lag during a
    backlog, none after stream_now(), and after a failover every commit
    at or below the frontier survives."""
    from foundationdb_tpu_torch import workloads

    c = region_cluster(mode="async")
    preload(c, REGION_ASYNC_PRELOAD)
    reg = c.regions
    reqs = [workloads.commit_requests(t, cv, c.sequencer.committed_version,
                                      c.knobs.key_limbs, value)
            for t, cv, _ in stream[:4]]
    outs = [_outcomes(r) for r in c.commit_proxy.commit_batches(reqs)]
    lag_backlog = reg.lag_versions()
    assert lag_backlog > 0, "no lag behind an async backlog"
    t0 = time.perf_counter()
    copied = reg.stream_now()
    stream_ms = (time.perf_counter() - t0) * 1e3
    assert reg.lag_versions() == 0
    frontier = reg.position
    at_frontier = storage_digests(c, frontier)
    outs += commit_walls(c, stream[4:6], value)[0]
    lag_after = reg.lag_versions()
    acked = [v for b in outs for v in b if isinstance(v, int)]
    kill_primary_region(c)
    events = c.detect_and_recruit()
    assert events == [("region-failover", 0)], events
    assert reg.position == frontier
    assert storage_digests(c, frontier) == at_frontier, \
        "a commit at or below the frontier was lost"
    survived = sum(v <= frontier for v in acked)
    r = dict(lag_during_backlog=lag_backlog, records_streamed=copied,
             stream_ms=stream_ms, lag_at_failover=lag_after,
             frontier=frontier, acked=len(acked), acked_at_or_below=survived,
             status=reg.status())
    log(f"[regions async] lag {lag_backlog} versions behind a backlog of 4;"
        f" stream_now copied {copied} records in {stream_ms:.3f} ms, lag 0;"
        f" lag at the failover {lag_after} versions: the {survived} commits "
        f"at or below the frontier {frontier} survived, rows "
        f"{[n for n, _ in at_frontier]}")
    c.close()
    return r


def region_configure_arm(c, stream, value):
    """15(e): configure() on the promoted cluster: 3 resolver lanes, back
    to one, 3 lanes again (the leak check: the card memory after it
    against after the first), back to one, 3 commit proxies, the same
    call again, regions off."""
    from foundationdb_tpu_torch.core import systemdata
    from foundationdb_tpu_torch.ops import _kernels

    steps = []
    i = 0
    for cfg, batches in ((dict(resolvers=SHARDED_LANES),
                          REGION_RESIZE_BATCHES),
                         (dict(resolvers=1), 2),
                         (dict(resolvers=SHARDED_LANES),
                          REGION_RESIZE_BATCHES),
                         (dict(resolvers=1), 1),
                         (dict(commit_proxies=3), 2),
                         (dict(commit_proxies=3), 1),
                         (dict(regions="off"), 1)):
        gen0 = c.generation
        l0 = dict(_kernels.launches)
        t0 = time.perf_counter()
        shape = c.configure(**cfg)
        ms = (time.perf_counter() - t0) * 1e3
        outs, walls = commit_walls(c, stream[i:i + batches], value)
        i += batches
        step = dict(config={k: str(v) for k, v in cfg.items()}, shape=shape,
                    configure_ms=ms, recovered=c.generation - gen0,
                    recovery_ms=(c.recovery_timeline.records[-1]["total_ms"]
                                 if c.generation > gen0 else None),
                    first_commit_ms=walls[0],
                    committed=sum(isinstance(o, int) for b in outs for o in b),
                    launches={k: v - l0[k]
                              for k, v in _kernels.launches.items()},
                    memory=card_bytes())
        steps.append(step)
        log(f"[regions configure] {cfg}: {shape}, {ms:.3f} ms, recovery "
            f"{step['recovery_ms']} ms, first commit {walls[0]:.3f} ms, "
            f"{step['committed']} committed over {batches} batches; launches"
            f" {step['launches']}; card memory {step['memory']} B")
    lanes, one, lanes2, _, proxies, again, off = steps
    for st in (lanes, lanes2):
        assert st["shape"]["resolver_lanes"] == SHARDED_LANES
        assert st["launches"]["accept_sweep"] > 0
        assert st["launches"]["fused_accept"] == 0
    assert one["launches"]["fused_accept"] > 0
    assert proxies["shape"]["commit_proxies"] == 3
    assert again["recovered"] == 0, "a repeated configure recovered"
    assert all(st["recovered"] == 1 for st in steps if st is not again)
    assert c.regions is None
    s0 = c.storage
    assert s0.get(systemdata.CONF_REGIONS, s0.version) is None
    # replaced resolvers release their history and graphs: the third
    # resize's 3 lanes hold what the first's did
    m1, m3 = lanes["memory"], lanes2["memory"]
    assert abs(m3 - m1) <= REGION_MEMORY_SLACK * m1, (m1, m3)
    return dict(steps=steps)


def tenant_arm(d):
    """15(f): TENANTS tenants in mode "required" on a WAL-backed thread
    pipeline cluster with an async satellite; range-heavy shaped
    transactions in the tenants from 64 client threads; a plain write
    2130; a quota's 1213 for its tenant only; a restart restores the
    mode, the quotas and the region row."""
    from foundationdb_tpu_torch import workloads
    from foundationdb_tpu_torch.core.errors import FDBError
    from foundationdb_tpu_torch.layers.tenant import (
        Tenant,
        TenantManagement,
        tenant_tag,
    )
    from foundationdb_tpu_torch.ops import _kernels

    kw = dict(wal_path=os.path.join(d, "wal"),
              coordination_dir=os.path.join(d, "coordinators"))
    c = region_cluster(mode="async", commit_pipeline="thread", **QUIET, **kw)
    db = c.database()
    names = [b"tenant%02d" % i for i in range(TENANTS)]
    for name in names:
        TenantManagement.create_tenant(db, name)
        rows = [(workloads.user_key(j), b"t" * 100)
                for j in range(TENANT_ROWS)]
        Tenant(db, name).run(lambda tr, rows=rows: [tr.set(k, v)
                                                    for k, v in rows])
    TenantManagement.set_tenant_mode(db, "required")
    per = TENANT_TXNS // PIPE_CLIENTS
    rng = np.random.default_rng(SEED + 15)
    starts = rng.integers(0, TENANT_ROWS - 8, (PIPE_CLIENTS, per)).tolist()
    walls = [[] for _ in range(PIPE_CLIENTS)]

    def client(i):
        t = Tenant(db, names[i % TENANTS])
        for j in range(per):
            s = starts[i][j]

            def txn(tr):
                tr.get_range(workloads.user_key(s), workloads.user_key(s + 8))
                tr.clear_range(workloads.user_key(s + 2),
                               workloads.user_key(s + 6))
                tr.set(workloads.user_key(s + 2), b"r" * 100)

            t0 = time.perf_counter()
            t.run(txn)
            walls[i].append((time.perf_counter() - t0) * 1e3)

    f0 = _kernels.launches["fused_accept"]
    wall = run_clients(PIPE_CLIENTS, client)
    fused = _kernels.launches["fused_accept"] - f0
    assert fused > 0, "fused_accept never launched on tenant traffic"
    flat = [w for ws in walls for w in ws]
    try:
        db[b"plain"] = b"x"
        plain = "committed"
    except FDBError as e:
        plain = e.code
    assert plain == 2130, plain
    TenantManagement.set_tenant_quota(db, names[0], 1.0)
    codes = {}
    for name in names[:2]:
        got = []
        for k in range(TENANT_QUOTA_TRIES):
            tr = Tenant(db, name).create_transaction()
            try:
                tr[b"quota%02d" % k] = b"q"
                tr.commit()
                got.append("committed")
            except FDBError as e:
                got.append(e.code)
        codes[name.decode()] = got
    assert 1213 in codes[names[0].decode()], codes
    assert 1213 not in codes[names[1].decode()], codes
    region_row = c.regions.config.to_json()
    c.close()
    c = region_cluster(mode=None, **kw)  # the row brings the regions back
    restored = dict(tenant_mode=c.tenant_mode(),
                    quota=c.ratekeeper.tag_quotas.get(tenant_tag(names[0])),
                    regions=(c.regions.config.to_json()
                             if c.regions is not None else None))
    assert restored == dict(tenant_mode="required", quota=1.0,
                            regions=region_row), restored
    c.close()
    r = dict(tenants=TENANTS, txns=len(flat), wall_s=wall,
             committed_txns_per_s=len(flat) / wall,
             client_p50_ms=float(np.percentile(flat, 50)),
             client_p99_ms=float(np.percentile(flat, 99)),
             fused_accept=fused, plain_write=plain,
             quota_1213={k: v.count(1213) for k, v in codes.items()},
             restored=restored)
    log(f"[regions tenants] {TENANTS} tenants, mode required, {len(flat)} "
        f"transactions (get_range of 8, clear_range of 4, a set) on "
        f"{PIPE_CLIENTS} threads in {wall:.3f} s: "
        f"{r['committed_txns_per_s']:.1f} committed txns/s, client p50 "
        f"{r['client_p50_ms']:.3f} / p99 {r['client_p99_ms']:.3f} ms; "
        f"fused_accept {fused}; a plain write got {plain}; 1213s with the "
        f"quota {r['quota_1213']}; restart restored {restored}")
    return r


def region_twin(device, stream):
    """15(g): the phase's script at REGION_TWIN_PRELOAD rows: outcomes,
    rows per storage, the feed, the region status and the resolver
    state."""
    from foundationdb_tpu_torch import workloads
    from foundationdb_tpu_torch.convert import state_to_numpy
    from foundationdb_tpu_torch.layers.tenant import Tenant, TenantManagement

    c = region_cluster(device, mode=None)
    db = c.database()
    out = []
    for reqs in workloads.preload_requests(
            REGION_TWIN_PRELOAD, c.knobs.key_limbs, batch=256, seed=SEED):
        out.append(_outcomes(c.commit_proxy.commit_batch(reqs)))
    db.register_change_feed(FEED_ID, *feed_range())
    out.append(c.configure(regions=dict(REGIONS, satellite_mode="sync")))
    out += commit_walls(c, stream[:2], b"g")[0]
    c.regions.partition()
    out += commit_walls(c, stream[2:3], b"g")[0]
    c.regions.heal()
    out += commit_walls(c, stream[3:4], b"g")[0]
    kill_primary_region(c)
    out.append(c.detect_and_recruit())
    out += commit_walls(c, stream[4:5], b"g")[0]
    out.append(c.configure(resolvers=SHARDED_LANES))
    out += commit_walls(c, stream[5:6], b"g")[0]
    out.append(c.configure(resolvers=1, commit_proxies=2))
    TenantManagement.create_tenant(db, b"twin")
    TenantManagement.set_tenant_mode(db, "required")
    Tenant(db, b"twin")[b"k"] = b"v"
    out += commit_walls(c, stream[6:7], b"g")[0]
    st = dict(c.regions.status())
    st.pop("last_failover_ms")
    rows = [s.get_range(b"", b"\xff\xff", s.version) for s in c.storages]
    feed = feed_entries(db)
    state = state_to_numpy(c.resolvers[0].state)
    c.close()
    return out, rows, feed, st, state


def phase_regions(stream, rh_rate):
    """Phase 15 on the card; its launch and graph counts are zeroed at
    its start and read before the CPU twin."""
    from foundationdb_tpu_torch.ops import _kernels

    value = b"r" * 100
    report = {}
    reset_counts()
    c = region_cluster(mode=None)
    n = 2 * CLUSTER_BATCHES
    report["attach"], report["sync"], report["feed"] = region_sync_arm(
        c, stream, value)
    report["sync"]["vs_phase8"] = (
        report["sync"]["commit_batch_committed_per_s"] / rh_rate)
    log(f"[regions sync] range-heavy commit_batch "
        f"{report['sync']['commit_batch_committed_per_s']:.0f} committed "
        f"txns/s against phase 8's {rh_rate:.0f}: "
        f"{report['sync']['vs_phase8']:.3f}x")
    rv_old = c.sequencer.committed_version - 1
    rest = stream[n + SPLIT_BATCHES:]
    report["failover"] = region_failover_arm(c, rest, value, rv_old)
    report["configure"] = region_configure_arm(c, rest[1:], value)
    c.close()
    del c
    gc.collect()
    report["async"] = region_async_arm(stream, value)
    with tempfile.TemporaryDirectory() as d:
        report["tenants"] = tenant_arm(d)
    launches = dict(_kernels.launches)
    report["graphs"] = graph_report("regions")
    log(f"[regions] launches {launches}")
    gpu = region_twin(None, stream)
    cpu = region_twin("cpu", stream)
    for name, a, b in zip(("outcomes", "rows", "feed", "region status"),
                          gpu[:4], cpu[:4]):
        assert a == b, f"regions {name} differ between card and CPU"
    for f, a, b in zip(type(gpu[4])._fields, gpu[4], cpu[4]):
        assert np.array_equal(a, b), f"regions state field {f} differs"
    log(f"[regions replay] {REGION_TWIN_PRELOAD} rows, a sync satellite, a "
        f"partition and heal, a failover, 3 lanes and back, 2 proxies, a "
        f"tenant: card == CPU ({sum(map(len, gpu[1]))} rows over "
        f"{REGION_STORAGE} storages, {len(gpu[2])} feed versions, region "
        "status, 12 state fields)")
    report["launches"] = launches
    return report, launches


OBS_PRELOAD = 100_000  # config 2's 1M rows cut tenfold, as in phase 14
OBS_TXNS = 6_400  # (a): range-heavy db.run transactions, 100 a thread
OBS_RECOVERY_TXNS = 1_280  # (b): after the recovery, 20 a thread
OBS_TRACING_RATE = 0.01
# the shard size (a): FoundationDB's shards hold hundreds of MB; at DD's
# 250,000 B default phase 14's 100 MB split into 512 shards, which a
# scan round walks a batch each, every batch waiting on its cursor's
# commit. At 4 MB the map holds tens of shards
OBS_SHARD_BYTES = 4_000_000
# (a)'s scan: a batch of up to this many keys every ~1.5 intervals, not
# paced by bytes, so a whole round over the 100,000 rows ends inside the
# drive
OBS_SCAN_BATCH_KEYS = 2_048
OBS_SCAN_INTERVAL_S = 0.002
OBS_HISTORY_CADENCE_S = 0.5
OBS_SCAN_DEADLINE_S = 60.0  # (c): the planted row confirmed within this
OBS_SMOKE_PRELOAD = 16_384  # (d)'s sync cluster: the ratio needs no more
OBS_SMOKE_BATCHES = 12
OBS_SMOKE_PAIRS = 5
OBS_TWIN_PRELOAD = 2048
OBS_MEMORY_SLACK = 0.05
OBS_MODULES = ("metrics", "heatmap", "deviceprofile", "health", "timeseries",
               "consistencyscan")


def obs_knobs():
    return dict(tracing_sample_rate=OBS_TRACING_RATE,
                consistency_scan_batch_keys=OBS_SCAN_BATCH_KEYS,
                consistency_scan_interval_s=OBS_SCAN_INTERVAL_S,
                scan_rate_bytes_per_s=0.0,
                history_cadence_s=OBS_HISTORY_CADENCE_S)


def obs_modules():
    """The kill switch of each observability module."""
    import importlib

    mods = {"metrics": "utils.metrics", "heatmap": "utils.heatmap",
            "deviceprofile": "utils.deviceprofile",
            "health": "server.health", "timeseries": "utils.timeseries",
            "consistencyscan": "server.consistencyscan"}
    return [importlib.import_module("foundationdb_tpu_torch." + mods[n])
            for n in OBS_MODULES]


class RouteTally:
    """One resolver's two dispatch sites (the single step and the
    backlog scan) wrapped so that each dispatch's route, live batches
    and batch slots (pads included) are tallied; a dispatch holds
    ``lock`` from its kernels' launch to its profile record, so a
    snapshot under it sees none half counted. ``close`` unwraps."""

    def __init__(self, r):
        import threading

        self.r, self.lock = r, threading.Lock()
        self.live, self.slots, self.backlogs = {}, {}, 0
        step, scan = r._profiled_step, r._scan

        def add(use_fast, live, slots):
            route = r._kernel_route(use_fast)
            self.live[route] = self.live.get(route, 0) + live
            self.slots[route] = self.slots.get(route, 0) + slots
            self.backlogs += slots > 1

        def profiled_step(use_fast, batch, n, *a, **kw):
            with self.lock:
                out = step(use_fast, batch, n, *a, **kw)
                add(use_fast, 1, 1)
            return out

        def scan_(use_fast, stacked, n_batches, *a, **kw):
            with self.lock:
                out = scan(use_fast, stacked, n_batches, *a, **kw)
                add(use_fast, n_batches, stacked.rv.shape[0])
            return out

        r._profiled_step, r._scan = profiled_step, scan_

    def snapshot(self):
        return dict(live=dict(self.live), slots=dict(self.slots),
                    backlogs=self.backlogs)

    def close(self):
        del self.r._profiled_step, self.r._scan


def obs_counts(c, tally=None):
    """The counters the phase holds across its arms, read under the
    commit mutex (which every single-batch dispatch takes) and the
    tally's lock (which every dispatch of its resolver takes) so that no
    dispatch lands between them: the workload counters, the probes, the
    device profile's aggregate, the launch and graph counts, the
    tally's."""
    from foundationdb_tpu_torch.ops import _kernels
    from foundationdb_tpu_torch.ops import conflict as ck

    with c._commit_target()._commit_mu, (
            tally.lock if tally else contextlib.nullcontext()):
        st = c.status()["cluster"]
        return dict(status=st, launches=dict(_kernels.launches),
                    graphs=dict(ck.graph_counts),
                    profile=st["device"]["aggregate"],
                    tally=tally.snapshot() if tally else None,
                    counters={k: v["counter"] for k, v in
                              st["workload"]["transactions"].items()})


def obs_drive(db, txns, seed):
    """``txns`` range-heavy transactions (config 5's shapes: an 8-key
    scan and a 4-key clear, Zipfian over config 2's 1M keys, of which
    the preload holds the first OBS_PRELOAD, as phases 14 and 15 drive
    them) on PIPE_CLIENTS threads; returns the wall seconds."""
    from foundationdb_tpu_torch import workloads

    per = txns // PIPE_CLIENTS
    cdf = workloads.zipfian_cdf(workloads.NKEYS, workloads.THETA)
    samplers = [workloads.zipfian_sampler(
        workloads.NKEYS, workloads.THETA, np.random.default_rng(seed + i),
        cdf) for i in range(PIPE_CLIENTS)]

    def client(i):
        for _ in range(per):
            a, b = (int(x) for x in samplers[i](2))

            def txn(tr, a=a, b=b):
                tr.get_range(workloads.user_key(a), workloads.user_key(a + 8))
                tr.clear_range(workloads.user_key(b),
                               workloads.user_key(b + 4))

            db.run(txn)

    return run_clients(PIPE_CLIENTS, client)


def occ_pair(db):
    """A read-modify-write that loses to a concurrent writer (1020),
    then commits on its retry: a conflict the heatmap charges."""
    from foundationdb_tpu_torch.core.errors import FDBError

    t1 = db.create_transaction()
    t1.get(b"obs/ctr")
    db.run(lambda tr: tr.set(b"obs/ctr", b"other"))
    t1.set(b"obs/ctr", b"mine")
    try:
        t1.commit()
    except FDBError as e:
        assert e.code == 1020, e.code
        return 1020
    raise AssertionError("the OCC pair committed both writers")


def obs_drive_checks(a, b, wall):
    """(a)'s checks over the drive window [a, b]."""
    st = b["status"]
    health = st["health"]
    assert health["verdict"] == "healthy", (health["reasons"],
                                            health["ratekeeper"],
                                            b["counters"])
    probe = health["probe"]
    assert probe["probes"] > a["status"]["health"]["probe"]["probes"], probe
    assert probe["commit"]["count"] > 0, probe
    hist = st["history"]
    assert hist["windows"] >= 3, hist["windows"]
    scan = st["consistency_scan"]
    assert scan["round"] > a["status"]["consistency_scan"]["round"], scan
    assert scan["inconsistencies"] == 0, scan
    for dim in ("conflict", "read", "write"):
        assert st["workload"]["hot_ranges"][dim], f"no {dim} heat"
    assert st["trace"]["spans_emitted"] > a["status"]["trace"][
        "spans_emitted"], st["trace"]
    p0, p1 = a["profile"], b["profile"]
    routes = (p1["kernel_routes"].get("fused_accept", 0)
              - p0["kernel_routes"].get("fused_accept", 0))
    launches = b["launches"]["fused_accept"] - a["launches"]["fused_accept"]
    # a profile route counts a live batch, a launch every slot of a
    # replay: they differ by the pads of the backlog scans
    t0, t1 = a["tally"], b["tally"]
    live = (t1["live"].get("fused_accept", 0)
            - t0["live"].get("fused_accept", 0))
    slots = (t1["slots"].get("fused_accept", 0)
             - t0["slots"].get("fused_accept", 0))
    pads = slots - live
    backlogs = t1["backlogs"] - t0["backlogs"]
    assert routes > 0 and routes == live, (routes, live)
    assert launches == slots == routes + pads, (launches, slots, routes, pads)
    assert all(v == 0 for v in p1["fallback_causes"].values()), \
        p1["fallback_causes"]
    assert p1["recompiles"] == b["graphs"]["captures"], \
        (p1["recompiles"], b["graphs"])
    assert b["graphs"]["captures"] == a["graphs"]["captures"], \
        "the drive captured a step"
    assert b["graphs"]["replays"] == b["graphs"]["dispatches"]
    txns = b["counters"]["committed"] - a["counters"]["committed"]
    log(f"[observability drive] {OBS_TXNS} range-heavy txns on "
        f"{PIPE_CLIENTS} threads in {wall:.3f} s: {txns} committed "
        f"({txns / wall:.1f}/s, probe and scan commits included); verdict "
        f"{health['verdict']}; probes {probe['probes']} (commit p99 "
        f"{probe['commit']['p99_ms']} ms); {hist['windows']} history "
        f"windows; scan round {scan['round']} ({scan['keys_scanned']} keys, "
        f"{scan['bytes_scanned']} B, last round {scan['last_round_ms']} ms); "
        f"hot ranges {[len(st['workload']['hot_ranges'][d]) for d in ('conflict', 'read', 'write')]}; "
        f"spans {st['trace']['spans_emitted']}; fused_accept routes "
        f"{routes} == launches {launches} less {pads} pads of "
        f"{backlogs} backlog scans; compiles {p1['recompiles']} == "
        f"captures; fallback causes all 0")
    # where a batch's time goes in this deployment, by the roles' bands
    # (cumulative since the cluster started) and the profile's walls
    ru = st["metrics"]["rollups"]
    n_disp = max(1, p1["dispatches"] - p0["dispatches"])
    split = dict(
        commit_e2e_p50_ms=ru["commit_latency_p50_ms"],
        commit_e2e_p99_ms=ru["commit_latency_p99_ms"],
        grv_p99_ms=ru["grv_latency_p99_ms"],
        tlog_push_p99_ms=ru["tlog_push_p99_ms"],
        storage_apply_p99_ms=ru["storage_apply_p99_ms"],
        storage_apply_p50_ms=[
            s["metrics"]["latency_ms"]["storage_apply"]["p50_ms"]
            for s in st["processes"]["storage_servers"]],
        dispatch_ms_per_dispatch=(p1["dispatch_wall_ms"]
                                  - p0["dispatch_wall_ms"]) / n_disp,
        verdict_wait_ms_per_dispatch=(p1["verdict_reduce_wall_ms"]
                                      - p0["verdict_reduce_wall_ms"]) / n_disp)
    log(f"[observability split] submit->settle p50 "
        f"{split['commit_e2e_p50_ms']} / p99 {split['commit_e2e_p99_ms']} "
        f"ms; grv p99 {split['grv_p99_ms']}; tlog push p99 "
        f"{split['tlog_push_p99_ms']}; storage apply p50 "
        f"{split['storage_apply_p50_ms']} / p99 "
        f"{split['storage_apply_p99_ms']} ms; resolver dispatch "
        f"{split['dispatch_ms_per_dispatch']:.4f} and statuses' wait "
        f"{split['verdict_wait_ms_per_dispatch']:.4f} ms a dispatch")
    return dict(txns=OBS_TXNS, wall_s=wall, committed=txns,
                committed_per_s=txns / wall, probes=probe["probes"],
                probe_commit_p99_ms=probe["commit"]["p99_ms"],
                windows=hist["windows"], scan_rounds=scan["round"],
                scan_last_round_ms=scan["last_round_ms"],
                spans_emitted=st["trace"]["spans_emitted"],
                fused_accept_routes=routes, fused_accept_launches=launches,
                fused_accept_pads=pads, backlog_scans=backlogs,
                compiles=p1["recompiles"],
                dispatch_wall_ms=p1["dispatch_wall_ms"],
                verdict_reduce_wall_ms=p1["verdict_reduce_wall_ms"],
                transfer_bytes=p1["transfer_bytes"],
                pad_waste_pct=p1["pad_waste_pct"],
                hottest_stage=st["metrics"]["rollups"]["hottest_stage"],
                stage_totals_s=st["metrics"]["rollups"][
                    "hottest_stage_totals_s"],
                split=split)


def obs_recovery(c, db, before):
    """(b): a transaction-system recovery, then more traffic; nothing
    goes backwards and card memory stays within OBS_MEMORY_SLACK."""
    mem0 = card_bytes()
    t0 = time.perf_counter()
    c.sequencer.kill()
    events = c.detect_and_recruit()
    rec_s = time.perf_counter() - t0
    assert events == [("txn-system", 0)], events
    obs_drive(db, OBS_RECOVERY_TXNS, SEED + 700)
    after = obs_counts(c)
    mem1 = card_bytes()
    for k in ("committed", "started", "conflicted"):
        assert after["counters"][k] >= before["counters"][k], (k, before,
                                                                after)
    assert after["counters"]["committed"] > before["counters"]["committed"]
    assert after["profile"]["dispatches"] > before["profile"]["dispatches"]
    probes = [x["status"]["health"]["probe"]["probes"]
              for x in (before, after)]
    assert probes[1] >= probes[0], probes
    assert abs(mem1 - mem0) <= OBS_MEMORY_SLACK * mem0, (mem0, mem1)
    rec = after["status"]["health"]["recovery"]
    log(f"[observability recovery] detect_and_recruit {rec_s * 1e3:.3f} ms "
        f"(timeline {rec['last_recovery_ms']} ms, generation "
        f"{after['status']['generation']}); counters {before['counters']} -> "
        f"{after['counters']}, dispatches {before['profile']['dispatches']} "
        f"-> {after['profile']['dispatches']}, probes {probes[0]} -> "
        f"{probes[1]}; card memory {mem0} -> {mem1} B")
    return dict(recovery_ms=rec["last_recovery_ms"], wall_ms=rec_s * 1e3,
                before=before["counters"], after=after["counters"],
                card_bytes=[mem0, mem1])


def obs_plant(c, db):
    """(c): one replica takes a write no commit made. Before it the check
    and the scan are clean; after it the scanner confirms it, the verdict
    turns degraded with data_inconsistent and consistency_check() lists
    it."""
    from foundationdb_tpu_torch import workloads
    from foundationdb_tpu_torch.core.mutations import Mutation, Op

    assert c.consistency_check() == []
    assert c.consistency_scan_status()["inconsistencies"] == 0
    key = workloads.user_key(OBS_PRELOAD // 2)
    sid = c.dd.map.team_for(key)[0]
    s = c.storages[sid]
    # under the commit mutex: no apply of the pipeline interleaves
    with c._commit_target()._commit_mu:
        s.apply(s.version + 1, [Mutation(Op.SET, key, b"planted")])
    db.run(lambda tr: tr.set(b"obs/after-plant", b"1"))  # moves the version
    t0 = time.perf_counter()
    while c.consistency_scan_status()["inconsistencies"] == 0:
        assert time.perf_counter() - t0 < OBS_SCAN_DEADLINE_S, \
            "the scanner never confirmed the planted row"
        time.sleep(0.05)
    confirm_s = time.perf_counter() - t0
    health = c.health_status()
    problems = c.consistency_check()
    assert health["verdict"] == "degraded", health["verdict"]
    assert "data_inconsistent" in health["reasons"], health["reasons"]
    assert problems and any(repr(key)[2:-1] in p for p in problems), problems
    log(f"[observability plant] {key!r} on storage {sid}: the scanner "
        f"confirmed it after {confirm_s:.3f} s; verdict {health['verdict']} "
        f"{health['reasons']}; consistency_check: {len(problems)} problem(s)")
    return dict(confirm_s=confirm_s, reasons=health["reasons"],
                problems=len(problems))


def obs_overhead():
    """(d): the metrics_smoke protocol on a sync cluster: OBS_SMOKE_PAIRS
    interleaved pairs of OBS_SMOKE_BATCHES-batch range-heavy commit_batch
    runs, one arm with every module switched off and tracing at 0, the
    other with all on and tracing at OBS_TRACING_RATE; the medians and
    their ratio (printed, not gated). Then one pipelined group's
    dispatch under set_sync_debug_mode("error")."""
    from foundationdb_tpu_torch import workloads
    from foundationdb_tpu_torch.server.cluster import Cluster

    c = Cluster(**obs_knobs())
    preload(c, OBS_SMOKE_PRELOAD)
    stream = workloads.range_heavy(OBS_SMOKE_BATCHES + 6, seed=SEED + 16)
    mods = obs_modules()

    def run(off=()):
        """One run with the modules named in ``off`` (and tracing, if
        named) switched off: committed txns/s."""
        for name, m in zip(OBS_MODULES, mods):
            m.set_enabled(name not in off)
        c.set_tracing(sample_rate=0.0 if "tracing" in off
                      else OBS_TRACING_RATE)
        reqs = [workloads.commit_requests(
            txns, cv, c.sequencer.committed_version, c.knobs.key_limbs,
            b"o" * 100) for txns, cv, _ in stream[:OBS_SMOKE_BATCHES]]
        n = sum(len(r) for r in reqs)
        t0 = time.perf_counter()
        ok = sum(sum(isinstance(v, int)
                     for v in c.commit_proxy.commit_batch(r)) for r in reqs)
        assert 0 < ok <= n, (ok, n)
        return ok / (time.perf_counter() - t0)

    runs = {True: [], False: []}
    try:
        for _ in range(OBS_SMOKE_PAIRS):
            runs[False].append(run(off=OBS_MODULES + ("tracing",)))
            runs[True].append(run())
    finally:
        for m in mods:
            m.set_enabled(True)
    on, off = float(np.median(runs[True])), float(np.median(runs[False]))
    log(f"[observability overhead] {OBS_SMOKE_PAIRS} pairs of "
        f"{OBS_SMOKE_BATCHES}-batch range-heavy commit_batch runs: median "
        f"{on:.1f} committed txns/s with every module on (tracing "
        f"{OBS_TRACING_RATE}), {off:.1f} with all off; on/off {on / off:.4f}")
    # one pipelined group's dispatch adds no host sync: the capture sites
    # (the profile, the route, the spans) are all host-side
    cp = c._commit_target()
    group = [workloads.commit_requests(
        txns, cv, c.sequencer.committed_version, c.knobs.key_limbs, b"s")
        for txns, cv, _ in stream[OBS_SMOKE_BATCHES:OBS_SMOKE_BATCHES + 3]]
    cp.commit_batches_finish(cp.commit_batches_begin(group))  # warm
    group = [workloads.commit_requests(
        txns, cv, c.sequencer.committed_version, c.knobs.key_limbs, b"s")
        for txns, cv, _ in stream[OBS_SMOKE_BATCHES + 3:]]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        pg = cp.commit_batches_begin(group)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert pg.results_list is None and pg.handle is not None, pg.error
    cp.commit_batches_finish(pg)
    log("[observability overhead] a pipelined group's dispatch under "
        "set_sync_debug_mode('error'): no host sync")
    c.close()
    return dict(on_txns_per_s=on, off_txns_per_s=off, ratio=on / off,
                runs_on=runs[True], runs_off=runs[False])


def obs_twin(device, stream):
    """(e): the phase's script on a sync cluster at OBS_TWIN_PRELOAD rows
    under a clock that moves only where the script ticks it: the status
    documents after it."""
    from foundationdb_tpu_torch.core import deterministic

    clock = [1000.0]
    deterministic.seed(SEED)
    deterministic.set_clock(lambda: clock[0])
    try:
        c = repl_cluster(device, accept_kernel="on", **obs_knobs())
        c.dd.max_shard_bytes = 64_000
        for reqs in workloads_preload(c, OBS_TWIN_PRELOAD):
            _outcomes(c.commit_proxy.commit_batch(reqs))
        settle_map(c)
        commit_walls(c, stream[:2], b"t")
        db = c.database()
        occ_pair(db)
        docs = []
        for _ in range(6):
            clock[0] += 0.5
            c.prober.maybe_probe()
            c.scanner.maybe_scan()
            c.history.maybe_collect()
        docs.append(c.status()["cluster"])
        c.sequencer.kill()
        c.detect_and_recruit()
        commit_walls(c, stream[2:3], b"t")
        for _ in range(4):
            clock[0] += 0.5
            c.prober.maybe_probe()
            c.scanner.maybe_scan()
            c.history.maybe_collect()
        docs.append(c.status()["cluster"])
        c.close()
        return docs
    finally:
        deterministic.unseed()
        deterministic.set_clock(time.time)


def workloads_preload(c, n):
    from foundationdb_tpu_torch import workloads

    return workloads.preload_requests(n, c.knobs.key_limbs, batch=256,
                                      seed=SEED)


def twin_doc(doc):
    """A status document less what is the device's own: each resolver's
    device and graphs (a CPU step captures none), and the process-wide
    trace counters (the card's twin ran after the rest of this
    process's phases)."""
    doc = json.loads(json.dumps(doc))
    for r in doc["processes"]["resolvers"]:
        del r["device"], r["graphs"]
    for k in ("suppressed_events", "suppressed_by_type", "spans_sampled",
              "spans_emitted"):
        del doc["trace"][k]
    return doc


def phase_observability():
    """Phase 16 on the card; its launch and graph counts are zeroed at
    its start and read before the CPU twin."""
    from foundationdb_tpu_torch import workloads
    from foundationdb_tpu_torch.ops import _kernels

    t_phase = time.perf_counter()
    report = dict(knobs=obs_knobs())
    log(f"[observability] scan batch {OBS_SCAN_BATCH_KEYS} keys every "
        f"~{OBS_SCAN_INTERVAL_S * 1.5 * 1e3:.1f} ms, unpaced; history "
        f"cadence {OBS_HISTORY_CADENCE_S} s; tracing {OBS_TRACING_RATE}")
    from foundationdb_tpu_torch.server import consistencyscan

    reset_counts()
    # the scan starts once the map has settled: a round walking shards
    # while they split and move only re-reads them
    consistencyscan.set_enabled(False)
    try:
        c = repl_cluster(commit_pipeline="thread", **obs_knobs())
        c.dd.max_shard_bytes = OBS_SHARD_BYTES
        db = c.database()
        t0 = time.perf_counter()
        preload(c, OBS_PRELOAD)
        rounds = settle_map(c)
        report["preload_s"] = time.perf_counter() - t0
    finally:
        consistencyscan.set_enabled(True)
    # every step captured before the drive, as a server at start-up;
    # under the commit mutex, which every single-batch dispatch takes
    with c._commit_target()._commit_mu:
        keys = c.resolvers[0].precompile()
    # the full variant from here on (a range write enters history)
    db.run(lambda tr: tr.clear_range(b"obs/", b"obs0"))
    log(f"[observability] {OBS_PRELOAD} rows and {len(rounds)} rebalance "
        f"rounds ({len(c.dd.map)} shards) in {report['preload_s']:.3f} s; "
        f"{len(keys)} steps precompiled")
    tally = RouteTally(c.resolvers[0])
    a = obs_counts(c, tally)
    wall = obs_drive(db, OBS_TXNS, SEED + 600)
    occ_pair(db)
    b = obs_counts(c, tally)
    tally.close()
    report["drive"] = obs_drive_checks(a, b, wall)
    report["recovery"] = obs_recovery(c, db, b)
    report["plant"] = obs_plant(c, db)
    c.close()
    del c, db
    gc.collect()
    launches = dict(_kernels.launches)
    report["graphs"] = graph_report("observability")
    log(f"[observability] launches {launches}")
    report["overhead"] = obs_overhead()
    stream = workloads.range_heavy(3, txns=256, seed=SEED, nkeys=4096)
    gpu = obs_twin(None, stream)
    cpu = obs_twin("cpu", stream)
    for i, (g, p) in enumerate(zip(gpu, cpu)):
        g, p = twin_doc(g), twin_doc(p)
        assert g == p, ("observability twin status differs", i,
                        [k for k in g if g[k] != p.get(k)])
    log(f"[observability replay] {OBS_TWIN_PRELOAD} rows, a conflict, a "
        f"recovery, probes, scans and history windows on a step clock: the "
        f"card's status document == the CPU's ({len(gpu[-1])} keys, apart "
        f"from the resolvers' device and graphs)")
    report["seconds"] = time.perf_counter() - t_phase
    log(f"[observability] phase 16 took {report['seconds']:.3f} s")
    report["launches"] = launches
    return report, launches


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from foundationdb_tpu_torch import workloads
    from foundationdb_tpu_torch.core.options import Knobs
    from foundationdb_tpu_torch.ops import _kernels

    t_start = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    log(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    phase_build()
    count_eager_steps()
    checks = phase_kernels()

    streams = {name: make(STREAM_BATCHES, seed=SEED)
               for name, make in workloads.STREAMS.items()}
    # the streams are set-up data (about a million objects a resolver
    # process would never hold at once): keep the collector from
    # rescanning them inside the timed phases
    gc.collect()
    gc.freeze()
    main_report, main_launches = phase_main(streams, Knobs(), "main")
    ring_report, ring_launches = phase_main(
        {"mixed": streams["mixed"]},
        Knobs(accept_kernel="off", ring_kernel="on"), "ring-route")
    phase_parts(checks)
    main_report["packers"] = phase_packers(streams)
    phase_replay(streams)
    graphs_report = phase_graphs(streams)
    cluster_report, cluster_launches = phase_cluster(streams)
    phase_cluster_replay(streams)
    sharded_report = phase_sharded(streams)
    phase_sharded_replay(streams)
    sharded_report["partitioned"] = phase_partitioned(streams)
    sharded_launches = dict(_kernels.launches)
    log(f"[sharded] launches over phase 10 {sharded_launches}")
    sharded_report["graphs"] = graph_report("sharded and partitioned")
    del streams
    gc.collect()
    pipeline_report_, pipeline_launches = phase_pipeline()
    gc.collect()
    durable_stream = workloads.range_heavy(max(
        2 * CLUSTER_BATCHES, RECOVERY_BATCHES + SPLIT_BATCHES // 2
        + RECOVERY_AFTER_KILL + RECOVERY_AFTER), seed=SEED)
    recovery_report, recovery_launches = phase_recovery(durable_stream)
    native_report = phase_native(durable_stream)
    gc.collect()
    repl_stream = workloads.range_heavy(
        2 * CLUSTER_BATCHES + SPLIT_BATCHES + 2, seed=SEED)
    repl_report, repl_launches = phase_replication(repl_stream)
    rh = cluster_report["range_heavy"]["commit_batch_committed_per_s"]
    repl_report["vs_phase8"] = (
        repl_report["commits"]["commit_batch_committed_per_s"] / rh)
    log(f"[replication] range-heavy commit_batch "
        f"{repl_report['commits']['commit_batch_committed_per_s']:.0f} "
        f"committed txns/s against phase 8's {rh:.0f}: "
        f"{repl_report['vs_phase8']:.3f}x")
    del repl_stream
    gc.collect()
    region_stream = workloads.range_heavy(region_stream_batches(), seed=SEED)
    region_report, region_launches = phase_regions(region_stream, rh)
    del region_stream
    gc.collect()
    obs_report, obs_launches = phase_observability()

    kernels = []
    for name, src, replaces in (
            ("fused_accept", "foundationdb_tpu_torch/csrc/accept.cu",
             "foundationdb_tpu/ops/pallas_scan.py:81"),
            ("ring_hits", "foundationdb_tpu_torch/csrc/ring.cu",
             "foundationdb_tpu/ops/pallas_ring.py:62"),
            # no TPU kernel: the reference's on-device lax.while_loop
            ("accept_sweep", "foundationdb_tpu_torch/csrc/accept.cu",
             "foundationdb_tpu/ops/conflict.py:560")):
        cases = checks[name]
        head = cases[0]
        by_path = {"main": main_launches[name],
                   "ring_route": ring_launches[name],
                   "cluster": cluster_launches[name],
                   "pipeline": pipeline_launches[name],
                   "sharded_and_partitioned": sharded_launches[name],
                   "recovery": recovery_launches[name],
                   "native": native_report["launches"][name],
                   "replication": repl_launches[name],
                   "regions": region_launches[name],
                   "observability": obs_launches[name]}
        kernels.append(dict(
            name=name, route="cuda", source=src, replaces=replaces,
            launches=sum(by_path.values()), launches_by_path=by_path,
            max_abs_err=max(c["max_abs_err"] for c in cases),
            mismatches=sum(c["mismatches"] for c in cases),
            ms=head["ms"], plain_ms=head["plain_ms"],
            device_ms=head["device_ms"],
            plain_device_ms=head["plain_device_ms"],
            bound_ms=head["bound_ms"], bound_by=head["bound_by"],
            library_ms=None, cases=cases))
    summary = dict(card=card, main=main_report, ring_route=ring_report,
                   graphs=graphs_report, cluster=cluster_report,
                   pipeline=pipeline_report_, sharded=sharded_report,
                   recovery=recovery_report, native=native_report,
                   replication=repl_report, regions=region_report,
                   observability=obs_report,
                   seconds=time.perf_counter() - t_start)
    log("[summary] " + json.dumps(summary))
    log(f"[total] chip_smoke.py took {summary['seconds']:.3f} s, phase 16 "
        f"{obs_report['seconds']:.3f} s of it")
    paths = {"fused_accept": ("main", "cluster", "pipeline", "recovery",
                              "replication", "regions", "observability"),
             "ring_hits": ("ring_route",),
             "accept_sweep": ("main", "ring_route",
                              "sharded_and_partitioned", "regions")}
    for k in kernels:
        for path in paths[k["name"]]:
            assert k["launches_by_path"][path] > 0, \
                f"{k['name']} never launched on the {path} path"
        assert k["mismatches"] == 0 and k["max_abs_err"] == 0, k["name"]
        # the reference runs no Pallas kernel on the mesh or the
        # partitioned ring: neither ported kernel may launch there
        if k["name"] != "accept_sweep":
            assert k["launches_by_path"]["sharded_and_partitioned"] == 0, \
                k["name"]
        # the host resolvers run no kernel, as in the reference
        assert k["launches_by_path"]["native"] == 0, k["name"]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

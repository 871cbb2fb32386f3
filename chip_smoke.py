"""Drive the PyTorch/CUDA Resolver on one card and hold its kernels to
their plain versions.

    python3 chip_smoke.py

Phases:
  1. the card's name and power limit (nvidia-smi);
  2. build csrc/*.cu with nvcc (one process per source, in parallel) and
     print ptxas' registers and shared memory per kernel;
  3. at the default widths (T=1024, W=9, KR=4096), each kernel against its
     plain PyTorch version on the card, on inputs taken from a Resolver's
     own history: ring_hits in point (Q=4096) and range (Q=2048) mode,
     fused_accept on a Zipfian mixed batch and on a high-conflict batch;
     kernel and plain times by CUDA events;
  4. the main path: Resolver() with default knobs (accept kernel on)
     through resolve (12 batches) and two resolve_many backlogs (depth
     12) on YCSB-A, range-heavy and mixed streams of 1024-txn batches;
     launch counts are zeroed just before and read just after;
  5. the ring-kernel path: the mixed stream again with accept_kernel="off",
     ring_kernel="on", counted the same way;
  6. the first batches of each stream replayed on Resolver(device="cpu"):
     statuses and all 12 state fields must be equal.

Any failure raises and the script exits non-zero; without a card it exits
non-zero before printing any result. The line before the last is
{"kernels": [...]}; the last is {"ok": true, "device": {...}}.
"""

import gc
import json
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 0
RESOLVE_BATCHES = 12  # per stream, one resolve() each
BACKLOG = 12
STREAM_BATCHES = RESOLVE_BATCHES + 2 * BACKLOG  # then two resolve_many
REPLAY_BATCHES = 4
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
# no integer peak is published for the CUDA cores; the non-tensor
# float32 rate is the fastest rate any 32-bit scalar op could retire at,
# so dividing by it keeps the bound a lower bound
SCALAR_OPS_PER_S = 67e12


def log(*a):
    print(*a, flush=True)


def cuda_ms(fn, reps):
    """Mean device milliseconds per call, warmed, by CUDA events."""
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


def accept_ops(state, batch, T):
    """Integer ops of the accept step on these inputs: the ring walk of
    every live read slot, the pair tiles (all w < r, every hash pair, and
    the limb compares of every live slot pair of the interval lanes) and
    one step of the sweep per txn."""
    W = batch.pr_key.shape[-1]
    ring = (state.ring_b, state.ring_e, state.ring_v, state.ring_mask)
    PR, PW = batch.pr_key.shape[1], batch.pw_key.shape[1]
    RR, RW = batch.rr_b.shape[1], batch.rw_b.shape[1]
    rvq = batch.rv[:, None]
    ops = ring_ops(batch.pr_key.reshape(-1, W), batch.pr_key.reshape(-1, W),
                   rvq.expand(T, PR).reshape(-1), batch.pr_mask.reshape(-1),
                   *ring, point=True)
    ops += ring_ops(batch.rr_b.reshape(-1, W), batch.rr_e.reshape(-1, W),
                    rvq.expand(T, RR).reshape(-1), batch.rr_mask.reshape(-1),
                    *ring, point=False)
    upper = torch.ones((T, T), dtype=torch.bool, device=batch.rv.device).triu(1)
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
    static shared memory, which is 0 for all of them)."""
    W, T = p.key_width, p.txns
    ring_walk = 4 * 512 * (2 * W + 2)  # lex.cuh ring_walk_smem_bytes
    pairs = 4 * (32 * (p.point_reads * (W + 2) + p.range_reads * (2 * W + 1))
                 + 8 * (p.point_writes * (W + 2)
                        + p.range_writes * (2 * W + 1)))
    return {"ring_hits_kernel": ring_walk, "accept_ring_kernel": ring_walk,
            "accept_pairs_kernel": pairs,
            "accept_sweep_kernel": 4 * T * ((T + 31) // 32)}


def kernel_inputs():
    """A Resolver's history after a few Zipfian mixed batches, the next
    mixed batch, and a high-conflict batch at the same versions (the
    same mix over 64 hot keys), on the Resolver's device. Read versions
    lag up to 5000 versions (about five batches), so the ring holds
    entries newer than them and the ring lanes really hit."""
    from foundationdb_tpu_torch import workloads
    from foundationdb_tpu_torch.convert import batch_from_numpy
    from foundationdb_tpu_torch.resolver.resolver import Resolver

    r = Resolver()
    stream = workloads.mixed(9, seed=SEED + 1, lag=5000)
    for txns, cv, ws in stream[:8]:
        r.resolve(txns, cv, ws)

    def packed(b):
        return batch_from_numpy(r.packer.pack(b[0], r.base_version, *b[1:]),
                                r.device)

    hot = workloads.mixed(9, seed=SEED + 2, nkeys=64, lag=5000)[8]
    state = type(r.state)(*(f.clone() for f in r.state))
    return r.params, state, packed(stream[8]), packed(hot)


def phase_kernels():
    from foundationdb_tpu_torch.ops.accept import fused_accept, fused_accept_plain
    from foundationdb_tpu_torch.ops.ring import ring_hits, ring_hits_plain

    params, state, zipf, high = kernel_inputs()
    T, W = params.txns, params.key_width
    ring = (state.ring_b, state.ring_e, state.ring_v, state.ring_mask)
    log(f"[inputs] T={T} W={W} KR={state.ring_v.shape[0]} live ring entries="
        f"{int(state.ring_mask.sum())}")
    log("[smem] dynamic shared memory per block at these widths: " + ", ".join(
        f"{k} {v} B" for k, v in dynamic_smem(params).items()))
    results = {}

    cases = []
    for mode, lo, hi, mask in (
            ("point", zipf.pr_key, zipf.pr_key, zipf.pr_mask),
            ("range", zipf.rr_b, zipf.rr_e, zipf.rr_mask)):
        S = lo.shape[1]
        args = (lo.reshape(T * S, W), hi.reshape(T * S, W),
                zipf.rv[:, None].expand(T, S).reshape(-1).contiguous(), *ring)
        point = mode == "point"
        got = ring_hits(*args, point_mode=point)
        want = ring_hits_plain(*args, point_mode=point)
        torch.cuda.synchronize()
        err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
        mism = int((got != want).sum())
        ms = cuda_ms(lambda: ring_hits(*args, point_mode=point), 20)
        pms = cuda_ms(lambda: ring_hits_plain(*args, point_mode=point), 5)
        ops = ring_ops(*args[:3], torch.ones_like(args[2], dtype=torch.bool),
                       *ring, point=point)
        # point mode reads the key once (qhi is qlo and unread)
        reads = args[:1] + args[2:] if point else args
        bms, by = bound_ms(io_bytes(*reads, got), ops)
        cases.append(dict(case=f"{mode} Q={T * S}", hits=int(got.sum()),
                          mismatches=mism, max_abs_err=err, ms=ms,
                          plain_ms=pms, bound_ms=bms, bound_by=by, ops=ops))
        log(f"[ring_hits {mode}] Q={T * S} hits={int(got.sum())} "
            f"mismatches={mism} kernel {ms:.4f} ms plain {pms:.4f} ms "
            f"bound {bms:.5f} ms ({by})")
    results["ring_hits"] = cases

    cases = []
    for label, batch in (("zipfian mixed", zipf), ("high-conflict", high)):
        a0 = batch.txn_mask & ~(batch.rv < state.window_start)
        got = fused_accept(state, batch, params, a0)
        want = fused_accept_plain(state, batch, params, a0)
        torch.cuda.synchronize()
        err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
        mism = int((got != want).sum())
        ms = cuda_ms(lambda: fused_accept(state, batch, params, a0), 20)
        pms = cuda_ms(lambda: fused_accept_plain(state, batch, params, a0), 3)
        ops = accept_ops(state, batch, T)
        # the tensors fdb_fused_accept reads, and the accepted bits
        b = batch
        nb = io_bytes(a0, b.rv, b.pw_hash, b.pw_mask, b.pw_key, b.pr_hash,
                      b.pr_mask, b.pr_key, b.rr_b, b.rr_e, b.rr_mask, b.rw_b,
                      b.rw_e, b.rw_mask, state.ring_b, state.ring_e,
                      state.ring_v, state.ring_mask, got)
        bms, by = bound_ms(nb, ops)
        cases.append(dict(case=label, accepted=int(got.sum()),
                          admissible=int(a0.sum()), mismatches=mism,
                          max_abs_err=err, ms=ms, plain_ms=pms, bound_ms=bms,
                          bound_by=by, ops=ops))
        log(f"[fused_accept {label}] accepted {int(got.sum())}/"
            f"{int(a0.sum())} mismatches={mism} kernel {ms:.4f} ms plain "
            f"{pms:.4f} ms bound {bms:.5f} ms ({by})")
    results["fused_accept"] = cases
    return results


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
    """Host pack ms and device step ms per batch, each alone: the packer
    on the host, and the resolver step by CUDA events on the packed
    batches (on a copy of the history); then a profiled run of the same
    steps (device_profile)."""
    from foundationdb_tpu_torch.convert import batch_from_numpy
    from foundationdb_tpu_torch.ops import conflict as ck

    packer, params = (r._fast[0], r._fast_params) if use_fast else (
        r.packer, r.params)
    t0 = time.perf_counter()
    packed = [packer.pack(t, r.base_version, cv, ws) for t, cv, ws in stream]
    pack_ms = (time.perf_counter() - t0) * 1e3 / len(stream)
    batches = [batch_from_numpy(b, r.device) for b in packed]
    state = type(r.state)(*(f.clone() for f in r.state))
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for b in batches:
        ck.resolve_batch(state, b, params)
    end.record()
    torch.cuda.synchronize()
    return pack_ms, start.elapsed_time(end) / len(batches), device_profile(
        lambda: [ck.resolve_batch(state, b, params) for b in batches])


def device_profile(fn, top=4):
    """Where one run of ``fn`` spends the card's time, by torch.profiler:
    the device's busy share of the host wall time (every kernel and copy,
    synchronised at the end) and the kernels that take most of it."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
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


def phase_main(streams, knobs, label):
    from foundationdb_tpu_torch.core.status import COMMITTED
    from foundationdb_tpu_torch.ops import _kernels
    from foundationdb_tpu_torch.resolver.resolver import Resolver

    report = {}
    resolvers = {}
    _kernels.reset_launches()
    for name, stream in streams.items():
        r = Resolver(knobs)
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
            backlog_ms=backlog_ms,
        )
        resolvers[name] = (r, out)
        log(f"[{label} {name}] {ntx} txns, committed "
            f"{report[name]['committed']}; resolve "
            f"{report[name]['resolve_txns_per_s']:.0f} txns/s (p50 "
            f"{report[name]['resolve_p50_ms']:.3f} ms, p99 "
            f"{report[name]['resolve_p99_ms']:.3f} ms per batch); "
            f"resolve_many(depth {BACKLOG}) "
            f"{report[name]['resolve_many_txns_per_s']:.0f} txns/s (backlogs "
            + ", ".join(f"{ms:.3f}" for ms in backlog_ms) + " ms)")
    launches = dict(_kernels.launches)
    for name, (r, _) in resolvers.items():
        use_fast = name == "ycsb_a"
        pack_ms, step_ms, prof = step_split(r, streams[name][:8], use_fast)
        report[name].update(host_pack_ms=pack_ms, device_step_ms=step_ms,
                            step_profile=prof)
        log(f"[{label} {name}] host pack {pack_ms:.3f} ms vs device step "
            f"{step_ms:.3f} ms per batch ({'fast' if use_fast else 'full'} "
            "variant)")
        log(f"[{label} {name}] 8 steps: device busy {prof['busy_ms']:.3f} ms "
            f"of {prof['wall_ms']:.3f} ms wall ({prof['busy_share']:.1%}); "
            "top " + ", ".join(f"{n} {s:.1%}" for n, s in prof["top"]))
    log(f"[{label}] launches {launches}")
    return report, launches


def phase_replay(streams):
    """The first batches of each stream on the card and on the CPU: the
    statuses and the state must be equal."""
    from foundationdb_tpu_torch.convert import state_to_numpy
    from foundationdb_tpu_torch.resolver.resolver import Resolver

    for name, stream in streams.items():
        gpu, cpu = Resolver(), Resolver(device="cpu")
        first = stream[:REPLAY_BATCHES]
        got = [gpu.resolve(*b) for b in first[:2]] + gpu.resolve_many(first[2:])
        want = [cpu.resolve(*b) for b in first[:2]] + cpu.resolve_many(first[2:])
        assert got == want, f"{name}: statuses differ between card and CPU"
        for f, a, b in zip(gpu.state._fields, state_to_numpy(gpu.state),
                           state_to_numpy(cpu.state)):
            assert np.array_equal(a, b), f"{name}: state field {f} differs"
        log(f"[replay {name}] {REPLAY_BATCHES} batches: card == CPU "
            f"(statuses and 12 state fields)")


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from foundationdb_tpu_torch import workloads
    from foundationdb_tpu_torch.core.options import Knobs

    t_start = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    log(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    phase_build()
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
    phase_replay(streams)

    kernels = []
    for name, src, replaces, launches in (
            ("fused_accept", "foundationdb_tpu_torch/csrc/accept.cu",
             "foundationdb_tpu/ops/pallas_scan.py:81",
             main_launches["fused_accept"]),
            ("ring_hits", "foundationdb_tpu_torch/csrc/ring.cu",
             "foundationdb_tpu/ops/pallas_ring.py:62",
             ring_launches["ring_hits"])):
        cases = checks[name]
        head = cases[0]
        kernels.append(dict(
            name=name, route="cuda", source=src, replaces=replaces,
            launches=launches,
            max_abs_err=max(c["max_abs_err"] for c in cases),
            mismatches=sum(c["mismatches"] for c in cases),
            ms=head["ms"], plain_ms=head["plain_ms"],
            bound_ms=head["bound_ms"], bound_by=head["bound_by"],
            library_ms=None, cases=cases))
    summary = dict(card=card, main=main_report, ring_route=ring_report,
                   seconds=time.perf_counter() - t_start)
    log("[summary] " + json.dumps(summary))
    for k in kernels:
        assert k["launches"] > 0, f"{k['name']} never launched on its path"
        assert k["mismatches"] == 0 and k["max_abs_err"] == 0, k["name"]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

// Native host ConflictSet — the CPU fast path behind resolver_backend="native".
//
// Role parity: fdbserver/SkipList.cpp's ConflictSet::detectConflicts (the
// reference keeps ~5s of committed write ranges in a lock-free skip list and
// stabs it per read range). This is an independent design, not a port: the
// history is a *flattened interval map* — an ordered set of non-overlapping
// segments of the keyspace, each carrying the newest commit version that
// wrote any part of it. Recording a write splices the segment list
// (split partials, max-merge covered parts); a read conflict check is a
// range-max over the overlapping segments. Both are O(log n + k).
//
// The ABI is batch-oriented to amortize FFI cost: one call resolves a whole
// commit batch from packed offset arrays (the same packing philosophy as the
// TPU kernel's device arrays — contiguous buffers, no per-range calls).

#include <cstdint>
#include <cstring>
#include <map>
#include <string>

namespace {

using Key = std::string;

struct ConflictSet {
  // segment [iter->first, iter->second.end) wrote at version iter->second.v
  struct Seg {
    Key end;
    uint64_t v;
  };
  std::map<Key, Seg> segs;
  uint64_t window_start = 0;
  uint32_t advances_since_prune = 0;

  // Newest version among segments overlapping [b, e). 0 = none.
  uint64_t query_max(const Key& b, const Key& e) const {
    if (segs.empty() || b >= e) return 0;
    uint64_t best = 0;
    auto it = segs.upper_bound(b);
    if (it != segs.begin()) {
      auto prev = std::prev(it);
      if (prev->second.end > b) best = prev->second.v;
    }
    for (; it != segs.end() && it->first < e; ++it)
      if (it->second.v > best) best = it->second.v;
    return best;
  }

  // Record write [b, e) at version v (v is >= every version already
  // present, since commit versions are handed out in order; we still
  // max() defensively so recovery replays cannot regress history).
  void record(const Key& b, const Key& e, uint64_t v) {
    if (b >= e) return;
    // first segment whose begin is >= b; a strictly-earlier segment can
    // straddle b and must be split so the loop below sees a clean edge
    auto it = segs.lower_bound(b);
    if (it != segs.begin()) {
      auto prev = std::prev(it);  // prev->first < b by lower_bound
      if (prev->second.end > b) {
        Seg right{prev->second.end, prev->second.v};
        prev->second.end = b;
        it = segs.emplace(b, right).first;
      }
    }
    Key cur = b;
    while (cur < e) {
      if (it == segs.end() || it->first >= e) {
        // trailing gap [cur, e)
        segs.emplace(cur, Seg{e, v});
        break;
      }
      if (it->first > cur) {
        // gap [cur, it->first)
        it = segs.emplace(cur, Seg{it->first, v}).first;
        ++it;
        cur = (it == segs.end()) ? e : std::prev(it)->second.end;
        continue;
      }
      // segment starts at cur
      if (it->second.end > e) {
        // split at e; left part gets max version
        Seg right{it->second.end, it->second.v};
        it->second.end = e;
        if (v > it->second.v) it->second.v = v;
        segs.emplace(e, right);
        break;
      }
      if (v > it->second.v) it->second.v = v;
      cur = it->second.end;
      ++it;
    }
  }

  // Drop segments entirely older than the window (lazy GC; the reference
  // advances oldestVersion and unlinks dead skip-list nodes the same way).
  void prune() {
    for (auto it = segs.begin(); it != segs.end();) {
      if (it->second.v < window_start)
        it = segs.erase(it);
      else
        ++it;
    }
  }
};

inline Key mk(const uint8_t* blob, uint64_t off, uint32_t len) {
  return Key(reinterpret_cast<const char*>(blob) + off, len);
}

}  // namespace

extern "C" {

void* ccs_new() { return new ConflictSet(); }
void ccs_free(void* p) { delete static_cast<ConflictSet*>(p); }

uint64_t ccs_window_start(void* p) {
  return static_cast<ConflictSet*>(p)->window_start;
}

uint64_t ccs_segment_count(void* p) {
  return static_cast<ConflictSet*>(p)->segs.size();
}

// Resolve one commit batch.
//   blob, offsets/lengths: all keys packed into one byte buffer.
//   Ranges are rows of 5 x int64: {txn, b_off, b_len, e_off, e_len},
//   read ranges and write ranges in separate arrays, sorted by txn.
//   statuses out: 0 = COMMITTED, 1 = CONFLICT, 2 = TOO_OLD
//   (matches foundationdb_tpu_torch/core/status.py).
void ccs_resolve_batch(void* p, const uint8_t* blob,
                       const int64_t* reads, int64_t n_reads,
                       const int64_t* writes, int64_t n_writes,
                       const uint64_t* read_versions, int64_t n_txns,
                       uint64_t commit_version, uint64_t new_window_start,
                       uint8_t* statuses) {
  auto* cs = static_cast<ConflictSet*>(p);
  int64_t ri = 0, wi = 0;
  for (int64_t t = 0; t < n_txns; ++t) {
    if (read_versions[t] < cs->window_start) {
      statuses[t] = 2;  // TOO_OLD
      while (ri < n_reads && reads[ri * 5] == t) ++ri;
      while (wi < n_writes && writes[wi * 5] == t) ++wi;
      continue;
    }
    bool conflict = false;
    for (; ri < n_reads && reads[ri * 5] == t; ++ri) {
      if (conflict) continue;
      const int64_t* r = reads + ri * 5;
      Key b = mk(blob, r[1], static_cast<uint32_t>(r[2]));
      Key e = mk(blob, r[3], static_cast<uint32_t>(r[4]));
      if (cs->query_max(b, e) > read_versions[t]) conflict = true;
    }
    if (conflict) {
      statuses[t] = 1;  // CONFLICT
      while (wi < n_writes && writes[wi * 5] == t) ++wi;
      continue;
    }
    statuses[t] = 0;  // COMMITTED — record its writes at once, so later
    // txns in this batch conflict against them (intra-batch ordering)
    for (; wi < n_writes && writes[wi * 5] == t; ++wi) {
      const int64_t* w = writes + wi * 5;
      Key b = mk(blob, w[1], static_cast<uint32_t>(w[2]));
      Key e = mk(blob, w[3], static_cast<uint32_t>(w[4]));
      cs->record(b, e, commit_version);
    }
  }
  if (new_window_start > cs->window_start) {
    cs->window_start = new_window_start;
    // amortize GC: the proxy advances the window every batch, and a full
    // map scan per batch would dominate; raising window_start alone is
    // already correct (reads below it are TOO_OLD before any stab, and
    // stale segments can never out-version an admissible read)
    if (++cs->advances_since_prune >= 64) {
      cs->advances_since_prune = 0;
      cs->prune();
    }
  }
}

// Force a GC pass (tests; checkpoint/quiesce paths).
void ccs_prune(void* p) { static_cast<ConflictSet*>(p)->prune(); }

}  // extern "C"

// Shared key-order helpers for the resolver's CUDA kernels (ring.cu,
// accept.cu, lanes.cu): the counterpart of _signed / _pairwise_lex in
// foundationdb_tpu/ops/pallas_ring.py, and the 16-byte key prefixes the
// pair kernels compare before they fall back to the full keys.
//
// Keys are W uint32 limbs compared lexicographically, most significant
// limb first. The TPU kernels flipped the sign bit because the TPU's
// vector unit compares int32 only; CUDA compares uint32 natively, so the
// limbs and version offsets stay unsigned here and keep their order at
// and above 2^31. The port's tensors hold every uint32 quantity as a
// zero-extended int64; the kernels read those and narrow to uint32 when
// they stage a tile in shared memory.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

// Widest key the kernels take: 16 limbs + the length limb. The Python
// wrappers reject wider keys before launching.
#define FDB_MAX_W 17
// The ring walk's block: FDB_RING_QUERIES queries (one thread each, a
// multiple of 32) against FDB_RING_TILE ring entries. A block's walk is
// a serial chain of shared-memory loads per entry, so a short tile and
// many blocks keep the chains short and every SM busy.
#define FDB_RING_QUERIES 128
#define FDB_RING_TILE 32
// Ring tiles lie on the grid's y axis, which takes at most 65535 blocks.
#define FDB_RING_MAX_KR (65535 * FDB_RING_TILE)

// a < b for a key held in registers against a key in shared memory.
__device__ __forceinline__ bool lex_lt_rs(const uint32_t (&a)[FDB_MAX_W],
                                          const uint32_t* b, int W) {
#pragma unroll
  for (int i = 0; i < FDB_MAX_W; ++i) {
    if (i >= W) break;
    if (a[i] != b[i]) return a[i] < b[i];
  }
  return false;
}

// a > b for a key held in registers against a key in shared memory.
__device__ __forceinline__ bool lex_gt_rs(const uint32_t (&a)[FDB_MAX_W],
                                          const uint32_t* b, int W) {
#pragma unroll
  for (int i = 0; i < FDB_MAX_W; ++i) {
    if (i >= W) break;
    if (a[i] != b[i]) return a[i] > b[i];
  }
  return false;
}

// Load one key of W limbs from a zero-extended int64 row into registers.
__device__ __forceinline__ void load_key(uint32_t (&k)[FDB_MAX_W],
                                         const int64_t* row, int W,
                                         bool valid) {
#pragma unroll
  for (int i = 0; i < FDB_MAX_W; ++i)
    k[i] = (valid && i < W) ? (uint32_t)row[i] : 0u;
}

// A key's prefix: its limbs 0-2 (zero past W), then its tail, the last
// limb when every limb between is zero and LONG_KEY otherwise. Two
// prefixes order their keys exactly unless both tails read LONG_KEY (a
// key whose last limb is LONG_KEY reads long too, which only sends more
// pairs to the full compare): with limbs 0-2 equal, a key with a nonzero
// limb between is the greater, and two keys with none differ only in
// their last limb.
#define LONG_KEY 0xFFFFFFFFu
__device__ __forceinline__ uint4 key_prefix(const int64_t* k, int W) {
  uint4 p;
  p.x = (uint32_t)k[0];
  p.y = W > 1 ? (uint32_t)k[1] : 0u;
  p.z = W > 2 ? (uint32_t)k[2] : 0u;
  const uint32_t last = (uint32_t)k[W - 1];
  uint32_t mid = 0u;
  for (int i = 3; i < W - 1; ++i) mid |= (uint32_t)k[i];
  p.w = W > 3 ? (mid ? LONG_KEY : last) : 0u;
  return p;
}

// The order of two keys from their prefixes, computed without branches
// so that the lanes of a warp never part: lt, a < b; open, the prefixes
// cannot tell (lt is then false).
struct Order {
  bool lt, open;
};
__device__ __forceinline__ Order prefix_cmp(uint4 a, uint4 b) {
  const bool ex = a.x == b.x, ey = a.y == b.y, ez = a.z == b.z;
  const bool lt = (a.x < b.x) | (ex & ((a.y < b.y) |
                  (ey & ((a.z < b.z) | (ez & (a.w < b.w))))));
  return {lt, bool(ex & ey & ez & (a.w == b.w) & (a.w == LONG_KEY))};
}

// Fold one test of the prefixes into a lane's verdict where on: c when
// it holds, open when the prefixes cannot tell.
__device__ __forceinline__ void prefix_test(bool on, bool yes, bool no,
                                            bool& c, bool& open) {
  c |= on & yes;
  open |= on & !yes & !no;
}

// b <= k < e
__device__ __forceinline__ void prefix_in(bool on, uint4 k, uint4 b, uint4 e,
                                          bool& c, bool& open) {
  const Order lo = prefix_cmp(k, b), hi = prefix_cmp(k, e);
  prefix_test(on, !lo.lt & !lo.open & hi.lt, lo.lt | (!hi.lt & !hi.open),
              c, open);
}

// [b1, e1) meets [b2, e2): b1 < e2 and b2 < e1
__device__ __forceinline__ void prefix_overlap(bool on, uint4 b1, uint4 e1,
                                               uint4 b2, uint4 e2, bool& c,
                                               bool& open) {
  const Order x = prefix_cmp(b1, e2), y = prefix_cmp(b2, e1);
  prefix_test(on, x.lt & y.lt, (!x.lt & !x.open) | (!y.lt & !y.open), c,
              open);
}

// a < b for two W-limb keys in device memory (zero-extended int64 limbs).
__device__ __forceinline__ bool lex_lt_dev(const int64_t* a, const int64_t* b,
                                           int W) {
  for (int i = 0; i < W; ++i) {
    const uint32_t x = (uint32_t)a[i], y = (uint32_t)b[i];
    if (x != y) return x < y;
  }
  return false;
}

// Dynamic shared memory of one ring-walk block for keys of W limbs: the
// kept entries' begin and end limbs, their versions and tile indices.
__host__ __device__ inline size_t ring_walk_smem_bytes(int W) {
  return sizeof(uint32_t) * (size_t)FDB_RING_TILE * (2 * W + 2);
}

// Grid of the ring walk: query tiles on x, ring tiles on y. The caller
// checks KR <= FDB_RING_MAX_KR.
inline dim3 ring_walk_grid(int Q, int KR) {
  return dim3((Q + FDB_RING_QUERIES - 1) / FDB_RING_QUERIES,
              (KR + FDB_RING_TILE - 1) / FDB_RING_TILE);
}

// Whether this thread's query hits a live entry of ring tile blockIdx.y
// newer than rv. Point mode: key lo in [b, e). Range mode: [lo, hi)
// meets [b, e). The query's keys are the W-limb rows lo_row / hi_row
// (hi_row is not read in point mode; neither is read when !active).
//
// The TPU kernel's sequential ring grid axis with a max-accumulator is
// the grid's y axis here: each block sees one ring tile, and the caller
// ORs the tiles together by storing 1 for a hit into an output that was
// zeroed before the launch. Every store writes the same value, so the
// result does not depend on the order the blocks run in.
//
// Every thread of a block of FDB_RING_QUERIES threads must call it (it
// has barriers); threads without a query pass active = false. Steps:
//   1. the smallest rv among the block's active queries (0xFFFFFFFF if
//      none is active), by a warp reduction and a pass over the warps;
//   2. the cull: the tile's entries that are live and newer than that
//      rv are compacted, in tile order, by ballot and prefix count. An
//      entry newer than no query of the block can hit none of them, so
//      this tests each entry alone and assumes no order of ring_v. A
//      block that keeps nothing returns before it reads a limb;
//   3. the kept entries' limbs are staged as uint32 in shared memory,
//      [entry][limb] like the rows in device memory, so neighbouring
//      threads read neighbouring addresses and write neighbouring
//      words;
//   4. each thread walks the kept entries with its own rv test and the
//      W-limb compare, every lane of a warp reading the same entry (a
//      shared-memory broadcast), and stops at its first hit.
__device__ inline bool ring_walk(const int64_t* lo_row, const int64_t* hi_row,
                                 uint32_t rv, bool point_mode, bool active,
                                 const int64_t* __restrict__ ring_b,
                                 const int64_t* __restrict__ ring_e,
                                 const int64_t* __restrict__ ring_v,
                                 const bool* __restrict__ ring_mask, int KR,
                                 int W, uint32_t* smem) {
  constexpr int NWARPS = FDB_RING_QUERIES / 32;
  __shared__ uint32_t warp_word[NWARPS];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // 1. the oldest read version the block asks about
  const uint32_t m = __reduce_min_sync(0xFFFFFFFFu, active ? rv : 0xFFFFFFFFu);
  if (lane == 0) warp_word[warp] = m;
  __syncthreads();
  uint32_t min_rv = warp_word[0];
#pragma unroll
  for (int i = 1; i < NWARPS; ++i) min_rv = min(min_rv, warp_word[i]);

  // 2. the cull
  uint32_t* sb = smem;
  uint32_t* se = sb + FDB_RING_TILE * W;
  uint32_t* sv = se + FDB_RING_TILE * W;
  uint32_t* sk = sv + FDB_RING_TILE;
  const int k0 = blockIdx.y * FDB_RING_TILE;
  const int n = min(FDB_RING_TILE, KR - k0);
  int kept = 0;
  for (int base = 0; base < FDB_RING_TILE; base += FDB_RING_QUERIES) {
    const int k = base + tid;
    uint32_t v = 0;
    bool keep = false;
    if (k < n) {
      v = (uint32_t)ring_v[k0 + k];
      keep = ring_mask[k0 + k] && v > min_rv;
    }
    const uint32_t ballot = __ballot_sync(0xFFFFFFFFu, keep);
    __syncthreads();  // every thread has read warp_word
    if (lane == 0) warp_word[warp] = __popc(ballot);
    __syncthreads();
    int at = kept, total = kept;
#pragma unroll
    for (int i = 0; i < NWARPS; ++i) {
      at += i < warp ? warp_word[i] : 0;
      total += warp_word[i];
    }
    if (keep) {
      const int c = at + __popc(ballot & ((1u << lane) - 1u));
      sv[c] = v;
      sk[c] = k;
    }
    kept = total;
  }
  if (kept == 0) return false;  // the same for every thread of the block
  __syncthreads();  // sk is complete

  // 3. stage the kept entries' limbs; the query's keys load meanwhile
  for (int f = tid; f < kept * W; f += FDB_RING_QUERIES) {
    const int c = f / W;
    const size_t g = (size_t)(k0 + (int)sk[c]) * W + (f - c * W);
    sb[f] = (uint32_t)ring_b[g];
    se[f] = (uint32_t)ring_e[g];
  }
  uint32_t lo[FDB_MAX_W], hi[FDB_MAX_W];
  load_key(lo, lo_row, W, active);
  load_key(hi, hi_row, W, active && !point_mode);
  __syncthreads();

  // 4. the walk
  if (!active) return false;
  for (int j = 0; j < kept; ++j) {
    if (sv[j] <= rv) continue;
    const uint32_t* b = sb + j * W;
    const uint32_t* e = se + j * W;
    const bool ov = point_mode ? (!lex_lt_rs(lo, b, W) && lex_lt_rs(lo, e, W))
                               : (lex_lt_rs(lo, e, W) && lex_gt_rs(hi, b, W));
    if (ov) return true;
  }
  return false;
}

// Opt a kernel into more than the default 48 KB of dynamic shared memory.
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// fused_accept: the resolver's whole per-batch accept step.
//
// Replaces the Pallas TPU kernel _scan_kernel
// (foundationdb_tpu/ops/pallas_scan.py, launched by fused_accept). Given
// a0 (each txn admissible after the history lanes that stay in torch),
// it folds in
//   1. the exact ring check: a txn whose point or range read hits a live
//      committed range write newer than its read version dies;
//   2. the intra-batch conflict relation O[w, r], w < r: an accepted
//      earlier txn w kills r when w's writes meet r's reads, over four
//      lanes (point x point by hash, point write in range read, point
//      read in range write, range x range);
//   3. greedy sequential acceptance over O.
// Greedy acceptance is the unique fixpoint of the Jacobi map the torch
// route iterates, so both routes give the same bits.
//
// Design, three kernels on one stream:
//   accept_ring_kernel   the ring walk of lex.cuh (ring_walk) over the
//                        T*PR point slots, then the T*RR range slots:
//                        a 2-D grid of (128-slot tile) x (32-entry ring
//                        tile); each block culls its ring tile to the
//                        live entries newer than its oldest read
//                        version, stages those and walks them, one
//                        thread per slot. A hit stores 1 into qhit, which
//                        fdb_fused_accept zeroes on the stream first, so
//                        qhit is the OR over ring tiles in any block
//                        order.
//   accept_pairs_kernel  one block per tile of one 32-txn word of writers
//                        x one word of readers, only on and above the
//                        diagonal (a triangular block index: NW(NW+1)/2
//                        blocks, 528 at T = 1024). A tile whose live
//                        writers (a0) all come after its live readers,
//                        or that has none of either, returns before it
//                        reads a key. Otherwise it loads each live key
//                        once from device memory into a 16-byte prefix
//                        (limbs 0-2 and a tail that orders keys which
//                        share them, key_prefix), and each of 16 warps
//                        takes 2 writers, one reader a lane: every slot
//                        pair of the four lanes on the prefixes, without
//                        branches; only a pair whose prefixes tie on two
//                        long keys compares the full keys, from device
//                        memory. A ballot writes the tile row's word of
//                        the bitset obits[T][NW].
//   accept_sweep_kernel  greedy acceptance by words, one block of 32
//                        warps: each thread tests one txn (a0 and no
//                        ring hit) and a ballot makes the words of
//                        candidates; the candidates' rows are staged in
//                        shared memory word-major from their own word on
//                        (T <= FDB_MAX_TXNS; past that they are read from
//                        device memory). Then the words go 32 at a time,
//                        warp w taking word w. In rounds over all 32 at
//                        once, each warp ORs into its kill word the rows
//                        of the txns the last round accepted in earlier
//                        words (one a lane, one warp reduction) and
//                        resolves its 32x32 diagonal block against them
//                        (lane b holds row 32w+b's word w; rounds of a
//                        warp OR-reduction, as many as the longest chain
//                        of kills inside the word plus one, none when a
//                        vote finds no candidate meeting another); a
//                        round that changes no word ends it. Word i is
//                        final after round i + 1, so the rounds are as
//                        many as the longest chain of kills across words
//                        plus one, not one a word. A chunk of words with
//                        no candidate costs one barrier.
// The TPU kernel computed O tile by tile on the fly inside one program
// and resolved only its diagonal tile step by step, the verdicts of
// earlier tiles gating their conflict rows in parallel; the sweep keeps
// that order of work at the size of a warp word, and goes further: the
// words of a chunk resolve together, in rounds.
//
// Which words are written and read: a pair (w, r) can change an accepted
// bit only when both a0[w] and a0[r] hold, since the sweep ORs only the
// rows of candidates (a subset of a0) and its kill bits matter only at
// candidates. So the pair kernel writes only the rows of live writers in
// tiles with a live pair, and the sweep reads only candidates' rows, at
// the diagonal word and after it, and masks every word it reads by its
// candidates; words it reads that no tile wrote hold bits of dead
// readers only, which the masks drop.
//
// Bound on this card: integer compares on the CUDA cores for the ring
// walk (slots x ring entries) and the pair tiles (live pairs x the slot
// pairs of four lanes); the sweep is a chain of rounds, each a barrier
// and a warp reduction, latency-bound. Measured on this card (NVIDIA
// H100 80GB HBM3, 700 W power limit; T = 1024, W = 9, KR = 4096; device
// ms a call by torch.profiler, the mean of two runs of chip_ab.py, which
// timed the earlier design, one warp stepping txn by txn, in the same
// call):
//   batch (history of 8 batches)  pairs (earlier)   sweep (earlier)
//   Zipfian mixed                 0.041  (0.060)    0.0102 (0.083)
//   high-conflict                 0.041  (0.063)    0.0081 (0.082)
//   33 live txns of 1024          0.012  (0.035)    0.0043 (0.078)
//   pad batch, no live txn        0.0024 (0.034)    0.0024 (0.070)
// With the ring wrapped, pairs 0.041-0.043 (0.060-0.064) and sweep
// 0.0092-0.0096 (0.082) on both full batches. accept_sweep's sweep over
// the same batches' O: 0.0088-0.0098 (0.068-0.073), 0.0042 on 33 live,
// 0.0020 on the pad batch. The pair tiles are held by each warp's chain
// of compares: a full batch's 528 tiles take two waves of two blocks an
// SM, each warp comparing its 2 writers' slots with its readers' one
// writer after the other.
//
// Semantics kept exactly from the TPU kernel: the lane gating flags, and
// the sentinel hashes of masked slots (a masked write hashes to
// 0xFFFFFFFF, a masked read to 0xFFFFFFFE), including that a live write
// whose hash is 0xFFFFFFFE matches a masked read slot.

#include "lex.cuh"

#define FDB_MAX_TXNS 1024
#define LANE_PP 1      // point write x point read (hash)
#define LANE_P_RR 2    // point write in range read
#define LANE_RW_P 4    // point read in range write
#define LANE_RW_RR 8   // range write x range read
#define LANE_PR_RING 16  // point reads vs the committed ring
#define LANE_RR_RING 32  // range reads vs the committed ring

#define FULL_MASK 0xFFFFFFFFu
#define WRITE_SENTINEL 0xFFFFFFFFu  // hash of a masked point-write slot
#define READ_SENTINEL 0xFFFFFFFEu   // hash of a masked point-read slot

#define READERS 32  // accept_pack_kernel: readers per block, one warp's lanes
#define WRITERS 8   // accept_pack_kernel: writers per block, one per warp

// pair tile: one 32-txn word of writers x one word of readers, 16 warps
// of 2 writers each
#define PAIR_WARPS 16
#define PAIR_THREADS (32 * PAIR_WARPS)

#define SWEEP_THREADS 1024  // 32 warps: warp w takes word w of each 32
#define FDB_SWEEP_MAX_WORDS 1024  // widest relation the sweep takes, in words

__global__ void accept_ring_kernel(
    const int64_t* __restrict__ pr_key, const bool* __restrict__ pr_mask,
    const int64_t* __restrict__ rr_b, const int64_t* __restrict__ rr_e,
    const bool* __restrict__ rr_mask, const int64_t* __restrict__ rv,
    const int64_t* __restrict__ ring_b, const int64_t* __restrict__ ring_e,
    const int64_t* __restrict__ ring_v, const bool* __restrict__ ring_mask,
    int T, int PR, int RR, int KR, int W, int flags,
    uint8_t* __restrict__ qhit) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int q = blockIdx.x * FDB_RING_QUERIES + threadIdx.x;
  const int n_point = T * PR;
  const int Q = n_point + T * RR;
  const bool point = q < n_point;
  bool active = false;
  int t = 0;
  const int64_t* lo_row = pr_key;
  const int64_t* hi_row = pr_key;
  if (point) {
    t = q / PR;
    active = (flags & LANE_PR_RING) && pr_mask[q];
    lo_row = pr_key + (size_t)q * W;
  } else if (q < Q) {
    const int qq = q - n_point;
    t = qq / RR;
    active = (flags & LANE_RR_RING) && rr_mask[qq];
    lo_row = rr_b + (size_t)qq * W;
    hi_row = rr_e + (size_t)qq * W;
  }
  const uint32_t v = active ? (uint32_t)rv[t] : 0u;
  if (ring_walk(lo_row, hi_row, v, point, active, ring_b, ring_e, ring_v,
                ring_mask, KR, W, smem))
    qhit[q] = 1;
}

// Shared memory of one pair tile, each array [slot][txn]: the prefixes
// of the live txns' keys (key_prefix; readers' PR point keys then RR
// (b, e), writers' PW then RW (b, e)), then the readers' point hashes
// (the masked-slot sentinel applied) and masks, range masks, and the
// writers' the same.
__host__ __device__ inline size_t pairs_smem_words(int PR, int PW, int RR,
                                                   int RW) {
  return (size_t)32 * (4 * (PR + 2 * RR + PW + 2 * RW) + 2 * PR + RR +
                       2 * PW + RW);
}

// Tile b of the upper triangle, by reader word: reader word k holds
// tiles k(k+1)/2 .. k(k+1)/2 + k, one per writer word i <= k.
__device__ __forceinline__ void tri_tile(int b, int& i, int& k) {
  int kk = (int)((sqrtf(8.0f * b + 1.0f) - 1.0f) * 0.5f);
  while (kk * (kk + 1) / 2 > b) --kk;
  while ((kk + 1) * (kk + 2) / 2 <= b) ++kk;
  k = kk;
  i = b - kk * (kk + 1) / 2;
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

// Two blocks an SM, 64 registers a thread at most.
__global__ void __launch_bounds__(PAIR_THREADS, 2) accept_pairs_kernel(
    const bool* __restrict__ a0, const int64_t* __restrict__ pw_hash,
    const bool* __restrict__ pw_mask, const int64_t* __restrict__ pw_key,
    const int64_t* __restrict__ pr_hash, const bool* __restrict__ pr_mask,
    const int64_t* __restrict__ pr_key, const int64_t* __restrict__ rr_b,
    const int64_t* __restrict__ rr_e, const bool* __restrict__ rr_mask,
    const int64_t* __restrict__ rw_b, const int64_t* __restrict__ rw_e,
    const bool* __restrict__ rw_mask, int T, int PR, int PW, int RR, int RW,
    int W, int flags, uint32_t* __restrict__ obits) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int NW = (T + 31) / 32;
  int wi, rk;
  tri_tile(blockIdx.x, wi, rk);
  const int w0 = wi * 32, r0 = rk * 32;
  const int lane = threadIdx.x % 32;

  // the tile's live txns; every warp takes the same ballots, so the
  // return below is the whole block's
  const uint32_t wl = __ballot_sync(FULL_MASK, w0 + lane < T && a0[w0 + lane]);
  const uint32_t rl =
      wi == rk ? wl : __ballot_sync(FULL_MASK, r0 + lane < T && a0[r0 + lane]);
  // no live writer before a live reader: nothing here can kill a txn
  if (wl == 0 || rl == 0 ||
      (wi == rk && __ffs(wl) - 1 >= 31 - __clz(rl)))
    return;

  const int NKR = PR + 2 * RR, NKW = PW + 2 * RW;
  uint4* r_kx = reinterpret_cast<uint4*>(smem);  // [NKR][32]
  uint4* w_kx = r_kx + 32 * NKR;                 // [NKW][32]
  uint32_t* r_ph = reinterpret_cast<uint32_t*>(w_kx + 32 * NKW);  // [PR][32]
  uint32_t* r_pm = r_ph + 32 * PR;
  uint32_t* r_rm = r_pm + 32 * PR;  // [RR][32]
  uint32_t* w_ph = r_rm + 32 * RR;  // [PW][32]
  uint32_t* w_pm = w_ph + 32 * PW;
  uint32_t* w_rm = w_pm + 32 * PW;  // [RW][32]

  // the live txns' key prefixes straight from device memory, one key a
  // thread (a dead txn's are never read), then their slots' hashes and
  // masks
  for (int j = threadIdx.x; j < 32 * (NKR + NKW); j += PAIR_THREADS) {
    const bool reader = j < 32 * NKR;
    const int jj = reader ? j : j - 32 * NKR, s = jj / 32, tl = jj % 32;
    if (!(((reader ? rl : wl) >> tl) & 1)) continue;
    const size_t t = (reader ? r0 : w0) + tl;
    const int64_t* k;
    if (reader)
      k = s < PR ? pr_key + (t * PR + s) * W
                 : ((s - PR) % 2 ? rr_e : rr_b) + (t * RR + (s - PR) / 2) * W;
    else
      k = s < PW ? pw_key + (t * PW + s) * W
                 : ((s - PW) % 2 ? rw_e : rw_b) + (t * RW + (s - PW) / 2) * W;
    r_kx[j] = key_prefix(k, W);
  }
  for (int j = threadIdx.x; j < 32 * (PR + RR + PW + RW); j += PAIR_THREADS) {
    const int s = j / 32, tl = j % 32;
    if (s < PR + RR) {
      if (!((rl >> tl) & 1)) continue;
      const size_t t = r0 + tl;
      if (s < PR) {
        const bool m = pr_mask[t * PR + s];
        r_pm[j] = m;
        r_ph[j] = m ? (uint32_t)pr_hash[t * PR + s] : READ_SENTINEL;
      } else {
        r_rm[j - 32 * PR] = rr_mask[t * RR + s - PR];
      }
    } else {
      if (!((wl >> tl) & 1)) continue;
      const size_t t = w0 + tl;
      const int sw = s - PR - RR;
      if (sw < PW) {
        const bool m = pw_mask[t * PW + sw];
        w_pm[sw * 32 + tl] = m;
        w_ph[sw * 32 + tl] =
            m ? (uint32_t)pw_hash[t * PW + sw] : WRITE_SENTINEL;
      } else {
        w_rm[(sw - PW) * 32 + tl] = rw_mask[t * RW + sw - PW];
      }
    }
  }
  __syncthreads();

  // the compares: each warp takes writers warp and warp + 16 (on the
  // diagonal tile later writers have fewer readers after them, so each
  // warp gets an early and a late one), one reader a lane; a ballot
  // writes the writer's word of obits
  const int warp = threadIdx.x / 32;
  const bool r_live = (rl >> lane) & 1;
  const size_t r = r0 + lane;
  uint32_t rh[4];  // the reader's point-read hashes, for PR <= 4
#pragma unroll
  for (int s2 = 0; s2 < 4; ++s2)
    rh[s2] = s2 < PR && r_live ? r_ph[s2 * 32 + lane] : READ_SENTINEL;
  for (int tl = warp; tl < 32; tl += PAIR_WARPS) {
    if (!((wl >> tl) & 1)) continue;  // the sweep never reads this row
    const size_t w = w0 + tl;
    const bool active = r_live && r > w;
    bool c = false;
    bool open = false;  // a prefix compare could not tell
    if (active && (flags & LANE_PP)) {
      for (int s1 = 0; s1 < PW; ++s1) {
        const uint32_t wh = w_ph[s1 * 32 + tl];
        if (PR <= 4) {
#pragma unroll
          for (int s2 = 0; s2 < 4; ++s2) c |= s2 < PR && wh == rh[s2];
        } else {
          for (int s2 = 0; s2 < PR; ++s2) c |= wh == r_ph[s2 * 32 + lane];
        }
      }
    }
    // the interval lanes on the prefixes, every slot pair
    if (flags & LANE_P_RR) {  // writer's point in range
      for (int s2 = 0; s2 < RR; ++s2) {
        const bool on = active && r_rm[s2 * 32 + lane];
        const uint4 b = r_kx[(PR + 2 * s2) * 32 + lane];
        const uint4 e = r_kx[(PR + 2 * s2 + 1) * 32 + lane];
        for (int s1 = 0; s1 < PW; ++s1)
          prefix_in(on && w_pm[s1 * 32 + tl], w_kx[s1 * 32 + tl], b, e, c,
                    open);
      }
    }
    if (flags & LANE_RW_P) {  // reader's point in range
      for (int s2 = 0; s2 < PR; ++s2) {
        const bool on = active && r_pm[s2 * 32 + lane];
        const uint4 k = r_kx[s2 * 32 + lane];
        for (int s1 = 0; s1 < RW; ++s1)
          prefix_in(on && w_rm[s1 * 32 + tl], k, w_kx[(PW + 2 * s1) * 32 + tl],
                    w_kx[(PW + 2 * s1 + 1) * 32 + tl], c, open);
      }
    }
    if (flags & LANE_RW_RR) {  // two ranges overlap
      for (int s2 = 0; s2 < RR; ++s2) {
        const bool on = active && r_rm[s2 * 32 + lane];
        const uint4 b = r_kx[(PR + 2 * s2) * 32 + lane];
        const uint4 e = r_kx[(PR + 2 * s2 + 1) * 32 + lane];
        for (int s1 = 0; s1 < RW; ++s1)
          prefix_overlap(on && w_rm[s1 * 32 + tl], b, e,
                         w_kx[(PW + 2 * s1) * 32 + tl],
                         w_kx[(PW + 2 * s1 + 1) * 32 + tl], c, open);
      }
    }
    // the full keys from device memory, only for the lanes whose prefixes
    // left the pair open (two long keys that share limbs 0-2)
    if (active && !c && open) {
      for (int s1 = 0; s1 < PW && (flags & LANE_P_RR) && !c; ++s1) {
        if (!w_pm[s1 * 32 + tl]) continue;
        const int64_t* k = pw_key + (w * PW + s1) * W;
        for (int s2 = 0; s2 < RR && !c; ++s2) {
          if (!r_rm[s2 * 32 + lane]) continue;
          c = !lex_lt_dev(k, rr_b + (r * RR + s2) * W, W) &&
              lex_lt_dev(k, rr_e + (r * RR + s2) * W, W);
        }
      }
      for (int s1 = 0; s1 < RW && (flags & LANE_RW_P) && !c; ++s1) {
        if (!w_rm[s1 * 32 + tl]) continue;
        const int64_t* b = rw_b + (w * RW + s1) * W;
        const int64_t* e = rw_e + (w * RW + s1) * W;
        for (int s2 = 0; s2 < PR && !c; ++s2) {
          if (!r_pm[s2 * 32 + lane]) continue;
          const int64_t* k = pr_key + (r * PR + s2) * W;
          c = !lex_lt_dev(k, b, W) && lex_lt_dev(k, e, W);
        }
      }
      for (int s1 = 0; s1 < RW && (flags & LANE_RW_RR) && !c; ++s1) {
        if (!w_rm[s1 * 32 + tl]) continue;
        const int64_t* wb = rw_b + (w * RW + s1) * W;
        const int64_t* we = rw_e + (w * RW + s1) * W;
        for (int s2 = 0; s2 < RR && !c; ++s2) {
          if (!r_rm[s2 * 32 + lane]) continue;
          c = lex_lt_dev(rr_b + (r * RR + s2) * W, we, W) &&
              lex_lt_dev(wb, rr_e + (r * RR + s2) * W, W);
        }
      }
    }
    const uint32_t word = __ballot_sync(FULL_MASK, c && active);
    if (lane == 0) obits[w * NW + rk] = word;
  }
}

// Dynamic shared memory of the sweep: the candidate and kill words, the
// accepted words and a second copy for the rounds, then, for T <=
// FDB_MAX_TXNS, the staged rows word-major: word k of row t at
// k * (T | 1) + t (an odd stride: the lanes of a warp reading one word
// of 32 rows, or writing words of rows, meet no bank twice).
__host__ __device__ inline size_t sweep_smem_words(int T) {
  const size_t NW = (T + 31) / 32;
  return 4 * NW + (T <= FDB_MAX_TXNS ? NW * (size_t)(T | 1) : 0);
}

// Greedy acceptance over obits[T][NW], word by word (see the file's
// head). qhit holds T * PR point then T * RR range ring hits (PR = RR =
// 0: none, and qhit is not read). Past FDB_MAX_TXNS the rows the walk
// reads come from device memory.
__global__ void __launch_bounds__(SWEEP_THREADS) accept_sweep_kernel(
    const bool* __restrict__ a0, const uint8_t* __restrict__ qhit,
    const uint32_t* __restrict__ obits, int T, int PR, int RR,
    bool* __restrict__ accepted) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int NW = (T + 31) / 32;
  uint32_t* base = smem;       // candidates: a0 and no ring hit
  uint32_t* kill = base + NW;  // word k, for the walk's chunks past k's
  uint32_t* accw = kill + NW;  // the accepted words
  uint32_t* accn = accw + NW;  // the rounds' other copy of them
  uint32_t* srows = accn + NW;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const bool staged = T <= FDB_MAX_TXNS;
  const int RS = T | 1;  // staged: words between two words of one row
  // row t's word k (staged: only candidates' rows, from their own word)
  auto row = [&](int t, int k) -> uint32_t {
    return staged ? srows[k * RS + t] : obits[(size_t)t * NW + k];
  };

  // 1. candidates: one txn a thread, one ballot a word
  for (int t0 = 0; t0 < NW * 32; t0 += SWEEP_THREADS) {
    const int t = t0 + tid;
    bool ok = false;
    if (t < T) {
      ok = a0[t];
#pragma unroll 4
      for (int s = 0; s < PR; ++s) ok &= qhit[(size_t)t * PR + s] == 0;
#pragma unroll 4
      for (int s = 0; s < RR; ++s)
        ok &= qhit[(size_t)T * PR + (size_t)t * RR + s] == 0;
    }
    const uint32_t word = __ballot_sync(FULL_MASK, ok);
    if (lane == 0 && t / 32 < NW) {
      base[t / 32] = word;
      kill[t / 32] = 0u;
      accw[t / 32] = accn[t / 32] = 0u;
    }
  }
  __syncthreads();

  // 2. stage the candidates' rows from their own word on, up to the
  // last word with a candidate
  if (staged) {
    const uint32_t live = __ballot_sync(FULL_MASK, lane < NW && base[lane]);
    const int words = live ? 32 - __clz(live) : 0;
    if (words && NW % 4 == 0 && 128 % NW == 0) {
      // rows of 4, 8, 16 or 32 words: 16 bytes a lane, NW / 4 lanes a
      // row, so that a warp copies 128 / NW rows a load; 8 passes cover
      // T <= FDB_MAX_TXNS, their loads in flight together
      const int per = NW / 4, g = lane % per, step = SWEEP_THREADS / per;
      uint4 v[8];
      uint32_t want = 0;
#pragma unroll
      for (int p = 0; p < 8; ++p) {
        const int t = tid / per + p * step;
        if (t < 32 * words && t < T && ((base[t / 32] >> (t % 32)) & 1) &&
            4 * g + 3 >= t / 32) {
          v[p] = reinterpret_cast<const uint4*>(obits)[(size_t)t * per + g];
          want |= 1u << p;
        }
      }
#pragma unroll
      for (int p = 0; p < 8; ++p) {
        const int t = tid / per + p * step;
        if ((want >> p) & 1) {
          srows[(4 * g) * RS + t] = v[p].x;
          srows[(4 * g + 1) * RS + t] = v[p].y;
          srows[(4 * g + 2) * RS + t] = v[p].z;
          srows[(4 * g + 3) * RS + t] = v[p].w;
        }
      }
    } else {
      // otherwise warp w copies rows w, w + 32, ... (row w + 32m lies in
      // word m), lane k word k, 16 rows' loads in flight
      for (int m0 = 0; m0 < words; m0 += 16) {
        uint32_t v[16];
#pragma unroll
        for (int m = 0; m < 16; ++m) {
          const int t = warp + 32 * (m0 + m);
          const bool want = m0 + m < words && t < T &&
                            ((base[m0 + m] >> warp) & 1) &&
                            lane >= m0 + m && lane < NW;
          v[m] = want ? obits[(size_t)t * NW + lane] : 0u;
        }
#pragma unroll
        for (int m = 0; m < 16; ++m) {
          const int t = warp + 32 * (m0 + m);
          if (m0 + m < words && t < T && lane < NW)
            srows[lane * RS + t] = v[m];
        }
      }
    }
    __syncthreads();
  }

  // 3. the words, 32 at a time (a chunk), warp w taking word w of the
  // chunk with its candidates, its kills from earlier chunks and its
  // diagonal rows in registers. Rounds over all the chunk's words at
  // once: each warp ORs the rows of the txns the last round accepted in
  // the chunk's earlier words (one a lane, one warp reduction), then
  // resolves its word against those kills; a round in which no word
  // changes ends the chunk. Word i's bits are final after round i + 1,
  // so this is greedy acceptance, in as many rounds as the longest chain
  // of kills across the chunk's words plus one. Then each warp ORs the
  // chunk's accepted rows into its kill words of later chunks.
  const uint32_t after = ~((2u << lane) - 1u);  // bits after lane's
  for (int q = 0; q < NW; q += 32) {
    const int kw = q + warp, nq = min(32, NW - q);
    const bool owns = warp < nq;
    const uint32_t bq = owns ? base[kw] : 0u;
    if (!__syncthreads_or(bq != 0u)) continue;  // no candidate
    const uint32_t kpre = owns ? kill[kw] : 0u;
    // the diagonal block, lane b row 32kw + b's bits after b
    const uint32_t dq =
        bq && 32 * kw + lane < T ? row(32 * kw + lane, kw) & after : 0u;
    uint32_t acc = 0u;
    for (int round = 0;; ++round) {
      // accw[] and accn[] hold the last round's words, in turn
      const uint32_t* last = round % 2 ? accn : accw;
      uint32_t* next = round % 2 ? accw : accn;
      uint32_t x = 0u;
      if (bq) {
#pragma unroll 8
        for (int i = q; i < kw; ++i)
          if ((last[i] >> lane) & 1) x |= row(32 * i + lane, kw);
      }
      const uint32_t cand = bq & ~(kpre | __reduce_or_sync(FULL_MASK, x));
      const uint32_t d = (cand >> lane) & 1 ? dq : 0u;
      uint32_t a = cand;
      // inside the word: bit b depends only on the bits before it, so
      // these rounds fix one more bit each (as many as the longest chain
      // of kills in the word plus one, none when no candidate meets
      // another)
      if (__any_sync(FULL_MASK, d & cand)) {
        for (;;) {
          const uint32_t n = cand & ~__reduce_or_sync(
              FULL_MASK, (a >> lane) & 1 ? d : 0u);
          if (n == a) break;
          a = n;
        }
      }
      const bool changed = a != acc;
      acc = a;
      if (owns && lane == 0) next[kw] = acc;
      if (!__syncthreads_or(changed)) break;
    }
    if (owns && lane == 0) accw[kw] = acc;
    __syncthreads();
    for (int k = kw + 32; k < NW; k += 32) {
      uint32_t y = 0u;
      for (int i = q; i < q + nq; ++i)
        if ((accw[i] >> lane) & 1) y |= row(32 * i + lane, k);
      kill[k] |= __reduce_or_sync(FULL_MASK, y);
    }
  }
  __syncthreads();

  // 4. the accepted bits, one txn a thread
  for (int t = tid; t < T; t += SWEEP_THREADS)
    accepted[t] = (accw[t / 32] >> (t % 32)) & 1u;
}

// The sweep's launch: one block.
static cudaError_t launch_sweep(const bool* a0, const uint8_t* qhit,
                                const uint32_t* obits, int T, int PR, int RR,
                                bool* accepted, cudaStream_t st) {
  const size_t smem = sizeof(uint32_t) * sweep_smem_words(T);
  cudaError_t err = allow_smem(accept_sweep_kernel, smem);
  if (err != cudaSuccess) return err;
  accept_sweep_kernel<<<1, SWEEP_THREADS, smem, st>>>(a0, qhit, obits, T, PR,
                                                      RR, accepted);
  return cudaGetLastError();
}

// accept_sweep: greedy acceptance over a conflict relation the caller has
// already built as a dense bool O[T][T] (the plain routes of
// ops/conflict.py: the flat step without the accept kernel, the lanes,
// the presharded step). No TPU kernel: it replaces the reference's
// lax.while_loop over the Jacobi map (foundationdb_tpu/ops/conflict.py:560
// in resolve_batch, :876 in resolve_batch_presharded), which stays on the
// device there, where the plain PyTorch version (jacobi_accept) decides on
// the host when to stop. Two launches:
//   accept_pack_kernel   one warp per (row w, 32-reader word): a ballot
//                        turns 32 bools of O into one word of obits.
//   accept_sweep_kernel  the word-by-word sweep above, with no ring hits,
//                        for every T up to 32 * FDB_SWEEP_MAX_WORDS.
// Bound on this card: reading O (T^2 bytes) for the pack; the sweep's
// chain over the words, latency-bound like fused_accept's.

__global__ void accept_pack_kernel(const bool* __restrict__ O, int T,
                                   uint32_t* __restrict__ obits) {
  const int NW = (T + 31) / 32;
  const int x = blockIdx.x;  // reader word
  const int w = blockIdx.y * WRITERS + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int r = x * READERS + lane;
  const bool c = w < T && r < T && O[(size_t)w * T + r];
  const uint32_t word = __ballot_sync(0xFFFFFFFFu, c);
  if (lane == 0 && w < T) obits[(size_t)w * NW + x] = word;
}

extern "C" int fdb_accept_sweep(const void* a0, const void* O, int T,
                                void* obits, void* accepted, void* stream) {
  if (T <= 0) return 0;
  const int NW = (T + 31) / 32;
  if (NW > FDB_SWEEP_MAX_WORDS) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err;
  accept_pack_kernel<<<dim3(NW, (T + WRITERS - 1) / WRITERS),
                       READERS * WRITERS, 0, st>>>((const bool*)O, T,
                                                   (uint32_t*)obits);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  // no ring lanes: PR = RR = 0, so qhit is never read
  return (int)launch_sweep((const bool*)a0, nullptr, (const uint32_t*)obits,
                           T, 0, 0, (bool*)accepted, st);
}

extern "C" int fdb_fused_accept(
    const void* a0, const void* rv, const void* pw_hash, const void* pw_mask,
    const void* pw_key, const void* pr_hash, const void* pr_mask,
    const void* pr_key, const void* rr_b, const void* rr_e,
    const void* rr_mask, const void* rw_b, const void* rw_e,
    const void* rw_mask, const void* ring_b, const void* ring_e,
    const void* ring_v, const void* ring_mask, int T, int PR, int PW, int RR,
    int RW, int KR, int W, int flags, void* qhit, void* obits,
    void* accepted, void* stream) {
  if (T <= 0) return 0;
  if (T > FDB_MAX_TXNS || W < 1 || W > FDB_MAX_W)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err;

  const int Q = T * (PR + RR);
  if (Q > 0) {
    if ((err = cudaMemsetAsync(qhit, 0, (size_t)Q, st)) != cudaSuccess)
      return (int)err;
    if ((flags & (LANE_PR_RING | LANE_RR_RING)) && KR > 0) {
      if (KR > FDB_RING_MAX_KR) return (int)cudaErrorInvalidValue;
      const size_t smem = ring_walk_smem_bytes(W);
      if ((err = allow_smem(accept_ring_kernel, smem)) != cudaSuccess)
        return (int)err;
      accept_ring_kernel<<<ring_walk_grid(Q, KR), FDB_RING_QUERIES, smem,
                           st>>>(
          (const int64_t*)pr_key, (const bool*)pr_mask, (const int64_t*)rr_b,
          (const int64_t*)rr_e, (const bool*)rr_mask, (const int64_t*)rv,
          (const int64_t*)ring_b, (const int64_t*)ring_e,
          (const int64_t*)ring_v, (const bool*)ring_mask, T, PR, RR, KR, W,
          flags, (uint8_t*)qhit);
      if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    }
  }

  const int NW = (T + 31) / 32;
  const size_t pair_smem =
      sizeof(uint32_t) * pairs_smem_words(PR, PW, RR, RW);
  if ((err = allow_smem(accept_pairs_kernel, pair_smem)) != cudaSuccess)
    return (int)err;
  accept_pairs_kernel<<<NW * (NW + 1) / 2, PAIR_THREADS, pair_smem, st>>>(
      (const bool*)a0, (const int64_t*)pw_hash, (const bool*)pw_mask,
      (const int64_t*)pw_key, (const int64_t*)pr_hash, (const bool*)pr_mask,
      (const int64_t*)pr_key, (const int64_t*)rr_b, (const int64_t*)rr_e,
      (const bool*)rr_mask, (const int64_t*)rw_b, (const int64_t*)rw_e,
      (const bool*)rw_mask, T, PR, PW, RR, RW, W, flags, (uint32_t*)obits);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  return (int)launch_sweep((const bool*)a0, (const uint8_t*)qhit,
                           (const uint32_t*)obits, T, PR, RR,
                           (bool*)accepted, st);
}

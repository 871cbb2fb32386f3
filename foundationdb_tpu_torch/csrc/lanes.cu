// lane_pairs: the intra-batch conflict relation of the presharded
// ("range") resolver lanes.
//
// Replaces the JAX package's scatter-add of the lanes' pair counts in
// resolve_batch_presharded (foundationdb_tpu/ops/conflict.py:823,
// O_i.at[w_txn, r_txn].add(...) over every lane's [Qw, Qr] slot pairs of
// four relations), which XLA runs: there is no Pallas kernel for it. The
// port's plain version (ops/lanes.py lane_pairs_plain) is that scatter as
// index_add_ into int32 counts T*T, one add a slot pair of every lane's
// fixed capacity, live or padding; padding slots point at txn 0, so on a
// card the adds of a batch serialise on one word.
//
// The router (resolver/packing.py ShardRouter) gives each lane compacted
// slot arrays per conflict side, [n * Q] with lane j owning slots
// [j*Q, (j+1)*Q), each slot naming its txn. This kernel writes the marks
// directly: O[w][r] = 1 iff some lane holds a write slot of txn w and a
// read slot of txn r that meet, w < r, both txns live (txn_mask). That is
// the plain version's (counts > 0) & upper & masks exactly, since every
// count is a sum of 0/1 terms. The caller zeroes O first.
//
// Design, one kernel of LANE_THREADS threads a block:
//   grid y  the relation: point write x point read (32-bit hash
//           equality, the masked-slot sentinels of ops/accept.py
//           applied), point write in range read, point read in range
//           write, range write meets range read (half-open, as
//           ops/intervals.py point_in and ranges_overlap);
//   grid x  (lane, write tile, read tile), tiles of LANE_TILE slots a
//           side; blocks past the relation's count return at once.
//   1. the first LANE_TILE threads read one write slot's mask each, the
//      rest one read slot's, and the block votes (__syncthreads_or): with
//      no live slot on either side it returns. The router packs a lane's
//      live entries into its first slots, so dead tiles are the common
//      case and cost two mask loads a thread. On the hash relation a
//      masked slot still compares, as its sentinel: a live read hashing
//      to the write sentinel meets every masked write slot, a live write
//      hashing to the read sentinel every masked read slot, and such a
//      slot keeps its tile too.
//   2. the slots' txn ids (-1 where the slot cannot mark: past the lane's
//      Q, masked outside the hash relation, or of a txn out of range or
//      not live), and their hashes or 16-byte key prefixes (lex.cuh
//      key_prefix), go to shared memory.
//   3. each thread takes one read slot and every other write slot of the
//      tile, the lanes of a warp reading the same writer (a broadcast):
//      for w < r, the hash compare or the prefix tests of lex.cuh, and
//      the full keys from device memory only where the prefixes tie on
//      two long keys, as accept_pairs_kernel does. A match stores 1 into
//      O[w * T + r]: plain byte stores of one value, so the result does
//      not depend on the order the blocks run in, with no atomics.
//
// Bound on this card: the T*T memset (1 MB at T = 1024) and the live
// tiles' slot pairs, integer compares on the CUDA cores; a dead tile
// reads its masks and returns. Measured on this card (NVIDIA H100 80GB
// HBM3, 700 W; n = 3 lanes of 2,392 point and 1,200 range slots a side,
// T = 1024, one lane's 1,024 x 1,024 point slots live, as YCSB-A under
// three range-sharded resolvers): 0.0073 ms of device time a call and
// 0.0013 for the memset, against 23.95 ms for the plain version's
// index_add_.

#include "lex.cuh"

#define LANE_TILE 128                // slots a side per block
#define LANE_THREADS (2 * LANE_TILE)  // a write half and a read half
#define LANE_RELATIONS 4

#define WRITE_SENTINEL 0xFFFFFFFFu  // hash of a masked point-write slot
#define READ_SENTINEL 0xFFFFFFFEu   // hash of a masked point-read slot

enum Relation { REL_PP = 0, REL_PW_RR = 1, REL_RW_PR = 2, REL_RW_RR = 3 };

// One conflict side's slot arrays: [n * Q] (keys [n * Q][W]). A point
// side has hash and key; a range side key (its begins) and end.
struct LaneSide {
  const int64_t* hash;
  const int64_t* key;
  const int64_t* end;
  const int32_t* txn;
  const bool* mask;
  int Q;
};

__host__ __device__ inline int lane_tiles(int Q) {
  return (Q + LANE_TILE - 1) / LANE_TILE;
}

// Shared memory of one block: [side][slot], side 0 the writers, 1 the
// readers; keys [side][point or begin, end][slot].
struct LaneTile {
  int txn[2][LANE_TILE];
  uint32_t hash[2][LANE_TILE];
  uint4 key[2][2][LANE_TILE];
};

// Whether write slot w and read slot r of the tile meet (their txns
// already checked); wg / rg their slots' indices in the side arrays.
template <int REL>
__device__ __forceinline__ bool slots_meet(const LaneTile& s, int w, int r,
                                           const LaneSide& ws,
                                           const LaneSide& rs, size_t wg,
                                           size_t rg, int W) {
  if (REL == REL_PP) return s.hash[0][w] == s.hash[1][r];
  bool c = false, open = false;
  if (REL == REL_PW_RR) {
    prefix_in(true, s.key[0][0][w], s.key[1][0][r], s.key[1][1][r], c, open);
    if (!c && open) {
      const int64_t* k = ws.key + wg * W;
      c = !lex_lt_dev(k, rs.key + rg * W, W) &&
          lex_lt_dev(k, rs.end + rg * W, W);
    }
  } else if (REL == REL_RW_PR) {
    prefix_in(true, s.key[1][0][r], s.key[0][0][w], s.key[0][1][w], c, open);
    if (!c && open) {
      const int64_t* k = rs.key + rg * W;
      c = !lex_lt_dev(k, ws.key + wg * W, W) &&
          lex_lt_dev(k, ws.end + wg * W, W);
    }
  } else {
    prefix_overlap(true, s.key[1][0][r], s.key[1][1][r], s.key[0][0][w],
                   s.key[0][1][w], c, open);
    if (!c && open)
      c = lex_lt_dev(rs.key + rg * W, ws.end + wg * W, W) &&
          lex_lt_dev(ws.key + wg * W, rs.end + rg * W, W);
  }
  return c;
}

// Step 3 for this thread's read slot r against every other write slot.
template <int REL>
__device__ __forceinline__ void mark_tile(const LaneTile& s, int r,
                                          const LaneSide& ws,
                                          const LaneSide& rs, size_t wg0,
                                          size_t rg0, int T, int W,
                                          bool* __restrict__ O) {
  const int rt = s.txn[1][r];
  if (rt <= 0) return;  // no writer comes before txn 0
  bool* col = O + rt;  // column rt of O
  for (int w = threadIdx.x / LANE_TILE; w < LANE_TILE;
       w += LANE_THREADS / LANE_TILE) {
    const int wt = s.txn[0][w];
    if (wt < 0 || wt >= rt) continue;
    if (slots_meet<REL>(s, w, r, ws, rs, wg0 + w, rg0 + r, W))
      col[(size_t)wt * T] = true;
  }
}

__global__ void __launch_bounds__(LANE_THREADS) lane_pairs_kernel(
    LaneSide pw, LaneSide pr, LaneSide rr, LaneSide rw,
    const bool* __restrict__ txn_mask, int n, int T, int W,
    bool* __restrict__ O) {
  __shared__ LaneTile s;
  const int rel = blockIdx.y;
  const bool pp = rel == REL_PP;
  // by value: a reference to a parameter would copy all four sides to
  // every thread's stack
  const LaneSide ws = rel < REL_RW_PR ? pw : rw;
  const LaneSide rs = rel % 2 == 0 ? pr : rr;
  const int tw = lane_tiles(ws.Q), tr = lane_tiles(rs.Q);
  // the grid is the widest relation's: blocks past this one's return
  if ((long long)blockIdx.x >= (long long)n * tw * tr) return;
  const int lane = blockIdx.x / (tw * tr), tile = blockIdx.x % (tw * tr);
  const int w0 = tile / tr * LANE_TILE, r0 = tile % tr * LANE_TILE;

  // 1. the tile's live slots, one a thread
  const int side = threadIdx.x / LANE_TILE, i = threadIdx.x % LANE_TILE;
  const LaneSide me = side ? rs : ws;
  const int q = (side ? r0 : w0) + i;
  const bool in = q < me.Q;
  const size_t g = (size_t)lane * me.Q + q;
  const bool m = in && me.mask[g];
  uint32_t h = 0u;
  bool odd = false;  // a live slot that meets the other side's sentinel
  if (pp && m) {
    h = (uint32_t)me.hash[g];
    odd = h == (side ? WRITE_SENTINEL : READ_SENTINEL);
  }
  const bool live_w = __syncthreads_or(side == 0 && m);
  const bool live_r = __syncthreads_or(side == 1 && m);
  if (!(live_w && live_r) && !__syncthreads_or(odd)) return;

  // 2. stage the slots
  int t = -1;
  if (in && (m || pp)) {
    const int tt = me.txn[g];
    if (tt >= 0 && tt < T && txn_mask[tt]) t = tt;
  }
  s.txn[side][i] = t;
  if (pp) {
    s.hash[side][i] = m ? h : (side ? READ_SENTINEL : WRITE_SENTINEL);
  } else if (t >= 0) {
    const bool point = side ? rel == REL_RW_PR : rel == REL_PW_RR;
    s.key[side][0][i] = key_prefix(me.key + g * W, W);
    if (!point) s.key[side][1][i] = key_prefix(me.end + g * W, W);
  }
  __syncthreads();

  // 3. the pairs
  const size_t wg0 = (size_t)lane * ws.Q + w0, rg0 = (size_t)lane * rs.Q + r0;
  switch (rel) {
    case REL_PP:
      mark_tile<REL_PP>(s, i, ws, rs, wg0, rg0, T, W, O);
      break;
    case REL_PW_RR:
      mark_tile<REL_PW_RR>(s, i, ws, rs, wg0, rg0, T, W, O);
      break;
    case REL_RW_PR:
      mark_tile<REL_RW_PR>(s, i, ws, rs, wg0, rg0, T, W, O);
      break;
    default:
      mark_tile<REL_RW_RR>(s, i, ws, rs, wg0, rg0, T, W, O);
  }
}

extern "C" int fdb_lane_pairs(
    const void* txn_mask, const void* pw_hash, const void* pw_key,
    const void* pw_txn, const void* pw_mask, const void* pr_hash,
    const void* pr_key, const void* pr_txn, const void* pr_mask,
    const void* rr_b, const void* rr_e, const void* rr_txn,
    const void* rr_mask, const void* rw_b, const void* rw_e,
    const void* rw_txn, const void* rw_mask, int n, int T, int Qpw, int Qpr,
    int Qrr, int Qrw, int W, void* O, void* stream) {
  if (n <= 0 || T <= 0) return 0;
  if (W < 1 || W > FDB_MAX_W) return (int)cudaErrorInvalidValue;
  const LaneSide pw = {(const int64_t*)pw_hash, (const int64_t*)pw_key,
                       nullptr, (const int32_t*)pw_txn, (const bool*)pw_mask,
                       Qpw};
  const LaneSide pr = {(const int64_t*)pr_hash, (const int64_t*)pr_key,
                       nullptr, (const int32_t*)pr_txn, (const bool*)pr_mask,
                       Qpr};
  const LaneSide rr = {nullptr, (const int64_t*)rr_b, (const int64_t*)rr_e,
                       (const int32_t*)rr_txn, (const bool*)rr_mask, Qrr};
  const LaneSide rw = {nullptr, (const int64_t*)rw_b, (const int64_t*)rw_e,
                       (const int32_t*)rw_txn, (const bool*)rw_mask, Qrw};
  const int qw[LANE_RELATIONS] = {Qpw, Qpw, Qrw, Qrw};
  const int qr[LANE_RELATIONS] = {Qpr, Qrr, Qpr, Qrr};
  long long blocks = 0;
  for (int k = 0; k < LANE_RELATIONS; ++k) {
    const long long nb = (long long)n * lane_tiles(qw[k]) * lane_tiles(qr[k]);
    blocks = nb > blocks ? nb : blocks;
  }
  if (blocks == 0) return 0;
  if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  lane_pairs_kernel<<<dim3((unsigned)blocks, LANE_RELATIONS), LANE_THREADS,
                      0, (cudaStream_t)stream>>>(
      pw, pr, rr, rw, (const bool*)txn_mask, n, T, W, (bool*)O);
  return (int)cudaGetLastError();
}

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
//   accept_ring_kernel   one thread per (txn, read slot) query, walking
//                        the ring in shared-memory tiles (lex.cuh
//                        ring_walk); writes one hit byte per query.
//   accept_pairs_kernel  one block per 8-writer x 32-reader tile; the
//                        tile's keys are staged in shared memory as
//                        uint32, one thread per (w, r) pair, and a warp
//                        ballot writes O as a bitset obits[T][T/32]
//                        (128 KiB at T = 1024). Tiles wholly below the
//                        diagonal write zeros and return.
//   accept_sweep_kernel  one block: all of obits is staged in shared
//                        memory, then one warp holds the kill vector,
//                        one 32-txn word per lane. For t = 0..T-1 the lane
//                        owning bit t tests it and broadcasts with a
//                        shuffle; if t is accepted every lane ORs in its
//                        word of row t.
// The TPU kernel computed O tile by tile on the fly inside one program;
// here O goes through device memory once as a bitset, so the pair work
// runs on every SM and only the T-step sweep is sequential.
//
// Bound on this card: integer compares on the CUDA cores for the pair
// tiles (T^2/2 pairs x the slot pairs of four lanes x up to W limbs);
// the sweep is a chain of T dependent shuffles, latency-bound.
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

#define READERS 32  // readers per pair tile: one warp's lanes
#define WRITERS 8   // writers per pair tile: one per warp

__global__ void accept_ring_kernel(
    const int64_t* __restrict__ pr_key, const bool* __restrict__ pr_mask,
    const int64_t* __restrict__ rr_b, const int64_t* __restrict__ rr_e,
    const bool* __restrict__ rr_mask, const int64_t* __restrict__ rv,
    const int64_t* __restrict__ ring_b, const int64_t* __restrict__ ring_e,
    const int64_t* __restrict__ ring_v, const bool* __restrict__ ring_mask,
    int T, int PR, int RR, int KR, int W, int flags,
    uint8_t* __restrict__ qhit) {
  extern __shared__ uint32_t smem[];
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
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
  uint32_t lo[FDB_MAX_W], hi[FDB_MAX_W];
  load_key(lo, lo_row, W, active);
  load_key(hi, hi_row, W, active && !point);
  const uint32_t v = active ? (uint32_t)rv[t] : 0u;
  const bool hit = ring_walk(lo, hi, v, point, active, ring_b, ring_e,
                             ring_v, ring_mask, KR, W, smem);
  if (q < Q) qhit[q] = hit ? 1 : 0;
}

__host__ __device__ inline size_t pairs_smem_words(int PR, int PW, int RR,
                                                   int RW, int W) {
  return (size_t)READERS * (PR * (W + 2) + RR * (2 * W + 1)) +
         (size_t)WRITERS * (PW * (W + 2) + RW * (2 * W + 1));
}

__global__ void accept_pairs_kernel(
    const int64_t* __restrict__ pw_hash, const bool* __restrict__ pw_mask,
    const int64_t* __restrict__ pw_key, const int64_t* __restrict__ pr_hash,
    const bool* __restrict__ pr_mask, const int64_t* __restrict__ pr_key,
    const int64_t* __restrict__ rr_b, const int64_t* __restrict__ rr_e,
    const bool* __restrict__ rr_mask, const int64_t* __restrict__ rw_b,
    const int64_t* __restrict__ rw_e, const bool* __restrict__ rw_mask,
    int T, int PR, int PW, int RR, int RW, int W, int flags,
    uint32_t* __restrict__ obits) {
  extern __shared__ uint32_t smem[];
  const int NW = (T + 31) / 32;
  const int x = blockIdx.x;  // reader word
  const int r0 = x * READERS;
  const int w0 = blockIdx.y * WRITERS;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int w = w0 + warp, r = r0 + lane;

  if (r0 + READERS - 1 <= w0) {  // every reader precedes every writer
    if (lane == 0 && w < T) obits[(size_t)w * NW + x] = 0u;
    return;
  }

  // reader side, [slot][limb][lane]: lane-consecutive words
  uint32_t* r_pk = smem;
  uint32_t* r_ph = r_pk + READERS * PR * W;
  uint32_t* r_pm = r_ph + READERS * PR;
  uint32_t* r_rb = r_pm + READERS * PR;
  uint32_t* r_re = r_rb + READERS * RR * W;
  uint32_t* r_rm = r_re + READERS * RR * W;
  // writer side, [writer][slot][limb]: the global layout
  uint32_t* w_pk = r_rm + READERS * RR;
  uint32_t* w_ph = w_pk + WRITERS * PW * W;
  uint32_t* w_pm = w_ph + WRITERS * PW;
  uint32_t* w_rb = w_pm + WRITERS * PW;
  uint32_t* w_re = w_rb + WRITERS * RW * W;
  uint32_t* w_rm = w_re + WRITERS * RW * W;

  const int tid = threadIdx.x, nthr = blockDim.x;
  for (int f = tid; f < READERS * PR * W; f += nthr) {
    const int tl = f / (PR * W), rem = f % (PR * W);
    const int t = r0 + tl;
    r_pk[rem * READERS + tl] =
        t < T ? (uint32_t)pr_key[(size_t)t * PR * W + rem] : 0u;
  }
  for (int f = tid; f < READERS * PR; f += nthr) {
    const int tl = f / PR, s = f % PR;
    const int t = r0 + tl;
    const bool ok = t < T;
    r_ph[s * READERS + tl] = ok ? (uint32_t)pr_hash[(size_t)t * PR + s] : 0u;
    r_pm[s * READERS + tl] = ok && pr_mask[(size_t)t * PR + s] ? 1u : 0u;
  }
  for (int f = tid; f < READERS * RR * W; f += nthr) {
    const int tl = f / (RR * W), rem = f % (RR * W);
    const int t = r0 + tl;
    const bool ok = t < T;
    r_rb[rem * READERS + tl] =
        ok ? (uint32_t)rr_b[(size_t)t * RR * W + rem] : 0u;
    r_re[rem * READERS + tl] =
        ok ? (uint32_t)rr_e[(size_t)t * RR * W + rem] : 0u;
  }
  for (int f = tid; f < READERS * RR; f += nthr) {
    const int tl = f / RR, s = f % RR;
    const int t = r0 + tl;
    r_rm[s * READERS + tl] =
        t < T && rr_mask[(size_t)t * RR + s] ? 1u : 0u;
  }
  for (int f = tid; f < WRITERS * PW * W; f += nthr) {
    const bool ok = w0 + f / (PW * W) < T;
    w_pk[f] = ok ? (uint32_t)pw_key[(size_t)w0 * PW * W + f] : 0u;
  }
  for (int f = tid; f < WRITERS * PW; f += nthr) {
    const bool ok = w0 + f / PW < T;
    const size_t g = (size_t)w0 * PW + f;
    w_ph[f] = ok ? (uint32_t)pw_hash[g] : 0u;
    w_pm[f] = ok && pw_mask[g] ? 1u : 0u;
  }
  for (int f = tid; f < WRITERS * RW * W; f += nthr) {
    const bool ok = w0 + f / (RW * W) < T;
    const size_t g = (size_t)w0 * RW * W + f;
    w_rb[f] = ok ? (uint32_t)rw_b[g] : 0u;
    w_re[f] = ok ? (uint32_t)rw_e[g] : 0u;
  }
  for (int f = tid; f < WRITERS * RW; f += nthr) {
    const bool ok = w0 + f / RW < T;
    w_rm[f] = ok && rw_mask[(size_t)w0 * RW + f] ? 1u : 0u;
  }
  __syncthreads();

  bool c = false;
  if (w < T && r < T && r > w) {
    if (flags & LANE_PP) {
      for (int s1 = 0; s1 < PW && !c; ++s1) {
        const uint32_t wh =
            w_pm[warp * PW + s1] ? w_ph[warp * PW + s1] : 0xFFFFFFFFu;
        for (int s2 = 0; s2 < PR; ++s2) {
          const uint32_t rh = r_pm[s2 * READERS + lane]
                                  ? r_ph[s2 * READERS + lane]
                                  : 0xFFFFFFFEu;
          c |= wh == rh;
        }
      }
    }
    if ((flags & LANE_P_RR) && !c) {
      for (int s1 = 0; s1 < PW && !c; ++s1) {
        if (!w_pm[warp * PW + s1]) continue;
        const uint32_t* k = w_pk + (warp * PW + s1) * W;
        for (int s2 = 0; s2 < RR && !c; ++s2) {
          if (!r_rm[s2 * READERS + lane]) continue;
          const uint32_t* b = r_rb + s2 * W * READERS + lane;
          const uint32_t* e = r_re + s2 * W * READERS + lane;
          c = !lex_lt_ss(k, 1, b, READERS, W) &&
              lex_lt_ss(k, 1, e, READERS, W);
        }
      }
    }
    if ((flags & LANE_RW_P) && !c) {
      for (int s1 = 0; s1 < RW && !c; ++s1) {
        if (!w_rm[warp * RW + s1]) continue;
        const uint32_t* b = w_rb + (warp * RW + s1) * W;
        const uint32_t* e = w_re + (warp * RW + s1) * W;
        for (int s2 = 0; s2 < PR && !c; ++s2) {
          if (!r_pm[s2 * READERS + lane]) continue;
          const uint32_t* k = r_pk + s2 * W * READERS + lane;
          c = !lex_lt_ss(k, READERS, b, 1, W) &&
              lex_lt_ss(k, READERS, e, 1, W);
        }
      }
    }
    if ((flags & LANE_RW_RR) && !c) {
      for (int s1 = 0; s1 < RW && !c; ++s1) {
        if (!w_rm[warp * RW + s1]) continue;
        const uint32_t* wb = w_rb + (warp * RW + s1) * W;
        const uint32_t* we = w_re + (warp * RW + s1) * W;
        for (int s2 = 0; s2 < RR && !c; ++s2) {
          if (!r_rm[s2 * READERS + lane]) continue;
          const uint32_t* b = r_rb + s2 * W * READERS + lane;
          const uint32_t* e = r_re + s2 * W * READERS + lane;
          c = lex_lt_ss(b, READERS, we, 1, W) &&
              lex_lt_ss(wb, 1, e, READERS, W);
        }
      }
    }
  }
  const uint32_t word = __ballot_sync(0xFFFFFFFFu, c);
  if (lane == 0 && w < T) obits[(size_t)w * NW + x] = word;
}

__global__ void accept_sweep_kernel(const bool* __restrict__ a0,
                                    const uint8_t* __restrict__ qhit,
                                    const uint32_t* __restrict__ obits,
                                    int T, int PR, int RR,
                                    bool* __restrict__ accepted) {
  extern __shared__ uint32_t rows[];
  const int NW = (T + 31) / 32;
  for (int i = threadIdx.x; i < T * NW; i += blockDim.x) rows[i] = obits[i];
  __syncthreads();
  if (threadIdx.x >= 32) return;
  const int lane = threadIdx.x;

  // the lane's word of admissible txns: a0 and no ring hit
  uint32_t base = 0;
  if (lane < NW) {
    for (int b = 0; b < 32; ++b) {
      const int t = lane * 32 + b;
      if (t >= T || !a0[t]) continue;
      bool killed = false;
      for (int s = 0; s < PR; ++s) killed |= qhit[t * PR + s] != 0;
      for (int s = 0; s < RR; ++s) killed |= qhit[T * PR + t * RR + s] != 0;
      if (!killed) base |= 1u << b;
    }
  }
  uint32_t kill = 0;
  for (int t = 0; t < T; ++t) {
    const uint32_t mine = ((base & ~kill) >> (t & 31)) & 1u;
    const uint32_t acc = __shfl_sync(0xFFFFFFFFu, mine, t >> 5);
    if (acc && lane < NW) kill |= rows[t * NW + lane];
  }
  if (lane < NW) {
    const uint32_t out = base & ~kill;
    for (int b = 0; b < 32; ++b) {
      const int t = lane * 32 + b;
      if (t < T) accepted[t] = (out >> b) & 1u;
    }
  }
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
    if ((flags & (LANE_PR_RING | LANE_RR_RING)) && KR > 0) {
      const size_t smem = ring_walk_smem_bytes(W);
      if ((err = allow_smem(accept_ring_kernel, smem)) != cudaSuccess)
        return (int)err;
      accept_ring_kernel<<<(Q + 127) / 128, 128, smem, st>>>(
          (const int64_t*)pr_key, (const bool*)pr_mask, (const int64_t*)rr_b,
          (const int64_t*)rr_e, (const bool*)rr_mask, (const int64_t*)rv,
          (const int64_t*)ring_b, (const int64_t*)ring_e,
          (const int64_t*)ring_v, (const bool*)ring_mask, T, PR, RR, KR, W,
          flags, (uint8_t*)qhit);
    } else {
      cudaMemsetAsync(qhit, 0, (size_t)Q, st);
    }
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }

  const int NW = (T + 31) / 32;
  const size_t pair_smem =
      sizeof(uint32_t) * pairs_smem_words(PR, PW, RR, RW, W);
  if ((err = allow_smem(accept_pairs_kernel, pair_smem)) != cudaSuccess)
    return (int)err;
  accept_pairs_kernel<<<dim3(NW, (T + WRITERS - 1) / WRITERS),
                        READERS * WRITERS, pair_smem, st>>>(
      (const int64_t*)pw_hash, (const bool*)pw_mask, (const int64_t*)pw_key,
      (const int64_t*)pr_hash, (const bool*)pr_mask, (const int64_t*)pr_key,
      (const int64_t*)rr_b, (const int64_t*)rr_e, (const bool*)rr_mask,
      (const int64_t*)rw_b, (const int64_t*)rw_e, (const bool*)rw_mask, T, PR,
      PW, RR, RW, W, flags, (uint32_t*)obits);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  const size_t sweep_smem = sizeof(uint32_t) * (size_t)T * NW;
  if ((err = allow_smem(accept_sweep_kernel, sweep_smem)) != cudaSuccess)
    return (int)err;
  accept_sweep_kernel<<<1, 1024, sweep_smem, st>>>(
      (const bool*)a0, (const uint8_t*)qhit, (const uint32_t*)obits, T, PR,
      RR, (bool*)accepted);
  return (int)cudaGetLastError();
}

// ring_hits: does each query hit a live committed range write newer
// than its read version?
//
// Replaces the Pallas TPU kernel _ring_kernel
// (foundationdb_tpu/ops/pallas_ring.py, launched by ring_hits). Point
// mode: key in [ring_b, ring_e). Range mode: [qlo, qhi) meets
// [ring_b, ring_e). A hit also needs ring_mask and ring_v > rv.
//
// Design: one thread per query, 128 queries per block, the query's limbs
// in registers. The block walks the whole ring in FDB_RING_TILE-entry
// tiles staged in shared memory; every thread of a warp reads the same
// ring entry at once (a broadcast, no bank conflicts). The TPU kernel's
// sequential ring grid axis is this loop inside the block, so there is
// no reduction across blocks. Each query checks only entries that are
// live and newer than its read version with the W-limb compare, and
// stops at its first hit.
//
// Bound on this card: integer compares on the CUDA cores when many ring
// entries are newer than the read versions (Q x KR pairs); otherwise the
// bytes of the ring and queries, which are a few hundred KB and come
// from L2 after the first block.

#include "lex.cuh"

__global__ void ring_hits_kernel(const int64_t* __restrict__ qlo,
                                 const int64_t* __restrict__ qhi,
                                 const int64_t* __restrict__ rv,
                                 const int64_t* __restrict__ ring_b,
                                 const int64_t* __restrict__ ring_e,
                                 const int64_t* __restrict__ ring_v,
                                 const bool* __restrict__ ring_mask, int Q,
                                 int KR, int W, int point_mode,
                                 bool* __restrict__ out) {
  extern __shared__ uint32_t smem[];
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  const bool active = q < Q;
  uint32_t lo[FDB_MAX_W], hi[FDB_MAX_W];
  load_key(lo, qlo + (size_t)q * W, W, active);
  load_key(hi, qhi + (size_t)q * W, W, active && !point_mode);
  const uint32_t v = active ? (uint32_t)rv[q] : 0u;
  const bool hit = ring_walk(lo, hi, v, point_mode != 0, active, ring_b,
                             ring_e, ring_v, ring_mask, KR, W, smem);
  if (active) out[q] = hit;
}

extern "C" int fdb_ring_hits(const void* qlo, const void* qhi,
                             const void* rv, const void* ring_b,
                             const void* ring_e, const void* ring_v,
                             const void* ring_mask, int Q, int KR, int W,
                             int point_mode, void* out, void* stream) {
  if (Q <= 0) return 0;
  if (W < 1 || W > FDB_MAX_W) return (int)cudaErrorInvalidValue;
  const size_t smem = ring_walk_smem_bytes(W);
  cudaError_t err = allow_smem(ring_hits_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const int threads = 128;
  ring_hits_kernel<<<(Q + threads - 1) / threads, threads, smem,
                     (cudaStream_t)stream>>>(
      (const int64_t*)qlo, (const int64_t*)qhi, (const int64_t*)rv,
      (const int64_t*)ring_b, (const int64_t*)ring_e, (const int64_t*)ring_v,
      (const bool*)ring_mask, Q, KR, W, point_mode, (bool*)out);
  return (int)cudaGetLastError();
}

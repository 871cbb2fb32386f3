// ring_hits: does each query hit a live committed range write newer
// than its read version?
//
// Replaces the Pallas TPU kernel _ring_kernel
// (foundationdb_tpu/ops/pallas_ring.py, launched by ring_hits). Point
// mode: key in [ring_b, ring_e). Range mode: [qlo, qhi) meets
// [ring_b, ring_e). A hit also needs ring_mask and ring_v > rv.
//
// Design (lex.cuh ring_walk): a 2-D grid of (128-query tile) x
// (32-entry ring tile), one thread per query with its limbs in
// registers. Each block culls its ring tile to the live entries newer
// than the oldest read version among its queries, stages only those as
// uint32 in shared memory, and walks them; a block whose tile keeps
// nothing exits before it reads a limb. The TPU kernel's sequential ring
// grid axis becomes the grid's y axis: a hit is an idempotent store of 1
// into the output, which fdb_ring_hits zeroes on the stream before the
// launch, so the result is the OR over ring tiles in any block order.
//
// Bound on this card: integer compares on the CUDA cores (Q x KR pairs
// of a version test, and the limb compares of live, newer entries); the
// bytes (the ring and the queries, a few hundred KB) come from L2. The
// earlier design (one 128-query block walking the whole ring in
// 512-entry tiles, 32 blocks at Q = 4096) took 0.5983 ms at Q = 4096,
// W = 9, KR = 4096 on an NVIDIA H100 80GB HBM3 at a 700 W power limit:
// it kept at most 32 SMs busy at 4 warps each, restaged the whole ring
// in every block with latency-bound strided loads, and stopped early
// only when all 128 queries had hit. Each block's walk is a serial
// chain of shared-memory loads, so the ring tile is short: with 32
// entries the same call takes about 0.02 ms of device time, 0.04-0.06
// ms a call with the host's launch cost (chip_smoke.py, ring 40% full
// or wrapped).

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
  const int q = blockIdx.x * FDB_RING_QUERIES + threadIdx.x;
  const bool active = q < Q;
  const size_t row = active ? (size_t)q * W : 0;
  const uint32_t v = active ? (uint32_t)rv[q] : 0u;
  if (ring_walk(qlo + row, qhi + row, v, point_mode != 0, active, ring_b,
                ring_e, ring_v, ring_mask, KR, W, smem))
    out[q] = true;
}

extern "C" int fdb_ring_hits(const void* qlo, const void* qhi,
                             const void* rv, const void* ring_b,
                             const void* ring_e, const void* ring_v,
                             const void* ring_mask, int Q, int KR, int W,
                             int point_mode, void* out, void* stream) {
  if (Q <= 0) return 0;
  if (W < 1 || W > FDB_MAX_W || KR < 0 || KR > FDB_RING_MAX_KR)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(out, 0, (size_t)Q, st);
  if (err != cudaSuccess || KR == 0) return (int)err;
  const size_t smem = ring_walk_smem_bytes(W);
  if ((err = allow_smem(ring_hits_kernel, smem)) != cudaSuccess)
    return (int)err;
  ring_hits_kernel<<<ring_walk_grid(Q, KR), FDB_RING_QUERIES, smem, st>>>(
      (const int64_t*)qlo, (const int64_t*)qhi, (const int64_t*)rv,
      (const int64_t*)ring_b, (const int64_t*)ring_e, (const int64_t*)ring_v,
      (const bool*)ring_mask, Q, KR, W, point_mode, (bool*)out);
  return (int)cudaGetLastError();
}

// Shared key-order helpers for the resolver's CUDA kernels (ring.cu,
// accept.cu): the counterpart of _signed / _pairwise_lex in
// foundationdb_tpu/ops/pallas_ring.py.
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
// Ring entries staged in shared memory per step of the ring walk (the
// TPU kernels' RING_TILE).
#define FDB_RING_TILE 512

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

// a < b for two keys in shared memory whose limbs lie sa and sb words
// apart.
__device__ __forceinline__ bool lex_lt_ss(const uint32_t* a, int sa,
                                          const uint32_t* b, int sb, int W) {
  for (int i = 0; i < W; ++i) {
    uint32_t x = a[i * sa], y = b[i * sb];
    if (x != y) return x < y;
  }
  return false;
}

// Shared memory the ring walk needs for keys of W limbs.
__host__ __device__ inline size_t ring_walk_smem_bytes(int W) {
  return sizeof(uint32_t) * (size_t)FDB_RING_TILE * (2 * W + 2);
}

// Whether this thread's query hits a live ring entry newer than rv.
// Point mode: key lo in [b, e). Range mode: [lo, hi) meets [b, e).
// Every thread of the block must call it (it stages the ring in
// FDB_RING_TILE-entry tiles with barriers); threads without a query pass
// active=false. The walk is the TPU kernel's sequential ring grid axis,
// turned into a loop inside the block; it stops once every active
// thread has found a hit.
__device__ inline bool ring_walk(const uint32_t (&lo)[FDB_MAX_W],
                                 const uint32_t (&hi)[FDB_MAX_W], uint32_t rv,
                                 bool point_mode, bool active,
                                 const int64_t* __restrict__ ring_b,
                                 const int64_t* __restrict__ ring_e,
                                 const int64_t* __restrict__ ring_v,
                                 const bool* __restrict__ ring_mask, int KR,
                                 int W, uint32_t* smem) {
  uint32_t* sb = smem;
  uint32_t* se = sb + FDB_RING_TILE * W;
  uint32_t* sv = se + FDB_RING_TILE * W;
  uint32_t* sm = sv + FDB_RING_TILE;
  bool hit = false;
  for (int k0 = 0; k0 < KR; k0 += FDB_RING_TILE) {
    const int n = min(FDB_RING_TILE, KR - k0);
    __syncthreads();  // the previous tile has been read by every thread
    const int64_t* gb = ring_b + (size_t)k0 * W;
    const int64_t* ge = ring_e + (size_t)k0 * W;
    for (int i = threadIdx.x; i < n * W; i += blockDim.x) {
      sb[i] = (uint32_t)gb[i];
      se[i] = (uint32_t)ge[i];
    }
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      sv[i] = (uint32_t)ring_v[k0 + i];
      sm[i] = ring_mask[k0 + i] ? 1u : 0u;
    }
    __syncthreads();
    if (active && !hit) {
      for (int j = 0; j < n; ++j) {
        if (!sm[j] || sv[j] <= rv) continue;
        const uint32_t* b = sb + j * W;
        const uint32_t* e = se + j * W;
        const bool ov = point_mode
                            ? (!lex_lt_rs(lo, b, W) && lex_lt_rs(lo, e, W))
                            : (lex_lt_rs(lo, e, W) && lex_gt_rs(hi, b, W));
        if (ov) {
          hit = true;
          break;
        }
      }
    }
    if (!__syncthreads_or(active && !hit)) break;
  }
  return hit;
}

// Load one key of W limbs from a zero-extended int64 row into registers.
__device__ __forceinline__ void load_key(uint32_t (&k)[FDB_MAX_W],
                                         const int64_t* row, int W,
                                         bool valid) {
#pragma unroll
  for (int i = 0; i < FDB_MAX_W; ++i)
    k[i] = (valid && i < W) ? (uint32_t)row[i] : 0u;
}

// Opt a kernel into more than the default 48 KB of dynamic shared memory.
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

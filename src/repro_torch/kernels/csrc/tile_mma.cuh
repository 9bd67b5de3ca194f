// Shared-memory tiled f32 multiply-accumulate of the packed kernels' pass 1
// (`column_currents<PackedCells>` in fused_impact.cu).
//
// One block of THREADS threads owns a BB x BN output tile; each thread keeps
// a TM x TN register tile of accumulators.  `tile_mma` walks a contraction
// range [k_begin, k_end) in BK-row stages: every stage stages a BB x BK
// slice of the row operand and a BK x BN slice of the column operand in
// shared memory, through caller-supplied loaders that also mask ragged
// edges (a masked element loads as 0, which adds exactly 0), and then
// runs BK steps of IEEE f32 FFMA.  No tensor cores: the contract is IEEE
// f32 end to end.

#pragma once

#include <cuda_runtime.h>

namespace impact {

constexpr int BB = 32;                       // rows (batch lanes) per block
constexpr int BN = 32;                       // columns per block
constexpr int BK = 32;                       // contraction rows per stage
constexpr int TM = 4;                        // rows per thread
constexpr int TN = 2;                        // columns per thread
constexpr int TX = BN / TN;                  // 16 column groups
constexpr int THREADS = (BB / TM) * TX;      // 128

struct Smem {
  float a[BK][BB + 1];   // row operand, k-major; the pad keeps the
  float b[BK][BN];       // k-contiguous loads bank-conflict free
};

// acc += A[rows of this block, k_begin:k_end] @ B[k_begin:k_end, cols].
// load_a(bb, k) / load_b(k, nn) return the operand element (bb, nn local
// to the block tile, k global) or 0 outside the operand.
template <class LoadA, class LoadB>
__device__ __forceinline__ void tile_mma(float (&acc)[TM][TN], int k_begin,
                                         int k_end, Smem& s, LoadA load_a,
                                         LoadB load_b) {
  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    for (int e = tid; e < BB * BK; e += THREADS) {
      const int kk = e % BK, bb = e / BK;
      s.a[kk][bb] = (k0 + kk < k_end) ? load_a(bb, k0 + kk) : 0.f;
    }
    for (int e = tid; e < BK * BN; e += THREADS) {
      const int nn = e % BN, kk = e / BN;
      s.b[kk][nn] = (k0 + kk < k_end) ? load_b(k0 + kk, nn) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], w[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = s.a[kk][ty * TM + i];
#pragma unroll
      for (int j = 0; j < TN; ++j) w[j] = s.b[kk][tx * TN + j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], w[j], acc[i][j]);
    }
    __syncthreads();
  }
}

}  // namespace impact

// Analog crossbar matrix-vector product for Hopper (sm_90a), IEEE f32.
//
// Replaces: src/repro/kernels/crossbar_mvm.py, `_mvm_kernel` (:30) behind
// `crossbar_mvm` (:69), the Pallas TPU kernel.
//
// Computes out (B, N) = drive (B, K) @ (g * v_read * nl(g)), with
// nl(g) = nonlin where g < cutoff, else 1 (the Y-Flash low-conductance
// read nonlinearity).  As in the Pallas kernel, the nonlinearity is applied
// to the conductance tile in shared memory right before the multiply-add
// loop, so the effective current matrix never exists in device memory.
//
// What bounds it on this card: the staged serving path calls it per row
// shard at (B = 128, K = tr = 2048, N = C*tc = 512), 2*B*K*N = 0.27 GFLOP
// on 5.2 MB of operands, about 50 flop per byte, so the f32 FMA rate (not
// memory) is the limit; and per class shard at (128, 2048, 10), 5 MFLOP,
// where only latency matters.  The contract is IEEE f32, so every product
// is one FFMA on the CUDA cores (no tensor cores, no TF32).
//
// Design: the shared-memory tiled FFMA of tile_mma.cuh (32 x 32 output
// tiles, 4 x 2 accumulators a thread).  The TPU walks K as a sequential
// grid axis with the sum in VMEM; here output tiles alone are too few to
// fill 132 SMs (64 at the clause shape, 4 at the class shape), so the
// contraction is also split across blocks: pass 1 writes each split's
// partial sums, pass 2 adds the splits in a fixed order.  No float
// atomics, so results are identical from run to run.  Ragged edges (B, K,
// N of any size, N = 10 on the class stage) are masked in the loads:
// out-of-range drive reads as 0 V and out-of-range conductance as 0 S,
// which adds exactly 0, the same result as the reference's neutral padding
// (drive 0, g = 1.0).

#include <cuda_runtime.h>

#include "tile_mma.cuh"

using namespace impact;

namespace {

// Pass 1: block (tile_n, tile_b, split) -> part[split] (B, N).
__global__ void __launch_bounds__(THREADS)
mvm_partial(const float* __restrict__ drive, const float* __restrict__ g,
            float* __restrict__ part, int B, int K, int N, int chunk,
            float v_read, float nonlin, float cutoff) {
  __shared__ Smem s;
  const int b0 = blockIdx.y * BB;
  const int n0 = blockIdx.x * BN;
  const int k_begin = blockIdx.z * chunk;
  const int k_end = min(K, k_begin + chunk);
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  tile_mma(
      acc, k_begin, k_end, s,
      [&](int bb, int k) {
        const int b = b0 + bb;
        return b < B ? drive[(size_t)b * K + k] : 0.f;
      },
      [&](int k, int nn) {
        const int n = n0 + nn;
        if (n >= N) return 0.f;
        const float gv = g[(size_t)k * N + n];
        return gv * v_read * (gv < cutoff ? nonlin : 1.f);
      });

  float* out = part + (size_t)blockIdx.z * B * N;
  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int b = b0 + ty * TM + i;
    if (b >= B) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tx * TN + j;
      if (n < N) out[(size_t)b * N + n] = acc[i][j];
    }
  }
}

// Pass 2: out = sum over splits of part, in split order.
__global__ void mvm_reduce(const float* __restrict__ part,
                           float* __restrict__ out, int BN_total,
                           int splits) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= BN_total) return;
  float acc = 0.f;
  for (int s = 0; s < splits; ++s) acc += part[(size_t)s * BN_total + e];
  out[e] = acc;
}

Split plan(int B, int K, int N) {
  return split_k(K, ((N + BN - 1) / BN) * ((B + BB - 1) / BB));
}

}  // namespace

// Number of contraction splits for (B, K, N): the wrapper allocates a
// (splits, B, N) f32 scratch when it is above 1.
extern "C" int crossbar_mvm_splits(int B, int K, int N) {
  return plan(B, K, N).count;
}

// drive (B, K) f32, g (K, N) f32, out (B, N) f32, scratch (splits, B, N)
// f32 or null when splits == 1; all contiguous on the device.  Launches
// on `stream`; returns cudaGetLastError().
extern "C" int crossbar_mvm_f32(const float* drive, const float* g,
                                float* out, float* scratch, int B, int K,
                                int N, float v_read, float nonlin,
                                float cutoff, cudaStream_t stream) {
  if (B <= 0 || N <= 0) return static_cast<int>(cudaGetLastError());
  const Split sp = plan(B, K, N);
  const dim3 grid((N + BN - 1) / BN, (B + BB - 1) / BB, sp.count);
  float* part = sp.count > 1 ? scratch : out;
  mvm_partial<<<grid, THREADS, 0, stream>>>(drive, g, part, B, K, N,
                                            sp.chunk, v_read, nonlin, cutoff);
  if (sp.count > 1) {
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    const int total = B * N;
    mvm_reduce<<<(total + 255) / 256, 256, 0, stream>>>(scratch, out, total,
                                                        sp.count);
  }
  return static_cast<int>(cudaGetLastError());
}

// Analog crossbar matrix-vector product for Hopper (sm_90a), IEEE f32.
//
// Replaces: src/repro/kernels/crossbar_mvm.py, `_mvm_kernel` (:30) behind
// `crossbar_mvm` (:69), the Pallas TPU kernel.
//
// Computes out (B, N) = drive (B, K) @ (g * v_read * nl(g)), with
// nl(g) = nonlin where g < cutoff, else 1 (the Y-Flash low-conductance
// read nonlinearity).  As in the Pallas kernel, the nonlinearity is applied
// to the staged conductance tile right before the multiply-add loop, so
// the effective current matrix never exists in device memory.  The
// contract is IEEE f32: every product is one FFMA on the CUDA cores (no
// tensor cores, no TF32).
//
// What bounds it, at the two shapes of a staged sweep (B = 128 lanes):
// - the clause call, (B, K, N) = (128, 1568, 512): 0.206 GFLOP on 4.3 MB
//   of operands, about 48 flop per byte, so the f32 FMA rate bounds it
//   (3.1 us at 67 TFLOP/s).  Its 16 output tiles of 64 x 64 cannot fill
//   132 SMs, and each tile's FFMAs must be fed from shared memory faster
//   than one load per FFMA.
// - the class call, (128, 500, 10): 1.3 MFLOP, well under a microsecond
//   of either bound; launch latency and the depth of the reduction set
//   its time.
//
// Design, one path per shape class; the wrapper plans which, and how many
// splits, on the host (`crossbar_mvm.py`), and this file checks the plan:
// - `mvm_tiles` (N >= 16): a register-tiled SGEMM.  A block of 256 threads
//   owns a 64 x 64 output tile (lanes x columns), each thread a 4 x 4
//   register tile, fed by float4 shared-memory reads: 8 loads per 64 FFMAs.
//   Both operands are staged BK = 16 contraction rows at a time through a
//   ring of 3 shared-memory buffers with `cp.async`, so the copies of the
//   next two stages overlap this stage's FFMAs.  The copy is 16 bytes wide
//   (`.cg`) where an operand's base pointer and row stride allow it, else
//   4 bytes (`.ca`): a template parameter per operand, chosen at launch.
//   Each thread applies the nonlinearity to the conductance elements it
//   copied itself, once they have landed and before the barrier that
//   publishes the stage.  The contraction is split so that one wave runs,
//   two 27 KB blocks an SM (14 splits of 112 rows at the clause shape);
//   each split writes its partial tile and `mvm_reduce` adds the splits in
//   split order.  No float atomics: bit-identical from run to run.  (A
//   last-block-sums-the-tile fixup inside `mvm_tiles`, with an arrival
//   counter per tile, measured slower than the second launch.)
// - `mvm_narrow` (N < 16): one launch, no scratch.  A block owns a few
//   lanes and all N columns; its 256 threads split K, and the partial sums
//   are added by a fixed shuffle tree in each warp and then across warps
//   in shared memory in warp order.
// Every launch is a programmatic dependent launch (Hopper), so that a
// kernel's launch latency hides behind the tail of the kernel before it on
// the stream: at both shapes the launches cost more than the arithmetic.
// Ragged edges are masked: out-of-range drive reads as 0 V and conductance
// as 0 S, which adds exactly 0, the same result as the reference's neutral
// padding (drive 0, g = 1.0).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int BM = 64;        // lanes per block tile
constexpr int BN = 64;        // columns per block tile
constexpr int BK = 16;        // contraction rows per stage
constexpr int STAGES = 3;     // shared-memory ring depth
constexpr int TM = 4;         // lanes per thread
constexpr int TN = 4;         // columns per thread
constexpr int TX = BN / TN;   // 16 column groups
constexpr int THREADS = (BM / TM) * TX;   // 256
constexpr int APAD = BK + 4;  // drive tile row: 80 B, 16-byte aligned

constexpr int NARROW_MAX_N = 15;    // the narrow path takes N < 16
constexpr int NARROW_MAX_LANES = 4;
constexpr int NARROW_THREADS = 256;
constexpr int WARPS = NARROW_THREADS / 32;

static_assert(BM * BK % (4 * THREADS) == 0 && BK * BN % (4 * THREADS) == 0,
              "whole 16-byte copies per thread and operand per stage");
static_assert(TN == 4, "a thread's columns are one float4");

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Copy `bytes` (0 = fill with zeros) of a 16- or 4-byte chunk.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ float cell_current(float g, float v_read,
                                              float nonlin, float cutoff) {
  return g * v_read * (g < cutoff ? nonlin : 1.f);
}

// Every kernel here is launched as a programmatic dependent (`launch`
// below): it may start while the kernel before it on the stream drains,
// and waits here, before it reads anything, until that kernel is done and
// its writes are visible.
__device__ __forceinline__ void grid_dependency_wait() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

struct TileSmem {
  float a[STAGES][BM][APAD];   // drive, lane-major
  float b[STAGES][BK][BN];     // conductance, then cell current
};

// Copies a thread makes per stage and operand: 16-byte or 4-byte ones.
constexpr int A_COPIES16 = BM * BK / 4 / THREADS;
constexpr int B_COPIES16 = BK * BN / 4 / THREADS;
constexpr int A_COPIES4 = BM * BK / THREADS;
constexpr int B_COPIES4 = BK * BN / THREADS;

// Issue the copies of one stage (contraction rows [k0, k0 + BK) clipped to
// k_end) into ring buffer `buf`.  VA / VB: 16-byte copies of drive / g.
template <bool VA, bool VB>
__device__ __forceinline__ void load_stage(
    TileSmem& s, int buf, const float* __restrict__ drive,
    const float* __restrict__ g, int B, int K, int N, int b0, int n0, int k0,
    int k_end) {
  const int tid = threadIdx.x;
  if (VA) {   // K % 4 == 0, so a chunk of 4 rows is all in or all out
#pragma unroll
    for (int i = 0; i < A_COPIES16; ++i) {
      const int c = tid + i * THREADS;
      const int bb = c / (BK / 4), kk = (c % (BK / 4)) * 4;
      const int b = b0 + bb, k = k0 + kk;
      const bool in = b < B && k < k_end;
      cp_async16(&s.a[buf][bb][kk], in ? drive + (size_t)b * K + k : drive,
                 in ? 16 : 0);
    }
  } else {
#pragma unroll
    for (int i = 0; i < A_COPIES4; ++i) {
      const int e = tid + i * THREADS;
      const int bb = e / BK, kk = e % BK;
      const int b = b0 + bb, k = k0 + kk;
      const bool in = b < B && k < k_end;
      cp_async4(&s.a[buf][bb][kk], in ? drive + (size_t)b * K + k : drive,
                in ? 4 : 0);
    }
  }
  if (VB) {   // N % 4 == 0, so a chunk of 4 columns is all in or all out
#pragma unroll
    for (int i = 0; i < B_COPIES16; ++i) {
      const int c = tid + i * THREADS;
      const int kk = c / (BN / 4), nn = (c % (BN / 4)) * 4;
      const int k = k0 + kk, n = n0 + nn;
      const bool in = k < k_end && n < N;
      cp_async16(&s.b[buf][kk][nn], in ? g + (size_t)k * N + n : g,
                 in ? 16 : 0);
    }
  } else {
#pragma unroll
    for (int i = 0; i < B_COPIES4; ++i) {
      const int e = tid + i * THREADS;
      const int kk = e / BN, nn = e % BN;
      const int k = k0 + kk, n = n0 + nn;
      const bool in = k < k_end && n < N;
      cp_async4(&s.b[buf][kk][nn], in ? g + (size_t)k * N + n : g,
                in ? 4 : 0);
    }
  }
}

// The conductance elements this thread copied into `buf` (the same map as
// load_stage's), turned into cell currents in place.  A masked element is
// 0 and stays 0.
template <bool VB>
__device__ __forceinline__ void to_current(TileSmem& s, int buf,
                                           float v_read, float nonlin,
                                           float cutoff) {
  const int tid = threadIdx.x;
  if (VB) {
#pragma unroll
    for (int i = 0; i < B_COPIES16; ++i) {
      const int c = tid + i * THREADS;
      float4* p = reinterpret_cast<float4*>(
          &s.b[buf][c / (BN / 4)][(c % (BN / 4)) * 4]);
      float4 v = *p;
      v.x = cell_current(v.x, v_read, nonlin, cutoff);
      v.y = cell_current(v.y, v_read, nonlin, cutoff);
      v.z = cell_current(v.z, v_read, nonlin, cutoff);
      v.w = cell_current(v.w, v_read, nonlin, cutoff);
      *p = v;
    }
  } else {
#pragma unroll
    for (int i = 0; i < B_COPIES4; ++i) {
      const int e = tid + i * THREADS;
      float& v = s.b[buf][e / BN][e % BN];
      v = cell_current(v, v_read, nonlin, cutoff);
    }
  }
}

// Block (tile_n, tile_b, split) -> out (splits == 1) or part[split].
template <bool VA, bool VB>
__global__ void __launch_bounds__(THREADS)
mvm_tiles(const float* __restrict__ drive, const float* __restrict__ g,
          float* __restrict__ dst, int B, int K, int N, int chunk,
          float v_read, float nonlin, float cutoff) {
  __shared__ __align__(16) TileSmem s;
  const int tid = threadIdx.x;
  grid_dependency_wait();
  const int tx = tid % TX, ty = tid / TX;
  const int b0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int k_begin = blockIdx.z * chunk;
  const int k_end = min(K, k_begin + chunk);
  const int n_stages = k_end > k_begin ? (k_end - k_begin + BK - 1) / BK : 0;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < n_stages)
      load_stage<VA, VB>(s, st, drive, g, B, K, N, b0, n0,
                         k_begin + st * BK, k_end);
    cp_async_commit();
  }

  for (int st = 0; st < n_stages; ++st) {
    const int buf = st % STAGES;
    cp_async_wait<STAGES - 2>();          // this thread's stage st landed
    to_current<VB>(s, buf, v_read, nonlin, cutoff);
    __syncthreads();                      // ... and every thread's
    // Refill the buffer that stage st - 1 used: every thread is past its
    // FFMAs, having reached the barrier above.
    const int next = st + STAGES - 1;
    if (next < n_stages)
      load_stage<VA, VB>(s, next % STAGES, drive, g, B, K, N, b0, n0,
                         k_begin + next * BK, k_end);
    cp_async_commit();

#pragma unroll
    for (int kq = 0; kq < BK; kq += 4) {
      float4 a[TM];
      // Lanes ty, ty + 16, ...: a warp's two lane groups read rows one
      // 80-byte row apart, on other banks.
#pragma unroll
      for (int i = 0; i < TM; ++i)
        a[i] = *reinterpret_cast<const float4*>(
            &s.a[buf][ty + i * (BM / TM)][kq]);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float4 w =
            *reinterpret_cast<const float4*>(&s.b[buf][kq + kk][tx * TN]);
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const float d = kk == 0 ? a[i].x : kk == 1 ? a[i].y
                        : kk == 2 ? a[i].z : a[i].w;
          acc[i][0] = fmaf(d, w.x, acc[i][0]);
          acc[i][1] = fmaf(d, w.y, acc[i][1]);
          acc[i][2] = fmaf(d, w.z, acc[i][2]);
          acc[i][3] = fmaf(d, w.w, acc[i][3]);
        }
      }
    }
  }
  cp_async_wait<0>();

  float* out = dst + (size_t)blockIdx.z * B * N;
  const int n = n0 + tx * TN;
  const bool vec_out = (N & 3) == 0 && n + TN <= N;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int b = b0 + ty + i * (BM / TM);
    if (b >= B) continue;
    float* row = out + (size_t)b * N;
    if (vec_out) {
      *reinterpret_cast<float4*>(row + n) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    } else {
#pragma unroll
      for (int j = 0; j < TN; ++j)
        if (n + j < N) row[n + j] = acc[i][j];
    }
  }
}

// out = sum over splits of part, in split order; four elements a thread.
__global__ void mvm_reduce(const float* __restrict__ part,
                           float* __restrict__ out, int total, int splits) {
  grid_dependency_wait();                 // the partial sums are complete
  const int e = (blockIdx.x * blockDim.x + threadIdx.x) * 4;
  if (e >= total) return;
  if ((total & 3) == 0) {
    float4 acc = *reinterpret_cast<const float4*>(part + e);
    for (int s = 1; s < splits; ++s) {
      const float4 p =
          *reinterpret_cast<const float4*>(part + (size_t)s * total + e);
      acc.x += p.x;
      acc.y += p.y;
      acc.z += p.z;
      acc.w += p.w;
    }
    *reinterpret_cast<float4*>(out + e) = acc;
  } else {
    for (int j = e; j < min(e + 4, total); ++j) {
      float acc = part[j];
      for (int s = 1; s < splits; ++s) acc += part[(size_t)s * total + j];
      out[j] = acc;
    }
  }
}

// Block: lanes [blockIdx.x * lanes, + lanes), all N < 16 columns; thread t
// walks k = t, t + 256, ...
__global__ void __launch_bounds__(NARROW_THREADS)
mvm_narrow(const float* __restrict__ drive, const float* __restrict__ g,
           float* __restrict__ out, int B, int K, int N, int lanes,
           float v_read, float nonlin, float cutoff) {
  __shared__ float red[WARPS][NARROW_MAX_LANES * NARROW_MAX_N];
  const int tid = threadIdx.x;
  grid_dependency_wait();
  const int b0 = blockIdx.x * lanes;
  const int nl = min(lanes, B - b0);

  float acc[NARROW_MAX_LANES][NARROW_MAX_N];
#pragma unroll
  for (int l = 0; l < NARROW_MAX_LANES; ++l)
#pragma unroll
    for (int j = 0; j < NARROW_MAX_N; ++j) acc[l][j] = 0.f;

#pragma unroll 2
  for (int k = tid; k < K; k += NARROW_THREADS) {
    float w[NARROW_MAX_N];
#pragma unroll
    for (int j = 0; j < NARROW_MAX_N; ++j)
      w[j] = j < N ? cell_current(g[(size_t)k * N + j], v_read, nonlin,
                                  cutoff)
                   : 0.f;
#pragma unroll
    for (int l = 0; l < NARROW_MAX_LANES; ++l) {
      if (l < nl) {
        const float d = drive[(size_t)(b0 + l) * K + k];
#pragma unroll
        for (int j = 0; j < NARROW_MAX_N; ++j)
          acc[l][j] = fmaf(d, w[j], acc[l][j]);
      }
    }
  }

  const int warp = tid / 32, lane = tid % 32;
#pragma unroll
  for (int l = 0; l < NARROW_MAX_LANES; ++l) {
#pragma unroll
    for (int j = 0; j < NARROW_MAX_N; ++j) {
      if (l < nl && j < N) {        // uniform over the block
        float v = acc[l][j];
#pragma unroll
        for (int off = 16; off > 0; off /= 2)
          v += __shfl_down_sync(0xffffffffu, v, off);
        if (lane == 0) red[warp][l * NARROW_MAX_N + j] = v;
      }
    }
  }
  __syncthreads();
  if (tid < nl * N) {
    const int l = tid / N, j = tid % N;
    float v = red[0][l * NARROW_MAX_N + j];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) v += red[w][l * NARROW_MAX_N + j];
    out[(size_t)(b0 + l) * N + j] = v;
  }
}

// Launch `kernel` on `stream` as a programmatic dependent launch (Hopper),
// which hides the launch latency behind the previous kernel's tail.
template <class... Params, class... Args>
cudaError_t launch(void (*kernel)(Params...), dim3 grid, int threads,
                   cudaStream_t stream, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.stream = stream;
  cudaLaunchAttribute early;
  early.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  early.val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = &early;
  cfg.numAttrs = 1;
  const cudaError_t err =
      cudaLaunchKernelEx(&cfg, kernel, static_cast<Params>(args)...);
  return err != cudaSuccess ? err : cudaGetLastError();
}

bool aligned16(const void* p) {
  return (reinterpret_cast<std::uintptr_t>(p) & 15) == 0;
}

template <bool VA, bool VB>
cudaError_t launch_tiles(const float* drive, const float* g, float* dst,
                         int B, int K, int N, int splits, int chunk,
                         float v_read, float nonlin, float cutoff,
                         cudaStream_t stream) {
  const dim3 grid((N + BN - 1) / BN, (B + BM - 1) / BM, splits);
  return launch(mvm_tiles<VA, VB>, grid, THREADS, stream, drive, g, dst, B,
                K, N, chunk, v_read, nonlin, cutoff);
}

}  // namespace

// drive (B, K) f32, g (K, N) f32, out (B, N) f32, all contiguous on the
// device; scratch (splits, B, N) f32 when splits > 1, else null.  The plan
// comes from the wrapper:
//   path 0 (tiles):  vec_a / vec_b = 1 for 16-byte copies of drive / g,
//                    K split into `splits` chunks of `chunk` rows (a
//                    multiple of 16), the last one ragged;
//   path 1 (narrow): N < 16, `lanes` (1..4) batch lanes per block.
// A plan this file cannot run returns cudaErrorInvalidValue, launching
// nothing.  Launches on `stream`; returns cudaGetLastError() after every
// launch.
extern "C" int crossbar_mvm_f32(const float* drive, const float* g,
                                float* out, float* scratch, int B, int K,
                                int N, float v_read, float nonlin,
                                float cutoff, int path, int vec_a, int vec_b,
                                int splits, int chunk, int lanes,
                                cudaStream_t stream) {
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  if (B < 0 || K < 0 || N < 0) return bad;
  if (B == 0 || N == 0) return static_cast<int>(cudaGetLastError());
  if (path == 1) {
    if (N > NARROW_MAX_N || lanes < 1 || lanes > NARROW_MAX_LANES) return bad;
    return static_cast<int>(launch(mvm_narrow, dim3((B + lanes - 1) / lanes),
                                   NARROW_THREADS, stream, drive, g, out, B,
                                   K, N, lanes, v_read, nonlin, cutoff));
  }
  if (path != 0 || chunk <= 0 || chunk % BK != 0 || splits < 1 ||
      splits > 65535 || (B + BM - 1) / BM > 65535 ||
      (long long)(splits - 1) * chunk >= (K > 0 ? K : 1) ||
      (long long)splits * chunk < K || (splits > 1 && scratch == nullptr))
    return bad;
  if (vec_a && (K % 4 != 0 || !aligned16(drive))) return bad;
  if (vec_b && (N % 4 != 0 || !aligned16(g))) return bad;
  float* dst = splits > 1 ? scratch : out;
  cudaError_t err;
  if (vec_a && vec_b)
    err = launch_tiles<true, true>(drive, g, dst, B, K, N, splits, chunk,
                                   v_read, nonlin, cutoff, stream);
  else if (vec_a)
    err = launch_tiles<true, false>(drive, g, dst, B, K, N, splits, chunk,
                                    v_read, nonlin, cutoff, stream);
  else if (vec_b)
    err = launch_tiles<false, true>(drive, g, dst, B, K, N, splits, chunk,
                                    v_read, nonlin, cutoff, stream);
  else
    err = launch_tiles<false, false>(drive, g, dst, B, K, N, splits, chunk,
                                     v_read, nonlin, cutoff, stream);
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const int total = B * N;
  const dim3 grid(((total + 3) / 4 + 255) / 256);
  return static_cast<int>(
      launch(mvm_reduce, grid, 256, stream, scratch, out, total, splits));
}

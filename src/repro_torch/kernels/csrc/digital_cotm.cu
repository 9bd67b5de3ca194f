// Digital CoTM inference for Hopper (sm_90a), exact integers: the clause
// stage, the class stage, and both fused.
//
// Replaces three Pallas TPU kernels of one integer family:
//   src/repro/kernels/fused_cotm.py  `_fused_kernel`  (:40, `fused_cotm` :68,
//       `pl.pallas_call` :85): viol = (1-L) @ include, fired = (viol == 0)
//       & nonempty, scores += fired @ W, the clause bits kept in VMEM;
//   src/repro/kernels/clause_eval.py `_clause_kernel` (:40, `clause_eval`
//       :69, :87): the clause stage alone, fired (int8) or the raw viol
//       counts (int32, the partials of the sharded digital AND);
//   src/repro/kernels/class_sum.py   `_class_kernel`  (:30, `class_sum`
//       :50, :61): scores = clauses (int8) @ W (int32).
//
// What bounds them on this card: at the quickstart's shape (B = 256,
// K = 1568, N = 500, M = 10) the clause stage is 0.4 G 0/1 operations,
// 0.2 us at the int8 tensor-core rate, on 1.2 MB of operands, 0.36 us at
// 3.35 TB/s: both bounds are below a microsecond, so launch latency and
// the number of blocks in flight set the time.  The class stage has int32
// weights, which the int8 tensor cores cannot take; class_sum alone at
// (B, N, M) = (256, 500, 10) moves 158 KB (0.05 us), so one launch is
// its floor.
//
// Design:
// - The clause stage is a binary product.  Literals are packed along K
//   into 32-bit words of NOT-literal bits (a warp ballot per word) and
//   the include matrix into words of include bits per clause column, so
//   a violation count is sum_w popc(notL[b][w] & inc[j][w]): 49 AND +
//   popcount steps for K = 1568 instead of 1568 multiply-adds.
// - Hopper has no sequential grid, and the `== 0` test needs the whole
//   count: one block owns a 32-lane x 32-column tile and walks all of K
//   itself (32 words = 1024 literals a shared-memory stage), so the count
//   is complete in registers before the epilogue.
// - fused_cotm keeps the fired bits of its tile in shared memory and adds
//   its 32 clauses' weighted votes to the scores with int32 atomics.
//   Integer addition is associative, so the scores do not depend on the
//   order the blocks finish in, and the clause matrix never reaches
//   device memory.  fired is 0/1, so the class stage is conditional int32
//   adds on the CUDA cores.
// - class_sum is one launch in which a block owns whole lanes, one a
//   warp (8 a block, 32 blocks at B = 256): each score is written once,
//   so nothing zeroes the scores first, there are no atomics, and the
//   result is the same bits from run to run.  The block stages the
//   weights of up to 512 clauses x 16 classes in shared memory, class
//   major; a warp's threads stride over the clauses, four at a time
//   (one 4-byte load of clause bytes, one 16-byte read of each class's
//   weights) where the pointer and N allow, and keep up to 16 class
//   accumulators in registers; passes of 16 classes take any M.  A fixed
//   butterfly of shuffles sums each class over the warp.  The clause
//   values are any int8 (the contract is an int8 x int32 product summed
//   in int32), not only 0/1.
// - Ragged edges are masked, never padded: packed bits past K are 0 (no
//   violation), lanes and columns past B and N are skipped.  The Pallas
//   wrappers pad literals with 1 and include with 0 instead
//   (src/repro/kernels/backends.py:342-390), which gives the same counts.

#include <cuda_runtime.h>
#include <stdint.h>

#include <cstdint>

#include "hopper_async.cuh"

namespace {

using hopper::cp_async4;
using hopper::cp_async_commit;
using hopper::cp_async_wait;

constexpr int THREADS = 256;
constexpr int TB = 32;               // lanes per block
constexpr int TJ = 32;               // clause columns per block
constexpr int RB = THREADS / TJ;     // lane rows per thread pass (8)
constexpr int QB = TB / RB;          // outputs per thread (4)
constexpr int KW = 32;               // K words per shared-memory stage
constexpr int CS_LANES = 8;          // class_sum lanes a block, one a warp
constexpr int CS_THREADS = 32 * CS_LANES;
constexpr int CS_MT = 16;            // class_sum classes a pass
constexpr int CS_NC = 512;           // class_sum clauses a weight stage

// Literal bits: out (B, words); bit i of word w of lane b is
// (L[b][32w + i] == 0), 0 past K.  One thread per (b, bit): a warp covers
// exactly one word (words * 32 is a multiple of the warp).
__global__ void __launch_bounds__(THREADS)
pack_not_literals(const int8_t* __restrict__ lit, uint32_t* __restrict__ out,
                  int B, int K, int words) {
  const long long e = (long long)blockIdx.x * THREADS + threadIdx.x;
  const long long row = (long long)words * 32;
  const bool in = e < (long long)B * row;
  const int b = in ? static_cast<int>(e / row) : 0;
  const int k = in ? static_cast<int>(e % row) : 0;
  const bool bit = in && k < K && lit[(size_t)b * K + k] == 0;
  const uint32_t word = __ballot_sync(0xffffffffu, bit);
  if (in && (threadIdx.x & 31) == 0) out[(size_t)b * words + k / 32] = word;
}

// Include bits per clause column: out (N, words); bit i of word w of
// column j is include[32w + i][j] != 0, 0 past K.
__global__ void __launch_bounds__(THREADS)
pack_include(const uint8_t* __restrict__ inc, uint32_t* __restrict__ out,
             int K, int N, int words) {
  const int j = blockIdx.x * THREADS + threadIdx.x;
  const int w = blockIdx.y;
  if (j >= N) return;
  const int k0 = w * 32, k1 = min(K, k0 + 32);
  uint32_t word = 0;
  for (int k = k0; k < k1; ++k)
    word |= static_cast<uint32_t>(inc[(size_t)k * N + j] != 0) << (k - k0);
  out[(size_t)j * words + w] = word;
}

struct ClauseSmem {
  uint32_t l[TB][KW + 1];            // +1: conflict-free column reads
  uint32_t i[TJ][KW + 1];
};

// Violation counts of the tile at (b0, j0): thread t holds lanes
// b0 + t / TJ + RB * q (q < QB) of column j0 + t % TJ, counted over all
// of K before it returns.
__device__ void clause_counts(const uint32_t* __restrict__ notl,
                              const uint32_t* __restrict__ incw, int B,
                              int N, int words, int b0, int j0,
                              ClauseSmem& s, int (&acc)[QB]) {
  const int tj = threadIdx.x % TJ, tb = threadIdx.x / TJ;
#pragma unroll
  for (int q = 0; q < QB; ++q) acc[q] = 0;
  for (int w0 = 0; w0 < words; w0 += KW) {
    for (int e = threadIdx.x; e < TB * KW; e += THREADS) {
      const int r = e / KW, w = e % KW, ww = w0 + w;
      const bool kin = ww < words;
      s.l[r][w] = (kin && b0 + r < B) ? notl[(size_t)(b0 + r) * words + ww]
                                      : 0u;
      s.i[r][w] = (kin && j0 + r < N) ? incw[(size_t)(j0 + r) * words + ww]
                                      : 0u;
    }
    __syncthreads();
    const int wn = min(KW, words - w0);
    for (int w = 0; w < wn; ++w) {
      const uint32_t iv = s.i[tj][w];
#pragma unroll
      for (int q = 0; q < QB; ++q) acc[q] += __popc(s.l[tb + RB * q][w] & iv);
    }
    __syncthreads();
  }
}

// mode 0: fired (B, N) int8 = (viol == 0) & nonempty; mode 1: viol (B, N)
// int32.  Grid (ceil(N / TJ), ceil(B / TB)).
__global__ void __launch_bounds__(THREADS)
clause_eval_kernel(const uint32_t* __restrict__ notl,
                   const uint32_t* __restrict__ incw,
                   const uint8_t* __restrict__ nonempty, void* out, int B,
                   int N, int words, int mode) {
  __shared__ ClauseSmem s;
  const int b0 = blockIdx.y * TB, j0 = blockIdx.x * TJ;
  int acc[QB];
  clause_counts(notl, incw, B, N, words, b0, j0, s, acc);
  const int j = j0 + threadIdx.x % TJ;
  if (j >= N) return;
  const bool ne = nonempty[j] != 0;
#pragma unroll
  for (int q = 0; q < QB; ++q) {
    const int b = b0 + threadIdx.x / TJ + RB * q;
    if (b >= B) continue;
    const size_t e = (size_t)b * N + j;
    if (mode == 1)
      static_cast<int32_t*>(out)[e] = acc[q];
    else
      static_cast<int8_t*>(out)[e] = (acc[q] == 0 && ne) ? 1 : 0;
  }
}

// scores (B, M) int32, zeroed before the launch, += fired tile @ W rows.
// Grid (ceil(N / TJ), ceil(B / TB)).
__global__ void __launch_bounds__(THREADS)
fused_cotm_kernel(const uint32_t* __restrict__ notl,
                  const uint32_t* __restrict__ incw,
                  const uint8_t* __restrict__ nonempty,
                  const int32_t* __restrict__ weights,
                  int32_t* __restrict__ scores, int B, int N, int M,
                  int words) {
  __shared__ ClauseSmem s;
  __shared__ uint8_t fired[TB][TJ];
  const int b0 = blockIdx.y * TB, j0 = blockIdx.x * TJ;
  int acc[QB];
  clause_counts(notl, incw, B, N, words, b0, j0, s, acc);
  const int tj = threadIdx.x % TJ;
  const int j = j0 + tj;
  const bool live = j < N && nonempty[j] != 0;
#pragma unroll
  for (int q = 0; q < QB; ++q) {
    const int r = threadIdx.x / TJ + RB * q;
    fired[r][tj] = (live && b0 + r < B && acc[q] == 0) ? 1 : 0;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < TB * M; e += THREADS) {
    const int r = e / M, m = e % M;
    int sum = 0;
    for (int jj = 0; jj < TJ; ++jj)
      if (fired[r][jj]) sum += weights[(size_t)(j0 + jj) * M + m];
    if (sum != 0) atomicAdd(&scores[(size_t)(b0 + r) * M + m], sum);
  }
}

// Sign-extended byte q of `word`.
__device__ __forceinline__ int sbyte(unsigned word, int q) {
  return static_cast<int>(static_cast<int8_t>(word >> (8 * q)));
}

// scores (B, M) int32 = clauses (B, N) int8 @ weights (N, M) int32.
// Grid ceil(B / CS_LANES); warp w of block x owns lane x * CS_LANES + w.
// VW = 4: clause bytes read 4 at a time (base and N multiples of 4);
// 1: one at a time.  Lane l of a warp takes clause groups l, l + 32, ...
// of VW clauses, at most CS_NC / 32 / VW of a stage, loaded before the
// stage's weights so that both loads are in flight together.
template <int VW>
__global__ void __launch_bounds__(CS_THREADS)
class_sum_kernel(const int8_t* __restrict__ clauses,
                 const int32_t* __restrict__ weights,
                 int32_t* __restrict__ scores, int B, int N, int M) {
  __shared__ __align__(16) int32_t w_s[CS_MT][CS_NC + 4];   // +4: banks
  constexpr int PER = CS_NC / 32 / VW;       // clause groups a thread
  const int warp = threadIdx.x / 32, wl = threadIdx.x % 32;
  const int b = blockIdx.x * CS_LANES + warp;
  const bool live = b < B;
  const int8_t* row = clauses + (size_t)(live ? b : 0) * N;
  for (int m0 = 0; m0 < M; m0 += CS_MT) {
    const int mp = min(CS_MT, M - m0);
    int acc[CS_MT];
#pragma unroll
    for (int m = 0; m < CS_MT; ++m) acc[m] = 0;
    for (int n0 = 0; n0 < N; n0 += CS_NC) {
      const int groups = min(CS_NC, N - n0) / VW;
      unsigned cl[PER];
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        const int g = wl + 32 * i;
        cl[i] = 0u;
        if (live && g < groups) {
          if (VW == 4)
            cl[i] = __ldg(reinterpret_cast<const unsigned*>(row + n0) + g);
          else
            cl[i] = static_cast<uint8_t>(__ldg(row + n0 + g));
        }
      }
      __syncthreads();                       // the last stage is read
      // Weight (j, m) of the stage, e = j * mp + m, is copied to
      // w_s[m][j] by a 4-byte `cp.async`, all of a thread's in flight at
      // once; (j, m) is stepped without a division.
      const int total = min(CS_NC, N - n0) * mp;
      const int dj = CS_THREADS / mp, dm = CS_THREADS % mp;
      int j = threadIdx.x / mp, m = threadIdx.x % mp;
      for (int e = threadIdx.x; e < total; e += CS_THREADS) {
        cp_async4(&w_s[m][j], weights + (size_t)(n0 + j) * M + m0 + m, 4);
        j += dj;
        m += dm;
        if (m >= mp) {
          m -= mp;
          ++j;
        }
      }
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        const int g = wl + 32 * i;
        if (g >= groups) break;
#pragma unroll
        for (int m = 0; m < CS_MT; ++m) {
          if (m >= mp) break;
          if (VW == 4) {
            const int4 w = *reinterpret_cast<const int4*>(&w_s[m][4 * g]);
            acc[m] += sbyte(cl[i], 0) * w.x + sbyte(cl[i], 1) * w.y +
                      sbyte(cl[i], 2) * w.z + sbyte(cl[i], 3) * w.w;
          } else {
            acc[m] += sbyte(cl[i], 0) * w_s[m][g];
          }
        }
      }
    }
    // Each class over the warp, by a fixed butterfly; thread m stores
    // class m0 + m.
#pragma unroll
    for (int m = 0; m < CS_MT; ++m) {
      if (m >= mp) break;
#pragma unroll
      for (int off = 16; off > 0; off /= 2)
        acc[m] += __shfl_xor_sync(0xffffffffu, acc[m], off);
      if (live && wl == m) scores[(size_t)b * M + m0 + m] = acc[m];
    }
  }
}

// The two packing passes shared by the clause-stage entries; `scratch`
// holds (B + N) * words uint32.
cudaError_t pack(const int8_t* lit, const uint8_t* inc, uint32_t* scratch,
                 int B, int K, int N, int words, cudaStream_t stream) {
  const long long bits = (long long)B * words * 32;
  pack_not_literals<<<static_cast<unsigned>((bits + THREADS - 1) / THREADS),
                      THREADS, 0, stream>>>(lit, scratch, B, K, words);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  pack_include<<<dim3((N + THREADS - 1) / THREADS, words), THREADS, 0,
                 stream>>>(inc, scratch + (size_t)B * words, K, N, words);
  return cudaGetLastError();
}

dim3 clause_grid(int B, int N) {
  return dim3((N + TJ - 1) / TJ, (B + TB - 1) / TB);
}

}  // namespace

// literals (B, K) int8 {0,1}; include (K, N) bool; nonempty (N,) bool;
// out (B, N) int8 (mode 0, fired) or int32 (mode 1, viol); scratch of
// (B + N) * ceil(K / 32) uint32.  All contiguous on the device; launches
// on `stream`; returns cudaGetLastError().
extern "C" int clause_eval_i8(const int8_t* lit, const uint8_t* inc,
                              const uint8_t* nonempty, void* out,
                              uint32_t* scratch, int B, int K, int N,
                              int mode, cudaStream_t stream) {
  if (B <= 0 || N <= 0) return static_cast<int>(cudaGetLastError());
  const int words = (K + 31) / 32;
  if (words > 0) {
    cudaError_t err = pack(lit, inc, scratch, B, K, N, words, stream);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  clause_eval_kernel<<<clause_grid(B, N), THREADS, 0, stream>>>(
      scratch, scratch + (size_t)B * words, nonempty, out, B, N, words,
      mode);
  return static_cast<int>(cudaGetLastError());
}

// As clause_eval_i8, then scores (B, M) int32 += fired @ weights (N, M)
// int32, without writing the clause bits.
extern "C" int fused_cotm_i32(const int8_t* lit, const uint8_t* inc,
                              const uint8_t* nonempty, const int32_t* weights,
                              int32_t* scores, uint32_t* scratch, int B,
                              int K, int N, int M, cudaStream_t stream) {
  if (B <= 0 || M <= 0) return static_cast<int>(cudaGetLastError());
  cudaError_t err = cudaMemsetAsync(scores, 0, sizeof(int32_t) * B * M,
                                    stream);
  if (err != cudaSuccess || N <= 0) return static_cast<int>(err);
  const int words = (K + 31) / 32;
  if (words > 0) {
    err = pack(lit, inc, scratch, B, K, N, words, stream);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  fused_cotm_kernel<<<clause_grid(B, N), THREADS, 0, stream>>>(
      scratch, scratch + (size_t)B * words, nonempty, weights, scores, B, N,
      M, words);
  return static_cast<int>(cudaGetLastError());
}

// clauses (B, N) int8; weights (N, M) int32; scores (B, M) int32, each
// written once by the one launch (zeros where N = 0).  clause_width 4:
// the clause bytes are read 4 at a time (base and N multiples of 4), 1:
// one at a time; anything else returns cudaErrorInvalidValue, launching
// nothing.  Nothing is launched where B or M is 0.
extern "C" int class_sum_i32(const int8_t* clauses, const int32_t* weights,
                             int32_t* scores, int B, int N, int M,
                             int clause_width, cudaStream_t stream) {
  const bool words = clause_width == 4 &&
                     reinterpret_cast<std::uintptr_t>(clauses) % 4 == 0 &&
                     N % 4 == 0;
  if (B < 0 || N < 0 || M < 0 || !(words || clause_width == 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || M == 0) return static_cast<int>(cudaGetLastError());
  const dim3 grid((B + CS_LANES - 1) / CS_LANES);
  if (words)
    class_sum_kernel<4><<<grid, CS_THREADS, 0, stream>>>(clauses, weights,
                                                      scores, B, N, M);
  else
    class_sum_kernel<1><<<grid, CS_THREADS, 0, stream>>>(clauses, weights,
                                                      scores, B, N, M);
  return static_cast<int>(cudaGetLastError());
}

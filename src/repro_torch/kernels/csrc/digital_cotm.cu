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
// 3.35 TB/s: both bounds are below a microsecond, while one empty launch
// takes about 4.8 us of the CUDA-event timer (NVIDIA H100 80GB HBM3,
// 700 W).  So launches and passes over device memory set the time:
// clause_eval is one launch with no packing pass and no scratch, and
// fused_cotm the memset of its scores and one launch.
// The class stage has int32 weights, which the int8 tensor cores cannot
// take; class_sum alone at (B, N, M) = (256, 500, 10) moves 158 KB
// (0.05 us), so one launch is its floor.
//
// Design:
// - The clause stage is a binary product: a violation count is
//   sum_k notL[b][k] & inc[k][j] over bits packed along K, which the
//   tensor cores run as a b1 AND + popcount product (m16n8k256,
//   `bit_pack.cuh`), 256 literals a step, 7 steps for K = 1568.
// - Each block packs its own operands, stage by stage (64 words = 2048
//   literals a shared-memory stage; K = 1568 takes one), straight from
//   the int8 literals and the include bytes: a thread makes 16
//   NOT-literal bits from one 16-byte literal load (two aligned 16-byte
//   loads and a shift where K or the base is not a multiple of 16) and a
//   lane pair joins two halves into a word; the block copies its 32
//   columns of include rows into shared memory by 4-byte `cp.async`
//   (aligned 16-byte loads and shifts where N or the base is not a
//   multiple of 4) while it packs the literals, and a warp then
//   turns 32 rows of them into a word a column by a shuffle transpose.
//   The re-reads this costs (each block reads its lanes' literals and
//   its columns' include rows) come from L2.
// - Hopper has no sequential grid, and the `== 0` test needs the whole
//   count: one block owns a 32-lane x 32-column tile (on the grid of
//   `kernels/clause_eval.plan`; 16 lanes measured slower, PERF.md) and
//   walks all of K itself, so the count is complete in registers before
//   the epilogue.
//   A block has 512 threads (one block an SM): the packing is a chain of
//   short dependent steps, and 16 warps an SM hide more of it than 8
//   (256 threads measured slower: PERF.md, findings).
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

#include <atomic>
#include <cstdint>

#include "bit_pack.cuh"
#include "hopper_async.cuh"

namespace {

using hopper::cp_async4;
using hopper::cp_async_commit;
using hopper::cp_async_wait;

constexpr int THREADS = 512;            // clause-stage threads a block
constexpr int WARPS = THREADS / 32;
constexpr int TB = 32;               // lanes per block
constexpr int TJ = 32;               // clause columns per block
constexpr int KW = 64;               // K words per shared-memory stage
constexpr int KPAD = 4;              // conflict-free fragment reads
constexpr int CS_LANES = 8;          // class_sum lanes a block, one a warp
constexpr int CS_THREADS = 32 * CS_LANES;
constexpr int CS_MT = 16;            // class_sum classes a pass
constexpr int CS_NC = 512;           // class_sum clauses a weight stage

// The 16-lane x 8-column output blocks of a tile, and the warps that
// share each of them, taking alternate 256-bit steps.
constexpr int PAIRS = TB / 16 * (TJ / 8);
constexpr int SPLIT = WARPS / PAIRS;

// A block's operands of one K stage, packed: NOT-literal words of its TB
// lanes and include words of its TJ columns; the warps that share an
// output block hand their counts over in red.
struct ClauseSmem {
  uint32_t l[TB][KW + KPAD];
  uint32_t i[TJ][KW + KPAD];
  int red[SPLIT - 1][PAIRS][32][4];
};

// NOT-literal bits of 16 literal bytes, each 0 or 1: bit 4b + q is
// (byte 4q + b == 0).  Words keep this order (a 4 x 4 transpose within
// each half), and the include rows are read in it too (`literal_row`).
__device__ __forceinline__ uint32_t not_literal_bits(uint4 x) {
  constexpr uint32_t kOnes = 0x01010101u;
  const uint32_t y = (~x.x & kOnes) | (~x.y & kOnes) << 1 |
                     (~x.z & kOnes) << 2 | (~x.w & kOnes) << 3;
  const uint32_t z = y | y >> 4;   // bytes 0-1 in bits 0-7, 2-3 in 16-23
  return (z & 0xffu) | (z >> 8 & 0xff00u);
}

// The literal (row of a 32-row word) that bit L of a word stands for.
__device__ __forceinline__ int literal_row(int L) {
  return (L & 16) | (L & 3) << 2 | (L >> 2 & 3);
}

// Pack the stage of words [w0, w0 + KW) of the tile at (b0, j0) into
// shared memory, straight from the int8 literals and the include bytes
// (0 or 1; the literals too).  A thread first issues its literal loads
// (16 literals of one lane a load: one 16-byte load where LW = 16, K and
// the base multiples of 16; else `bit_pack.cuh`'s `load16`, two aligned
// 16-byte loads and a shift), so that a warp reads 512 contiguous bytes
// of a literal row; then the block starts copying the stage's include
// tile of its TJ columns into `raw` (4-byte `cp.async` where IW = 4: N
// and the base multiples of 4; else `load16`s).  While that is in
// flight, a thread makes half a word of NOT-literal bits from each load
// and a lane pair joins its halves.  Then a warp makes the include words
// of 32 rows, one a column, a lane a row, by a shuffle transpose
// (`bit_pack.cuh`); words up to the stage's last whole 256-bit step are
// packed (zeros past K).
template <int LW, int IW>
__device__ __forceinline__ void pack_stage(
    const int8_t* __restrict__ lit, const uint8_t* __restrict__ inc, int B,
    int K, int N, int words, int w0, int b0, int j0, ClauseSmem& s,
    uint8_t* raw) {
  constexpr int HALVES = TB * 2 * KW / THREADS;  // a thread's, a stage
  const int lane = threadIdx.x & 31;
  const int wn = (min(KW, words - w0) + 7) / 8 * 8;
  const auto* lit_lo = reinterpret_cast<const uint8_t*>(lit);
  const uint8_t* const lit_hi = lit_lo + static_cast<size_t>(B) * K;
  uint4 x[HALVES];
#pragma unroll
  for (int it = 0; it < HALVES; ++it) {
    const int e = threadIdx.x + THREADS * it;
    const int r = e / (2 * KW), k = 32 * w0 + 16 * (e % (2 * KW));
    const uint8_t* row = lit_lo + static_cast<size_t>(b0 + r) * K + k;
    x[it] = make_uint4(0u, 0u, 0u, 0u);
    if (b0 + r >= B || k >= K) continue;
    // Bytes past K (the next row's, or past the tensor): 1, which is no
    // NOT-literal bit.
    x[it] = LW == 16 ? __ldg(reinterpret_cast<const uint4*>(row))
                     : bitpack::fill_past(bitpack::load16(row, lit_lo,
                                                          lit_hi),
                                          K - k, 1u);
  }
  bitpack::stage_tile<IW>(raw, inc, N, 32 * w0, K, 32 * wn, j0, TJ, N);
  cp_async_commit();
#pragma unroll
  for (int it = 0; it < HALVES; ++it) {
    const int e = threadIdx.x + THREADS * it;
    const int r = e / (2 * KW), h = e % (2 * KW);
    const bool live = b0 + r < B && 32 * w0 + 16 * h < K;
    const uint32_t half = live ? not_literal_bits(x[it]) : 0u;
    const uint32_t high = __shfl_down_sync(0xffffffffu, half, 1);
    if ((h & 1) == 0) s.l[r][h / 2] = half | high << 16;
  }
  cp_async_wait<0>();
  __syncthreads();
  for (int w = threadIdx.x / 32; w < wn; w += WARPS) {
    uint32_t v[8];
    bitpack::row_bytes(raw, TJ, 32 * w + literal_row(lane), 0, v);
    s.i[lane][w] = bitpack::transpose32(bitpack::row_bits(v));
  }
}

// Violation counts of the tile at (b0, j0), over all of K, stage by
// stage, on the tensor cores (`mma_popc`): 16-lane x 8-column block p =
// (lanes 16 (p / 4), columns 8 (p % 4)), PAIRS of them, belongs to warps
// p, p + PAIRS, ..., which take alternate 256-bit steps and sum their
// counts in warp p.
// Returns whether this thread holds block p's counts: acc[e] is lane
// 16 (p / 4) + lane / 4 + 8 (e / 2), column 8 (p % 4) + 2 (lane % 4) +
// e % 2 of the tile.
template <int LW, int IW>
__device__ bool clause_counts(const int8_t* __restrict__ lit,
                              const uint8_t* __restrict__ inc, int B, int K,
                              int N, int b0, int j0, ClauseSmem& s,
                              uint8_t* raw, int& p, int (&acc)[4]) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  p = warp % PAIRS;
  const int part = warp / PAIRS;
  const int lr = 16 * (p / 4) + g, jc = 8 * (p % 4) + g;
  const int words = (K + 31) / 32;
#pragma unroll
  for (int e = 0; e < 4; ++e) acc[e] = 0;
  for (int w0 = 0; w0 < words; w0 += KW) {
    if (w0 > 0) __syncthreads();                 // the last stage is read
    pack_stage<LW, IW>(lit, inc, B, K, N, words, w0, b0, j0, s, raw);
    __syncthreads();
    const int steps = (min(KW, words - w0) + 7) / 8;
    for (int st = part; st < steps; st += SPLIT) {
      const int wb = 8 * st;
      const uint32_t a[4] = {s.l[lr][wb + t], s.l[lr + 8][wb + t],
                             s.l[lr][wb + 4 + t], s.l[lr + 8][wb + 4 + t]};
      bitpack::mma_popc(acc, a, s.i[jc][wb + t], s.i[jc][wb + 4 + t]);
    }
  }
  if (part > 0) {
#pragma unroll
    for (int e = 0; e < 4; ++e) s.red[part - 1][p][lane][e] = acc[e];
  }
  __syncthreads();
  if (part > 0) return false;
  for (int q = 0; q < SPLIT - 1; ++q) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[e] += s.red[q][p][lane][e];
  }
  return true;
}

// mode 0: fired (B, N) int8 = (viol == 0) & nonempty; mode 1: viol (B, N)
// int32.  Grid (ceil(N / TJ), ceil(B / TB)).
template <int LW, int IW>
__global__ void __launch_bounds__(THREADS, 1)
clause_eval_kernel(const int8_t* __restrict__ lit,
                   const uint8_t* __restrict__ inc,
                   const uint8_t* __restrict__ nonempty, void* out, int B,
                   int K, int N, int mode) {
  __shared__ ClauseSmem s;
  extern __shared__ __align__(16) uint8_t raw[];
  const int b0 = blockIdx.y * TB, j0 = blockIdx.x * TJ;
  int p, acc[4];
  if (!clause_counts<LW, IW>(lit, inc, B, K, N, b0, j0, s, raw, p, acc))
    return;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int b = b0 + 16 * (p / 4) + (lane >> 2) + 8 * (e / 2);
    const int j = j0 + 8 * (p % 4) + 2 * (lane & 3) + e % 2;
    if (b >= B || j >= N) continue;
    const size_t o = static_cast<size_t>(b) * N + j;
    if (mode == 1)
      static_cast<int32_t*>(out)[o] = acc[e];
    else
      static_cast<int8_t*>(out)[o] = (acc[e] == 0 && nonempty[j]) ? 1 : 0;
  }
}

// scores (B, M) int32, zeroed before the launch, += fired tile @ W rows.
// Grid (ceil(N / TJ), ceil(B / TB)).
template <int LW, int IW>
__global__ void __launch_bounds__(THREADS, 1)
fused_cotm_kernel(const int8_t* __restrict__ lit,
                  const uint8_t* __restrict__ inc,
                  const uint8_t* __restrict__ nonempty,
                  const int32_t* __restrict__ weights,
                  int32_t* __restrict__ scores, int B, int K, int N, int M) {
  __shared__ ClauseSmem s;
  __shared__ uint8_t fired[TB][TJ];
  extern __shared__ __align__(16) uint8_t raw[];
  const int b0 = blockIdx.y * TB, j0 = blockIdx.x * TJ;
  int p, acc[4];
  if (clause_counts<LW, IW>(lit, inc, B, K, N, b0, j0, s, raw, p, acc)) {
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = 16 * (p / 4) + (lane >> 2) + 8 * (e / 2);
      const int c = 8 * (p % 4) + 2 * (lane & 3) + e % 2;
      const bool live = j0 + c < N && nonempty[j0 + c] != 0;
      fired[r][c] = (live && b0 + r < B && acc[e] == 0) ? 1 : 0;
    }
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

// The load widths of one clause-stage launch, as types.
template <int LW_, int IW_>
struct Widths {
  static constexpr int LW = LW_, IW = IW_;
};

bool aligned(const void* p, int bytes) {
  return reinterpret_cast<std::uintptr_t>(p) % bytes == 0;
}

// Calls launch(Widths<lit_width, inc_width>{}) where the operands allow
// the widths (lit_width 16: K a multiple of 16 and lit 16-byte aligned,
// else 1; inc_width 4: N a multiple of 4 and inc 4-byte aligned, else
// 1); else returns cudaErrorInvalidValue, launching nothing.
template <class F>
cudaError_t with_widths(const int8_t* lit, const uint8_t* inc, int K,
                        int N, int lit_width, int inc_width, F launch) {
  const bool l16 = lit_width == 16 && K % 16 == 0 && aligned(lit, 16);
  const bool i4 = inc_width == 4 && N % 4 == 0 && aligned(inc, 4);
  if (!(l16 || lit_width == 1) || !(i4 || inc_width == 1))
    return cudaErrorInvalidValue;
  if (l16) return i4 ? launch(Widths<16, 4>{}) : launch(Widths<16, 1>{});
  return i4 ? launch(Widths<1, 4>{}) : launch(Widths<1, 1>{});
}

// The include tile of a stage in dynamic shared memory: 32 rows of TJ +
// ROW_PAD bytes a word, up to KW words (96 KB, past the 48 KB default).
constexpr int RAW_ROW = TJ + bitpack::ROW_PAD;
int raw_bytes(int K) {
  const int words = (K + 31) / 32;
  return 32 * RAW_ROW * (((words < KW ? words : KW) + 7) / 8 * 8);
}

// Lets `Kernel` take the largest include tile, once a device (static
// storage starts false).
template <auto Kernel>
cudaError_t allow_raw() {
  constexpr int kDevices = 64;
  static std::atomic<bool> done[kDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kDevices && done[dev].load(std::memory_order_relaxed))
    return cudaSuccess;
  err = cudaFuncSetAttribute(Kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             32 * RAW_ROW * KW);
  if (err == cudaSuccess && dev < kDevices)
    done[dev].store(true, std::memory_order_relaxed);
  return err;
}

dim3 clause_grid(int B, int N) {
  return dim3((N + TJ - 1) / TJ, (B + TB - 1) / TB);
}

}  // namespace

// literals (B, K) int8 {0,1}; include (K, N) bool; nonempty (N,) bool;
// out (B, N) int8 (mode 0, fired) or int32 (mode 1, viol); all contiguous
// on the device.  Literal rows read 16 bytes at a time (lit_width 16) or
// by bytes (1), include rows 4 bytes at a time (inc_width 4) or by bytes
// (1).  One launch on `stream`, none where B or N is 0; widths the
// operands do not allow return cudaErrorInvalidValue, launching nothing.
// Returns cudaGetLastError().
extern "C" int clause_eval_i8(const int8_t* lit, const uint8_t* inc,
                              const uint8_t* nonempty, void* out, int B,
                              int K, int N, int mode, int lit_width,
                              int inc_width, cudaStream_t stream) {
  if (B < 0 || K < 0 || N < 0 || !(mode == 0 || mode == 1))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(with_widths(
      lit, inc, K, N, lit_width, inc_width, [&](auto widths) {
        using W = decltype(widths);
        if (B == 0 || N == 0) return cudaGetLastError();
        const auto kernel = clause_eval_kernel<W::LW, W::IW>;
        const cudaError_t err =
            allow_raw<clause_eval_kernel<W::LW, W::IW>>();
        if (err != cudaSuccess) return err;
        kernel<<<clause_grid(B, N), THREADS, raw_bytes(K), stream>>>(
            lit, inc, nonempty, out, B, K, N, mode);
        return cudaGetLastError();
      }));
}

// As clause_eval_i8, then scores (B, M) int32 = fired @ weights (N, M)
// int32, without writing the clause bits: a memset of the scores and one
// launch (the memset alone where N is 0).
extern "C" int fused_cotm_i32(const int8_t* lit, const uint8_t* inc,
                              const uint8_t* nonempty, const int32_t* weights,
                              int32_t* scores, int B, int K, int N, int M,
                              int lit_width, int inc_width,
                              cudaStream_t stream) {
  if (B < 0 || K < 0 || N < 0 || M < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(with_widths(
      lit, inc, K, N, lit_width, inc_width, [&](auto widths) {
        using W = decltype(widths);
        if (B == 0 || M == 0) return cudaGetLastError();
        cudaError_t err = cudaMemsetAsync(
            scores, 0, sizeof(int32_t) * static_cast<size_t>(B) * M, stream);
        if (err != cudaSuccess || N == 0) return err;
        const auto kernel = fused_cotm_kernel<W::LW, W::IW>;
        err = allow_raw<fused_cotm_kernel<W::LW, W::IW>>();
        if (err != cudaSuccess) return err;
        kernel<<<clause_grid(B, N), THREADS, raw_bytes(K), stream>>>(
            lit, inc, nonempty, weights, scores, B, K, N, M);
        return cudaGetLastError();
      }));
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

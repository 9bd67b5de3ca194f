// CoTM Type I/II TA feedback deltas for Hopper (sm_90a), exact integers.
//
// Replaces: src/repro/kernels/fused_impact.py, `_ta_feedback_kernel`
// (:394) behind `ta_feedback` (:417, `pl.pallas_call` :433), the Pallas
// TPU kernel of the online trainer's update sweep.
//
// Computes, over one doubled update batch of 2B rows,
//   t1f = sel & match & fired, t1nf = sel & match & ~fired,
//   t2f = sel & ~match & fired                              (2B, n) masks
//   present = lit^T @ t1f, absent = (1-lit)^T @ t1f,
//   inval = (1-lit)^T @ t2f, decay = sum_b t1nf              (K, n) counts
//   delta = hi*present - lo*(absent + decay) + (!include)*inval   int32
// The TPU kernel runs the three products as f32 MACs, which are exact for
// these counts; here they are integer counts, so the result is the same
// bit for bit.
//
// What bounds it on this card: at the trainer's shape (2B, K, n) = (32,
// 1568, 500) the products are 0.15 G 0/1 operations, under 0.1 us at the
// int8 tensor-core rate, while the (K, n) stream (hi and lo int32, the
// include bytes, the int32 output: 13 B a cell) is 10.3 MB, 3.1 us at
// 3.35 TB/s.  So device memory bounds it, and one launch (about 4.8 us
// of the CUDA-event timer on an NVIDIA H100 80GB HBM3 at 700 W) is more
// than that bound: every pass over device memory or launch beyond the
// one that streams (K, n) costs as much as the stream itself, and so
// does instruction issue that the stream cannot hide (word popcounts
// issue at a quarter of the integer rate).
//
// Design: one launch, no scratch.  A block owns a KT x NT = 128 x 32 tile
// of (K, n), tall so that it re-reads few mask bytes (64 x 64 measured
// within noise of it, 32 x 128 slower: PERF.md), on the grid of
// `kernels/ta_feedback.plan`, and:
// 1. starts copying its byte tiles of sel / match / fired (128 rows x NT
//    columns, 4 bytes a copy) and of the literals (128 rows x KT, 16
//    bytes a copy) into shared memory by `cp.async` along the contiguous
//    axis (where n, K or the pointers do not allow: `bit_pack.cuh`'s
//    `load16`, the aligned 16-byte chunks around 16 bytes, shifted), then
//    issues its hi / lo / include loads straight into registers, 16 and 4
//    bytes a thread a row (one element at a time where n or the pointers
//    do not allow): the stream is in flight while the block packs;
// 2. packs the tiles along 2B into 32-bit words, PASS_WORDS words (128
//    rows) a pass: a warp takes 32 rows x 32 columns of the literals, or
//    of sel / match / fired, from which it forms t1f, t1nf and t2f, a
//    lane a row, and makes a word a column by five-step shuffle
//    transposes (`bit_pack.cuh`; a mask unit's three are independent and
//    overlap); a 2B past one pass copies the next pass's tiles while it
//    counts;
// 3. counts on the tensor cores: popc(lit & t1f) (present) and popc(lit
//    & t2f) are binary products (`mma_popc`, m16n8k256), a warp 16 x 32
//    cells; the per-column popc(t1f), popc(t2f) and decay = popc(t1nf)
//    take a thread a column.  The counts go through shared memory to the
//    threads that hold the stream, which compute absent = popc(t1f) -
//    present, inval = popc(t2f) - popc(lit & t2f) and
//    delta = hi*present - lo*(absent + decay) + (!include)*inval, and
//    store 16 bytes a row where the width allows.
// Mask and literal re-reads (3 * 2B * NT + 2B * KT bytes a block, from
// L2) stay a small share of the block's 13 * KT * NT bytes of stream.
// Ragged edges are masked: bits past 2B are 0, cells past K or n are
// neither loaded nor stored; the Pallas wrapper pads instead
// (src/repro/kernels/backends.py:458-481).

#include <cuda_runtime.h>
#include <stdint.h>

#include <cstdint>

#include "bit_pack.cuh"
#include "hopper_async.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int KT = 128;            // a block's tile: KT rows of (K, n) ...
constexpr int NT = 32;             // ... by NT columns
constexpr int PASS_WORDS = 4;      // words of 32 rows a pass
constexpr int PASS_ROWS = 32 * PASS_WORDS;
constexpr int CHUNK = 32;          // columns (literals) a warp packs
constexpr int PAD = 8;             // conflict-free fragment reads

// The packed words of a pass, and each column's counts over all of 2B.
struct Packed {
  uint32_t lit[PASS_WORDS][KT + PAD];
  uint32_t t1f[PASS_WORDS][NT + PAD];
  uint32_t t1nf[PASS_WORDS][NT + PAD];
  uint32_t t2f[PASS_WORDS][NT + PAD];
  int col[3][NT];                  // popc(t1f), popc(t2f), popc(t1nf)
};

// Dynamic shared memory: a pass's byte tiles (3 masks x NT columns and KT
// literal columns of PASS_ROWS rows), and after the last pass, in the
// same bytes, the two counts of every cell (KT rows of NT + PAD ints).
// With the static `Packed` it stays under the 48 KB a launch may take
// without opting in.
constexpr int MASK_BYTES = PASS_ROWS * (NT + bitpack::ROW_PAD);
constexpr int TILES_BYTES =
    3 * MASK_BYTES + PASS_ROWS * (KT + bitpack::ROW_PAD);
constexpr int COUNTS_BYTES = 2 * 4 * KT * (NT + PAD);
constexpr int RAW_BYTES =
    TILES_BYTES > COUNTS_BYTES ? TILES_BYTES : COUNTS_BYTES;
static_assert(RAW_BYTES + sizeof(Packed) <= 48 * 1024,
              "ta_feedback's shared memory must fit the default limit");

// Grid (ceil(n / NT), ceil(K / KT)).  The stream: thread t holds columns
// j0 + 4 (t % 8) + c (c < 4) of rows k0 + t / 8 + 32 q (q < 4).  The
// counts: warp w computes rows 16 w .. 16 w + 15, all NT = 32 columns of
// the tile.  VW = 4: hi / lo / out 16 bytes a row, include and the mask
// tiles 4 bytes (n a multiple of 4, the pointers aligned); 1: one element
// at a time.  LW = 16: the literal tile 16 bytes at a time (K a multiple
// of 16, lit2 aligned); 1: bytes.  The mask bytes are 0 or 1 (the wrapper
// passes bools); literal bytes are tested against 0.
template <int VW, int LW>
__global__ void __launch_bounds__(THREADS, 2)
ta_feedback_kernel(const int8_t* __restrict__ lit2,
                   const uint8_t* __restrict__ sel,
                   const uint8_t* __restrict__ match,
                   const uint8_t* __restrict__ fired,
                   const int32_t* __restrict__ hi,
                   const int32_t* __restrict__ lo,
                   const uint8_t* __restrict__ include,
                   int32_t* __restrict__ out, int rows, int K, int n) {
  constexpr int TJN = NT / 4, TKN = THREADS / TJN;
  __shared__ Packed s;
  __shared__ __align__(16) uint8_t raw[RAW_BYTES];
  const int j0 = blockIdx.x * NT, k0 = blockIdx.y * KT;
  const int tj = threadIdx.x % TJN, tk = threadIdx.x / TJN;
  const int j = j0 + 4 * tj;
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int kw = 16 * warp;
  const int words = (rows + 31) / 32;
  uint8_t* const raw_sel = raw;
  uint8_t* const raw_match = raw + MASK_BYTES;
  uint8_t* const raw_fired = raw + 2 * MASK_BYTES;
  uint8_t* const raw_lit = raw + 3 * MASK_BYTES;
  // The byte tiles of the pass from word w0, in flight until the wait; a
  // row at a time, which keeps the plain loads' registers (VW or LW = 1)
  // from spilling beside the stream's.
  auto stage = [&](int w0) {
    const int r0 = 32 * w0, nr = 32 * min(PASS_WORDS, words - w0);
    using bitpack::stage_tile;
    stage_tile<VW, 1>(raw_sel, sel, n, r0, rows, nr, j0, NT, n);
    stage_tile<VW, 1>(raw_match, match, n, r0, rows, nr, j0, NT, n);
    stage_tile<VW, 1>(raw_fired, fired, n, r0, rows, nr, j0, NT, n);
    stage_tile<LW, 1>(raw_lit, reinterpret_cast<const uint8_t*>(lit2), K,
                      r0, rows, nr, k0, KT, K);
    hopper::cp_async_commit();
  };

  // 1. The first pass's tiles, then the (K, n) stream.
  if (words > 0) stage(0);
  int h[4][4], l[4][4];
  uint32_t inc[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int k = k0 + tk + TKN * q;
    const size_t e = static_cast<size_t>(k) * n + j;
    if (VW == 4) {
      int4 x = make_int4(0, 0, 0, 0), y = x;
      uint32_t z = 0u;
      if (k < K && j < n) {
        x = __ldg(reinterpret_cast<const int4*>(hi + e));
        y = __ldg(reinterpret_cast<const int4*>(lo + e));
        z = __ldg(reinterpret_cast<const uint32_t*>(include + e));
      }
      h[q][0] = x.x, h[q][1] = x.y, h[q][2] = x.z, h[q][3] = x.w;
      l[q][0] = y.x, l[q][1] = y.y, l[q][2] = y.z, l[q][3] = y.w;
      inc[q] = z;
    } else {
      inc[q] = 0u;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const bool in = k < K && j + c < n;
        h[q][c] = in ? __ldg(hi + e + c) : 0;
        l[q][c] = in ? __ldg(lo + e + c) : 0;
        if (in) inc[q] |= static_cast<uint32_t>(__ldg(include + e + c))
                          << (8 * c);
      }
    }
  }

  // 2-3. Pack a pass's tiles into words, stage the next pass, count.
  int present[4][4] = {}, lit_t2f[4][4] = {};
  int t1 = 0, t2 = 0, decay = 0;     // column threadIdx.x, if < NT
  for (int w0 = 0; w0 < words; w0 += PASS_WORDS) {
    const int wn = min(PASS_WORDS, words - w0);
    const int mask_units = wn * (NT / CHUNK);
    hopper::cp_async_wait<0>();
    __syncthreads();             // the tiles landed; the last count is done
    // A unit: one word and 32 columns of the three masks (their three
    // transposes are independent, so they overlap) or of the literals.
    for (int u = warp; u < mask_units + wn * (KT / CHUNK); u += WARPS) {
      uint32_t va[8], vb[8], vc[8];
      if (u < mask_units) {
        const int w = u / (NT / CHUNK), cc = CHUNK * (u % (NT / CHUNK));
        bitpack::row_bytes(raw_sel, NT, 32 * w + lane, cc, va);
        bitpack::row_bytes(raw_match, NT, 32 * w + lane, cc, vb);
        bitpack::row_bytes(raw_fired, NT, 32 * w + lane, cc, vc);
        uint32_t t1f[8], t1nf[8], t2f[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const uint32_t sm = va[i] & vb[i];
          t1f[i] = sm & vc[i];
          t1nf[i] = sm & (vc[i] ^ 0x01010101u);
          t2f[i] = va[i] & (vb[i] ^ 0x01010101u) & vc[i];
        }
        const uint32_t x = bitpack::transpose32(bitpack::row_bits(t1f));
        const uint32_t y = bitpack::transpose32(bitpack::row_bits(t1nf));
        const uint32_t z = bitpack::transpose32(bitpack::row_bits(t2f));
        s.t1f[w][cc + lane] = x;
        s.t1nf[w][cc + lane] = y;
        s.t2f[w][cc + lane] = z;
      } else {
        const int v = u - mask_units;
        const int w = v / (KT / CHUNK), cc = CHUNK * (v % (KT / CHUNK));
        bitpack::row_bytes(raw_lit, KT, 32 * w + lane, cc, va);
#pragma unroll
        for (int i = 0; i < 8; ++i) va[i] = bitpack::nonzero4(va[i]);
        s.lit[w][cc + lane] = bitpack::transpose32(bitpack::row_bits(va));
      }
    }
    __syncthreads();             // the words are packed; the tiles are free
    if (w0 + PASS_WORDS < words) stage(w0 + PASS_WORDS);
    if (threadIdx.x < NT) {
      for (int w = 0; w < wn; ++w) {
        t1 += __popc(s.t1f[w][threadIdx.x]);
        t2 += __popc(s.t2f[w][threadIdx.x]);
        decay += __popc(s.t1nf[w][threadIdx.x]);
      }
    }
    // A pass fills bits 0-127 of the 256-bit step; words past wn are 0.
    const bool live = t < wn;
    const uint32_t a[4] = {live ? s.lit[t][kw + g] : 0u,
                           live ? s.lit[t][kw + g + 8] : 0u, 0u, 0u};
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int jj = 8 * m + g;
      bitpack::mma_popc(present[m], a, live ? s.t1f[t][jj] : 0u, 0u);
      bitpack::mma_popc(lit_t2f[m], a, live ? s.t2f[t][jj] : 0u, 0u);
    }
  }

  // The counts to the stream's layout, through the tiles' bytes (no pass
  // reads them any more).
  int* const xp = reinterpret_cast<int*>(raw);
  int* const xl = xp + KT * (NT + PAD);
#pragma unroll
  for (int m = 0; m < 4; ++m) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int o = (kw + g + 8 * half) * (NT + PAD) + 8 * m + 2 * t;
      *reinterpret_cast<int2*>(xp + o) =
          make_int2(present[m][2 * half], present[m][2 * half + 1]);
      *reinterpret_cast<int2*>(xl + o) =
          make_int2(lit_t2f[m][2 * half], lit_t2f[m][2 * half + 1]);
    }
  }
  if (threadIdx.x < NT) {
    s.col[0][threadIdx.x] = t1;
    s.col[1][threadIdx.x] = t2;
    s.col[2][threadIdx.x] = decay;
  }
  __syncthreads();

  // absent = popc(t1f) - present, inval = popc(t2f) - popc(lit & t2f).
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int r = tk + TKN * q, k = k0 + r;
    if (k >= K) continue;
    const int4 P = *reinterpret_cast<const int4*>(xp + r * (NT + PAD) +
                                                  4 * tj);
    const int4 L = *reinterpret_cast<const int4*>(xl + r * (NT + PAD) +
                                                  4 * tj);
    const int p[4] = {P.x, P.y, P.z, P.w}, lt[4] = {L.x, L.y, L.z, L.w};
    int d[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int cc = 4 * tj + c;
      const bool in_c = (inc[q] >> (8 * c)) & 0xffu;
      d[c] = h[q][c] * p[c] -
             l[q][c] * (s.col[0][cc] - p[c] + s.col[2][cc]) +
             (in_c ? 0 : s.col[1][cc] - lt[c]);
    }
    const size_t e = static_cast<size_t>(k) * n + j;
    if (VW == 4) {
      if (j < n)
        *reinterpret_cast<int4*>(out + e) = make_int4(d[0], d[1], d[2], d[3]);
    } else {
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (j + c < n) out[e + c] = d[c];
    }
  }
}

bool aligned(const void* p, int bytes) {
  return reinterpret_cast<std::uintptr_t>(p) % bytes == 0;
}

}  // namespace

// lit2 (rows, K) int8 {0,1}; sel, match, fired (rows, n) bool (bytes 0
// or 1); hi, lo (K, n) int32; include (K, n) bool; out (K, n) int32; all
// contiguous on the device.  width 4 (n a multiple of 4; hi, lo, out
// 16-byte aligned, the byte operands 4-byte) or 1; lit_width 16 (K a
// multiple of 16, lit2 16-byte aligned) or 1.  One launch on `stream`,
// none where K or n is 0; a width the operands do not allow returns
// cudaErrorInvalidValue, launching nothing.  Returns cudaGetLastError().
extern "C" int ta_feedback_i32(const int8_t* lit2, const uint8_t* sel,
                               const uint8_t* match, const uint8_t* fired,
                               const int32_t* hi, const int32_t* lo,
                               const uint8_t* include, int32_t* out,
                               int rows, int K, int n, int width,
                               int lit_width, cudaStream_t stream) {
  const bool wide = width == 4 && n % 4 == 0 && aligned(hi, 16) &&
                    aligned(lo, 16) && aligned(out, 16) &&
                    aligned(include, 4) && aligned(sel, 4) &&
                    aligned(match, 4) && aligned(fired, 4);
  const bool lit16 = lit_width == 16 && K % 16 == 0 && aligned(lit2, 16);
  if (rows < 0 || K < 0 || n < 0 || !(wide || width == 1) ||
      !(lit16 || lit_width == 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (K == 0 || n == 0) return static_cast<int>(cudaGetLastError());
  const dim3 grid((n + NT - 1) / NT, (K + KT - 1) / KT);
  auto kernel = wide ? (lit16 ? ta_feedback_kernel<4, 16>
                               : ta_feedback_kernel<4, 1>)
                     : (lit16 ? ta_feedback_kernel<1, 16>
                               : ta_feedback_kernel<1, 1>);
  kernel<<<grid, THREADS, 0, stream>>>(lit2, sel, match, fired, hi, lo,
                                       include, out, rows, K, n);
  return static_cast<int>(cudaGetLastError());
}

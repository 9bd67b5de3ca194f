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
// What bounds it on this card: at the trainer's shape (K = 1568, n = 500,
// 2B = 128) the products are 0.6 G 0/1 operations, 0.3 us at the int8
// tensor-core rate, while the (K, n) operands hi, lo (int32), include and
// the int32 output are 10.2 MB, 3.0 us at 3.35 TB/s.  So device memory is
// the limit, and the design moves each (K, n) element once, coalesced.
//
// Design: the 0/1 masks and literals are packed along the 2B axis into
// 32-bit words (two small passes, 0.4 MB of reads), so a 2B contraction
// is 2B/32 AND + popcount steps; one thread then owns one (k, j) cell and
// walks every word of the batch, so the whole contraction stays inside
// the thread and every cell is independent (the Pallas kernel keeps the
// 2B axis whole inside a block for the same reason).  Ragged edges are
// masked: packed bits past 2B are 0, and threads past n do nothing; the
// Pallas wrapper pads instead (src/repro/kernels/backends.py:458-481).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;

// lit (rows, cols) bytes -> out (ceil(rows/32), cols) words; bit i of
// word w of column c is x[32w + i][c] != 0, and 0 past `rows`.
__global__ void __launch_bounds__(THREADS)
pack_literals(const int8_t* __restrict__ x, uint32_t* __restrict__ out,
              int rows, int cols) {
  const int c = blockIdx.x * THREADS + threadIdx.x;
  const int w = blockIdx.y;
  if (c >= cols) return;
  const int r0 = w * 32, r1 = min(rows, r0 + 32);
  uint32_t word = 0;
  for (int r = r0; r < r1; ++r)
    word |= static_cast<uint32_t>(x[(size_t)r * cols + c] != 0) << (r - r0);
  out[(size_t)w * cols + c] = word;
}

// The three feedback masks of (rows, n) bool sel / match / fired, packed
// the same way into (ceil(rows/32), n) words each.
__global__ void __launch_bounds__(THREADS)
pack_masks(const uint8_t* __restrict__ sel, const uint8_t* __restrict__ match,
           const uint8_t* __restrict__ fired, uint32_t* __restrict__ t1f,
           uint32_t* __restrict__ t1nf, uint32_t* __restrict__ t2f, int rows,
           int n) {
  const int j = blockIdx.x * THREADS + threadIdx.x;
  const int w = blockIdx.y;
  if (j >= n) return;
  const int r0 = w * 32, r1 = min(rows, r0 + 32);
  uint32_t a = 0, b = 0, c = 0;
  for (int r = r0; r < r1; ++r) {
    const size_t e = (size_t)r * n + j;
    const bool s = sel[e] != 0, m = match[e] != 0, f = fired[e] != 0;
    const uint32_t bit = 1u << (r - r0);
    a |= (s && m && f) ? bit : 0u;
    b |= (s && m && !f) ? bit : 0u;
    c |= (s && !m && f) ? bit : 0u;
  }
  const size_t o = (size_t)w * n + j;
  t1f[o] = a;
  t1nf[o] = b;
  t2f[o] = c;
}

// One thread per (k, j) cell: block (k, j-tile), threads along j so the
// (K, n) loads and the store are coalesced.
__global__ void __launch_bounds__(THREADS)
ta_delta(const uint32_t* __restrict__ lit, const uint32_t* __restrict__ t1f,
         const uint32_t* __restrict__ t1nf, const uint32_t* __restrict__ t2f,
         const int32_t* __restrict__ hi, const int32_t* __restrict__ lo,
         const uint8_t* __restrict__ include, int32_t* __restrict__ out,
         int K, int n, int words) {
  const int k = blockIdx.x;
  const int j = blockIdx.y * THREADS + threadIdx.x;
  if (j >= n) return;
  int present = 0, absent = 0, inval = 0, decay = 0;
  for (int w = 0; w < words; ++w) {
    const uint32_t l = lit[(size_t)w * K + k];
    const size_t o = (size_t)w * n + j;
    const uint32_t a = t1f[o];
    present += __popc(l & a);
    absent += __popc(~l & a);
    inval += __popc(~l & t2f[o]);
    decay += __popc(t1nf[o]);
  }
  const size_t e = (size_t)k * n + j;
  out[e] = hi[e] * present - lo[e] * (absent + decay) +
           (include[e] ? 0 : inval);
}

}  // namespace

// lit2 (rows, K) int8 {0,1}; sel, match, fired (rows, n) bool; hi, lo
// (K, n) int32; include (K, n) bool; out (K, n) int32; scratch of
// words * (K + 3n) uint32 with words = ceil(rows / 32); all contiguous on
// the device.  Launches on `stream`; returns cudaGetLastError().
extern "C" int ta_feedback_i32(const int8_t* lit2, const uint8_t* sel,
                               const uint8_t* match, const uint8_t* fired,
                               const int32_t* hi, const int32_t* lo,
                               const uint8_t* include, int32_t* out,
                               uint32_t* scratch, int rows, int K, int n,
                               cudaStream_t stream) {
  if (K <= 0 || n <= 0) return static_cast<int>(cudaGetLastError());
  const int words = (rows + 31) / 32;
  uint32_t* lit = scratch;
  uint32_t* t1f = lit + (size_t)words * K;
  uint32_t* t1nf = t1f + (size_t)words * n;
  uint32_t* t2f = t1nf + (size_t)words * n;
  if (words > 0) {
    pack_literals<<<dim3((K + THREADS - 1) / THREADS, words), THREADS, 0,
                    stream>>>(lit2, lit, rows, K);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    pack_masks<<<dim3((n + THREADS - 1) / THREADS, words), THREADS, 0,
                 stream>>>(sel, match, fired, t1f, t1nf, t2f, rows, n);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  ta_delta<<<dim3(K, (n + THREADS - 1) / THREADS), THREADS, 0, stream>>>(
      lit, t1f, t1nf, t2f, hi, lo, include, out, K, n, words);
  return static_cast<int>(cudaGetLastError());
}

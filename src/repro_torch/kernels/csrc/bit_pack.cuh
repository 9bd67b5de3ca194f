// Binary contractions on Hopper for the kernels that pack their own 0/1
// operands (ta_feedback.cu, the clause stage of digital_cotm.cu).
//
// - Packing along the strided axis: the block copies a byte tile of the
//   operand into shared memory (`stage_tile`, 16- or 4-byte `cp.async`
//   copies along the contiguous axis where the operand's alignment
//   allows, else `load16`: the aligned 16-byte chunks around any 16
//   bytes, loaded and shifted); then a warp takes 32 rows x 32
//   columns of it, lane r row r (`row_bytes`: two 16-byte shared loads,
//   the rows padded so that they hit distinct banks), packs the row into
//   a word (`row_bits`) and transposes the 32 x 32 bit matrix with five
//   shuffle steps (`transpose32`), so that lane c holds the word of
//   column c, bit r = row r.
// - Counting: `mma_popc` runs the tensor cores' binary product,
//   d += popc(a & b) over 256-bit rows of A (16 x 256) and columns of B
//   (256 x 8), in place of 16 x 8 x 8 word popcounts a warp.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "hopper_async.cuh"

namespace bitpack {

// Bytes a staged row takes in shared memory past its `cols`: 16 more, so
// the 16-byte loads of 8 consecutive rows hit distinct banks.
constexpr int ROW_PAD = 16;

// Per byte of x: 1 where the byte is not 0, else 0.
__device__ __forceinline__ uint32_t nonzero4(uint32_t x) {
  return ((((x & 0x7f7f7f7fu) + 0x7f7f7f7fu) | x) >> 7) & 0x01010101u;
}

// Four bytes that are each 0 or 1 -> four bits (byte q -> bit q).
__device__ __forceinline__ uint32_t nibble(uint32_t v) {
  return (v * 0x01020408u) >> 24;
}

// 32 bytes that are each 0 or 1 (v[q] holds bytes 4q .. 4q + 3) -> a
// word, bit c = byte c.
__device__ __forceinline__ uint32_t row_bits(const uint32_t (&v)[8]) {
  uint32_t x = 0u;
#pragma unroll
  for (int q = 0; q < 8; ++q) x |= nibble(v[q]) << (4 * q);
  return x;
}

// Bytes 0 .. valid - 1 of x (byte 4i + q is byte q of word i) kept, the
// rest set to `fill` (0 or 1).
__device__ __forceinline__ uint4 fill_past(uint4 x, int valid,
                                           uint32_t fill) {
  uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int v = valid - 4 * i;
    const uint32_t keep = v >= 4 ? ~0u : v <= 0 ? 0u : (1u << (8 * v)) - 1u;
    w[i] = (w[i] & keep) | (fill * 0x01010101u & ~keep);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// The 16 bytes at p, of any alignment, reading only bytes of [lo, hi)
// (the tensor p lies in; bytes past hi are 0).  Where the 16-byte-aligned
// chunks that cover p .. p + 15 lie in [lo, hi): one or two 16-byte
// loads and a funnel shift; else (the tensor's first and last 32 bytes)
// byte loads.
__device__ __forceinline__ uint4 load16(const uint8_t* p, const uint8_t* lo,
                                        const uint8_t* hi) {
  const auto a = reinterpret_cast<std::uintptr_t>(p);
  const int s = static_cast<int>(a & 15u);
  const uint8_t* q = p - s;
  if (q >= lo && q + (s ? 32 : 16) <= hi) {
    const uint4 x = __ldg(reinterpret_cast<const uint4*>(q));
    if (s == 0) return x;
    const uint4 y = __ldg(reinterpret_cast<const uint4*>(q) + 1);
    const uint32_t w[8] = {x.x, x.y, x.z, x.w, y.x, y.y, y.z, y.w};
    const int ws = s >> 2, bs = 8 * (s & 3);
    uint32_t u[5];
#pragma unroll
    for (int i = 0; i < 5; ++i)
      u[i] = ws == 0 ? w[i] : ws == 1 ? w[i + 1] : ws == 2 ? w[i + 2]
                                                            : w[i + 3];
    return make_uint4(__funnelshift_r(u[0], u[1], bs),
                      __funnelshift_r(u[1], u[2], bs),
                      __funnelshift_r(u[2], u[3], bs),
                      __funnelshift_r(u[3], u[4], bs));
  }
  uint32_t v[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int b = 0; b < 16; ++b)
    if (p + b >= lo && p + b < hi)
      v[b >> 2] |= static_cast<uint32_t>(__ldg(p + b)) << (8 * (b & 3));
  return make_uint4(v[0], v[1], v[2], v[3]);
}

// Copy rows [row0, row0 + nrows) x columns [c0, c0 + cols) of a
// contiguous row-major byte matrix (`rows` rows of `pitch` bytes, of
// which `lim` are columns) to dst in shared memory, cols + ROW_PAD bytes
// a row, zeros past `rows` and `lim`.  Every thread of the block takes
// part; a row's chunks (of 16 bytes where W = 16 or 1, else 4) are a
// power of 2 that divides the block's threads.  W = 16 / 4: `cp.async`
// copies of that many bytes (src, pitch, c0 and lim multiples of W),
// which the caller commits and waits for; 1: any alignment, `load16`s
// stored at once.  UNROLL: rows a thread copies at once.
template <int W, int UNROLL = 4>
__device__ __forceinline__ void stage_tile(uint8_t* dst,
                                           const uint8_t* __restrict__ src,
                                           int pitch, int row0, int rows,
                                           int nrows, int c0, int cols,
                                           int lim) {
  // Thread t copies chunk t % per of every (blockDim.x / per)-th row,
  // stepping its pointers.
  constexpr int CB = W == 4 ? 4 : 16;
  const int per = cols / CB, sh = __ffs(per) - 1, dr = blockDim.x >> sh;
  const int q = threadIdx.x & (per - 1), c = c0 + CB * q;
  int r = threadIdx.x >> sh;
  const uint8_t* p = src + static_cast<size_t>(row0 + r) * pitch + c;
  const uint8_t* const end = src + static_cast<size_t>(rows) * pitch;
  uint8_t* d = dst + r * (cols + ROW_PAD) + CB * q;
  const size_t dp = static_cast<size_t>(dr) * pitch;
  const int dd = dr * (cols + ROW_PAD);
  // Unrolled so that the loads of several rows are in flight at once.
#pragma unroll UNROLL
  for (; r < nrows; r += dr, p += dp, d += dd) {
    const bool in = row0 + r < rows && c < lim;
    if (W == 16) {
      hopper::cp_async16(d, in ? p : src, in ? 16 : 0);
    } else if (W == 4) {
      hopper::cp_async4(d, in ? p : src, in ? 4 : 0);
    } else {
      *reinterpret_cast<uint4*>(d) =
          in ? fill_past(load16(p, src, end), lim - c, 0u)
             : make_uint4(0u, 0u, 0u, 0u);
    }
  }
}

// The 32 bytes of row r, columns cc .. cc + 31 (cc a multiple of 16), of
// a tile staged by `stage_tile` with `cols` columns.
__device__ __forceinline__ void row_bytes(const uint8_t* tile, int cols,
                                          int r, int cc, uint32_t (&v)[8]) {
  const uint4* p = reinterpret_cast<const uint4*>(
      tile + r * (cols + ROW_PAD) + cc);
  const uint4 a = p[0], b = p[1];
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
  v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
}

// Lane r holds row r of a 32 x 32 bit matrix (bit c = column c) -> lane c
// holds column c (bit r = row r).  Step s swaps the off-diagonal s x s
// blocks between lanes r and r ^ s.
__device__ __forceinline__ uint32_t transpose32(uint32_t x) {
  const int lane = threadIdx.x & 31;
  constexpr uint32_t kMask[5] = {0x0000ffffu, 0x00ff00ffu, 0x0f0f0f0fu,
                                 0x33333333u, 0x55555555u};
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    const int s = 16 >> i;
    const uint32_t m = kMask[i];
    const uint32_t o = __shfl_xor_sync(0xffffffffu, x, s);
    x = (lane & s) ? (((o >> s) & m) | (x & ~m)) : ((x & m) | ((o & m) << s));
  }
  return x;
}

// d += popc(A & B) on the tensor cores (m16n8k256, b1 AND + popcount).
// Lane (g, t) = (lane / 4, lane % 4) holds a0..a3 = the 256-bit rows g,
// g + 8, g, g + 8 of A at bits 32t .. and 128 + 32t .. (a word each), b0,
// b1 = column g of B at the same bits, and d0..d3 = D[g][2t], D[g][2t +
// 1], D[g + 8][2t], D[g + 8][2t + 1].
__device__ __forceinline__ void mma_popc(int (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

}  // namespace bitpack

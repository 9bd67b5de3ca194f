// Fused analog IMPACT inference for Hopper (sm_90a), IEEE f32: both
// crossbars, the CSA threshold and the digital periphery, with optional
// per-lane read-current meters.
//
// Replaces: src/repro/kernels/fused_impact.py, `_fused_impact_kernel` (:58)
// behind `fused_impact` (:106), and `_fused_impact_metered_kernel` (:134)
// behind `fused_impact_metered` (:210), the Pallas TPU kernels.
//
//   per clause column j (row shards r = 0..R-1 of tr rows each):
//     i_col[r] = drive[r] @ clause_i[r][:, j]       Kirchhoff column sum
//     fired    = AND_r (i_col[r] < thresh) & nonempty[j]
//   scores    += fired @ class_i[j, :]               class column currents
//   metered:   clause meter = sum over every (r, j) of i_col[r] per lane;
//              class meter  = sum over m of scores per lane.
//
// Operands stay in the system's own layouts: literals (B, K) int8 (the
// drive 1 - literal is formed in the tile load), clause_i (R, C, tr, tc)
// f32, nonempty (C*tc,) u8, class_i (S*sr, M) f32.  Rows past K float at
// 0 V (the reference pads literals with 1), so they add exactly 0: the
// row loop stops at K and never loads or multiplies them.
//
// What bounds it on this card: at the paper serving shape (B = 128,
// K = 1568, R = C = S = 1, tr = sr = 2048, tc = 512, M = 10) the clause
// stage is 2*B*K*C*tc = 0.21 GFLOP on 3.2 MB of live clause currents and
// 0.2 MB of literals, so the f32 FMA rate bounds it, not memory.  The
// contract is IEEE f32 (scores at rtol 1e-6, CSA bits exact), so every
// product is one FFMA on the CUDA cores; no tensor cores, no TF32.
//
// Design, three launches on one stream:
// 1. Column currents.  The TPU walks the clause axis as a sequential grid
//    dimension carrying the score accumulator in VMEM, and keeps tr whole
//    (up to 2048 rows).  Hopper blocks run in no order, and (B, C*tc)
//    tiles alone are too few for 132 SMs (4 x 16 = 64 at the paper
//    shape), so each block takes one 32-lane x 32-column tile of one row
//    shard and one slice of its live rows, those below K (tile_mma.cuh:
//    shared-memory stages of 32 rows, 4 x 2 f32 accumulators a thread),
//    and writes its partial column currents to scratch.
// 2. CSA and class stage.  Per (32 lanes, 32 columns) tile: sum each
//    shard's slices in a fixed order into the column current, latch the
//    CSA bit with the reference's strict `<`, AND over shards, mask with
//    nonempty, then add the tile's fired columns' class currents per
//    (lane, class).  The clause bits live only in shared memory here.
// 3. A fixed-order sum of the tiles' partial scores and meters per lane.
// No float atomics anywhere, so scores and meters are identical from run
// to run.
//
// * Columns: the reference pads the clause axis to max(C*tc, S*sr) (2048
//   at paper dims against 512 live columns) with 0 A, nonempty = 0
//   columns that never fire.  This kernel never visits them: its tiles
//   cover exactly C*tc columns, and the class stage skips clause rows at
//   or past S*sr, which the reference drops too.  The output is the same.
//   The clause meter does sum every one of the C*tc columns of every row
//   shard, including the columns from n up to C*tc: those are real LCS
//   cells that leak.
// * Ragged edges are masked in the loads (0 V drive, 0 A cells), which add
//   exactly 0.  M (10 at paper dims) needs no padding: the class stage
//   loops over the M columns of class_i directly.
// * The class stage and both meters accumulate in f64 and round to f32
//   once at the end: a few thousand adds a lane, and it keeps the kernel's
//   own rounding out of the comparison with the f32 reference.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tile_mma.cuh"

using namespace impact;

namespace {

struct Plan {
  int tiles_c;     // 32-column tiles per clause tile (ceil(tc / 32))
  int tiles;       // column tiles over all C*tc columns
  Split split;     // slices of each shard's tr rows
};

Plan plan(int B, int K, int R, int C, int tr, int tc) {
  const int tiles_c = (tc + BN - 1) / BN;
  const int tiles = C * tiles_c;
  // The slices cover the live rows of the fullest shard; in a shard with
  // fewer live rows the slices past them run no stage and write zeros.
  return Plan{tiles_c, tiles,
              split_k(min(tr, K), tiles * ((B + BB - 1) / BB) * R)};
}

// Pass 1: block (column tile t, lane tile, r * slices + slice) -> partial
// column currents part[r * slices + slice] (B, C*tc).
__global__ void __launch_bounds__(THREADS)
column_currents(const int8_t* __restrict__ lits,
                const float* __restrict__ clause_i, float* __restrict__ part,
                int B, int K, int C, int tr, int tc, int tiles_c, int slices,
                int chunk) {
  __shared__ Smem s;
  const int t = blockIdx.x;
  const int c = t / tiles_c;
  const int col0 = (t % tiles_c) * BN;
  const int b0 = blockIdx.y * BB;
  const int r = blockIdx.z / slices;
  const int k_begin = (blockIdx.z % slices) * chunk;
  const int k_end = min(min(tr, K - r * tr), k_begin + chunk);
  const float* cur = clause_i + ((size_t)r * C + c) * tr * tc;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
  tile_mma(
      acc, k_begin, k_end, s,
      [&](int bb, int k) {
        const int b = b0 + bb;
        return b < B ? 1.f - static_cast<float>(
                                 lits[(size_t)b * K + r * tr + k])
                     : 0.f;
      },
      [&](int k, int nn) {
        const int col = col0 + nn;
        return col < tc ? cur[(size_t)k * tc + col] : 0.f;
      });

  const int N = C * tc;
  float* out = part + (size_t)blockIdx.z * B * N;
  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int b = b0 + ty * TM + i;
    if (b >= B) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int col = col0 + tx * TN + j;
      if (col < tc) out[(size_t)b * N + c * tc + col] = acc[i][j];
    }
  }
}

// Pass 2: block (column tile t, lane tile) -> part_scores[t] (B, M) and,
// metered, part_meter[t] (B,), both f64.
template <bool METERED>
__global__ void __launch_bounds__(THREADS)
csa_class(const float* __restrict__ part, const uint8_t* __restrict__ nonempty,
          const float* __restrict__ class_i, double* __restrict__ part_scores,
          double* __restrict__ part_meter, int B, int R, int C, int tc,
          int tiles_c, int slices, int Nc, int M, float thresh) {
  __shared__ float Fs[BB][BN + 1];
  __shared__ double Ms[BB][BN + 1];
  const int t = blockIdx.x;
  const int c = t / tiles_c;
  const int col0 = (t % tiles_c) * BN;
  const int b0 = blockIdx.y * BB;
  const int N = C * tc;

  for (int e = threadIdx.x; e < BB * BN; e += THREADS) {
    const int bb = e / BN, nn = e % BN;
    const int b = b0 + bb, col = col0 + nn, j = c * tc + col;
    bool fired = b < B && col < tc && nonempty[j] != 0;
    double meter = 0.0;
    if (b < B && col < tc) {
      for (int r = 0; r < R; ++r) {
        float i_col = 0.f;
        for (int sl = 0; sl < slices; ++sl)
          i_col += part[((size_t)(r * slices + sl) * B + b) * N + j];
        fired = fired && (i_col < thresh);
        meter += i_col;
      }
    }
    Fs[bb][nn] = fired ? 1.f : 0.f;
    Ms[bb][nn] = meter;
  }
  __syncthreads();

  const int jbase = c * tc + col0;           // clause column of nn = 0
  for (int e = threadIdx.x; e < BB * M; e += THREADS) {
    const int bb = e / M, m = e % M;
    const int b = b0 + bb;
    if (b >= B) continue;
    double s = 0.0;
    for (int nn = 0; nn < BN; ++nn) {
      const int jg = jbase + nn;
      if (col0 + nn < tc && jg < Nc && Fs[bb][nn] != 0.f)
        s += class_i[(size_t)jg * M + m];
    }
    part_scores[((size_t)t * B + b) * M + m] = s;
  }
  if (METERED && threadIdx.x < BB) {
    const int b = b0 + threadIdx.x;
    if (b < B) {
      double s = 0.0;
      for (int nn = 0; nn < BN; ++nn) s += Ms[threadIdx.x][nn];
      part_meter[(size_t)t * B + b] = s;
    }
  }
}

// Pass 3: fixed-order sum of the tiles' partials, one thread per lane.
template <bool METERED>
__global__ void lane_reduce(const double* __restrict__ part_scores,
                            const double* __restrict__ part_meter,
                            float* __restrict__ scores,
                            float* __restrict__ meter_clause,
                            float* __restrict__ meter_class, int B, int M,
                            int T) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  double cls = 0.0;
  for (int m = 0; m < M; ++m) {
    double s = 0.0;
    for (int t = 0; t < T; ++t) s += part_scores[((size_t)t * B + b) * M + m];
    scores[(size_t)b * M + m] = static_cast<float>(s);
    cls += s;
  }
  if (METERED) {
    double cl = 0.0;
    for (int t = 0; t < T; ++t) cl += part_meter[(size_t)t * B + b];
    meter_clause[b] = static_cast<float>(cl);
    meter_class[b] = static_cast<float>(cls);
  }
}

template <bool METERED>
int launch(const int8_t* lits, const float* clause_i, const uint8_t* nonempty,
           const float* class_i, float* part_cols, double* part_scores,
           double* part_meter, float* scores, float* meter_clause,
           float* meter_class, int B, int K, int R, int C, int tr, int tc,
           int Nc, int M, float thresh, cudaStream_t stream) {
  if (B <= 0) return static_cast<int>(cudaGetLastError());
  const Plan p = plan(B, K, R, C, tr, tc);
  const int tiles_b = (B + BB - 1) / BB;
  if (p.tiles > 0) {
    column_currents<<<dim3(p.tiles, tiles_b, R * p.split.count), THREADS, 0,
                      stream>>>(lits, clause_i, part_cols, B, K, C, tr, tc,
                                p.tiles_c, p.split.count, p.split.chunk);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    csa_class<METERED><<<dim3(p.tiles, tiles_b), THREADS, 0, stream>>>(
        part_cols, nonempty, class_i, part_scores, part_meter, B, R, C, tc,
        p.tiles_c, p.split.count, Nc, M, thresh);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  lane_reduce<METERED><<<(B + 127) / 128, 128, 0, stream>>>(
      part_scores, part_meter, scores, meter_clause, meter_class, B, M,
      p.tiles);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Scratch sizes for (B, K, R, C, tr, tc): sizes[0] = f32 elements of the
// column-current partials (R * slices * B * C*tc), sizes[1] = column
// tiles T (the f64 partial scores are (T, B, M), the meters (T, B)).
extern "C" void fused_impact_scratch(int B, int K, int R, int C, int tr,
                                     int tc, long long* sizes) {
  const Plan p = plan(B, K, R, C, tr, tc);
  sizes[0] = (long long)R * p.split.count * B * C * tc;
  sizes[1] = p.tiles;
}

extern "C" int fused_impact_f32(const int8_t* lits, const float* clause_i,
                                const uint8_t* nonempty,
                                const float* class_i, float* part_cols,
                                double* part_scores, float* scores, int B,
                                int K, int R, int C, int tr, int tc, int Nc,
                                int M, float thresh, cudaStream_t stream) {
  return launch<false>(lits, clause_i, nonempty, class_i, part_cols,
                       part_scores, nullptr, scores, nullptr, nullptr, B, K,
                       R, C, tr, tc, Nc, M, thresh, stream);
}

extern "C" int fused_impact_metered_f32(
    const int8_t* lits, const float* clause_i, const uint8_t* nonempty,
    const float* class_i, float* part_cols, double* part_scores,
    double* part_meter, float* scores, float* meter_clause,
    float* meter_class, int B, int K, int R, int C, int tr, int tc, int Nc,
    int M, float thresh, cudaStream_t stream) {
  return launch<true>(lits, clause_i, nonempty, class_i, part_cols,
                      part_scores, part_meter, scores, meter_clause,
                      meter_class, B, K, R, C, tr, tc, Nc, M, thresh, stream);
}

// Fused analog IMPACT inference for Hopper (sm_90a), IEEE f32: both
// crossbars, the CSA threshold and the digital periphery, with optional
// per-lane read-current meters, on f32 cell currents or on the 2-bit
// packed clause operand.
//
// Replaces: src/repro/kernels/fused_impact.py, the Pallas TPU kernels
// `_fused_impact_kernel` (:58) behind `fused_impact` (:106),
// `_fused_impact_metered_kernel` (:134) behind `fused_impact_metered`
// (:210), `_fused_impact_packed_kernel` (:280) behind
// `fused_impact_packed` (:349), with its helpers `_dequant_plane` (:260)
// and `_packed_column_current` (:266), and
// `_fused_impact_packed_metered_kernel` (:453) behind
// `fused_impact_packed_metered` (:511).
//
//   per clause column j (row shards r = 0..R-1 of tr rows each):
//     i_col[r] = drive[r] @ clause_i[r][:, j]       Kirchhoff column sum
//     fired    = AND_r (i_col[r] < thresh) & nonempty[j]
//   scores    += fired @ class_i[j, :]               class column currents
//   metered:   clause meter = sum over every (r, j) of i_col[r] per lane;
//              class meter  = sum over m of scores per lane.
//
// Operands stay in the system's own layouts: literals (B, K) int8 (the
// drive 1 - literal is formed in shared memory), nonempty (C*tc,) u8,
// class_i (S*sr, M) f32, and the clause cells either as clause_i
// (R, C, tr, tc) f32 or packed (kernels/packing.py): bits (R, C, tr4, tc)
// u8 with tr4 = ceil(tr / 4), bit-field j (shift 2j) of packed row q
// holding the code of cell row 4q + j, and levels [i_lcs, i_hcs] f32.
// Rows past K float at 0 V (the reference pads literals with 1), so they
// add exactly 0: the row loop stops at K and never loads or multiplies
// them.
//
// What bounds it on this card: at the paper serving shape (B = 128,
// K = 1568, R = C = S = 1, tr = sr = 2048, tc = 512, M = 10) the clause
// stage is 2*B*K*C*tc = 0.21 GFLOP on 3.2 MB of live clause currents
// (200,704 B of live codes when packed) and 0.2 MB of literals, so the
// f32 FMA rate bounds it (3.1 us at 67 TFLOP/s), not memory.  The
// contract is IEEE f32 (scores at rtol 1e-6, CSA bits exact), so every
// product is one FFMA on the CUDA cores; no tensor cores, no TF32.
//
// Design, two launches on one stream; the wrapper plans both on the host
// (`fused_impact.py`, `plan`) and this file checks the plan:
// 1. Column currents.  The TPU walks the clause axis as a sequential grid
//    dimension carrying the score accumulator in VMEM, and keeps tr whole
//    (up to 2048 rows).  Hopper blocks run in no order, and (B, C*tc)
//    tiles alone are too few for 132 SMs, so each block takes one tile
//    of (lanes x clause columns) of one row shard and one chunk of its
//    live rows (those below K), and writes its partial column currents
//    to scratch (R * splits, B, C*tc) f32; the chunks are planned for
//    about one wave of blocks.
//    Every block is a register-tiled SGEMM: 256 threads own 64 lanes x
//    64 columns, each thread a 4 x 4 register tile fed by float4
//    shared-memory reads (8 loads per 64 FFMAs).  Both operands come 16
//    rows at a time through a 3-deep `cp.async` ring, so the copies of
//    the next two stages overlap this stage's FFMAs.  The literals stay
//    int8: a 16-byte copy brings one lane's 16 literals of a stage, and
//    the thread that copied them writes the f32 drive into the stage once
//    they have landed, before the barrier that publishes it.  Copy widths
//    are template parameters chosen per call from pointers and strides:
//    literals 16 bytes, or plain loads where the base, K or shard r's
//    start r*tr is not a multiple of 16.  Launched as a programmatic
//    dependent.
//    - f32 cells, `impact_tiles<LIT, VC>`: clause currents by 16-byte
//      (`.cg`) or 4-byte copies (14 chunks of 112 rows, 224 blocks at the
//      paper shape, planned for two blocks an SM).
//    - packed cells, `packed_tiles<LIT, CW>`: a stage's cells are 256 code
//      bytes (4 packed rows x 64 columns), copied 4 bytes at a time by 64
//      threads (two whole warps) where the base and tc allow (CW = 4),
//      else loaded a byte a thread.  The thread that copied a word decodes
//      its 16 cells into the f32 stage (2 -> i_hcs, 1 -> i_lcs, else 0 A)
//      before the barrier, as the literals become drive, so the kernel
//      never holds an f32 clause operand in device memory and does the
//      same FFMAs as the f32 one.  16-byte code copies were measured
//      slower: 16 copying threads, half a warp, then decode 64 cells each
//      while the block waits at the barrier (PERF.md).  Planned as
//      the f32 pass (14 chunks of 112 rows, 224 blocks at the paper
//      shape), which measured best.
// 2. `impact_tail<METERED, VW>`, one launch for CSA, class stage and lane
//    sums, shared by all four entries (it never sees the clause operand's
//    format).  It reads the partials once, (R * splits, B, C*tc) f32, and
//    little else, so memory bounds it (33.5 MB at B = 16,384 and the paper
//    shape: 10 us at 3.35 TB/s).  Each lane has a group of whole warps
//    (one at B = 16,384, four at B = 128; `plan`), and each thread of the
//    group owns column groups of VW = 4 (16-byte loads, cached in L2 only;
//    plain 4-byte ones where C*tc % 4 != 0 or `part` is not 16-byte
//    aligned): it issues the loads of WIDE groups at once or, where it owns
//    fewer groups than there are partial planes (small B, many chunks),
//    DEEP planes of one group, before adding any.  Per column it adds the
//    chunk partials in chunk order in f32, latches the CSA bit with the
//    reference's strict `<`, ANDs over shards, and the lanes of a word OR
//    their bits into words of 32 columns in ascending order in shared
//    memory, ANDed with the nonempty words the block builds once.  Then
//    each warp lists its run of the lane's fired columns in ascending
//    order in shared memory, and its lanes, subgroups of min(M, 32) lanes
//    a class each, add the listed columns' class_i rows in f64: a
//    subgroup reads one row at a time, so a load touches few cache lines,
//    and no lane walks bits for a class it does not add.  Subgroups' sums
//    add in subgroup order, then the group's warps in warp order.
//    Metered, the clause meter adds every shard's column current in f64 (a
//    shuffle tree a warp, then the group's warps in warp order) and the
//    class meter the f64 scores in class order; everything rounds to f32
//    once.  Launched as a programmatic dependent.  (A first design walked
//    the fired bits once for each class, one lane a class: 64 / 152 us at
//    B = 16,384 on the benchmark's MNIST / CIFAR-2 data, issue-bound;
//    PERF.md.)
// No float atomics anywhere, so scores and meters are identical from run
// to run.  The packed meters bill the quantized column currents, as the
// reference's packed kernel does.
//
// * Columns: the reference pads the clause axis to max(C*tc, S*sr) (2048
//   at paper dims against 512 live columns) with 0 A, nonempty = 0
//   columns that never fire.  This kernel never visits them: its tiles
//   cover exactly C*tc columns, and the class stage skips clause rows at
//   or past S*sr, which the reference drops too.  The output is the same.
//   The clause meter does sum every one of the C*tc columns of every row
//   shard, including the columns from n up to C*tc: those are real LCS
//   cells that leak.
// * Ragged edges are masked (0 V drive, 0 A cells), which add exactly 0;
//   a shard's rows past tr (the packed padding, tr % 4 != 0) are never
//   read.  M (10 at paper dims) needs no padding: the class stage loops
//   over the M columns of class_i directly.  The packed reference instead
//   pads and transposes the drive bitplane-major (R, 4, B, tr4) and the
//   meters to (B, 128) lanes; none of that is needed here.

#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_async.cuh"

using namespace hopper;

namespace {

// -- pass 1: impact_tiles (f32 cells), packed_tiles (2-bit codes) ----------

constexpr int BM = 64;        // lanes per block tile
constexpr int BN = 64;        // clause columns per block tile
constexpr int BK = 16;        // rows per stage
constexpr int STAGES = 3;     // shared-memory ring depth
constexpr int TM = 4;         // lanes per thread
constexpr int TN = 4;         // columns per thread
constexpr int TX = BN / TN;   // 16 column groups
constexpr int THREADS = (BM / TM) * TX;   // 256
constexpr int APAD = BK + 4;  // drive tile row: 80 B, 16-byte aligned
// Blocks an SM the packed pass is planned for (`PACKED_BLOCKS_PER_SM` in
// fused_impact.py); its registers are capped to fit them.
constexpr int PACKED_BLOCKS = 2;

static_assert(BM * BK == 4 * THREADS, "one 4-literal group a thread");
static_assert(BK * BN == 4 * THREADS, "one 16-byte cell copy a thread");
static_assert(BK / 4 * BN == THREADS, "one code byte a thread");
static_assert(TN == 4, "a thread's columns are one float4");

struct TileSmem {
  float a[STAGES][BM][APAD];      // drive 1 - literal, lane-major
  float b[STAGES][BK][BN];        // clause cell currents
  int8_t lit[STAGES][BM][BK];     // literals as copied (LIT = 16)
};

struct PackedSmem : TileSmem {
  uint8_t code[STAGES][BK / 4][BN];   // 2-bit codes as copied (CW = 4)
};

// Drive of the four literals packed in `word` (rows k..k+3 of a lane):
// 1 - literal where the lane and the row are live, else 0 V.
__device__ __forceinline__ float4 drive4(int word, bool lane_in, int k,
                                         int k_end) {
  float d[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int8_t lit = static_cast<int8_t>((word >> (8 * j)) & 0xff);
    d[j] = lane_in && k + j < k_end ? 1.f - static_cast<float>(lit) : 0.f;
  }
  return make_float4(d[0], d[1], d[2], d[3]);
}

// Issue the literal copies of one stage (shard rows [k0, k0 + BK)
// clipped to k_end) into ring buffer `buf`.  `lit` is this shard's first
// literal (lits + r * tr, row stride K).  LIT = 16: one 16-byte copy a
// lane (64 threads); 1: plain loads, four literals a thread, the drive
// written straight into the stage.  Where a copy is in range it is
// whole: the wrapper picks LIT so that K and tr keep every chunk inside
// one shard and row.
template <int LIT>
__device__ __forceinline__ void load_lits(TileSmem& s, int buf,
                                          const int8_t* __restrict__ lit,
                                          int B, int K, int b0, int k0,
                                          int k_end) {
  const int tid = threadIdx.x;
  if (LIT == 16) {
    if (tid < BM) {
      const int b = b0 + tid;
      const bool in = b < B && k0 < k_end;
      cp_async16(&s.lit[buf][tid][0], in ? lit + (size_t)b * K + k0 : lit,
                 in ? 16 : 0);
    }
  } else {
    const int bb = tid / (BK / 4), kk = (tid % (BK / 4)) * 4;
    const int b = b0 + bb, k = k0 + kk;
    int word = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (b < B && k + j < k_end)
        word |= (static_cast<int>(lit[(size_t)b * K + k + j]) & 0xff)
                << (8 * j);
    *reinterpret_cast<float4*>(&s.a[buf][bb][kk]) =
        drive4(word, b < B, k, k_end);
  }
}

// The literals this thread copied into `buf` (the same map as
// load_lits'), written into the stage as drive.  LIT = 1 wrote the drive
// already.
template <int LIT>
__device__ __forceinline__ void to_drive(TileSmem& s, int buf, int B,
                                         int b0, int k0, int k_end) {
  const int tid = threadIdx.x;
  if (LIT == 16) {
    if (tid < BM) {
      const int4 raw = *reinterpret_cast<const int4*>(&s.lit[buf][tid][0]);
      const int words[4] = {raw.x, raw.y, raw.z, raw.w};
      const bool in = b0 + tid < B;
#pragma unroll
      for (int q = 0; q < 4; ++q)
        *reinterpret_cast<float4*>(&s.a[buf][tid][4 * q]) =
            drive4(words[q], in, k0 + 4 * q, k_end);
    }
  }
}

// Clause cells as f32 currents: `p` is clause_i (R, C, tr, tc), then the
// block's tile (tr, tc).  VC: 16-byte copies, else 4-byte ones (tc % 4
// == 0 for VC, so a chunk of 4 columns is all in or all out).
template <bool VC>
struct F32Cells {
  const float* __restrict__ p;

  __device__ F32Cells at(int r, int c, int C, int tr, int tc) const {
    return {p + ((size_t)r * C + c) * tr * tc};
  }

  __device__ void load(TileSmem& s, int buf, int tc, int n0, int k0,
                       int k_end) const {
    if (VC) {
      const int kk = threadIdx.x / (BN / 4), nn = (threadIdx.x % (BN / 4)) * 4;
      const int k = k0 + kk, n = n0 + nn;
      const bool in = k < k_end && n < tc;
      cp_async16(&s.b[buf][kk][nn], in ? p + (size_t)k * tc + n : p,
                 in ? 16 : 0);
    } else {
#pragma unroll
      for (int i = 0; i < BK * BN / THREADS; ++i) {
        const int e = threadIdx.x + i * THREADS;
        const int kk = e / BN, nn = e % BN;
        const int k = k0 + kk, n = n0 + nn;
        const bool in = k < k_end && n < tc;
        cp_async4(&s.b[buf][kk][nn], in ? p + (size_t)k * tc + n : p,
                  in ? 4 : 0);
      }
    }
  }

  __device__ void publish(TileSmem&, int, int, int) const {}
};

// The current of a 2-bit code: 2 -> i_hcs, 1 -> i_lcs, else 0 A
// (`_dequant_plane` of the reference).
__device__ __forceinline__ float level(unsigned code, float lcs, float hcs) {
  return code == 2u ? hcs : (code == 1u ? lcs : 0.f);
}

// Clause cells as 2-bit codes: `p` is bits (R, C, tr4, tc) u8, then the
// block's tile (tr4, tc); bit-field j of packed row q is cell row 4q + j.
// A stage's 16 rows are 4 packed rows x 64 columns, 256 code bytes.
// CW = 4: 4-byte `cp.async` copies by the 64 threads from thread BM on
// (warps 2-3; the literal copiers are warps 0-1); each decodes its own
// word into the f32 stage once it has landed (`publish`), before the
// barrier that publishes the stage.  CW = 1: plain loads, one byte a
// thread, decoded straight into the stage.  Rows at or past k_end decode
// to 0 A; so do bytes past tc or past the live packed rows, which are
// copied as zeros.  The wrapper picks CW = 4 only where a copy in range
// is whole (tc % 4 == 0, the base 4-byte aligned).
template <int CW>
struct CodeCells {
  static_assert(CW == 4 || CW == 1, "4-byte copies or plain loads");
  static constexpr int COPIES = BK / 4 * BN / CW;   // 64 or 256
  static constexpr int FIRST = CW == 1 ? 0 : BM;    // first copying thread
  static_assert(FIRST + COPIES <= THREADS, "copiers fit the block");

  const uint8_t* __restrict__ p;
  float lcs, hcs;

  __device__ CodeCells at(int r, int c, int C, int tr, int tc) const {
    return {p + ((size_t)r * C + c) * ((tr + 3) / 4) * tc, lcs, hcs};
  }

  __device__ void load(PackedSmem& s, int buf, int tc, int n0, int k0,
                       int k_end) const {
    const int t = static_cast<int>(threadIdx.x) - FIRST;
    if (t < 0 || t >= COPIES) return;
    const int qq = t / (BN / CW), nn = (t % (BN / CW)) * CW;
    const int q = k0 / 4 + qq, n = n0 + nn;
    const bool in = 4 * q < k_end && n < tc;
    const uint8_t* src = in ? p + (size_t)q * tc + n : p;
    if (CW == 4) {
      cp_async4(&s.code[buf][qq][nn], src, in ? 4 : 0);
    } else {
      const unsigned byte = in ? *src : 0u;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        s.b[buf][4 * qq + j][nn] =
            k0 + 4 * qq + j < k_end ? level((byte >> (2 * j)) & 3u, lcs, hcs)
                                    : 0.f;
    }
  }

  __device__ void publish(PackedSmem& s, int buf, int k0, int k_end) const {
    if (CW == 1) return;
    const int t = static_cast<int>(threadIdx.x) - FIRST;
    if (t < 0 || t >= COPIES) return;
    const int qq = t / (BN / CW), nn = (t % (BN / CW)) * CW;
    // Four columns' codes, one byte each.
    const unsigned word =
        *reinterpret_cast<const unsigned*>(&s.code[buf][qq][nn]);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const unsigned x = word >> (2 * j);
      const bool live = k0 + 4 * qq + j < k_end;
      *reinterpret_cast<float4*>(&s.b[buf][4 * qq + j][nn]) =
          live ? make_float4(level(x & 3u, lcs, hcs),
                             level((x >> 8) & 3u, lcs, hcs),
                             level((x >> 16) & 3u, lcs, hcs),
                             level((x >> 24) & 3u, lcs, hcs))
               : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
};

// Block (column tile, lane tile, r * splits + split) -> partial column
// currents part[r * splits + split] (B, C*tc).  A chunk past a shard's
// live rows runs no stage and writes zeros.  `cells` is the whole clause
// operand; `s` is a TileSmem, or a PackedSmem for codes.
template <int LIT, class Cells, class Smem>
__device__ __forceinline__ void run_tiles(Smem& s,
                                          const int8_t* __restrict__ lits,
                                          Cells cells,
                                          float* __restrict__ part, int B,
                                          int K, int C, int tr, int tc,
                                          int tiles_c, int splits,
                                          int chunk) {
  const int tid = threadIdx.x;
  const int tx = tid % TX, ty = tid / TX;
  const int c = blockIdx.x / tiles_c;
  const int n0 = (blockIdx.x % tiles_c) * BN;
  const int b0 = blockIdx.y * BM;
  const int r = blockIdx.z / splits;
  const int k_begin = (blockIdx.z % splits) * chunk;
  const int k_end = min(min(tr, K - r * tr), k_begin + chunk);
  const int n_stages = k_end > k_begin ? (k_end - k_begin + BK - 1) / BK : 0;
  const int8_t* lit = lits + (size_t)r * tr;
  cells = cells.at(r, c, C, tr, tc);

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < n_stages) {
      load_lits<LIT>(s, st, lit, B, K, b0, k_begin + st * BK, k_end);
      cells.load(s, st, tc, n0, k_begin + st * BK, k_end);
    }
    cp_async_commit();
  }

  for (int st = 0; st < n_stages; ++st) {
    const int buf = st % STAGES;
    const int k0 = k_begin + st * BK;
    cp_async_wait<STAGES - 2>();          // this thread's stage st landed
    to_drive<LIT>(s, buf, B, b0, k0, k_end);
    cells.publish(s, buf, k0, k_end);
    __syncthreads();                      // ... and every thread's
    // Refill the buffer that stage st - 1 used: every thread is past its
    // FFMAs, having reached the barrier above.
    const int next = st + STAGES - 1;
    if (next < n_stages) {
      load_lits<LIT>(s, next % STAGES, lit, B, K, b0, k_begin + next * BK,
                     k_end);
      cells.load(s, next % STAGES, tc, n0, k_begin + next * BK, k_end);
    }
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

  const int N = C * tc;
  float* out = part + (size_t)blockIdx.z * B * N + (size_t)c * tc;
  const int n = n0 + tx * TN;
  const bool vec_out = (tc & 3) == 0 && n + TN <= tc;
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
        if (n + j < tc) row[n + j] = acc[i][j];
    }
  }
}

template <int LIT, bool VC>
__global__ void __launch_bounds__(THREADS)
impact_tiles(const int8_t* __restrict__ lits,
             const float* __restrict__ clause_i, float* __restrict__ part,
             int B, int K, int C, int tr, int tc, int tiles_c, int splits,
             int chunk) {
  __shared__ __align__(16) TileSmem s;
  grid_dependency_wait();
  run_tiles<LIT>(s, lits, F32Cells<VC>{clause_i}, part, B, K, C, tr, tc,
                 tiles_c, splits, chunk);
}

// levels (2,) f32 [i_lcs, i_hcs], read once a block.
template <int LIT, int CW>
__global__ void __launch_bounds__(THREADS, PACKED_BLOCKS)
packed_tiles(const int8_t* __restrict__ lits,
             const uint8_t* __restrict__ bits,
             const float* __restrict__ levels, float* __restrict__ part,
             int B, int K, int C, int tr, int tc, int tiles_c, int splits,
             int chunk) {
  __shared__ __align__(16) PackedSmem s;
  grid_dependency_wait();
  run_tiles<LIT>(s, lits, CodeCells<CW>{bits, levels[0], levels[1]}, part,
                 B, K, C, tr, tc, tiles_c, splits, chunk);
}

// -- pass 2: impact_tail ----------------------------------------------------

constexpr int TAIL_THREADS = 256;   // threads a block at most
constexpr int TAIL_WARPS = TAIL_THREADS / 32;
// Blocks an SM the tail is planned for (`TAIL_BLOCKS_PER_SM` in
// fused_impact.py): 32 warps, so at most 64 registers a thread.
constexpr int TAIL_BLOCKS = 4;
constexpr int FIRED_WORDS = 2048;   // fired bits of all a block's lanes
constexpr int WIDE = 4;             // column groups a thread loads at once
constexpr int DEEP = 8;             // ... or partial planes of one group
constexpr int MT = 32;              // classes a pass of the class stage
constexpr int LIST = 1024;          // a warp's fired columns of 32 words
static_assert(LIST == 32 * 32, "a list holds every column of 32 words");
static_assert(32 * FIRED_WORDS <= 65536, "columns fit the u16 list");

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int off = 16; off > 0; off /= 2)
    v += __shfl_down_sync(0xffffffffu, v, off);
  return v;                                  // lane 0 holds the sum
}

// VW consecutive f32 partials, read once: a 16-byte load or a 4-byte one,
// cached in L2 only, so that L1 keeps the class rows.
template <int VW>
__device__ __forceinline__ void load_cols(float (&v)[VW], const float* p) {
  if constexpr (VW == 4) {
    const float4 x = __ldcg(reinterpret_cast<const float4*>(p));
    v[0] = x.x, v[1] = x.y, v[2] = x.z, v[3] = x.w;
  } else {
    v[0] = __ldcg(p);
  }
}

// The CSA of one lane's columns, by a group of G threads (whole warps) of
// which this is thread tg.  The columns come in groups of VW (16-byte
// loads at VW = 4), group tg + k * G for k = 0, 1, ...: U groups at a
// time, and of each the R * splits partial planes S at a time, every load
// of a batch issued before any is added.  A column's
// chunk partials are added in chunk order in f32, its shards' currents
// latched with the strict `<` and ANDed over shards; then the 32 / VW
// lanes that hold a word's 32 columns OR their bits into it, in ascending
// order, and AND it with `ne`, the nonempty words: `fired[j / 32]` bit
// j % 32.  Metered, `meter` adds every shard's column current in f64.
template <int U, int S, int VW, bool METERED>
__device__ __forceinline__ void csa(const float* __restrict__ part,
                                    const unsigned* ne, unsigned* fired,
                                    double& meter, bool lane_in, int b,
                                    int B, int N, int planes, int splits,
                                    int tg, int G, float thresh) {
  constexpr int TPW = 32 / VW;               // lanes a word
  const int groups = N / VW, wl = tg % 32;
  const int rounds = (groups + G - 1) / G;   // uniform over the block
  const size_t slice = (size_t)B * N;
  const float* row = part + (size_t)b * N;
  for (int k0 = 0; k0 < rounds; k0 += U) {
    int col[U];
    bool in[U];
    float acc[U][VW];
    unsigned f = 0;                          // bit u * VW + e: fired
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int g = (k0 + u) * G + tg;
      in[u] = lane_in && k0 + u < rounds && g < groups;
      col[u] = g * VW;
#pragma unroll
      for (int e = 0; e < VW; ++e) acc[u][e] = 0.f;
      if (in[u]) f |= ((1u << VW) - 1u) << (u * VW);
    }
    int s = 0;                               // chunk within the shard
    for (int i0 = 0; i0 < planes; i0 += S) {
      float v[U][S][VW];
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int q = 0; q < S; ++q) {
          if (in[u] && i0 + q < planes) {
            load_cols<VW>(v[u][q], row + (i0 + q) * slice + col[u]);
          } else {
#pragma unroll
            for (int e = 0; e < VW; ++e) v[u][q][e] = 0.f;
          }
        }
#pragma unroll
      for (int q = 0; q < S; ++q) {
        if (i0 + q >= planes) break;         // uniform
#pragma unroll
        for (int u = 0; u < U; ++u)
#pragma unroll
          for (int e = 0; e < VW; ++e) acc[u][e] += v[u][q][e];
        if (++s == splits) {                 // a shard's currents are whole
          s = 0;
#pragma unroll
          for (int u = 0; u < U; ++u)
#pragma unroll
            for (int e = 0; e < VW; ++e) {
              if (!(acc[u][e] < thresh)) f &= ~(1u << (u * VW + e));
              if (METERED && in[u]) meter += acc[u][e];
              acc[u][e] = 0.f;
            }
        }
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (k0 + u >= rounds) break;           // uniform
      const unsigned mine = (f >> (u * VW)) & ((1u << VW) - 1u);
      unsigned word;
      if constexpr (VW == 1) {
        word = __ballot_sync(0xffffffffu, mine);
      } else {
        word = mine << (VW * (wl % TPW));
#pragma unroll
        for (int x = 1; x < TPW; x *= 2)
          word |= __shfl_xor_sync(0xffffffffu, word, x);
      }
      const int g = (k0 + u) * G + tg, at = g * VW / 32;
      if (wl % TPW == 0 && g < groups) fired[at] = word & ne[at];
    }
  }
}

// Block: `lanes` lanes from blockIdx.x * lanes, each served by a group of
// `warps` warps (threads [l * G, (l + 1) * G), G = 32 * warps).  The block
// first ballots nonempty into words; each group streams its lane's
// columns (`csa`, wide or deep by what a thread owns), then runs the class
// stage below.  Metered, the clause meter is each warp's shuffle tree,
// then the group's warps in warp order; the class meter adds the f64
// scores in class order.
template <bool METERED, int VW>
__global__ void __launch_bounds__(TAIL_THREADS, TAIL_BLOCKS)
impact_tail(const float* __restrict__ part,
            const uint8_t* __restrict__ nonempty,
            const float* __restrict__ class_i, float* __restrict__ scores,
            float* __restrict__ meter_clause, float* __restrict__ meter_class,
            int B, int R, int N, int splits, int Nc, int M, int warps,
            int lanes, float thresh) {
  __shared__ unsigned fired_all[FIRED_WORDS];
  __shared__ unsigned ne[FIRED_WORDS];
  __shared__ double wmeter[TAIL_WARPS];
  __shared__ double wclass[TAIL_WARPS][MT];
  __shared__ uint16_t lists[TAIL_WARPS][LIST];
  const int G = 32 * warps, tid = threadIdx.x, warp = tid / 32;
  const int l = tid / G, tg = tid % G, wig = tg / 32, wl = tid % 32;
  const int b = blockIdx.x * lanes + l;
  const bool lane_in = b < B;
  const int words = (N + 31) / 32;
  unsigned* fired = fired_all + l * words;
  grid_dependency_wait();
  for (int j = tid; j < 32 * words; j += blockDim.x) {   // whole warps
    const unsigned word = __ballot_sync(0xffffffffu, j < N && nonempty[j]);
    if (wl == 0) ne[j / 32] = word;
  }
  __syncthreads();                           // the nonempty words

  double meter = 0.0;
  const int planes = R * splits;
  if (planes > (N / VW + G - 1) / G)        // few groups a thread: deep
    csa<1, DEEP, VW, METERED>(part, ne, fired, meter, lane_in, b, B, N,
                              planes, splits, tg, G, thresh);
  else
    csa<WIDE, 1, VW, METERED>(part, ne, fired, meter, lane_in, b, B, N,
                              planes, splits, tg, G, thresh);
  if (METERED) {
    meter = warp_sum(meter);
    if (wl == 0) wmeter[warp] = meter;
  }
  if (warps > 1)
    __syncthreads();                         // the group's words and sums
  else
    __syncwarp();

  // Class stage, ms classes a pass.  Warp k of the group takes the k-th of
  // `warps` runs of the lane's fired words below min(N, Nc), 32 words at a
  // time: it lists their fired columns in ascending order in shared
  // memory (a prefix sum of the words' bit counts), then its lanes form P
  // subgroups of ms lanes, lane m of subgroup p adding class m0 + m of
  // list entries p, p + P, ... in f64.
  const int live = min(N, Nc), lw = (live + 31) / 32;
  const int run = (lw + warps - 1) / warps;
  const int w_end = min(lw, (wig + 1) * run);
  const int ms = max(1, min(M, 32)), P = 32 / ms, p = wl / ms;
  uint16_t* list = lists[warp];
  double cls = 0.0;
  for (int m0 = 0; m0 < M; m0 += ms) {       // uniform over the block
    const float* col = class_i + min(m0 + wl % ms, M - 1);
    double acc = 0.0;
    for (int c0 = lane_in ? wig * run : w_end; c0 < w_end; c0 += 32) {
      const int w = c0 + wl;
      unsigned bits = w < w_end ? fired[w] : 0u;
      if (live - 32 * w < 32) bits &= (1u << max(0, live - 32 * w)) - 1u;
      int at = __popc(bits);                 // inclusive prefix sum
#pragma unroll
      for (int x = 1; x < 32; x *= 2) {
        const int o = __shfl_up_sync(0xffffffffu, at, x);
        if (wl >= x) at += o;
      }
      const int total = __shfl_sync(0xffffffffu, at, 31);
      for (at -= __popc(bits); bits; bits &= bits - 1u)
        list[at++] = static_cast<uint16_t>(32 * w + __ffs(bits) - 1);
      __syncwarp();
      for (int e = p < P ? p : total; e < total; e += 4 * P) {
        float v[4];
#pragma unroll
        for (int u = 0; u < 4; ++u)
          v[u] = e + u * P < total ? col[(size_t)list[e + u * P] * M] : 0.f;
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (e + u * P < total) acc += v[u];
      }
      __syncwarp();                          // the list is free again
    }
    // The warp's subgroups in order, then the group's warps in order.
    const double own = acc;
    for (int k = 1; k < P; ++k)
      acc += __shfl_sync(0xffffffffu, own, k * ms + wl % ms);
    const int m = m0 + wl;
    if (warps > 1) {
      if (wl < ms) wclass[warp][wl] = acc;
      __syncthreads();
      if (wig == 0 && wl < ms)
        for (int k = 1; k < warps; ++k) acc += wclass[warp + k][wl];
      if (m0 + ms < M) __syncthreads();      // wclass is free again
    }
    if (wig == 0 && lane_in) {               // uniform over the warp
      if (wl < ms && m < M)
        scores[(size_t)b * M + m] = static_cast<float>(acc);
      if (METERED)
        for (int t = 0; t < ms && m0 + t < M; ++t)
          cls += __shfl_sync(0xffffffffu, acc, t);
    }
  }
  if (METERED && wig == 0 && wl == 0 && lane_in) {
    double cl = wmeter[warp];
    for (int k = 1; k < warps; ++k) cl += wmeter[warp + k];
    meter_clause[b] = static_cast<float>(cl);
    meter_class[b] = static_cast<float>(cls);
  }
}

// -- entries ----------------------------------------------------------------

constexpr int BAD = static_cast<int>(cudaErrorInvalidValue);

// The tail's plan (`fused_impact.plan`): `warps` warps a lane, `lanes`
// lanes a block, the partials read `width` floats at a time (4: 16-byte
// loads, which need C*tc % 4 == 0 and `part` 16-byte aligned; or 1).
struct TailPlan {
  int warps, lanes, width;
};

// The checks every entry makes: shapes, a split of the fullest shard's
// `live` rows into `splits` chunks of `chunk` rows (whole stages of
// `stage` rows, none empty) and the tail's plan -> 0, or BAD.
int check_plan(int B, int K, int R, int C, int tr, int tc, int Nc, int M,
               int stage, int splits, int chunk, TailPlan tail,
               const float* part, int tiles_c, int tile_b) {
  if (B < 0 || K < 0 || R < 1 || C < 0 || tr < 0 || tc < 0 || Nc < 0 ||
      M < 0 || (long long)R * tr < K)
    return BAD;
  const long long live = tr < K ? tr : K;
  if (chunk <= 0 || chunk % stage != 0 || splits < 1 ||
      (long long)splits * chunk < live ||
      (long long)(splits - 1) * chunk >= (live > 0 ? live : 1))
    return BAD;
  if ((long long)R * splits > 65535 || (B + tile_b - 1) / tile_b > 65535 ||
      (long long)C * tiles_c > 0x7fffffff)
    return BAD;
  const long long N = (long long)C * tc, words = (N + 31) / 32;
  const int w = tail.warps, l = tail.lanes;
  if (w < 1 || l < 1 || (w & (w - 1)) != 0 || (l & (l - 1)) != 0 ||
      w * l > TAIL_WARPS || l * words > FIRED_WORDS)
    return BAD;
  if (tail.width != 1 &&
      (tail.width != 4 || N % 4 != 0 || !aligned16(part)))
    return BAD;
  return 0;
}

template <bool METERED>
cudaError_t launch_tail(const float* part, const uint8_t* nonempty,
                        const float* class_i, float* scores,
                        float* meter_clause, float* meter_class, int B,
                        int R, int C, int tc, int splits, int Nc, int M,
                        TailPlan t, float thresh, cudaStream_t stream) {
  const auto kernel = t.width == 4 ? impact_tail<METERED, 4>
                                   : impact_tail<METERED, 1>;
  return launch(kernel, dim3((B + t.lanes - 1) / t.lanes),
                32 * t.warps * t.lanes, stream, part, nonempty, class_i,
                scores, meter_clause, meter_class, B, R, C * tc, splits, Nc,
                M, t.warps, t.lanes, thresh);
}

// Pass 1 over a grid of (column tiles, lane tiles, R * splits) blocks.
template <class... Params, class... Args>
cudaError_t launch_pass1(void (*kernel)(Params...), int B, int R, int C,
                         int tc, int splits, int chunk, cudaStream_t stream,
                         Args... args) {
  const int tiles_c = (tc + BN - 1) / BN;
  const dim3 grid(C * tiles_c, (B + BM - 1) / BM, R * splits);
  return launch(kernel, grid, THREADS, stream, args..., tiles_c, splits,
                chunk);
}

// Literal copies of lit_width bytes (16 or 1) can run: the base, K and,
// with several shards, tr are multiples of 16 for 16-byte copies.
bool literals_ok(const int8_t* lits, int lit_width, int K, int R, int tr) {
  const auto at = reinterpret_cast<std::uintptr_t>(lits);
  return lit_width == 1 || (lit_width == 16 && at % 16 == 0 &&
                            K % 16 == 0 && (R == 1 || tr % 16 == 0));
}

// Pass 1 (`pass1`, a callable that launches it) then the tail, after the
// checks every entry makes.
template <bool METERED, class Pass1>
int run(Pass1 pass1, const uint8_t* nonempty, const float* class_i,
        float* part, float* scores, float* meter_clause, float* meter_class,
        int B, int K, int R, int C, int tr, int tc, int Nc, int M,
        float thresh, int splits, int chunk, TailPlan tail,
        cudaStream_t stream) {
  if (check_plan(B, K, R, C, tr, tc, Nc, M, BK, splits, chunk, tail, part,
                 (tc + BN - 1) / BN, BM) != 0)
    return BAD;
  if (B == 0) return static_cast<int>(cudaGetLastError());
  const int N = C * tc;
  if (N > 0 && part == nullptr) return BAD;
  if (N > 0) {
    const cudaError_t err = pass1();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(launch_tail<METERED>(
      part, nonempty, class_i, scores, meter_clause, meter_class, B, R, C,
      tc, splits, Nc, M, tail, thresh, stream));
}

template <bool METERED>
int run_f32(const int8_t* lits, const float* clause_i,
            const uint8_t* nonempty, const float* class_i, float* part,
            float* scores, float* meter_clause, float* meter_class, int B,
            int K, int R, int C, int tr, int tc, int Nc, int M, float thresh,
            int lit_width, int vec_c, int splits, int chunk, TailPlan tail,
            cudaStream_t stream) {
  if (!literals_ok(lits, lit_width, K, R, tr) ||
      (vec_c && (tc % 4 != 0 || !aligned16(clause_i))))
    return BAD;
  const auto pass1 = [=]() {
#define TILES(L, V)                                                        \
  launch_pass1(impact_tiles<L, V>, B, R, C, tc, splits, chunk, stream,    \
               lits, clause_i, part, B, K, C, tr, tc)
    if (lit_width == 16) return vec_c ? TILES(16, true) : TILES(16, false);
    return vec_c ? TILES(1, true) : TILES(1, false);
#undef TILES
  };
  return run<METERED>(pass1, nonempty, class_i, part, scores, meter_clause,
                      meter_class, B, K, R, C, tr, tc, Nc, M, thresh, splits,
                      chunk, tail, stream);
}

template <bool METERED>
int run_packed(const int8_t* lits, const uint8_t* bits, const float* levels,
               const uint8_t* nonempty, const float* class_i, float* part,
               float* scores, float* meter_clause, float* meter_class, int B,
               int K, int R, int C, int tr, int tc, int Nc, int M,
               float thresh, int lit_width, int code_width, int splits,
               int chunk, TailPlan tail, cudaStream_t stream) {
  const bool codes_ok =
      code_width == 1 ||
      (code_width == 4 && reinterpret_cast<std::uintptr_t>(bits) % 4 == 0 &&
       tc % 4 == 0);
  if (!literals_ok(lits, lit_width, K, R, tr) || !codes_ok) return BAD;
  const auto pass1 = [=]() {
#define TILES(L, W)                                                        \
  launch_pass1(packed_tiles<L, W>, B, R, C, tc, splits, chunk, stream,    \
               lits, bits, levels, part, B, K, C, tr, tc)
    if (lit_width == 16)
      return code_width == 4 ? TILES(16, 4) : TILES(16, 1);
    return code_width == 4 ? TILES(1, 4) : TILES(1, 1);
#undef TILES
  };
  return run<METERED>(pass1, nonempty, class_i, part, scores, meter_clause,
                      meter_class, B, K, R, C, tr, tc, Nc, M, thresh, splits,
                      chunk, tail, stream);
}

}  // namespace

// literals (B, K) int8, clause_i (R, C, tr, tc) f32, nonempty (C*tc,) u8,
// class_i (Nc = S*sr, M) f32, scores (B, M) f32, the meters (B,) f32, all
// contiguous on the device; part (R * splits, B, C*tc) f32 scratch.  The
// plan comes from the wrapper (`fused_impact.py`, `plan`):
//   lit_width 16 or 1: 16-byte copies of the literals (base, K and,
//             with R > 1, tr multiples of 16), or plain loads;
//   vec_c:    1 for 16-byte copies of the cells (base 16-byte aligned,
//             tc % 4 == 0);
//   splits, chunk: the live rows of the fullest shard, min(tr, K), in
//             `splits` chunks of `chunk` rows (a multiple of 16), the
//             last one ragged and none empty;
//   warps, lanes, tail_width: the tail's warps a lane and lanes a block
//             (powers of two, at most 8 warps a block), and 4 for its
//             16-byte loads of part (C*tc % 4 == 0, part 16-byte aligned)
//             or 1.
// A plan this file cannot run returns cudaErrorInvalidValue, launching
// nothing.  Launches on `stream`; returns cudaGetLastError() after every
// launch.
extern "C" int fused_impact_f32(const int8_t* lits, const float* clause_i,
                                const uint8_t* nonempty,
                                const float* class_i, float* part,
                                float* scores, int B, int K, int R, int C,
                                int tr, int tc, int Nc, int M, float thresh,
                                int lit_width, int vec_c, int splits,
                                int chunk, int warps, int lanes,
                                int tail_width, cudaStream_t stream) {
  return run_f32<false>(lits, clause_i, nonempty, class_i, part, scores,
                        nullptr, nullptr, B, K, R, C, tr, tc, Nc, M, thresh,
                        lit_width, vec_c, splits, chunk,
                        {warps, lanes, tail_width}, stream);
}

extern "C" int fused_impact_metered_f32(
    const int8_t* lits, const float* clause_i, const uint8_t* nonempty,
    const float* class_i, float* part, float* scores, float* meter_clause,
    float* meter_class, int B, int K, int R, int C, int tr, int tc, int Nc,
    int M, float thresh, int lit_width, int vec_c, int splits, int chunk,
    int warps, int lanes, int tail_width, cudaStream_t stream) {
  return run_f32<true>(lits, clause_i, nonempty, class_i, part, scores,
                       meter_clause, meter_class, B, K, R, C, tr, tc, Nc, M,
                       thresh, lit_width, vec_c, splits, chunk,
                       {warps, lanes, tail_width}, stream);
}

// The packed entries: bits (R, C, ceil(tr/4), tc) u8 and levels (2,) f32
// in place of clause_i, and code_width in place of vec_c: 4 for 4-byte
// `cp.async` copies of the codes (base and tc multiples of 4), 1 for
// plain loads.
extern "C" int fused_impact_packed_f32(
    const int8_t* lits, const uint8_t* bits, const float* levels,
    const uint8_t* nonempty, const float* class_i, float* part,
    float* scores, int B, int K, int R, int C, int tr, int tc, int Nc, int M,
    float thresh, int lit_width, int code_width, int splits, int chunk,
    int warps, int lanes, int tail_width, cudaStream_t stream) {
  return run_packed<false>(lits, bits, levels, nonempty, class_i, part,
                           scores, nullptr, nullptr, B, K, R, C, tr, tc, Nc,
                           M, thresh, lit_width, code_width, splits, chunk,
                           {warps, lanes, tail_width}, stream);
}

extern "C" int fused_impact_packed_metered_f32(
    const int8_t* lits, const uint8_t* bits, const float* levels,
    const uint8_t* nonempty, const float* class_i, float* part,
    float* scores, float* meter_clause, float* meter_class, int B, int K,
    int R, int C, int tr, int tc, int Nc, int M, float thresh, int lit_width,
    int code_width, int splits, int chunk, int warps, int lanes,
    int tail_width, cudaStream_t stream) {
  return run_packed<true>(lits, bits, levels, nonempty, class_i, part,
                          scores, meter_clause, meter_class, B, K, R, C, tr,
                          tc, Nc, M, thresh, lit_width, code_width, splits,
                          chunk, {warps, lanes, tail_width}, stream);
}

// Causal flash attention for the prefill of DeepSeek-V2's multi-head
// latent attention (MLA), on Hopper (sm_90a): q and k of 192 dims (128
// "nope" + 64 rope), v of 128, bf16 operands, f32 accumulation and f32
// softmax statistics.
//
// It replaces no TPU kernel: the JAX package's attention is plain `jnp`
// (`repro/models/attention.py: chunked_attention`), which the port first
// ran as the same flash recurrence in plain PyTorch
// (`models/attention.py: _flash_rows`, f32 GEMMs on CUDA cores and about
// eight elementwise passes over every (512, 2048) chunk of logits in
// device memory, the causal upper half included).  Prefill attention is
// bound by the tensor-core FLOPs of the causal triangle: 2 x (192 + 128)
// FLOPs a visible (query, key) pair, 0.69 TFLOP a layer at 8 x 4,096
// positions and 16 heads, 0.69 ms at 989 TFLOP/s bf16.  So the logits
// never leave the SM, both products run on `wgmma`, and only tiles that
// hold a visible key are loaded or computed:
//
// * One block a (128-query tile, head, batch row), 384 threads: warpgroup
//   0 is the producer, one thread of which keeps TMA loads of the key and
//   value tiles (128 keys x 192 + 128 x 128 bf16, 80 KB) in flight in a
//   two-stage ring behind `mbarrier`s; the 48 KB query tile is loaded
//   once.  Every tile lies in shared memory as 64-column panels of 128
//   rows in the 128-byte swizzle that `wgmma` reads.  q and k are read
//   as their two parts (nope, rope) without a concatenation, the rope
//   key as the one head that every head shares (the MLA layout).
// * Warpgroups 1 and 2 each own 64 query rows: S = Q K^T by `wgmma`
//   from shared memory into f32 registers (12 steps of k16), the online
//   softmax in registers (running max and sum in f32, `exp2f` of
//   log2(e)-scaled logits), P rounded to bf16 in registers and fed as the
//   register A operand of O += P V (8 steps of k16, V read transposed),
//   f32 accumulation.  The two warpgroups wait on no one but the
//   producer, so one's softmax can overlap the other's products.
// * Causal self-attention of one sequence (query row i sees keys 0..i):
//   key tiles wholly above the diagonal are neither loaded nor
//   computed; only the diagonal tile is masked (it also holds the keys
//   past the ragged end, which no stored row sees).  Every row sees key
//   0, so the running max is finite from the first tile on.  Blocks are
//   numbered longest query tile first, so the triangle's long tiles
//   start in the first wave and the short ones fill the tail.
//
// The rounding points are those of `_flash_rows`: q, k, v in bf16, P
// rounded to bf16 against the running max of its 128-key tile, the max,
// the exponent, the sum and both accumulators in f32; the output is
// O / max(l, 1e-30) in bf16 or f32.  The plain PyTorch version with the
// same tiles is `kernels/flash_attention.py: flash_prefill_ref`.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int BQ = 128;              // query rows a block
constexpr int BK = 128;              // keys a tile
constexpr int D_NOPE = 128;          // q / k dims without rope
constexpr int D_ROPE = 64;           // q / k rope dims
constexpr int DV = 128;              // v dims
constexpr int STAGES = 2;            // key / value tiles in flight
constexpr int THREADS = 384;         // producer + two consumer warpgroups
constexpr int PANEL = 64;            // bf16 columns of a 128-byte panel
constexpr int PANEL_BYTES = 128 * 128;              // 128 rows x 128 B
constexpr int Q_BYTES = 3 * PANEL_BYTES;             // 192 dims
constexpr int K_BYTES = 3 * PANEL_BYTES;
constexpr int V_BYTES = 2 * PANEL_BYTES;             // 128 dims
constexpr int STAGE_BYTES = K_BYTES + V_BYTES;
constexpr int BARRIER_BYTES = 128;
// Tiles, barriers, and 1 KB to align the tiles to the swizzle's 1024 B.
constexpr int SMEM_BYTES =
    Q_BYTES + STAGES * STAGE_BYTES + BARRIER_BYTES + 1024;
constexpr int PRODUCER_REGS = 24;
constexpr int CONSUMER_REGS = 240;
constexpr float LOG2E = 1.4426950408889634f;

static_assert(D_NOPE == 2 * PANEL && D_ROPE == PANEL && DV == 2 * PANEL,
              "the tiles are whole panels");
static_assert(BQ == BK, "query tile i ends where key tile i ends");

struct Params {
  void* out;                 // (B, S, H, DV), contiguous
  int B, S, H;
  int nq;                    // query tiles (and key tiles)
  float scale_log2;          // softmax scale x log2(e)
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// -- mbarriers ---------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Wait until the phase of parity `parity` has completed.  A wait that
// lasts past ~2^35 cycles (tens of seconds) traps, so that a protocol
// fault ends the launch with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done = 0;
  long long start = 0;
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (start == 0) {
      start = clock64();
    } else if (clock64() - start > (1ll << 35)) {
      __trap();
    }
  }
}

// -- TMA ---------------------------------------------------------------------

// One box of a 4-D tensor map (dims: feature, head, position, batch)
// into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load(const CUtensorMap* map, uint32_t dst,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(bar)
      : "memory");
}

// -- wgmma -------------------------------------------------------------------

// A shared-memory matrix descriptor in the 128-byte swizzle: start
// address, leading and stride byte offsets (each >> 4), layout type 1.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keep the compiler from moving register reads or writes across an
// asynchronous `wgmma` (its operands change behind the compiler's back).
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void pin(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

#define WG_D8(i)                                                          \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),             \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define WG_D64                                                            \
  WG_D8(0), WG_D8(8), WG_D8(16), WG_D8(24), WG_D8(32), WG_D8(40),         \
      WG_D8(48), WG_D8(56)
#define WG_R64                                                            \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "    \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, " \
  "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, " \
  "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, " \
  "%57, %58, %59, %60, %61, %62, %63}"

// d (64 x 128 f32, the accumulator fragment) (+)= A (64 x 16, shared,
// K-major) B (16 x 128, shared, K-major); `accumulate` 0 overwrites d.
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t a,
                                         uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " WG_R64
      ", %64, %65, p, 1, 1, 0, 0;\n}\n"
      : WG_D64
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x 128 f32) += A (64 x 16 bf16 in registers) B (16 x 128, shared,
// MN-major: read transposed).
__device__ __forceinline__ void wgmma_rs(float (&d)[64],
                                         const uint32_t (&a)[4],
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " WG_R64
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : WG_D64
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

// -- the kernel --------------------------------------------------------------

// F32_OUT: the output in f32, else in bf16.
template <bool F32_OUT>
__global__ void __launch_bounds__(THREADS, 1)
    flash_mla_kernel(const __grid_constant__ CUtensorMap qn_map,
                     const __grid_constant__ CUtensorMap qr_map,
                     const __grid_constant__ CUtensorMap kn_map,
                     const __grid_constant__ CUtensorMap kr_map,
                     const __grid_constant__ CUtensorMap v_map,
                     const Params p) {
  using Out = typename std::conditional<F32_OUT, float, __nv_bfloat16>::type;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base;
  const uint32_t sKV = base + Q_BYTES;      // stage s at s * STAGE_BYTES
  const uint32_t bars = sKV + STAGES * STAGE_BYTES;
  const uint32_t q_full = bars;
  const uint32_t full0 = bars + 8;           // + 8 s
  const uint32_t empty0 = bars + 8 + 8 * STAGES;

  // Longest query tile first: block 0 takes the last tile of every
  // (head, row), and so on down to the first.
  const int per_tile = p.H * p.B;
  const int qi = p.nq - 1 - static_cast<int>(blockIdx.x) / per_tile;
  const int rest = static_cast<int>(blockIdx.x) % per_tile;
  const int h = rest % p.H;
  const int b = rest / p.H;
  const int q0 = qi * BQ;
  const int n_kt = qi + 1;               // key tiles 0..qi, the last diagonal

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 8);          // each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // Producer.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, Q_BYTES);
      tma_load(&qn_map, sQ, q_full, 0, h, q0, b);
      tma_load(&qn_map, sQ + PANEL_BYTES, q_full, PANEL, h, q0, b);
      tma_load(&qr_map, sQ + 2 * PANEL_BYTES, q_full, 0, h, q0, b);
      for (int j = 0; j < n_kt; ++j) {
        const int s = j % STAGES;
        if (j >= STAGES) mbar_wait(empty0 + 8 * s, ((j / STAGES) - 1) & 1);
        const uint32_t full = full0 + 8 * s;
        const uint32_t dst = sKV + s * STAGE_BYTES;
        const int k0 = j * BK;
        mbar_expect_tx(full, STAGE_BYTES);
        tma_load(&kn_map, dst, full, 0, h, k0, b);
        tma_load(&kn_map, dst + PANEL_BYTES, full, PANEL, h, k0, b);
        tma_load(&kr_map, dst + 2 * PANEL_BYTES, full, 0, 0, k0, b);
        tma_load(&v_map, dst + K_BYTES, full, 0, h, k0, b);
        tma_load(&v_map, dst + K_BYTES + PANEL_BYTES, full, PANEL, h, k0, b);
      }
    }
    return;
  }

  // Consumers: warpgroup c owns query rows 64 c .. 64 c + 63 of the tile;
  // a thread holds rows r0 and r0 + 8 and, of each 8-column block of a
  // 64 x 128 fragment, columns 2 t and 2 t + 1.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
  const int c = wg - 1;
  const int warp = (threadIdx.x / 32) % 4;
  const int lane = threadIdx.x % 32;
  const int t = lane % 4;
  const int r0 = c * 64 + warp * 16 + lane / 4;   // row in the tile

  float o[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) o[i] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  mbar_wait(q_full, 0);
  const uint32_t sQc = sQ + c * 64 * 128;
  for (int j = 0; j < n_kt; ++j) {
    const int s = j % STAGES;
    mbar_wait(full0 + 8 * s, (j / STAGES) & 1);
    const uint32_t sK = sKV + s * STAGE_BYTES;
    const uint32_t sV = sK + K_BYTES;

    // S = Q K^T over 192 dims: 3 panels x 4 steps of 16.
    float sc[64];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 12; ++kk) {
      const uint32_t off = (kk / 4) * PANEL_BYTES + (kk % 4) * 32;
      wgmma_ss(sc, sw128_desc(sQc + off, 16, 1024),
               sw128_desc(sK + off, 16, 1024), kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    pin(sc);

    // Online softmax over this tile, in log2 units; on the diagonal tile
    // (key tile qi) key column kc is masked for tile rows before it.
    const bool diagonal = j == qi;
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int n = 0; n < 16; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = sc[4 * n + e] * p.scale_log2;
        if (diagonal) {
          const int kc = 8 * n + 2 * t + (e & 1);
          if (kc > (e < 2 ? r0 : r0 + 8)) x = -INFINITY;
        }
        sc[4 * n + e] = x;
        if (e < 2) mx0 = fmaxf(mx0, x);
        else mx1 = fmaxf(mx1, x);
      }
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    // Every row sees a key of every tile it reads, so the new max is
    // finite; the first tile's correction is exp2(-inf) = 0.
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float corr0 = exp2f(m0 - mn0), corr1 = exp2f(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int n = 0; n < 16; ++n) {
      sc[4 * n + 0] = exp2f(sc[4 * n + 0] - mn0);
      sc[4 * n + 1] = exp2f(sc[4 * n + 1] - mn0);
      sc[4 * n + 2] = exp2f(sc[4 * n + 2] - mn1);
      sc[4 * n + 3] = exp2f(sc[4 * n + 3] - mn1);
      sum0 += sc[4 * n + 0] + sc[4 * n + 1];
      sum1 += sc[4 * n + 2] + sc[4 * n + 3];
    }
    l0 = l0 * corr0 + sum0;       // this thread's share of the row's sum
    l1 = l1 * corr1 + sum1;

    // P in bf16 as the A fragments of 8 steps of 16 keys: step kk takes
    // the column blocks 2 kk and 2 kk + 1 of the S fragment.
    uint32_t pa[8][4];
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      pa[kk][0] = pack_bf16(sc[8 * kk + 0], sc[8 * kk + 1]);
      pa[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
      pa[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
      pa[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
    }
#pragma unroll
    for (int n = 0; n < 16; ++n) {
      o[4 * n + 0] *= corr0;
      o[4 * n + 1] *= corr0;
      o[4 * n + 2] *= corr1;
      o[4 * n + 3] *= corr1;
    }

    // O += P V: V (128 keys x 128) as two 64-column panels, read
    // transposed; a step of 16 keys is 2 KB further into both.
    pin(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
      wgmma_rs(o, pa[kk], sw128_desc(sV + kk * 2048, PANEL_BYTES, 1024));
    wgmma_commit();
    wgmma_wait_all();
    pin(o);
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) pin(pa[kk]);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty0 + 8 * s);
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
  Out* out = static_cast<Out*>(p.out);
  const long long row_stride = static_cast<long long>(p.H) * DV;
  const long long head_base =
      (static_cast<long long>(b) * p.S) * row_stride +
      static_cast<long long>(h) * DV + 2 * t;
  const int row0 = q0 + r0, row1 = row0 + 8;
  if (row0 < p.S) {
    Out* dst = out + head_base + row0 * row_stride;
#pragma unroll
    for (int n = 0; n < 16; ++n)
      store2(dst + 8 * n, o[4 * n + 0] / d0, o[4 * n + 1] / d0);
  }
  if (row1 < p.S) {
    Out* dst = out + head_base + row1 * row_stride;
#pragma unroll
    for (int n = 0; n < 16; ++n)
      store2(dst + 8 * n, o[4 * n + 2] / d1, o[4 * n + 3] / d1);
  }
}

// -- host --------------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, found through the runtime (so the
// library links against no libcuda).
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess)
      return nullptr;
    fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// A bf16 operand (B, S, heads, dims) with element strides (sb, ss, sh)
// and unit stride along dims, as a 4-D map of boxes of 64 dims x 1 head
// x 128 positions x 1 row in the 128-byte swizzle; positions past S read
// as zeros.  The shared rope key is one head (`heads` 1).
bool encode(CUtensorMap* map, const void* ptr, int B, int S, int heads,
            int dims, long long sb, long long ss, long long sh) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t size[4] = {static_cast<cuuint64_t>(dims),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  // Byte strides of dims 1..3; a dim of size 1 is never stepped over, so
  // its stride need only be valid.
  const cuuint64_t stride[3] = {
      static_cast<cuuint64_t>(heads > 1 ? sh * 2 : 16),
      static_cast<cuuint64_t>(S > 1 ? ss * 2 : 16),
      static_cast<cuuint64_t>(B > 1 ? sb * 2 : 16)};
  const cuuint32_t box[4] = {PANEL, 1, BQ, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
            const_cast<void*>(ptr), size, stride, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <bool F32_OUT>
cudaError_t launch(const CUtensorMap* maps, const Params& p,
                   cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_mla_kernel<F32_OUT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        SMEM_BYTES);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const dim3 grid(p.nq * p.H * p.B);
  flash_mla_kernel<F32_OUT><<<grid, THREADS, SMEM_BYTES, stream>>>(
      maps[0], maps[1], maps[2], maps[3], maps[4], p);
  return cudaGetLastError();
}

}  // namespace

// Causal self-attention of S positions: q = (q_nope, q_rope) (B, S, H,
// 128 / 64), k = (k_nope (B, S, H, 128), k_rope (B, S, 64), one rope key
// shared by every head), v (B, S, H, 128); bf16 with unit stride along
// their last dim and the element strides (batch, position[, head])
// given.  out: contiguous (B, S, H, 128), f32 where out_f32 is set, else
// bf16.
extern "C" int flash_mla_prefill(
    const void* q_nope, long long qn_sb, long long qn_ss, long long qn_sh,
    const void* q_rope, long long qr_sb, long long qr_ss, long long qr_sh,
    const void* k_nope, long long kn_sb, long long kn_ss, long long kn_sh,
    const void* k_rope, long long kr_sb, long long kr_ss,
    const void* v, long long v_sb, long long v_ss, long long v_sh, void* out,
    int out_f32, int B, int S, int H, float scale, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0) return cudaSuccess;
  CUtensorMap maps[5];
  if (!encode(&maps[0], q_nope, B, S, H, D_NOPE, qn_sb, qn_ss, qn_sh) ||
      !encode(&maps[1], q_rope, B, S, H, D_ROPE, qr_sb, qr_ss, qr_sh) ||
      !encode(&maps[2], k_nope, B, S, H, D_NOPE, kn_sb, kn_ss, kn_sh) ||
      !encode(&maps[3], k_rope, B, S, 1, D_ROPE, kr_sb, kr_ss, 0) ||
      !encode(&maps[4], v, B, S, H, DV, v_sb, v_ss, v_sh))
    return cudaErrorInvalidValue;
  Params p;
  p.out = out;
  p.B = B;
  p.S = S;
  p.H = H;
  p.nq = (S + BQ - 1) / BQ;
  p.scale_log2 = scale * LOG2E;
  auto s = static_cast<cudaStream_t>(stream);
  return out_f32 ? launch<true>(maps, p, s) : launch<false>(maps, p, s);
}

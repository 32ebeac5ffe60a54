// Grouped (per-expert) matmul for Hopper (sm_90a): the MoE expert FFN's
// three products, and their backward.
//
// Replaces the Pallas TPU kernel `grouped_matmul` (body `_gmm_kernel`),
// src/repro/kernels/moe/kernel.py:38. Same function: for x (E, C, D) and
// w (E, D, F),
//   y[e, c, f] = sum_{k < D} x[e, c, k] * w[e, k, f],
// every product exact in float32 (a bf16 x bf16 product is), summed in
// float32, and rounded once to x's dtype. x and w have one dtype, float32 or
// bfloat16; float32 inputs never go through TF32.
//
// The backward replaces no TPU kernel: the reference trains MoE by jax.grad
// through three einsums (src/repro/models/layers.py:371-376) and never
// differentiates its Pallas kernel. Training on the card runs every expert
// product through this file, so the gradient's two grouped products are
// kernels here too, with the forward's arithmetic (exact products, float32
// sums, one rounding):
//   dx[e, c, k] = sum_{f < F} dy[e, c, f] * w[e, k, f]   (E, C, D)
//   dw[e, k, f] = sum_{c < C} x[e, c, k] * dy[e, c, f]   (E, D, F)
// dw sums over the C capacity rows. At grok-1's training shapes each is
// the forward's 2 E C D F operations (8.34 ms at 989 TFLOP/s).
//
// Differences from the TPU kernel, all in what it takes, none in what it
// computes: any C >= 1, D >= 1 and F >= 1, the ragged edges masked (the
// Pallas wrapper asserts C % c_block == 0, F % f_block == 0 and
// D % d_block == 0).
//
// What bounds it. On the main path (grok-1 at full width, 8 experts, d_model
// 6144, d_ff 32768) two regimes:
//   * prefill, C = 2560 tokens an expert: 2 * E * C * D * F = 8.25e12
//     operations a call against 4.8 GB moved, so the bf16 tensor cores bound
//     it (8.34 ms at 989 TFLOP/s; the bytes alone take 1.44 ms);
//   * decode, C = 8: the same 3.2 GB of weights for 1/320 of the work, so
//     the bytes bound it (0.96 ms at 3.35 TB/s).
//
// What the design does about it. On the TPU the D axis is the innermost,
// sequential grid axis, and the float32 accumulator lives in VMEM scratch
// across grid steps. Blocks on the card run in parallel and in no order, so
// a sum over D either stays inside one block or is split into float32
// partials that a second pass adds in a fixed order. Four routes; the
// Python wrapper's `plan` picks one by dtype, shape and alignment alone, and
// the C entry launches it or refuses it:
//   * wgmma (bf16, C > 16, x and w 16-byte aligned, D and F multiples of 8:
//     the prefill). Hopper's warpgroup MMA fed by TMA, warp-specialised and
//     persistent: one block an SM walks output tiles t = blockIdx.x +
//     i * gridDim.x of 128 x 256 (C x F), C tiles fastest, then F panels,
//     then experts, so the blocks in flight share one expert's x and a few
//     of its w panels through L2. A producer warpgroup (40 registers) has
//     one thread issue cp.async.bulk.tensor loads of x's 128 x 64 tile and
//     w's 64 x 256 tile (4 boxes of 64 columns) into a ring of 4 stages (48
//     KB each, 192 KB) on mbarriers; two consumer warpgroups (232
//     registers) each run wgmma m64n256k16 on 64 rows with a 128-register
//     float32 accumulator, keep one stage's wgmmas in flight, and release
//     the stage before it. x's tensor map is {D, C, E} K-major and w's
//     {F, D, E} MN-major (wgmma's transpose bit), both with the 128-byte
//     swizzle, so a box past C, D or F of one expert reads zeros, never the
//     next expert's rows. The epilogue rounds each sum once to bf16 and
//     sends the tile out in 64 x 64 boxes through two 8 KB shared buffers a
//     consumer, with TMA stores on y's map {F, C, E} (which drop rows past
//     C and columns past F) marked evict-first in L2, so that x and w stay
//     cached; the stores run on under the next tile's products, whose
//     stages the producer has already loaded.
//   * split D (bf16, C <= 16, aligned as above: the decode step). One 128-row
//     tile would hold 8 tokens and leave the tensor cores idle; the bytes of
//     w bound the call, so the work is cut finer instead: blocks of 16 rows x
//     128 columns stream w through a 4-stage cp.async ring (16-byte copies,
//     two blocks an SM, 96 KB in flight an SM) into mma.sync m16n8k16, and D
//     is split into S chunks (a multiple of 64 deep) so that E x F tiles x S
//     gives about 4 waves of blocks. S 1 stores bf16; S > 1 stores float32
//     partials to a workspace that the wrapper allocates, and
//     gmm_splitd_reduce_kernel adds them in split order and rounds once. No
//     atomics: two calls give the same bits.
//   * mma.sync (bf16 inputs TMA cannot take: a base off 16 bytes, or D or F
//     not a multiple of 8): 128 x 128 output tiles, 8 warps of 64 x 32, D in
//     steps of 32 through a 4-stage cp.async ring (element by element where
//     a row is not 16-byte aligned), ldmatrix, mma.sync m16n8k16.
//   * float32: 64 x 64 output tiles, 256 threads of 4 x 4 outputs, D in
//     steps of 16 through shared memory, float32 FMAs on the CUDA cores
//     (gmm_fma_kernel<float>, the backward's CUDA-core kernel).
//
// The backward's routes (the wrapper's `plan_bwd`):
//   * wgmma (bf16, C > 16, aligned as the forward's): the forward's kernel
//     body with the operands' majors swapped, so neither product needs a
//     transposed copy in memory. wgmma reads bf16 A and B from shared
//     memory K-major or MN-major, and TMA writes either layout from the
//     tensors as they lie:
//       dx (M C, N D, K F): A = dy's {F, C, E} map K-major, as the
//         forward's x; B = w's {F, D, E} map read K-major (F contiguous is
//         wgmma's native B layout, transpose bit off) in one 64 x 256 box;
//       dw (M D, N F, K C): A = x's {D, C, E} map read MN-major (transpose
//         bit on: two 64 x 64 boxes of 64 D columns), B = dy's {F, C, E}
//         map MN-major, as the forward's w.
//     A box past C, D or F reads zeros, so a partial K step (F for dx, C
//     for dw) adds nothing. gmm_wgmma_dx_kernel and gmm_wgmma_dw_kernel.
//   * CUDA cores (float32; bf16 at C <= 16 or that TMA cannot take): the
//     float32 forward's kernel, each operand read through its own strides
//     (coalesced along whichever of its axes is contiguous), float32 FMAs,
//     one rounding: gmm_fma_kernel<T>.
//
// Every device kernel's name starts with `gmm_` (profiles find the grouped
// matmul's device time by that prefix). Left for later: thread-block
// clusters with TMA multicast of the shared operand, and gate and up fused
// into one launch.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

// ---------------------------------------------------------------------------
// bfloat16, inputs TMA cannot take: mma.sync m16n8k16, float32 accumulators
// ---------------------------------------------------------------------------

constexpr int kBM = 128;          // C rows of a tile
constexpr int kBN = 128;          // F columns of a tile
constexpr int kBK = 32;           // D step
constexpr int kStages = 4;        // shared-memory ring of D steps
constexpr int kPad = 8;           // bf16 elements of row padding
constexpr int kThreads = 256;     // 8 warps: 2 along C x 4 along F
constexpr int kLdA = kBK + kPad;  // 40 elements = 80 bytes a row of x's tile
constexpr int kLdB = kBN + kPad;  // 136 elements = 272 bytes a row of w's
constexpr int kTileA = kBM * kLdA;
constexpr int kTileB = kBK * kLdB;
constexpr int kSmemBytes = kStages * (kTileA + kTileB) * 2;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; bytes past src_bytes (0 or 16) are zero-filled
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// d += a (16 x 16, row) * b (16 x 8, col), bf16 in, float32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One D step of x's tile (kBM x kBK) and w's tile (kBK x kBN) into a stage.
// A chunk is 8 elements of one row; it goes by cp.async when the row is
// 16-byte aligned (vec_*), else element by element. With vec_* the row
// length is a multiple of 8, so a chunk lies wholly inside or wholly past
// the edge (then zero-filled).
__device__ __forceinline__ void load_stage(
    bf16* sa, bf16* sb, const bf16* __restrict__ xe,
    const bf16* __restrict__ we, int m0, int n0, int k0, int C, int D, int F,
    bool vec_a, bool vec_b) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int i = 0; i < (kBM * kBK / 8) / kThreads; ++i) {   // 2 chunks
    const int q = tid + i * kThreads;
    const int r = q / (kBK / 8), c8 = (q % (kBK / 8)) * 8;
    const int gm = m0 + r, gk = k0 + c8;
    bf16* dst = sa + r * kLdA + c8;
    if (vec_a) {
      const bool in = gm < C && gk < D;
      const bf16* src = in ? xe + (size_t)gm * D + gk : xe;
      cp_async16(dst, src, in ? 16 : 0);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j)
        dst[j] = (gm < C && gk + j < D) ? xe[(size_t)gm * D + gk + j]
                                        : __float2bfloat16_rn(0.f);
    }
  }
#pragma unroll
  for (int i = 0; i < (kBK * kBN / 8) / kThreads; ++i) {   // 2 chunks
    const int q = tid + i * kThreads;
    const int r = q / (kBN / 8), c8 = (q % (kBN / 8)) * 8;
    const int gk = k0 + r, gn = n0 + c8;
    bf16* dst = sb + r * kLdB + c8;
    if (vec_b) {
      const bool in = gk < D && gn < F;
      const bf16* src = in ? we + (size_t)gk * F + gn : we;
      cp_async16(dst, src, in ? 16 : 0);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j)
        dst[j] = (gk < D && gn + j < F) ? we[(size_t)gk * F + gn + j]
                                        : __float2bfloat16_rn(0.f);
    }
  }
}

// grid: x = ceil(C / kBM), y = ceil(F / kBN), z = E. block: kThreads.
__global__ void __launch_bounds__(kThreads, 2)
    gmm_bf16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                    bf16* __restrict__ y, int C, int D, int F) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sa = reinterpret_cast<bf16*>(smem_raw);
  bf16* sb = sa + kStages * kTileA;

  const int e = blockIdx.z;
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  const bf16* xe = x + (size_t)e * C * D;
  const bf16* we = w + (size_t)e * D * F;
  const bool vec_a = D % 8 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  const bool vec_b = F % 8 == 0 && (reinterpret_cast<uintptr_t>(w) & 15) == 0;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp >> 2, wn = warp & 3;   // warp tile: rows wm*64, cols wn*32
  // m16 tiles of this warp that hold a row below C (warp-uniform)
  const int rows_left = C - (m0 + wm * 64);
  const int n_mi = rows_left <= 0 ? 0 : (rows_left >= 64 ? 4 : (rows_left + 15) / 16);

  float acc[4][4][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[mi][ni][r] = 0.f;

  const int k_tiles = (D + kBK - 1) / kBK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < k_tiles)
      load_stage(sa + s * kTileA, sb + s * kTileB, xe, we, m0, n0, s * kBK, C,
                 D, F, vec_a, vec_b);
    cp_async_commit();
  }

  for (int kt = 0; kt < k_tiles; ++kt) {
    cp_async_wait<kStages - 2>();   // this step's stage has landed
    __syncthreads();                // ... for every thread; the stage about
                                    // to be refilled is no longer read
    const int nk = kt + kStages - 1;
    if (nk < k_tiles)
      load_stage(sa + (nk % kStages) * kTileA, sb + (nk % kStages) * kTileB,
                 xe, we, m0, n0, nk * kBK, C, D, F, vec_a, vec_b);
    cp_async_commit();

    const bf16* ta = sa + (kt % kStages) * kTileA;
    const bf16* tb = sb + (kt % kStages) * kTileB;
    if (n_mi > 0) {
#pragma unroll
      for (int kk = 0; kk < kBK; kk += 16) {
        // w fragments of the warp's four n8 tiles: two x4.trans loads, each
        // (k 0-7 | k 8-15) x (n 0-7 | n 8-15) of a 16-column pair
        uint32_t bfr[4][2];
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          uint32_t r[4];
          const int kr = kk + ((lane >> 3) & 1) * 8 + (lane & 7);
          const int nc = wn * 32 + p * 16 + (lane >> 4) * 8;
          ldmatrix_x4_trans(r, tb + kr * kLdB + nc);
          bfr[2 * p][0] = r[0];
          bfr[2 * p][1] = r[1];
          bfr[2 * p + 1][0] = r[2];
          bfr[2 * p + 1][1] = r[3];
        }
#pragma unroll
        for (int mi = 0; mi < 4; ++mi) {
          if (mi < n_mi) {
            uint32_t afr[4];
            const int ar = wm * 64 + mi * 16 + (lane & 15);
            const int ac = kk + (lane >> 4) * 8;
            ldmatrix_x4(afr, ta + ar * kLdA + ac);
#pragma unroll
            for (int ni = 0; ni < 4; ++ni)
              mma_bf16(acc[mi][ni], afr, bfr[ni][0], bfr[ni][1]);
          }
        }
      }
    }
  }
  cp_async_wait<0>();

  // accumulator (row g / g + 8, cols 2t, 2t + 1 of each m16 x n8 tile)
  const int g = lane >> 2, t = lane & 3;
  bf16* ye = y + (size_t)e * C * F;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int col = n0 + wn * 32 + ni * 8 + 2 * t;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + wm * 64 + mi * 16 + g + h * 8;
        if (row >= C) continue;
        bf16* out = ye + (size_t)row * F + col;
        if (col < F) out[0] = __float2bfloat16_rn(acc[mi][ni][2 * h]);
        if (col + 1 < F) out[1] = __float2bfloat16_rn(acc[mi][ni][2 * h + 1]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// bfloat16, small C (decode): D split over blocks, mma.sync, cp.async ring
// ---------------------------------------------------------------------------

constexpr int kSM = 16;             // C rows of a tile (C <= 16)
constexpr int kSN = 128;            // F columns of a tile
constexpr int kSK = 64;             // D step; a split's chunk is a multiple
constexpr int kSStages = 4;
constexpr int kSThreads = 128;      // 4 warps of 16 x 32
constexpr int kSLdA = kSK + kPad;   // 72 elements = 144 bytes a row of x's tile
constexpr int kSLdB = kSN + kPad;   // 136 elements = 272 bytes a row of w's
constexpr int kSTileA = kSM * kSLdA;
constexpr int kSTileB = kSK * kSLdB;
constexpr int kSSmemBytes = kSStages * (kSTileA + kSTileB) * 2;   // 78,848

// grid: x = ceil(F / kSN), y = S, z = E. block: kSThreads. Split s sums
// D rows [s * chunk, min(D, (s + 1) * chunk)); with one split it stores y in
// bf16, else its float32 partial at ws[s][e] (each E x C x F).
__global__ void __launch_bounds__(kSThreads, 2)
    gmm_splitd_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                      bf16* __restrict__ y, float* __restrict__ ws, int C,
                      int D, int F, int chunk) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sa = reinterpret_cast<bf16*>(smem_raw);
  bf16* sb = sa + kSStages * kSTileA;

  const int e = blockIdx.z, s = blockIdx.y, E = gridDim.z;
  const int n0 = blockIdx.x * kSN;
  const int k0 = s * chunk, k1 = min(D, k0 + chunk);
  const bf16* xe = x + (size_t)e * C * D;
  const bf16* we = w + (size_t)e * D * F;
  const int tid = threadIdx.x, lane = tid & 31, wn = tid >> 5;

  // One D step into a stage: x's 16 x 64 tile (one 16-byte chunk a thread)
  // and w's 64 x 128 tile (eight); rows past C and chunks past k1 or F are
  // zero-filled (D and F are multiples of 8, so a chunk is wholly in or out)
  auto load = [&](int st, int k) {
    {
      const int r = tid >> 3, c8 = (tid & 7) * 8, gk = k + c8;
      const bool in = r < C && gk < k1;
      cp_async16(sa + st * kSTileA + r * kSLdA + c8,
                 in ? xe + (size_t)r * D + gk : xe, in ? 16 : 0);
    }
#pragma unroll
    for (int i = 0; i < (kSK * kSN / 8) / kSThreads; ++i) {   // 8 chunks
      const int q = tid + i * kSThreads;
      const int r = q >> 4, c8 = (q & 15) * 8, gk = k + r, gn = n0 + c8;
      const bool in = gk < k1 && gn < F;
      cp_async16(sb + st * kSTileB + r * kSLdB + c8,
                 in ? we + (size_t)gk * F + gn : we, in ? 16 : 0);
    }
  };

  float acc[4][4];
#pragma unroll
  for (int ni = 0; ni < 4; ++ni)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[ni][r] = 0.f;

  const int k_tiles = (k1 - k0 + kSK - 1) / kSK;
#pragma unroll
  for (int st = 0; st < kSStages - 1; ++st) {
    if (st < k_tiles) load(st, k0 + st * kSK);
    cp_async_commit();
  }
  for (int kt = 0; kt < k_tiles; ++kt) {
    cp_async_wait<kSStages - 2>();
    __syncthreads();
    const int nk = kt + kSStages - 1;
    if (nk < k_tiles) load(nk % kSStages, k0 + nk * kSK);
    cp_async_commit();

    const bf16* ta = sa + (kt % kSStages) * kSTileA;
    const bf16* tb = sb + (kt % kSStages) * kSTileB;
#pragma unroll
    for (int kk = 0; kk < kSK; kk += 16) {
      uint32_t afr[4];
      ldmatrix_x4(afr, ta + (lane & 15) * kSLdA + kk + (lane >> 4) * 8);
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        uint32_t r[4];
        const int kr = kk + ((lane >> 3) & 1) * 8 + (lane & 7);
        const int nc = wn * 32 + p * 16 + (lane >> 4) * 8;
        ldmatrix_x4_trans(r, tb + kr * kSLdB + nc);
        mma_bf16(acc[2 * p], afr, r[0], r[1]);
        mma_bf16(acc[2 * p + 1], afr, r[2], r[3]);
      }
    }
  }
  cp_async_wait<0>();

  // accumulator: rows g and g + 8, columns 2t and 2t + 1 of each n8 tile
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int ni = 0; ni < 4; ++ni) {
    const int col = n0 + wn * 32 + ni * 8 + 2 * t;   // even; F is too
    if (col >= F) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = g + h * 8;
      if (row >= C) continue;
      const size_t at = ((size_t)e * C + row) * F + col;
      if (gridDim.y == 1)
        *reinterpret_cast<__nv_bfloat162*>(y + at) =
            __floats2bfloat162_rn(acc[ni][2 * h], acc[ni][2 * h + 1]);
      else
        *reinterpret_cast<float2*>(ws + (size_t)s * E * C * F + at) =
            make_float2(acc[ni][2 * h], acc[ni][2 * h + 1]);
    }
  }
}

// y = bf16(ws[0] + ws[1] + ... + ws[S - 1]), added in that order, four
// elements a thread; n4 = E * C * F / 4 (F is a multiple of 8).
__global__ void __launch_bounds__(256)
    gmm_splitd_reduce_kernel(const float* __restrict__ ws,
                             bf16* __restrict__ y, long long n4, int S) {
  const float4* p = reinterpret_cast<const float4*>(ws);
  for (long long i = blockIdx.x * 256LL + threadIdx.x; i < n4;
       i += (long long)gridDim.x * 256) {
    float4 a = p[i];
    for (int s = 1; s < S; ++s) {
      const float4 b = p[s * n4 + i];
      a.x += b.x;
      a.y += b.y;
      a.z += b.z;
      a.w += b.w;
    }
    __nv_bfloat162 lo = __floats2bfloat162_rn(a.x, a.y);
    __nv_bfloat162 hi = __floats2bfloat162_rn(a.z, a.w);
    uint2 out;
    out.x = *reinterpret_cast<uint32_t*>(&lo);
    out.y = *reinterpret_cast<uint32_t*>(&hi);
    reinterpret_cast<uint2*>(y)[i] = out;
  }
}

// ---------------------------------------------------------------------------
// bfloat16, large C (prefill): wgmma + TMA, warp-specialised and persistent
// ---------------------------------------------------------------------------

constexpr int kWM = 128;                      // C rows of a tile (2 x 64)
constexpr int kWN = 256;                      // F columns of a tile
constexpr int kWK = 64;                       // D step: 128 bytes of x's row
constexpr int kWBoxN = 64;                    // w's box: 64 columns x kWK rows
constexpr int kWStages = 4;
constexpr int kWThreads = 384;                // producer + 2 consumer groups
constexpr int kWTileA = kWM * kWK * 2;        // 16 KB
constexpr int kWBoxB = kWK * kWBoxN * 2;      // 8 KB
constexpr int kWTileB = kWK * kWN * 2;        // 32 KB (4 boxes)
constexpr int kWStageBytes = kWTileA + kWTileB;
constexpr int kWOutBox = 64;                  // y's box: 64 x 64, 8 KB
constexpr int kWOutBytes = kWOutBox * kWOutBox * 2;
// the ring, two output boxes a consumer warpgroup, the barriers, and room
// to align the ring to 1024 bytes: 230,464 of the 232,448 a block may have
constexpr int kWSmemBytes = kWStages * kWStageBytes + 4 * kWOutBytes +
                            2 * kWStages * 8 + 1024;

// wgmma shared-memory descriptors, 128-byte swizzle (offsets in bytes here,
// in 16-byte units in the descriptor). A K-major tile (the forward's x) has
// rows of 128 bytes, 8-row groups 1024 bytes apart (the stride offset; the
// leading one is unused), and a k16 step is 32 bytes along the row. An
// MN-major tile (the forward's w) is boxes of 64 MN columns, each kWK rows
// of 128 bytes: 8-row groups along K 1024 bytes apart (stride offset), the
// boxes 8 KB apart (leading offset), and a k16 step is 16 rows (2 KB).
constexpr uint32_t kDescKLead = 16, kDescMnLead = kWBoxB, kDescStride = 1024;
constexpr uint32_t kStepK = 32 >> 4, kStepMn = (16 * 128) >> 4;

__device__ __forceinline__ uint64_t gmma_desc(const void* p, uint32_t lead,
                                              uint32_t stride) {
  return (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4) |
         ((uint64_t)(lead >> 4) << 16) | ((uint64_t)(stride >> 4) << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

// spin until the barrier's phase of this parity has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred P1;\nLAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\nbra LAB_WAIT;\nDONE:\n}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile(
      "{\n.reg .b64 st;\nmbarrier.arrive.shared::cta.b64 st, [%0];\n}\n" ::"r"(
          smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

// a box of shared memory to a 3-D tensor map at element coordinates (c0,
// c1, c2), as one bulk group of the issuing thread; the map clips the box
// at the tensor's edges. Nothing here reads y again, so its lines are the
// first that L2 gives up, and x's rows and w's panels stay for the tiles
// that read them again
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map,
                                             const void* src, int c0, int c1,
                                             int c2) {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n"
               : "=l"(policy));
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group.L2::cache_hint "
      "[%0, {%2, %3, %4}], [%1], %5;\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_addr(src)), "r"(c0), "r"(c1), "r"(c2), "l"(policy)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// all but the newest N bulk groups of this thread have read their shared
// memory
template <int N>
__device__ __forceinline__ void tma_store_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

// the 128 threads of one warpgroup meet at named barrier `id` (0 is
// __syncthreads')
__device__ __forceinline__ void warpgroup_sync(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

// a box of a 3-D tensor map at element coordinates (c0, c1, c2) into shared
// memory; its bytes complete a transaction on the barrier
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving reads of the accumulator above the wait
__device__ __forceinline__ void fence_acc(float (&d)[128]) {
#pragma unroll
  for (int i = 0; i < 128; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 256 float32, the warpgroup's accumulator fragment) += a * b for
// one k16 step: a (64 x 16) and b (16 x 256), both bf16 in shared memory
// behind their descriptors, a K-major (kTransA 0) or MN-major (1), b K-major
// (kTransB 0) or MN-major (1). scale_d 0 starts d at zero (the first step
// of a tile).
template <int kTransA, int kTransB>
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128], uint64_t da,
                                                 uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, %131, %132;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(scale_d), "n"(kTransA), "n"(kTransB));
}

// the products the wgmma kernel body computes, by what it reads: y = x w
// (the forward), dx = dy w^T and dw = x^T dy
enum GmmMode : int { kGmmFwd = 0, kGmmDx = 1, kGmmDw = 2 };

// One persistent block of kWThreads computing out (E, M, N) = a (E, M, K) .
// b (E, K, N) on min(tiles, SMs) blocks. Warpgroup 0 produces, 1 and 2
// consume (rows 0-63 and 64-127 of each tile) and store through out's
// tensor map {N, M, E}. The maps and the operands' majors by kMode:
//   kGmmFwd: a = x {D, C, E} K-major, one 64 x 128 box a stage; b = w
//            {F, D, E} MN-major, four 64 x 64 boxes;
//   kGmmDx:  a = dy {F, C, E} K-major, as the forward's x; b = w {F, D, E}
//            K-major, one 64 x 256 box;
//   kGmmDw:  a = x {D, C, E} MN-major, two 64 x 64 boxes; b = dy {F, C, E}
//            MN-major, as the forward's w.
template <int kMode>
__device__ __forceinline__ void gmm_wgmma_body(const CUtensorMap* tma,
                                               const CUtensorMap* tmb,
                                               const CUtensorMap* tmy, int E,
                                               int M, int N, int K) {
  constexpr bool kAMn = kMode == kGmmDw;    // a read MN-major (trans-a)
  constexpr bool kBMn = kMode != kGmmDx;    // b read MN-major (trans-b)
  constexpr uint32_t kALead = kAMn ? kDescMnLead : kDescKLead;
  constexpr uint32_t kBLead = kBMn ? kDescMnLead : kDescKLead;
  constexpr uint32_t kAStep = kAMn ? kStepMn : kStepK;
  constexpr uint32_t kBStep = kBMn ? kStepMn : kStepK;
  extern __shared__ unsigned char smem_raw[];
  // the 128-byte swizzle repeats every 1024 bytes: align the ring to it
  unsigned char* base = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* sa = base;                         // kWStages x kWTileA
  unsigned char* sb = base + kWStages * kWTileA;    // kWStages x kWTileB
  unsigned char* so = sb + kWStages * kWTileB;      // 2 x 2 output boxes
  uint64_t* full = reinterpret_cast<uint64_t*>(so + 4 * kWOutBytes);
  uint64_t* empty = full + kWStages;

  const int n_ct = (M + kWM - 1) / kWM, n_ft = (N + kWN - 1) / kWN;
  const long long per_e = (long long)n_ct * n_ft, tiles = per_e * E;
  const int k_tiles = (K + kWK - 1) / kWK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kWStages; ++s) {
      mbar_init(&full[s], 1);    // the producer's expect_tx
      mbar_init(&empty[s], 2);   // one arrival a consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // producer: one thread issues every load; the roles never reconverge
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 0) {
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                       reinterpret_cast<uint64_t>(tma))
                   : "memory");
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                       reinterpret_cast<uint64_t>(tmb))
                   : "memory");
      int stage = 0;
      uint32_t phase = 0;
      for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int e = (int)(t / per_e), r = (int)(t % per_e);
        const int m0 = (r % n_ct) * kWM, n0 = (r / n_ct) * kWN;
        for (int kt = 0; kt < k_tiles; ++kt) {
          mbar_wait(&empty[stage], phase ^ 1);
          mbar_expect_tx(&full[stage], kWStageBytes);
          unsigned char* ta = sa + stage * kWTileA;
          unsigned char* tb = sb + stage * kWTileB;
          if (kAMn) {
#pragma unroll
            for (int j = 0; j < kWM / kWBoxN; ++j)
              tma_load_3d(ta + j * kWBoxB, tma, &full[stage], m0 + j * kWBoxN,
                          kt * kWK, e);
          } else {
            tma_load_3d(ta, tma, &full[stage], kt * kWK, m0, e);
          }
          if (kBMn) {
#pragma unroll
            for (int j = 0; j < kWN / kWBoxN; ++j)
              tma_load_3d(tb + j * kWBoxB, tmb, &full[stage], n0 + j * kWBoxN,
                          kt * kWK, e);
          } else {
            tma_load_3d(tb, tmb, &full[stage], kt * kWK, n0, e);
          }
          if (++stage == kWStages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int cw = wg - 1;                      // rows cw * 64 of the tile
    const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
    int stage = 0, prev = 0;
    uint32_t phase = 0;
    float acc[128];
    for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int e = (int)(t / per_e), r = (int)(t % per_e);
      const int m0 = (r % n_ct) * kWM, n0 = (r / n_ct) * kWN;
      for (int kt = 0; kt < k_tiles; ++kt) {
        mbar_wait(&full[stage], phase);
        // rows cw * 64: 64 rows of 128 bytes on (K-major), or the cw-th
        // 64-column box (MN-major); 8 KB in either layout
        const uint64_t da = gmma_desc(sa + stage * kWTileA + cw * 64 * 128,
                                      kALead, kDescStride);
        const uint64_t db = gmma_desc(sb + stage * kWTileB, kBLead,
                                      kDescStride);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kWK / 16; ++kk)
          wgmma_m64n256k16<kAMn, kBMn>(acc, da + kk * kAStep, db + kk * kBStep,
                                       (kt | kk) != 0);
        wgmma_commit();
        if (kt > 0) {   // the previous stage's wgmmas are done: release it
          wgmma_wait<1>();
          if (tid == 0) mbar_arrive(&empty[prev]);
        }
        prev = stage;
        if (++stage == kWStages) {
          stage = 0;
          phase ^= 1;
        }
      }
      wgmma_wait<0>();
      fence_acc(acc);
      if (tid == 0) mbar_arrive(&empty[prev]);

      // acc[4j + 2h + i] holds row 16 warp + lane / 4 + 8h and column 8j +
      // 2 (lane % 4) + i of the warpgroup's 64 x 256. Rounded once to bf16,
      // it goes out in four 64 x 64 boxes through two shared buffers in
      // turn, laid out with the map's 128-byte swizzle (16-byte chunk c of
      // row r at chunk c ^ (r % 8): no bank conflicts); the map drops rows
      // past M and columns past N, and the stores run on under the next
      // tile's products.
      const int r0 = warp * 16 + (lane >> 2);
#pragma unroll
      for (int q = 0; q < kWN / kWOutBox; ++q) {
        unsigned char* buf = so + (cw * 2 + (q & 1)) * kWOutBytes;
        if (tid == 0) tma_store_wait_read<1>();   // buf's last store has read it
        warpgroup_sync(1 + cw);
#pragma unroll
        for (int jj = 0; jj < kWOutBox / 8; ++jj) {
          const int j = q * (kWOutBox / 8) + jj;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int row = r0 + 8 * h;
            *reinterpret_cast<__nv_bfloat162*>(
                buf + row * 128 + ((jj ^ (row & 7)) << 4) + (lane & 3) * 4) =
                __floats2bfloat162_rn(acc[4 * j + 2 * h],
                                      acc[4 * j + 2 * h + 1]);
          }
        }
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        warpgroup_sync(1 + cw);
        if (tid == 0)
          tma_store_3d(tmy, buf, n0 + q * kWOutBox, m0 + cw * 64, e);
      }
    }
    if (tid == 0)   // the buffers stay until the last stores have read them
      asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
  }
}

// y (E, C, F) = x (E, C, D) . w (E, D, F): M C, N F, K D
__global__ void __launch_bounds__(kWThreads, 1)
    gmm_wgmma_kernel(const __grid_constant__ CUtensorMap tmx,
                     const __grid_constant__ CUtensorMap tmw,
                     const __grid_constant__ CUtensorMap tmy, int E, int C,
                     int D, int F) {
  gmm_wgmma_body<kGmmFwd>(&tmx, &tmw, &tmy, E, C, F, D);
}

// dx (E, C, D) = dy (E, C, F) . w (E, D, F)^T: M C, N D, K F
__global__ void __launch_bounds__(kWThreads, 1)
    gmm_wgmma_dx_kernel(const __grid_constant__ CUtensorMap tmdy,
                        const __grid_constant__ CUtensorMap tmw,
                        const __grid_constant__ CUtensorMap tmdx, int E, int C,
                        int D, int F) {
  gmm_wgmma_body<kGmmDx>(&tmdy, &tmw, &tmdx, E, C, D, F);
}

// dw (E, D, F) = x (E, C, D)^T . dy (E, C, F): M D, N F, K C
__global__ void __launch_bounds__(kWThreads, 1)
    gmm_wgmma_dw_kernel(const __grid_constant__ CUtensorMap tmx,
                        const __grid_constant__ CUtensorMap tmdy,
                        const __grid_constant__ CUtensorMap tmdw, int E, int C,
                        int D, int F) {
  gmm_wgmma_body<kGmmDw>(&tmx, &tmdy, &tmdw, E, D, F, C);
}

// ---------------------------------------------------------------------------
// the CUDA cores, for all three products: float32 (no TF32), and the bf16
// backward the wgmma route does not take (C <= 16, a base off 16 bytes, D or
// F not a multiple of 8)
// ---------------------------------------------------------------------------

constexpr int kFM = 64, kFN = 64, kFK = 16;
constexpr int kFThreads = 256;   // 16 x 16 threads, 4 x 4 outputs each

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store_as(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_as(bf16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// out (E, M, N) contiguous = a . b with a[e, m, k] at a + e sae + m sam +
// k sak and b[e, k, n] at b + e sbe + k sbk + n sbn: the forward reads x
// (k = d contiguous) and w (n = f contiguous), dx reads dy (k = f
// contiguous) and w (k = f contiguous), dw reads x (m = d contiguous) and
// dy (n = f contiguous). 64 x 64 output tiles, K in steps of 16 through
// shared memory; each operand's tile is loaded with neighbouring threads
// along its contiguous axis. Thread (ty, tx) owns rows ty + 16 i and
// columns tx + 16 j, so a warp's shared-memory reads of a k step are
// broadcasts (a) and 16 consecutive words (b). Products of bf16 values are
// exact in float32; fmaf sums them in float32.
// grid: x = ceil(M / kFM), y = ceil(N / kFN), z = E.
template <typename T>
__global__ void __launch_bounds__(kFThreads)
    gmm_fma_kernel(const T* __restrict__ a, const T* __restrict__ b,
                   T* __restrict__ out, int M, int N, int K,
                   long long sae, long long sam, long long sak,
                   long long sbe, long long sbk, long long sbn) {
  __shared__ float sa[kFK][kFM + 4];
  __shared__ float sb[kFK][kFN + 4];
  const int e = blockIdx.z;
  const int m0 = blockIdx.x * kFM, n0 = blockIdx.y * kFN;
  const T* ae = a + e * sae;
  const T* be = b + e * sbe;
  const bool a_k = sak == 1, b_k = sbk == 1;   // k the contiguous axis
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;

  float acc[4][4] = {};
  for (int k0 = 0; k0 < K; k0 += kFK) {
#pragma unroll
    for (int i = 0; i < (kFM * kFK) / kFThreads; ++i) {   // 4 each
      const int q = tid + i * kFThreads;
      const int ra = a_k ? q / kFK : q % kFM, ca = a_k ? q % kFK : q / kFM;
      const int gm = m0 + ra, gka = k0 + ca;
      sa[ca][ra] = (gm < M && gka < K)
                       ? to_f32(ae[gm * sam + gka * sak]) : 0.f;
      const int rb = b_k ? q / kFK : q % kFN, cb = b_k ? q % kFK : q / kFN;
      const int gn = n0 + rb, gkb = k0 + cb;
      sb[cb][rb] = (gn < N && gkb < K)
                       ? to_f32(be[gkb * sbk + gn * sbn]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kFK; ++k) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = sa[k][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = sb[k][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
  T* oe = out + (size_t)e * M * N;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + ty + 16 * i;
    if (row >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx + 16 * j;
      if (col < N) store_as(oe + (size_t)row * N + col, acc[i][j]);
    }
  }
}

// the C entry's routes; the Python wrapper's `plan` names them
enum Route : int {
  kRouteF32 = 0,      // float32, CUDA cores (forward and backward)
  kRouteMma = 1,      // bf16 forward, mma.sync
  kRouteWgmma = 2,    // bf16, wgmma + TMA (forward and backward)
  kRouteSplitD = 3,   // bf16 forward at C <= 16, D split over blocks
  kRouteBf16 = 4,     // bf16 backward, CUDA cores
};
constexpr int kBadArgs = -1, kNoTensorMap = -2;

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the runtime
// (cudaGetDriverEntryPoint) so that the library needs no -lcuda; nullptr
// where it is missing
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// a bf16 tensor {d0, d1, d2} (d0 contiguous) read in boxes {b0, b1, 1}
// with the 128-byte swizzle; zeros past every edge
bool encode_3d(CUtensorMap* map, const void* base, int d0, int d1, int d2,
               int b0, int b1) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)d0, (cuuint64_t)d1, (cuuint64_t)d2};
  const cuuint64_t strides[2] = {(cuuint64_t)d0 * 2,
                                 (cuuint64_t)d0 * (cuuint64_t)d1 * 2};
  const cuuint32_t box[3] = {(cuuint32_t)b0, (cuuint32_t)b1, 1};
  const cuuint32_t step[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base),
            dims, strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// SMs of the current device, read once per device
int sm_count() {
  static int counts[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (counts[dev] == 0)
    cudaDeviceGetAttribute(&counts[dev], cudaDevAttrMultiProcessorCount, dev);
  return counts[dev];
}

// the forward (mode kGmmFwd: a = x, b = w, out = y), dx (kGmmDx: a = dy,
// b = w, out = dx) or dw (kGmmDw: a = x, b = dy, out = dw) on the wgmma
// route: each operand's tensor map with the boxes its mode reads
int launch_wgmma(int mode, const void* a, const void* b, void* out, int E,
                 int C, int D, int F, cudaStream_t s) {
  CUtensorMap tma, tmb, tmo;
  bool ok;
  long long m, n;
  const void* kern;
  if (mode == kGmmFwd) {
    ok = encode_3d(&tma, a, D, C, E, kWK, kWM) &&
         encode_3d(&tmb, b, F, D, E, kWBoxN, kWK) &&
         encode_3d(&tmo, out, F, C, E, kWOutBox, kWOutBox);
    m = C, n = F, kern = (const void*)gmm_wgmma_kernel;
  } else if (mode == kGmmDx) {
    ok = encode_3d(&tma, a, F, C, E, kWK, kWM) &&
         encode_3d(&tmb, b, F, D, E, kWK, kWN) &&
         encode_3d(&tmo, out, D, C, E, kWOutBox, kWOutBox);
    m = C, n = D, kern = (const void*)gmm_wgmma_dx_kernel;
  } else if (mode == kGmmDw) {
    ok = encode_3d(&tma, a, D, C, E, kWBoxN, kWK) &&
         encode_3d(&tmb, b, F, C, E, kWBoxN, kWK) &&
         encode_3d(&tmo, out, F, D, E, kWOutBox, kWOutBox);
    m = D, n = F, kern = (const void*)gmm_wgmma_dw_kernel;
  } else {
    return kBadArgs;
  }
  if (!ok) return kNoTensorMap;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kWSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long tiles = (long long)E * ((m + kWM - 1) / kWM) *
                          ((n + kWN - 1) / kWN);
  const int sms = sm_count();
  if (sms < 1) return static_cast<int>(cudaGetLastError());
  const int grid = static_cast<int>(tiles < sms ? tiles : sms);
  if (mode == kGmmFwd)
    gmm_wgmma_kernel<<<grid, kWThreads, kWSmemBytes, s>>>(tma, tmb, tmo, E, C,
                                                          D, F);
  else if (mode == kGmmDx)
    gmm_wgmma_dx_kernel<<<grid, kWThreads, kWSmemBytes, s>>>(tma, tmb, tmo, E,
                                                             C, D, F);
  else
    gmm_wgmma_dw_kernel<<<grid, kWThreads, kWSmemBytes, s>>>(tma, tmb, tmo, E,
                                                             C, D, F);
  return static_cast<int>(cudaGetLastError());
}

// chunk of D a split sums: ceil(D / S) rounded up to the D step; the
// wrapper's plan gives an S whose last chunk is not empty
int split_chunk(int D, int S) {
  const int per = (D + S - 1) / S;
  return (per + kSK - 1) / kSK * kSK;
}

int launch_splitd(const void* x, const void* w, void* y, void* ws, int E,
                  int C, int D, int F, int S, cudaStream_t s) {
  const int chunk = split_chunk(D, S);
  if (C > kSM || S < 1 || S > 65535 || (long long)(S - 1) * chunk >= D ||
      (S > 1 && ws == nullptr))
    return kBadArgs;
  cudaError_t err = cudaFuncSetAttribute(
      gmm_splitd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  gmm_splitd_kernel<<<dim3((F + kSN - 1) / kSN, S, E), kSThreads, kSSmemBytes,
                      s>>>(static_cast<const bf16*>(x),
                           static_cast<const bf16*>(w), static_cast<bf16*>(y),
                           static_cast<float*>(ws), C, D, F, chunk);
  err = cudaGetLastError();
  if (err != cudaSuccess || S == 1) return static_cast<int>(err);
  const long long n4 = (long long)E * C * F / 4;
  const long long blocks = (n4 + 255) / 256;
  gmm_splitd_reduce_kernel<<<static_cast<int>(blocks < 4096 ? blocks : 4096),
                             256, 0, s>>>(static_cast<const float*>(ws),
                                          static_cast<bf16*>(y), n4, S);
  return static_cast<int>(cudaGetLastError());
}

// the forward (kGmmFwd: a = x, b = w, out = y), dx (kGmmDx: a = dy, b = w,
// out = dx) or dw (kGmmDw: a = x, b = dy, out = dw) on the CUDA cores
template <typename T>
int launch_fma(int mode, const void* a, const void* b, void* out, int E,
               int C, int D, int F, cudaStream_t s) {
  // forward: M C, N F, K D; a = x (E, C, D), b = w (E, D, F)
  // dx: M C, N D, K F; a = dy (E, C, F), b[e, k, n] = w[e, n, k]
  // dw: M D, N F, K C; a[e, m, k] = x[e, k, m], b = dy (E, C, F)
  int M, N, K;
  long long sae, sam, sak, sbe, sbk, sbn;
  if (mode == kGmmFwd) {
    M = C, N = F, K = D;
    sae = (long long)C * D, sam = D, sak = 1;
    sbe = (long long)D * F, sbk = F, sbn = 1;
  } else if (mode == kGmmDx) {
    M = C, N = D, K = F;
    sae = (long long)C * F, sam = F, sak = 1;
    sbe = (long long)D * F, sbk = 1, sbn = F;
  } else if (mode == kGmmDw) {
    M = D, N = F, K = C;
    sae = (long long)C * D, sam = 1, sak = D;
    sbe = (long long)C * F, sbk = F, sbn = 1;
  } else {
    return kBadArgs;
  }
  const long long gx = (M + kFM - 1) / kFM, gy = (N + kFN - 1) / kFN;
  if (gy > 65535) return kBadArgs;
  gmm_fma_kernel<T><<<dim3(gx, gy, E), kFThreads, 0, s>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<T*>(out),
      M, N, K, sae, sam, sak, sbe, sbk, sbn);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: (E, C, D), w: (E, D, F), y: (E, C, F), all contiguous and of one dtype
// (float32 for route 0, bfloat16 for the others). route: 0 float32 CUDA
// cores, 1 bf16 mma.sync, 2 bf16 wgmma + TMA, 3 bf16 split D into `splits`
// chunks (ws: splits x E x C x F float32 when splits > 1, else unused).
// Routes 2 and 3 take x and w 16-byte aligned with D and F multiples of 8,
// route 3 C <= 16. Sets *ran to the route it launched. Returns 0 on
// success, a cudaError_t from the launch, -1 for arguments the route does
// not take (the Python wrapper's plan checks these first) or -2 when a
// tensor map cannot be encoded.
extern "C" int grouped_matmul(const void* x, const void* w, void* y, void* ws,
                              int route, int E, int C, int D, int F,
                              int splits, void* stream, int* ran) {
  if (E < 1 || E > 65535 || C < 1 || D < 1 || F < 1) return kBadArgs;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool tma_ok = aligned16(x) && aligned16(w) && D % 8 == 0 && F % 8 == 0;
  int err;
  switch (route) {
    case kRouteWgmma:
      if (!tma_ok) return kBadArgs;
      err = launch_wgmma(kGmmFwd, x, w, y, E, C, D, F, s);
      break;
    case kRouteSplitD:
      if (!tma_ok) return kBadArgs;
      err = launch_splitd(x, w, y, ws, E, C, D, F, splits, s);
      break;
    case kRouteMma: {
      // above 48 KB of dynamic shared memory only on request (per device,
      // so on every launch)
      const long long gx = (C + kBM - 1) / kBM, gy = (F + kBN - 1) / kBN;
      if (gy > 65535) return kBadArgs;
      cudaError_t e = cudaFuncSetAttribute(
          gmm_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          kSmemBytes);
      if (e != cudaSuccess) return static_cast<int>(e);
      gmm_bf16_kernel<<<dim3(gx, gy, E), kThreads, kSmemBytes, s>>>(
          static_cast<const bf16*>(x), static_cast<const bf16*>(w),
          static_cast<bf16*>(y), C, D, F);
      err = static_cast<int>(cudaGetLastError());
      break;
    }
    case kRouteF32:
      err = launch_fma<float>(kGmmFwd, x, w, y, E, C, D, F, s);
      break;
    default:
      return kBadArgs;
  }
  if (err == 0) *ran = route;
  return err;
}

// The backward's two products, each into a new contiguous tensor of the
// operands' dtype:
//   mode 1, dx (E, C, D) = dy (E, C, F) . w (E, D, F)^T: a = dy, b = w;
//   mode 2, dw (E, D, F) = x (E, C, D)^T . dy (E, C, F): a = x, b = dy.
// route: 0 float32 on the CUDA cores, 4 bf16 on the CUDA cores, 2 bf16
// wgmma + TMA (a and b 16-byte aligned, D and F multiples of 8). Sets *ran
// to the route it launched. Returns 0 on success, a cudaError_t from the
// launch, -1 for arguments the route does not take (the Python wrapper's
// plan_bwd checks these first) or -2 when a tensor map cannot be encoded.
extern "C" int grouped_matmul_bwd(const void* a, const void* b, void* out,
                                  int mode, int route, int E, int C, int D,
                                  int F, void* stream, int* ran) {
  if (E < 1 || E > 65535 || C < 1 || D < 1 || F < 1 ||
      (mode != kGmmDx && mode != kGmmDw))
    return kBadArgs;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err;
  switch (route) {
    case kRouteWgmma:
      if (!(aligned16(a) && aligned16(b) && D % 8 == 0 && F % 8 == 0))
        return kBadArgs;
      err = launch_wgmma(mode, a, b, out, E, C, D, F, s);
      break;
    case kRouteF32:
      err = launch_fma<float>(mode, a, b, out, E, C, D, F, s);
      break;
    case kRouteBf16:
      err = launch_fma<bf16>(mode, a, b, out, E, C, D, F, s);
      break;
    default:
      return kBadArgs;
  }
  if (err == 0) *ran = route;
  return err;
}

extern "C" const char* grouped_matmul_error_string(int code) {
  if (code == kBadArgs) return "argument the grouped matmul route does not take";
  if (code == kNoTensorMap)
    return "cuTensorMapEncodeTiled refused the tensor map (or is "
           "missing)";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Grouped (per-expert) matmul for Hopper (sm_90a): the MoE expert FFN's
// three products.
//
// Replaces the Pallas TPU kernel `grouped_matmul` (body `_gmm_kernel`),
// src/repro/kernels/moe/kernel.py:38. Same function: for x (E, C, D) and
// w (E, D, F),
//   y[e, c, f] = sum_{k < D} x[e, c, k] * w[e, k, f],
// every product exact in float32 (a bf16 x bf16 product is), summed in
// float32, and rounded once to x's dtype. x and w have one dtype, float32 or
// bfloat16; float32 inputs never go through TF32.
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
// nothing can carry between them: one block owns one (C tile, F tile,
// expert) output tile and walks the whole D axis itself, its accumulator in
// registers.
//   * bf16: 128 x 128 output tiles, 8 warps of 64 x 32, D in steps of 32.
//     The tiles of x and w pass through shared memory in a ring of kStages
//     stages filled with cp.async (16-byte copies, zero-filled past the
//     edges), so the loads of the next stages are in flight while the
//     tensor cores work on this one; fragments come from shared memory with
//     ldmatrix (w's row-major tile transposed on the way by ldmatrix.trans),
//     and the products are mma.sync m16n8k16 with float32 accumulators.
//     Rows are padded by 8 elements so ldmatrix reads no bank twice. A warp
//     whose rows all lie past C skips its products (decode: C = 8 fills one
//     warp row of 16 of the 128). Where a row is not 16-byte aligned (D or F
//     not a multiple of 8) the tile is loaded element by element instead.
//   * float32: 64 x 64 output tiles, 256 threads of 4 x 4 outputs, D in
//     steps of 16 through shared memory, float32 FMAs on the CUDA cores.
//   The grid's fastest axis walks C tiles, so the blocks in flight share one
//   F panel of w (read from device memory once) and re-read x's rows from L2.
//
// The limits of this simple design: mma.sync, not Hopper's wgmma with TMA,
// so the tensor cores are fed at a fraction of their rate; and at the decode
// shape a 128-row tile holds 8 tokens, one block per F tile streams its
// whole D panel alone (no split over D), so few blocks are in flight for
// the down projection (F 6144: 48 tiles an expert).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

// ---------------------------------------------------------------------------
// bfloat16: tensor cores (mma.sync m16n8k16, float32 accumulators)
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
// float32: CUDA-core FMAs (no TF32)
// ---------------------------------------------------------------------------

constexpr int kFM = 64, kFN = 64, kFK = 16;
constexpr int kFThreads = 256;   // 16 x 16 threads, 4 x 4 outputs each

// grid: x = ceil(C / kFM), y = ceil(F / kFN), z = E. Thread (ty, tx) owns
// rows ty + 16 i and columns tx + 16 j, so a warp's shared-memory reads of a
// k step are broadcasts (x) and 16 consecutive words (w).
__global__ void __launch_bounds__(kFThreads)
    gmm_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                   float* __restrict__ y, int C, int D, int F) {
  __shared__ float sa[kFK][kFM + 4];   // x's tile, transposed
  __shared__ float sb[kFK][kFN + 4];
  const int e = blockIdx.z;
  const int m0 = blockIdx.x * kFM, n0 = blockIdx.y * kFN;
  const float* xe = x + (size_t)e * C * D;
  const float* we = w + (size_t)e * D * F;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;

  float acc[4][4] = {};
  for (int k0 = 0; k0 < D; k0 += kFK) {
#pragma unroll
    for (int i = 0; i < (kFM * kFK) / kFThreads; ++i) {   // 4 each
      const int q = tid + i * kFThreads;
      const int r = q / kFK, c = q % kFK;                  // x: row r, k c
      const int gm = m0 + r, gk = k0 + c;
      sa[c][r] = (gm < C && gk < D) ? xe[(size_t)gm * D + gk] : 0.f;
      const int rb = q / kFN, cb = q % kFN;                // w: k rb, col cb
      const int gkb = k0 + rb, gn = n0 + cb;
      sb[rb][cb] = (gkb < D && gn < F) ? we[(size_t)gkb * F + gn] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kFK; ++k) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = sa[k][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = sb[k][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
  float* ye = y + (size_t)e * C * F;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + ty + 16 * i;
    if (row >= C) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx + 16 * j;
      if (col < F) ye[(size_t)row * F + col] = acc[i][j];
    }
  }
}

}  // namespace

// x: (E, C, D), w: (E, D, F), y: (E, C, F), all contiguous and of one dtype,
// float32 or bfloat16 (is_bf16). Returns 0 on success, a cudaError_t from the
// launch, or -1 for arguments the kernel does not take (the Python wrapper
// checks these first).
extern "C" int grouped_matmul(const void* x, const void* w, void* y,
                              int is_bf16, int E, int C, int D, int F,
                              void* stream) {
  if (E < 1 || E > 65535 || C < 1 || D < 1 || F < 1) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    // above 48 KB of dynamic shared memory only on request (per device,
    // so on every launch)
    cudaError_t err = cudaFuncSetAttribute(
        gmm_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    const long long gx = (C + kBM - 1) / kBM, gy = (F + kBN - 1) / kBN;
    if (gy > 65535) return -1;
    gmm_bf16_kernel<<<dim3(gx, gy, E), kThreads, kSmemBytes, s>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(w),
        static_cast<bf16*>(y), C, D, F);
  } else {
    const long long gx = (C + kFM - 1) / kFM, gy = (F + kFN - 1) / kFN;
    if (gy > 65535) return -1;
    gmm_f32_kernel<<<dim3(gx, gy, E), kFThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w),
        static_cast<float*>(y), C, D, F);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* grouped_matmul_error_string(int code) {
  if (code == -1) return "argument the grouped matmul kernel does not take";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

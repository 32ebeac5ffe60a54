// Mamba-2 SSD chunk scan for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `ssd_hm` (body `_ssd_kernel`),
// src/repro/kernels/ssd/kernel.py:67. Same function: with the state S (P x N)
// starting at 0 and carried from chunk to chunk, each chunk of Q steps, with
// a = the inclusive cumsum of dA over the chunk, gives
//   y[i, p] = sum_{j <= i} (C_i . B_j) exp(a_i - a_j) x[j, p]
//             + exp(a_i) sum_n C[i, n] S[p, n]
//   S[p, n] <- S[p, n] exp(a_last) + sum_j x[j, p] B[j, n] exp(a_last - a_j)
// and the last S is the final state. Float32-accurate arithmetic and float32
// accumulation throughout, but for the cumsum a of dA, which is kept in
// float64: at the model's decay a reaches -200 within a chunk of 256 steps,
// where a float32 difference a_i - a_j near the diagonal keeps only about 5
// of its digits (the reference kernel's float32 difference loses them
// there). y is written in x's dtype, the state in float32.
//
// Differences from the TPU kernel, all in what it takes, none in what it
// computes: any S >= 1 (the ragged last chunk is cut to its length inside
// the kernel, which is what padding it with identity steps x = 0, dA = 0
// amounts to, so no padded copy is made); the model's layout x (b, s, h, p),
// dA (b, s, h), B/C (b, s, h, n) read through strides, so the head-broadcast
// B and C of the model (stride 0 over h) are never copied per head, and y is
// written in the same layout; float32 or bfloat16 x, B and C.
//
// Two routes, chosen by the wrapper's `plan` from the dtypes alone (no
// fallback from one to the other):
//
// "tc", bf16 B and C (the model's types; x float32 or bf16): the tensor
// cores, the SSD decomposition with the chunks in parallel, three launches
// a call, no float atomics, every sum in a fixed order:
//   (a)+(b) ssd_tc_state_kernel, a block of 8 warps per (b, h, chunk): the
//       chunk's cumsum a in float64 (written to a workspace that (c) reads),
//       then its own state S_c = (x * exp(a_last - a))^T B, P x N, into a
//       float32 workspace (b, h, chunk, P, N). The last of a (b, h) row's
//       blocks to finish (an integer counter a row, which it leaves at 0)
//       passes the states along the row in chunk order, S_in[c] =
//       S_in[c-1] exp(a_last[c-1]) + S_{c-1}, over the workspace in place,
//       while they are still in L2; the last sum is the final state;
//   (s) ssd_tc_scores_kernel, a block per 64 x 64 tile of the lower
//       triangle of each chunk's scores G = C B^T, once for all heads where
//       they share B and C (stride 0 over h), into a float32 workspace (33.5
//       MB at mamba2-370m's prefill shape, which stays in L2 for the heads);
//   (c) ssd_tc_out_kernel, a block of 8 warps per (b, h, chunk, 128 rows):
//       exp(a_i) C_i . S_in^T, then for each 64-column tile j at or before
//       the rows, G decayed by exp(a_i - a_j) only where j <= i (tiles
//       above the diagonal skipped, a warp's 16 rows take only the 8-column
//       steps at or before its last row) times x.
// Every product is an `mma.sync`. C B^T is bf16 m16n8k16: bf16 products are
// exact and the sums float32, so that product is float32-accurate in one
// pass. A product with a float32 operand runs as TF32 m16n8k8 with the
// float32 operand split, hi = tf32(v), lo = tf32(v - hi) (rounded to
// nearest by two integer operations: cvt.rna.tf32.f32 runs at the 16-a-
// clock conversion rate, and the kernels round about 10^8 warps' values a
// call): two float32
// operands take three products (lo.hi + hi.lo + hi.hi), one float32 operand
// against bf16 (exact in TF32) or bf16 x takes two. One TF32 pass misses the
// float32 bound by about 20x at the model's decay, a bf16 pass by about 230x
// (measured by emulation, tests/test_torch_ssd.py), so no product is single-
// pass. The decayed scores are the TF32 product's A fragment as loaded: the
// k index of scores . x is permuted so that a thread's A elements (k = t,
// t + 4) are columns (2t, 2t + 1), and x's B fragment is read with the same
// permutation; likewise C's bf16 pairs are the A fragment of C . S_in^T.
// S_in, which every warp of (c) reads, is split once a block into a hi and a
// lo tile. Tiles reach shared memory by `cp.async` (16-byte copies where the
// strides allow, else 8, 4, or plain 2-byte copies for bf16 off 4-byte
// alignment) into two-stage rings, the next tile's copy in flight under the
// current tile's products, one barrier a step; B and C fragments come by
// `ldmatrix`. (c) takes 110,592 B of shared memory a block at x float32 and
// chunk 256, 2 blocks an SM.
//
// What bounds it: operations. At mamba2-370m's prefill shape (b 8, s 4096,
// 32 heads, P 64, N 128, Q 256) the float32-accurate products are 1.205e11
// TF32 operations (0.243 ms at 495 TFLOP/s) and the C.B^T scores 1.08e9 bf16
// operations once for the heads that share B and C; the kernel moves about
// 0.57 GB of inputs and outputs (0.169 ms at 3.35 TB/s). The workspace (176
// MB at that shape: chunk states 134 MB, cumsums 8 MB, scores 34 MB) adds
// traffic the bound does not count, and `mma.sync` does not reach the TF32
// rate that the bound assumes (wgmma does).
//
// "fma", float32 B and C: the first port's kernel, unchanged. One block of
// 256 threads per (b, h) row walks the chunks in order with the state (32
// KB) in shared memory; within a chunk the rows are taken 64 at a time, each
// 64 x 64 score tile formed, masked, decayed and multiplied into y by float32
// FMAs on the CUDA cores (a 4 x 4 micro-tile a thread), and the last row
// tile accumulates the state update. Only b * h blocks run, and every
// product is a CUDA-core FMA fed from shared memory: 5.2 ms at the prefill
// shape with bf16 B and C, before the tc route served them.
//
// The backward (no TPU kernel computes it: the reference differentiates
// ssd_chunked with jax.grad) takes chunks of kBQ = 64 of its own, on two
// routes chosen by the wrapper's `plan_bwd` from B's dtype alone:
//
// "tc", bf16 B and C: two launches, no float atomics, every sum in a fixed
// order. (1) ssd_bwd_tc_state_kernel, 8 warps per (b, h, chunk): the chunk's
// state U = (x e)^T B and state gradient D = (dy f)^T C as TF32 `mma.sync`
// (x e and dy f split, two products each), into float32 workspaces; the last
// block of a (b, h) row passes U forward into the entering states H_in and D
// backward into the leaving states' gradients G, the two chains interleaved
// so that a thread keeps 16 loads in flight: one block walks a row, so the
// pass is bound by the loads it has in flight, and more than 8 a chain
// spill (tools/ssd_bwd_variants.py times it with 4 and 16 a chain and
// without it). (2) ssd_bwd_tc_grad_kernel, 4 warps
// per (b, h, chunk), each owning 16 rows: first as s, the inter-chunk
// products B G^T and x G into dx and dB, then its rows against the chunk's
// rows on or below the diagonal 16 at a time, x.dy (TF32, both split) and
// B.C (bf16 m16n8k16) into registers, decayed and masked there into M and
// LX, which go on as A fragments into dx += M^T dy and dB += LX^T C; then as
// l, dy H_in and the same with C.B and dy.x into dC += LX B. The two row
// sums d(dA) needs besides T's (F and w) come from the accumulators of the
// inter-chunk products before they are scaled. x, dy, B, C and a G / H_in
// tile take 106,512 B of shared memory, 2 blocks an SM; x.dy and C.B are
// formed once for the rows as s and once as l, which keeps M and LX in
// registers and every Q x Q tile out of shared memory.
// "fma", float32 B and C: the first backward's three kernels below, float32
// FMAs on the CUDA cores with both operands from shared memory.
// What bounds the backward: operations, the function's six (p, n)
// multiply-adds a step and head as TF32 triples (2.58e10 at mamba2-370m's
// training microbatch, 0.156 ms at 495 TFLOP/s). The chunks' quadratic
// terms and the workspace (268 MB of chunk states at that shape, written,
// passed along the rows and read) add work the bound does not count.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;        // rows of a tile (i or j)
constexpr int kMaxP = 64;
constexpr int kMaxN = 128;
constexpr int kMaxChunk = 1024;
constexpr int kSStride = kMaxN + 1;    // state rows (float)
constexpr int kBCStride = kMaxN + 2;   // B and C rows (input type)
constexpr int kGStride = kTile + 16;   // score rows: two thread rows 16 banks apart

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void from_f(float v, float* out) { *out = v; }
__device__ __forceinline__ void from_f(float v, __nv_bfloat16* out) {
  *out = __float2bfloat16_rn(v);
}

struct Strides {  // element strides of the model layout
  long long xb, xs, xh;
  long long db, ds, dh;
  long long bb, bs, bh;
  long long cb, cs, ch;
};

template <typename TBC>
__host__ __device__ constexpr size_t smem_bytes(int q_pad) {
  return sizeof(float) * kTile * kSStride          // state
         + sizeof(TBC) * 2 * kTile * kBCStride     // C row tile, B column tile
         + sizeof(float) * kTile * kMaxP           // x column tile
         + sizeof(float) * kTile * kGStride        // scores
         + sizeof(double) * q_pad                  // cumsum of dA
         + sizeof(float) * q_pad;                  // decay to the chunk's end
}

// rows [t0 + r0, t0 + r0 + 64) of a (b, s, h, width) input into a tile of
// 64 rows of `stride` elements; rows at or past `len` are zero
template <typename T>
__device__ __forceinline__ void stage(T* tile, int stride, const T* src,
                                      long long row_stride, int r0, int len,
                                      int width) {
  T zero;
  from_f(0.f, &zero);
  for (int e = threadIdx.x; e < kTile * width; e += kThreads) {
    const int r = e / width, c = e % width;
    tile[r * stride + c] =
        r0 + r < len ? src[(long long)(r0 + r) * row_stride + c] : zero;
  }
}

template <typename TX>
__device__ __forceinline__ void stage_x(float* tile, const TX* src,
                                        long long row_stride, int r0, int len,
                                        int P) {
  for (int e = threadIdx.x; e < kTile * P; e += kThreads) {
    const int r = e / P, c = e % P;
    tile[r * kMaxP + c] =
        r0 + r < len ? to_f(src[(long long)(r0 + r) * row_stride + c]) : 0.f;
  }
}

// grid: b * h blocks, one (b, h) row each. block: kThreads.
template <typename TX, typename TBC>
__global__ void __launch_bounds__(kThreads, 2)
ssd_chunk_scan_kernel(const TX* __restrict__ x, const float* __restrict__ dA,
                      const TBC* __restrict__ Bm, const TBC* __restrict__ Cm,
                      TX* __restrict__ y, float* __restrict__ state, int H,
                      int S, int P, int N, int Q, int q_pad, Strides st) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* sS = reinterpret_cast<float*>(smem);
  TBC* sC = reinterpret_cast<TBC*>(sS + kTile * kSStride);
  TBC* sB = sC + kTile * kBCStride;
  float* sX = reinterpret_cast<float*>(sB + kTile * kBCStride);
  float* sG = sX + kTile * kMaxP;
  double* a_cs = reinterpret_cast<double*>(sG + kTile * kGStride);
  float* w_end = reinterpret_cast<float*>(a_cs + q_pad);

  const int bi = blockIdx.x / H, hi = blockIdx.x % H;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // 64 x 64 products: rows ti + 16 a, columns tj + 16 c (a, c < 4)
  const int ti = tid >> 4, tj = tid & 15;
  // the state: p = sp + 8 k (k < 8), n = sn + 32 m (m < 4)
  const int sp = tid >> 5, sn = tid & 31;

  const TX* xrow = x + bi * st.xb + hi * st.xh;
  const float* drow = dA + bi * st.db + hi * st.dh;
  const TBC* brow = Bm + bi * st.bb + hi * st.bh;
  const TBC* crow = Cm + bi * st.cb + hi * st.ch;
  TX* yrow = y + ((long long)bi * S * H + hi) * P;
  const long long y_rs = (long long)H * P;

  for (int e = tid; e < kTile * kSStride; e += kThreads) sS[e] = 0.f;

  for (int t0 = 0; t0 < S; t0 += Q) {
    const int len = min(Q, S - t0);
    // inclusive cumsum of dA over the chunk in float64 (warp 0, 32 steps a
    // pass); steps past len add 0, so they hold a_last
    if (warp == 0) {
      double carry = 0.0;
      for (int base = 0; base < q_pad; base += 32) {
        const int t = base + lane;
        double v = t < len ? drow[(long long)(t0 + t) * st.ds] : 0.0;
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
          const double u = __shfl_up_sync(0xffffffffu, v, off);
          if (lane >= off) v += u;
        }
        v += carry;
        a_cs[t] = v;
        carry = __shfl_sync(0xffffffffu, v, 31);
      }
    }
    __syncthreads();
    const double a_last = a_cs[len - 1];
    for (int t = tid; t < q_pad; t += kThreads)
      w_end[t] = t < len ? expf(static_cast<float>(a_last - a_cs[t])) : 0.f;

    const TX* xc = xrow + (long long)t0 * st.xs;
    const TBC* bc = brow + (long long)t0 * st.bs;
    const TBC* cc = crow + (long long)t0 * st.cs;
    float acc[8][4];   // the new state, accumulated in the last row tile

    for (int i0 = 0; i0 < len; i0 += kTile) {
      const bool last = i0 + kTile >= len;
      stage(sC, kBCStride, cc, st.cs, i0, len, N);
      __syncthreads();

      // the incoming state's term, exp(a_i) C_i . S_p
      float yacc[4][4] = {};
      for (int n = 0; n < N; ++n) {
        float cv[4], sv[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) cv[a] = to_f(sC[(ti + 16 * a) * kBCStride + n]);
#pragma unroll
        for (int c = 0; c < 4; ++c) sv[c] = sS[(tj + 16 * c) * kSStride + n];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int c = 0; c < 4; ++c) yacc[a][c] = fmaf(cv[a], sv[c], yacc[a][c]);
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const float e = expf(static_cast<float>(a_cs[i0 + ti + 16 * a]));
#pragma unroll
        for (int c = 0; c < 4; ++c) yacc[a][c] *= e;
      }
      if (last) {
        const float e = expf(static_cast<float>(a_last));
#pragma unroll
        for (int k = 0; k < 8; ++k)
#pragma unroll
          for (int m = 0; m < 4; ++m) {
            const int p = sp + 8 * k, n = sn + 32 * m;
            acc[k][m] = (p < P && n < N) ? sS[p * kSStride + n] * e : 0.f;
          }
      }

      for (int j0 = 0; j0 <= i0; j0 += kTile) {
        __syncthreads();   // the previous tile's readers are done
        stage(sB, kBCStride, bc, st.bs, j0, len, N);
        stage_x(sX, xc, st.xs, j0, len, P);
        __syncthreads();

        // scores C_i . B_j, decayed by exp(a_i - a_j) where j <= i
        float g[4][4] = {};
        for (int n = 0; n < N; ++n) {
          float cv[4], bv[4];
#pragma unroll
          for (int a = 0; a < 4; ++a) cv[a] = to_f(sC[(ti + 16 * a) * kBCStride + n]);
#pragma unroll
          for (int c = 0; c < 4; ++c) bv[c] = to_f(sB[(tj + 16 * c) * kBCStride + n]);
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int c = 0; c < 4; ++c) g[a][c] = fmaf(cv[a], bv[c], g[a][c]);
        }
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const int i = i0 + ti + 16 * a;
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int j = j0 + tj + 16 * c;
            sG[(ti + 16 * a) * kGStride + tj + 16 * c] =
                j <= i ? g[a][c] * expf(static_cast<float>(a_cs[i] - a_cs[j]))
                       : 0.f;
          }
        }
        __syncthreads();

        // y += scores @ x
        for (int j = 0; j < kTile; ++j) {
          float gv[4], xv[4];
#pragma unroll
          for (int a = 0; a < 4; ++a) gv[a] = sG[(ti + 16 * a) * kGStride + j];
#pragma unroll
          for (int c = 0; c < 4; ++c) xv[c] = sX[j * kMaxP + tj + 16 * c];
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int c = 0; c < 4; ++c) yacc[a][c] = fmaf(gv[a], xv[c], yacc[a][c]);
        }
        // the state update's share of this column tile:
        // acc[p, n] += x[j, p] exp(a_last - a_j) B[j, n]
        if (last) {
          for (int j = 0; j < kTile; ++j) {
            const float wj = w_end[j0 + j];
            float xv[8], bv[4];
#pragma unroll
            for (int k = 0; k < 8; ++k) xv[k] = sX[j * kMaxP + sp + 8 * k] * wj;
#pragma unroll
            for (int m = 0; m < 4; ++m) bv[m] = to_f(sB[j * kBCStride + sn + 32 * m]);
#pragma unroll
            for (int k = 0; k < 8; ++k)
#pragma unroll
              for (int m = 0; m < 4; ++m) acc[k][m] = fmaf(xv[k], bv[m], acc[k][m]);
          }
        }
      }

#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int i = i0 + ti + 16 * a;
        if (i >= len) continue;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int p = tj + 16 * c;
          if (p < P) from_f(yacc[a][c], yrow + (long long)(t0 + i) * y_rs + p);
        }
      }
      __syncthreads();   // sC, sB, sX, sG and the old state are free
    }

    // the chunk's y has read the old state: store the new one
#pragma unroll
    for (int k = 0; k < 8; ++k)
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const int p = sp + 8 * k, n = sn + 32 * m;
        if (p < P && n < N) sS[p * kSStride + n] = acc[k][m];
      }
    __syncthreads();
  }

  float* out = state + (long long)blockIdx.x * P * N;
  for (int e = tid; e < P * N; e += kThreads)
    out[e] = sS[(e / N) * kSStride + e % N];
}

template <typename TX, typename TBC>
int launch(const void* x, const void* dA, const void* B, const void* C,
           void* y, void* state, int b, int S, int H, int P, int N, int Q,
           const Strides& st, cudaStream_t stream) {
  const int q_pad = (Q + kTile - 1) / kTile * kTile;
  const size_t smem = smem_bytes<TBC>(q_pad);
  auto kernel = ssd_chunk_scan_kernel<TX, TBC>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<b * H, kThreads, smem, stream>>>(
      static_cast<const TX*>(x), static_cast<const float*>(dA),
      static_cast<const TBC*>(B), static_cast<const TBC*>(C),
      static_cast<TX*>(y), static_cast<float*>(state), H, S, P, N, Q, q_pad,
      st);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// The tensor-core route (bf16 B and C)
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int kTcLdB = kMaxN + 8;   // B and C tile rows (bf16): 272 B, so
                                    // ldmatrix's 8 rows hit 8 bank groups
constexpr int kTcLdS = kMaxN + 8;   // S_in rows (float): a half-warp's
                                    // float2 reads on 32 distinct banks
constexpr int kTcLdG = kTile + 8;   // scores rows (float), likewise
constexpr int kStateThreads = 256;  // (a): 8 warps, 16 p x 64 n each
constexpr int kOutRows = 128;       // (c): rows a block
constexpr int kOutThreads = 2 * kOutRows;   // (c): a warp per 16 rows
constexpr int kStateStages = 2;     // (a): tiles in the ring
constexpr int kOutStages = 2;       // (c): tiles in the ring
constexpr int kScoreThreads = 128;  // (s): 4 warps, 16 rows each
constexpr int kPassGroup = 4;       // (b): chunk states loaded at once

// x tile rows: 68 floats or 72 bf16, so that the fragment reads
// x[j0 + 2t (+1)][p0 + g] of a warp fall on 32 distinct banks
template <typename TX>
__host__ __device__ constexpr int tc_ldx() {
  return sizeof(TX) == 4 ? kMaxP + 4 : kMaxP + 8;
}

__host__ __device__ constexpr int cmax(int a, int b) { return a > b ? a : b; }

__host__ __device__ constexpr int round_up(int v, int m) {
  return (v + m - 1) / m * m;
}

// one stage of (a)'s ring: an x tile and a B tile, 64 rows each
template <typename TX>
__host__ __device__ constexpr int tc_x_bytes() {
  return kTile * tc_ldx<TX>() * (int)sizeof(TX);
}
template <typename TX>
__host__ __device__ constexpr int tc_state_stage_bytes() {
  return tc_x_bytes<TX>() + kTile * kTcLdB * 2;
}
// one stage of (c)'s ring: an x tile (64 rows) and a scores tile (kOutRows
// x 64), or S_in (P rows of N floats) or its lo half, or a C tile
template <typename TX>
__host__ __device__ constexpr int tc_out_stage_bytes() {
  return cmax(tc_x_bytes<TX>() + kOutRows * kTcLdG * 4,
              cmax(kMaxP * kTcLdS * 4, kOutRows * kTcLdB * 2));
}
constexpr int kScoreSmem = 2 * kTile * kTcLdB * 2;   // (s): a C and a B tile

template <typename TX>
__host__ __device__ constexpr size_t tc_state_smem(int q_pad) {
  return kStateStages * (size_t)tc_state_stage_bytes<TX>() +
         q_pad * (sizeof(double) + sizeof(float));
}

template <typename TX>
__host__ __device__ constexpr size_t tc_out_smem(int q_pad) {
  return kOutStages * (size_t)tc_out_stage_bytes<TX>() +
         round_up(q_pad, kOutRows) * sizeof(double);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// one copy of `vec` bytes into shared memory, zeros when !in
__device__ __forceinline__ void copy_async(void* dst, const void* src, int vec,
                                           bool in) {
  const uint32_t d = smem_addr(dst);
  const int n = in ? vec : 0;
  switch (vec) {
    case 16:
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                   :: "r"(d), "l"(src), "r"(n));
      break;
    case 8:
      asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n"
                   :: "r"(d), "l"(src), "r"(n));
      break;
    case 4:
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                   :: "r"(d), "l"(src), "r"(n));
      break;
    default:   // bf16 rows off 4-byte alignment: a plain copy
      *static_cast<uint16_t*>(dst) =
          in ? *static_cast<const uint16_t*>(src) : static_cast<uint16_t>(0);
  }
}

__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most `pending` committed groups are in flight
template <int pending>
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(pending) : "memory");
}

// a tile of `rows` rows of `ld` elements: row r < rows_in from src + r * rs,
// columns < width; zeros elsewhere up to `wpad` columns (a multiple of the
// copy). `vec` divides the base, the row stride and the width in bytes.
// A thread keeps one column of copies and steps over the rows.
template <typename T>
__device__ __forceinline__ void stage_tile(T* dst, int ld, const T* src,
                                           long long rs, int rows_in,
                                           int width, int wpad, int vec,
                                           int rows = kTile) {
  const int per = vec / (int)sizeof(T);
  const int cpr = wpad / per;                 // copies a row, <= blockDim.x
  const int rows_a_pass = blockDim.x / cpr;
  const int r0 = threadIdx.x / cpr;
  if (r0 >= rows_a_pass) return;
  const int c = (threadIdx.x - r0 * cpr) * per;
  const bool col_in = c < width;
  for (int r = r0; r < rows; r += rows_a_pass) {
    const bool in = col_in && r < rows_in;
    copy_async(dst + r * ld + c, in ? src + r * rs + c : src, vec, in);
  }
}

// v rounded to TF32 (10 mantissa bits), to nearest with ties away from
// zero, as cvt.rna.tf32.f32 rounds, by two integer operations: the
// conversion instruction runs at the 16-a-clock conversion rate, and the
// kernels round about 10^8 warps' values a call
__device__ __forceinline__ uint32_t to_tf32(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
}

// v = hi + lo + O(2^-22 |v|), both TF32
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi,
                                           uint32_t& lo) {
  hi = to_tf32(v);
  lo = to_tf32(v - __uint_as_float(hi));
}

// the two bf16 of a packed pair as float32 bits (exact in TF32)
__device__ __forceinline__ uint32_t bf_lo(uint32_t r) { return r << 16; }
__device__ __forceinline__ uint32_t bf_hi(uint32_t r) { return r & 0xffff0000u; }

__device__ __forceinline__ uint32_t bits(float v) { return __float_as_uint(v); }
__device__ __forceinline__ uint32_t bits(bf16 v) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(v)) << 16;
}

// d += a (16 x 8, row) b (8 x 8, col), TF32 in, float32 sums
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a (16 x 16, row) b (16 x 8, col), bf16 in, float32 sums
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// 2^v, the SFU's approximation (relative error about 2^-22)
__device__ __forceinline__ float ex2(float v) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(r) : "f"(v));
  return r;
}

constexpr double kLog2e = 1.4426950408889634;


__device__ __forceinline__ float decay_add(float s, float f, float v) {
  return s * f + v;
}
__device__ __forceinline__ float4 decay_add(float4 s, float f, float4 v) {
  return make_float4(s.x * f + v.x, s.y * f + v.y, s.z * f + v.z, s.w * f + v.w);
}

// The states passed along one (b, h) row by a whole block, in chunk order:
// the row's chunk states S_c (P N floats each, ws) are replaced by the
// states entering each chunk, S_in[c] = S_in[c-1] exp(a_last[c-1]) +
// S_{c-1}, and the state leaving the last chunk is the final state. V = 4
// (T float4) where P N % 4 == 0, else 1 (T float). Other blocks wrote ws and
// acs, so both are read from L2.
template <typename T>
__device__ __forceinline__ void pass_row(float* __restrict__ ws,
                                         const double* __restrict__ acs,
                                         float* __restrict__ state, int PN,
                                         int Q, int nc) {
  constexpr int kV = sizeof(T) / sizeof(float);
  const int cols = PN / kV;
  T* w = reinterpret_cast<T*>(ws);
  for (int e = threadIdx.x; e < cols; e += blockDim.x) {
    T carry{};
    for (int c0 = 0; c0 < nc; c0 += kPassGroup) {   // a group's loads in flight
      T v[kPassGroup];
      float f[kPassGroup];
#pragma unroll
      for (int u = 0; u < kPassGroup; ++u) {
        if (c0 + u < nc) {
          v[u] = __ldcg(w + (long long)(c0 + u) * cols + e);
          f[u] = expf(static_cast<float>(__ldcg(acs + (long long)(c0 + u) * Q + Q - 1)));
        }
      }
#pragma unroll
      for (int u = 0; u < kPassGroup; ++u) {
        if (c0 + u < nc) {
          w[(long long)(c0 + u) * cols + e] = carry;
          carry = decay_add(carry, f[u], v[u]);
        }
      }
    }
    reinterpret_cast<T*>(state)[e] = carry;
  }
}

// (a) grid: b * H * nc blocks, one (b, h, chunk) each. block: 8 warps; warp
// w owns state rows p in [16 (w & 3), +16), columns n in [64 (w >> 2), +64).
template <typename TX>
__global__ void __launch_bounds__(kStateThreads, 3)
ssd_tc_state_kernel(const TX* __restrict__ x, const float* __restrict__ dA,
                    const bf16* __restrict__ Bm, float* __restrict__ ws_state,
                    double* __restrict__ ws_acs, float* __restrict__ state,
                    int* __restrict__ counters, int H, int S, int P, int N,
                    int Q, int nc, int q_pad, Strides st, int vec_x,
                    int vec_b) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kLdX = tc_ldx<TX>();
  constexpr int kStage = tc_state_stage_bytes<TX>();
  double* acs = reinterpret_cast<double*>(smem + kStateStages * kStage);
  float* w_end = reinterpret_cast<float*>(acs + q_pad);

  const long long bhi = blockIdx.x / nc;
  const int c = blockIdx.x % nc;
  const int bi = (int)(bhi / H), hi = (int)(bhi % H);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int pw = warp & 3, nw = warp >> 2;
  const int t0 = c * Q, len = min(Q, S - t0);
  const int ntiles = (len + kTile - 1) / kTile;
  const int xpad = round_up(P, 16), npad = round_up(N, 16);

  const TX* xc = x + bi * st.xb + hi * st.xh + (long long)t0 * st.xs;
  const bf16* bc = Bm + bi * st.bb + hi * st.bh + (long long)t0 * st.bs;
  // tile J into stage J % kStateStages; a group is committed for every J,
  // empty past the last tile, so that the wait below counts alike
  auto load = [&](int J) {
    if (J < ntiles) {
      unsigned char* s = smem + (J % kStateStages) * kStage;
      const int rows = min(kTile, len - J * kTile);
      stage_tile(reinterpret_cast<TX*>(s), kLdX,
                 xc + (long long)J * kTile * st.xs, st.xs, rows, P, xpad, vec_x);
      stage_tile(reinterpret_cast<bf16*>(s + tc_x_bytes<TX>()), kTcLdB,
                 bc + (long long)J * kTile * st.bs, st.bs, rows, N, npad, vec_b);
    }
    copy_commit();
  };
  for (int J = 0; J < kStateStages - 1; ++J) load(J);

  // the chunk's inclusive cumsum of dA in float64 (loads by every thread,
  // the scan by warp 0, 32 steps a pass); steps past len add 0, so they
  // hold a_last. Written out for (b) and (c).
  const float* dc = dA + bi * st.db + hi * st.dh + (long long)t0 * st.ds;
  for (int k = tid; k < q_pad; k += kStateThreads)
    acs[k] = k < len ? static_cast<double>(dc[(long long)k * st.ds]) : 0.0;
  __syncthreads();
  if (warp == 0) {
    double carry = 0.0;
    for (int base = 0; base < q_pad; base += 32) {
      double v = acs[base + lane];
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const double u = __shfl_up_sync(0xffffffffu, v, off);
        if (lane >= off) v += u;
      }
      v += carry;
      acs[base + lane] = v;
      carry = __shfl_sync(0xffffffffu, v, 31);
    }
  }
  __syncthreads();
  const double a_last = acs[len - 1];
  double* acs_out = ws_acs + (bhi * nc + c) * Q;
  for (int k = tid; k < q_pad; k += kStateThreads) {
    if (k < Q) acs_out[k] = acs[k];
    w_end[k] = k < len ? expf(static_cast<float>(a_last - acs[k])) : 0.f;
  }

  // S_c[p, n] = sum_j (x[j, p] w_end[j]) B[j, n]: TF32 with x w split (two
  // products: B is exact in TF32). The k index of a step of 8 is permuted,
  // k = t <-> j = 2t, k = t + 4 <-> j = 2t + 1, so that B's fragment is one
  // transposed ldmatrix of bf16 pairs (j 2t, 2t + 1).
  float acc[8][4] = {};
  const bool active = 16 * pw < P;
  for (int J = 0; J < ntiles; ++J) {
    copy_wait<kStateStages - 2>();
    __syncthreads();   // tile J is in; every warp is done with tile J - 1
    load(J + kStateStages - 1);
    if (active) {
      const unsigned char* s = smem + (J % kStateStages) * kStage;
      const TX* xs = reinterpret_cast<const TX*>(s);
      const bf16* bs = reinterpret_cast<const bf16*>(s + tc_x_bytes<TX>());
      const float* w = w_end + J * kTile;
#pragma unroll 2
      for (int ks = 0; ks < kTile / 8; ++ks) {
        const int j = 8 * ks + 2 * t;
        const float w0 = w[j], w1 = w[j + 1];
        const TX* xr = xs + j * kLdX + 16 * pw + g;
        uint32_t ah[4], al[4];
        split_tf32(to_f(xr[0]) * w0, ah[0], al[0]);          // (p g, j 2t)
        split_tf32(to_f(xr[8]) * w0, ah[1], al[1]);          // (p g + 8, j 2t)
        split_tf32(to_f(xr[kLdX]) * w1, ah[2], al[2]);       // (p g, j 2t + 1)
        split_tf32(to_f(xr[kLdX + 8]) * w1, ah[3], al[3]);   // (p g + 8, j 2t + 1)
        // B of 8 n-tiles; the lo products of all 8, then the hi products,
        // so that no mma waits on the one before it
        uint32_t r[2][4];
        const bool q_in[2] = {64 * nw < N, 64 * nw + 32 < N};
#pragma unroll
        for (int q = 0; q < 2; ++q)
          if (q_in[q])
            ldsm_x4_t(r[q], bs + (8 * ks + (lane & 7)) * kTcLdB + 64 * nw +
                                32 * q + 8 * (lane >> 3));
#pragma unroll
        for (int q = 0; q < 2; ++q)
          if (q_in[q])
#pragma unroll
            for (int m = 0; m < 4; ++m)
              mma_tf32(acc[4 * q + m], al, bf_lo(r[q][m]), bf_hi(r[q][m]));
#pragma unroll
        for (int q = 0; q < 2; ++q)
          if (q_in[q])
#pragma unroll
            for (int m = 0; m < 4; ++m)
              mma_tf32(acc[4 * q + m], ah, bf_lo(r[q][m]), bf_hi(r[q][m]));
      }
    }
  }

  if (active) {
    float* out = ws_state + (bhi * nc + c) * P * N;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int n = 64 * nw + 8 * nt + 2 * t;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int p = 16 * pw + g + 8 * half;
        if (p >= P) continue;
        if (n < N) out[p * N + n] = acc[nt][2 * half];
        if (n + 1 < N) out[p * N + n + 1] = acc[nt][2 * half + 1];
      }
    }
  }

  // (b): the last of the row's nc blocks to finish passes the states along
  // it, and leaves the row's counter at 0 for the next call
  __shared__ int last;
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    last = atomicAdd(counters + bhi, 1) == nc - 1;
    if (last) counters[bhi] = 0;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  const int PN = P * N;
  float* row_ws = ws_state + bhi * nc * PN;
  const double* row_acs = ws_acs + bhi * nc * Q;
  if (PN % 4 == 0)
    pass_row<float4>(row_ws, row_acs, state + bhi * PN, PN, Q, nc);
  else
    pass_row<float>(row_ws, row_acs, state + bhi * PN, PN, Q, nc);
}

// (s) grid: b * HB * nc * T (T + 1) / 2 blocks, T = q_pad / 64, HB = 1
// where the heads share B and C (stride 0 over h), else H: one 64 x 64 tile
// (I, J <= I) of a chunk's scores G = C B^T, bf16 m16n8k16 (exact products,
// float32 sums), written in float32 to a workspace (b, HB, nc, q_pad,
// q_pad) that every head's (c) reads. block: 4 warps of 16 rows.
__global__ void __launch_bounds__(kScoreThreads)
ssd_tc_scores_kernel(const bf16* __restrict__ Bm, const bf16* __restrict__ Cm,
                     float* __restrict__ ws_g, int H, int HB, int S, int N,
                     int Q, int nc, int q_pad, Strides st, int vec_b,
                     int vec_c) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* cs = reinterpret_cast<bf16*>(smem);
  bf16* bs = cs + kTile * kTcLdB;
  const int nt = q_pad / kTile, tiles = nt * (nt + 1) / 2;
  const long long row = blockIdx.x / tiles;
  int k = blockIdx.x % tiles, I = 0;
  while (k > I) k -= ++I;          // tile (I, J = k) of the lower triangle
  const int J = k;
  const long long bhb = row / nc;
  const int c = (int)(row % nc);
  const int bi = (int)(bhb / HB), hb = (int)(bhb % HB);
  const int t0 = c * Q, len = min(Q, S - t0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int npad = round_up(N, 16), nks16 = npad / 16;
  // tiles past the chunk's length are zeros (their base stays in the chunk)
  const int ci = I * kTile < len ? I * kTile : 0, bj = J * kTile < len ? J * kTile : 0;
  const bf16* cc = Cm + bi * st.cb + hb * st.ch + (long long)(t0 + ci) * st.cs;
  const bf16* bc = Bm + bi * st.bb + hb * st.bh + (long long)(t0 + bj) * st.bs;
  stage_tile(cs, kTcLdB, cc, st.cs, max(0, min(kTile, len - I * kTile)), N,
             npad, vec_c);
  stage_tile(bs, kTcLdB, bc, st.bs, max(0, min(kTile, len - J * kTile)), N,
             npad, vec_b);
  copy_commit();
  copy_wait<0>();
  __syncthreads();
  float acc[8][4] = {};
#pragma unroll
  for (int ks = 0; ks < 8; ++ks) {
    if (ks >= nks16) continue;
    uint32_t a[4];
    ldsm_x4(a, cs + (16 * warp + (lane & 7) + 8 * ((lane >> 3) & 1)) * kTcLdB +
                   16 * ks + 8 * (lane >> 4));
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      uint32_t r[4];
      ldsm_x4(r, bs + (16 * q + (lane & 7) + 8 * (lane >> 4)) * kTcLdB +
                     16 * ks + 8 * ((lane >> 3) & 1));
      mma_bf16(acc[2 * q], a, r[0], r[1]);
      mma_bf16(acc[2 * q + 1], a, r[2], r[3]);
    }
  }
  float* out = ws_g + row * q_pad * q_pad +
               (long long)(I * kTile + 16 * warp + g) * q_pad + J * kTile + 2 * t;
#pragma unroll
  for (int n8 = 0; n8 < 8; ++n8) {
    *reinterpret_cast<float2*>(out + 8 * n8) = make_float2(acc[n8][0], acc[n8][1]);
    *reinterpret_cast<float2*>(out + 8 * q_pad + 8 * n8) =
        make_float2(acc[n8][2], acc[n8][3]);
  }
}

// (c) grid: b * H * nc * ceil(Q / kOutRows) blocks, a chunk's row tiles
// adjacent (the last, which reads most, first), so that they find the
// chunk's x, scores and S_in in L2. block: a warp per 16 rows: warp w owns
// rows i0 + 16 w + [0, 16) of its row tile and all P columns. The ring
// takes, in order: the C tile, S_in, nothing (its stage takes S_in's TF32
// lo half), then the x tile and the scores tile (the block's rows x 64
// columns) of columns j0 = 0, 64, .. up to the row tile's last row.
template <typename TX>
__global__ void __launch_bounds__(kOutThreads, 2)
ssd_tc_out_kernel(const TX* __restrict__ x, const bf16* __restrict__ Cm,
                  const float* __restrict__ ws_state,
                  const double* __restrict__ ws_acs,
                  const float* __restrict__ ws_g, TX* __restrict__ y, int H,
                  int HB, int S, int P, int N, int Q, int nc, int q_pad,
                  Strides st, int vec_x, int vec_c) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kLdX = tc_ldx<TX>();
  constexpr int kStage = tc_out_stage_bytes<TX>();
  constexpr int kGOff = tc_x_bytes<TX>();   // the scores tile in a stage
  double* acs = reinterpret_cast<double*>(smem + kOutStages * kStage);

  const int rt = (Q + kOutRows - 1) / kOutRows;
  const long long row = blockIdx.x / rt;
  const long long bhi = row / nc;
  const int c = (int)(row % nc), I = rt - 1 - (int)(blockIdx.x % rt);
  const int bi = (int)(bhi / H), hi = (int)(bhi % H);
  const int t0 = c * Q, len = min(Q, S - t0), i0 = I * kOutRows;
  if (i0 >= len) return;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int xpad = round_up(P, 16), npad = round_up(N, 16);
  const int nks16 = npad / 16, nks8 = round_up(N, 8) / 8;
  const int np8 = round_up(P, 8) / 8;
  const int vec_s = N % 4 == 0 ? 16 : 4;

  const TX* xc = x + bi * st.xb + hi * st.xh + (long long)t0 * st.xs;
  const bf16* cc = Cm + bi * st.cb + hi * st.ch + (long long)(t0 + i0) * st.cs;
  const float* s_in = ws_state + (bhi * nc + c) * P * N;
  const long long row_g = ((long long)bi * HB + (HB == 1 ? 0 : hi)) * nc + c;
  const float* gc = ws_g + row_g * q_pad * q_pad + (long long)i0 * q_pad;
  // j tiles up to the one holding the block's last row
  const int nj = (min(i0 + kOutRows, len) + kTile - 1) / kTile;
  const int nload = 3 + nj;
  static_assert(kOutStages >= 2, "S_in and its lo half in two stages");
  constexpr int kLoStage = 2 % kOutStages;   // the stage of load 2
  // load k into stage k % kOutStages; a group is committed for every k,
  // empty for load 2 and past the last load, so that the wait counts alike
  auto load = [&](int k) {
    unsigned char* s = smem + (k % kOutStages) * kStage;
    if (k == 2 || k >= nload) {
    } else if (k == 0) {
      stage_tile(reinterpret_cast<bf16*>(s), kTcLdB, cc, st.cs,
                 min(kOutRows, len - i0), N, npad, vec_c, kOutRows);
    } else if (k == 1) {
      stage_tile(reinterpret_cast<float*>(s), kTcLdS, s_in, N, P, N,
                 round_up(N, 8), vec_s);
    } else {
      const int j0 = (k - 3) * kTile;
      const int rows = min(kTile, len - j0);
      stage_tile(reinterpret_cast<TX*>(s), kLdX, xc + (long long)j0 * st.xs,
                 st.xs, rows, P, xpad, vec_x);
      // the scores of the rows that read this tile: those of 64-row groups
      // at or past it
      const int r0 = max(0, j0 - i0);
      stage_tile(reinterpret_cast<float*>(s + kGOff) + r0 * kTcLdG, kTcLdG,
                 gc + (long long)r0 * q_pad + j0, q_pad,
                 min(kOutRows, q_pad - i0) - r0, kTile, kTile, 16,
                 kOutRows - r0);
    }
    copy_commit();
  };
  for (int k = 0; k < kOutStages - 1; ++k) load(k);
  // the cumsum up to the tile's last row, times log2(e) (the decays are
  // powers of 2); rows past Q repeat a_last
  const double* acs_in = ws_acs + (bhi * nc + c) * Q;
  for (int k = tid; k < i0 + kOutRows; k += kOutThreads)
    acs[k] = acs_in[min(k, Q - 1)] * kLog2e;

  const int r_lo = 16 * warp + g;               // the warp's rows in the tile
  const int i_lo = i0 + r_lo, i_hi = i_lo + 8;  // and in the chunk
  const int jt = (i0 + 16 * warp) / kTile;      // the j tile of its diagonal
  const int jq = (16 * warp) % kTile / 16;      // its 16 columns there
  const bool active = i0 + 16 * warp < len;
  uint32_t cf[8][4];        // C's rows as bf16 pairs, 16 n a step
  double a_lo = 0.0, a_hi = 0.0;
  float acc[8][4] = {};     // y, 16 rows x 64 p

  for (int k = 0; k < nload; ++k) {
    copy_wait<kOutStages - 2>();
    __syncthreads();   // load k is in; every warp is done with load k - 1
    load(k + kOutStages - 1);
    const unsigned char* s = smem + (k % kOutStages) * kStage;
    if (k == 1 && c > 0) {
      // every warp reads all of S_in: split it once, its TF32 hi in place
      // and its lo into the stage that load 2 leaves empty
      float* shi = reinterpret_cast<float*>(smem + kStage);
      float* slo = reinterpret_cast<float*>(smem + kLoStage * kStage);
      const int q4 = round_up(N, 8) / 4, rows_a_pass = kOutThreads / q4;
      const int r0 = tid / q4, c4 = 4 * (tid - r0 * q4);
      if (r0 < rows_a_pass) {
        for (int r = r0; r < P; r += rows_a_pass) {
          float4 v = *reinterpret_cast<const float4*>(shi + r * kTcLdS + c4);
          uint32_t h[4], l[4];
          split_tf32(v.x, h[0], l[0]);
          split_tf32(v.y, h[1], l[1]);
          split_tf32(v.z, h[2], l[2]);
          split_tf32(v.w, h[3], l[3]);
          *reinterpret_cast<uint4*>(shi + r * kTcLdS + c4) = make_uint4(h[0], h[1], h[2], h[3]);
          *reinterpret_cast<uint4*>(slo + r * kTcLdS + c4) = make_uint4(l[0], l[1], l[2], l[3]);
        }
      }
      __syncthreads();
    }
    if (!active || k == 2) {
    } else if (k == 0) {
      const bf16* cs = reinterpret_cast<const bf16*>(s);
#pragma unroll
      for (int ks = 0; ks < 8; ++ks)
        if (ks < nks16)
          ldsm_x4(cf[ks], cs + (16 * warp + (lane & 7) + 8 * ((lane >> 3) & 1)) *
                                   kTcLdB + 16 * ks + 8 * (lane >> 4));
      a_lo = acs[i_lo];
      a_hi = acs[i_hi];
    } else if (k == 1) {
      // exp(a_i) C_i . S_in: C exact in TF32, S_in split (two products).
      // The k index of a step of 8 is permuted as n = n0 + 2t, n0 + 2t + 1,
      // which makes the A fragment the halves of C's bf16 pairs.
      if (c > 0) {
        const float* ss = reinterpret_cast<const float*>(s);
        const float* sl = reinterpret_cast<const float*>(smem + kLoStage * kStage);
#pragma unroll
        for (int ks8 = 0; ks8 < 16; ++ks8) {
          if (ks8 >= nks8) continue;
          const uint32_t rg = cf[ks8 >> 1][2 * (ks8 & 1)];
          const uint32_t rg8 = cf[ks8 >> 1][2 * (ks8 & 1) + 1];
          const uint32_t a[4] = {bf_lo(rg), bf_lo(rg8), bf_hi(rg), bf_hi(rg8)};
#pragma unroll
          for (int pt = 0; pt < 8; ++pt) {
            if (pt >= np8) continue;
            const int o = (8 * pt + g) * kTcLdS + 8 * ks8 + 2 * t;
            const float2 sh = *reinterpret_cast<const float2*>(ss + o);
            const float2 slv = *reinterpret_cast<const float2*>(sl + o);
            mma_tf32(acc[pt], a, bits(slv.x), bits(slv.y));
            mma_tf32(acc[pt], a, bits(sh.x), bits(sh.y));
          }
        }
        const float e_lo = ex2(static_cast<float>(a_lo));
        const float e_hi = ex2(static_cast<float>(a_hi));
#pragma unroll
        for (int pt = 0; pt < 8; ++pt) {
          acc[pt][0] *= e_lo;
          acc[pt][1] *= e_lo;
          acc[pt][2] *= e_hi;
          acc[pt][3] *= e_hi;
        }
      }
    } else {
      const int J = k - 3, j0 = J * kTile;
      const TX* xs = reinterpret_cast<const TX*>(s);
      const float* gs = reinterpret_cast<const float*>(s + kGOff);
      // 8-column steps of the tile at or before the warp's last row, and
      // before len
      int steps = J < jt ? 8 : J == jt ? 2 * jq + 2 : 0;
      steps = min(steps, (len - j0 + 7) / 8);
      for (int n8 = 0; n8 < steps; ++n8) {
        const int jl = 8 * n8 + 2 * t;   // the tile's columns of this thread
        const int j = j0 + jl;
        const float2 g_lo = *reinterpret_cast<const float2*>(gs + r_lo * kTcLdG + jl);
        const float2 g_hi = *reinterpret_cast<const float2*>(gs + (r_lo + 8) * kTcLdG + jl);
        const double aj0 = acs[j], aj1 = acs[j + 1];
        // the scores decayed by 2^(log2(e) (a_i - a_j)) only where j <= i:
        // the power is never positive
        const float s0 = j <= i_lo ? g_lo.x * ex2(static_cast<float>(a_lo - aj0)) : 0.f;
        const float s1 = j + 1 <= i_lo ? g_lo.y * ex2(static_cast<float>(a_lo - aj1)) : 0.f;
        const float s2 = j <= i_hi ? g_hi.x * ex2(static_cast<float>(a_hi - aj0)) : 0.f;
        const float s3 = j + 1 <= i_hi ? g_hi.y * ex2(static_cast<float>(a_hi - aj1)) : 0.f;
        // y += scores . x. The A fragment with k = t <-> column 2t, k = t + 4
        // <-> 2t + 1: a0 (row g, k t), a1 (g + 8, t), a2 (g, t + 4), a3
        // (g + 8, t + 4); x's B fragment read with the same permutation
        uint32_t ah[4], al[4];
        split_tf32(s0, ah[0], al[0]);
        split_tf32(s2, ah[1], al[1]);
        split_tf32(s1, ah[2], al[2]);
        split_tf32(s3, ah[3], al[3]);
        const TX* xr = xs + jl * kLdX + g;
#pragma unroll
        for (int pt = 0; pt < 8; ++pt) {
          if (pt >= np8) continue;
          if constexpr (sizeof(TX) == 4) {
            uint32_t xh0, xl0, xh1, xl1;
            split_tf32(to_f(xr[8 * pt]), xh0, xl0);
            split_tf32(to_f(xr[kLdX + 8 * pt]), xh1, xl1);
            mma_tf32(acc[pt], al, xh0, xh1);
            mma_tf32(acc[pt], ah, xl0, xl1);
            mma_tf32(acc[pt], ah, xh0, xh1);
          } else {   // bf16 x is exact in TF32
            const uint32_t x0 = bits(xr[8 * pt]), x1 = bits(xr[kLdX + 8 * pt]);
            mma_tf32(acc[pt], al, x0, x1);
            mma_tf32(acc[pt], ah, x0, x1);
          }
        }
      }
    }
  }

  if (!active) return;
  const long long y_rs = (long long)H * P;
  TX* yb = y + ((long long)bi * S * H + hi) * P;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int i = (half ? i_hi : i_lo);
    if (i >= len) continue;
    TX* yr = yb + (long long)(t0 + i) * y_rs;
#pragma unroll
    for (int pt = 0; pt < 8; ++pt) {
      const int p = 8 * pt + 2 * t;
      if constexpr (sizeof(TX) == 4) {   // float32 y, even P: one 8-byte store
        if ((P & 1) == 0 && p < P) {
          *reinterpret_cast<float2*>(yr + p) =
              make_float2(acc[pt][2 * half], acc[pt][2 * half + 1]);
          continue;
        }
      }
      if (p < P) from_f(acc[pt][2 * half], yr + p);
      if (p + 1 < P) from_f(acc[pt][2 * half + 1], yr + p + 1);
    }
  }
}

// a copy width stage_tile takes: 16, 8 or 4 bytes, or 2 for bf16
__host__ __device__ constexpr bool copy_width_ok(int vec, int is_bf16) {
  return vec == 16 || vec == 8 || vec == 4 || (vec == 2 && is_bf16);
}

// (a) and (c) take more than 48 KB of dynamic shared memory
template <typename TX>
int tc_attributes(int q_pad) {
  cudaError_t err = cudaFuncSetAttribute(
      ssd_tc_state_kernel<TX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)tc_state_smem<TX>(q_pad));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        ssd_tc_out_kernel<TX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)tc_out_smem<TX>(q_pad));
  return static_cast<int>(err);
}

// (a) with (b), (s), (c) in order on one stream
template <typename TX>
int launch_tc(const void* x, const void* dA, const void* B, const void* C,
              void* y, void* state, void* ws_state, void* ws_acs, void* ws_g,
              int* counters, int b, int S, int H, int HB, int P, int N, int Q,
              const Strides& st, int vec_x, int vec_b, int vec_c,
              cudaStream_t stream) {
  const int nc = (S + Q - 1) / Q;
  const int q_pad = round_up(Q, kTile);
  const long long bh = (long long)b * H;
  int code = tc_attributes<TX>(q_pad);
  if (code != 0) return code;
  ssd_tc_state_kernel<TX><<<(unsigned)(bh * nc), kStateThreads,
                            tc_state_smem<TX>(q_pad), stream>>>(
      static_cast<const TX*>(x), static_cast<const float*>(dA),
      static_cast<const bf16*>(B), static_cast<float*>(ws_state),
      static_cast<double*>(ws_acs), static_cast<float*>(state), counters, H, S,
      P, N, Q, nc, q_pad, st, vec_x, vec_b);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const int nt = q_pad / kTile;
  ssd_tc_scores_kernel<<<(unsigned)((long long)b * HB * nc * (nt * (nt + 1) / 2)),
                         kScoreThreads, kScoreSmem, stream>>>(
      static_cast<const bf16*>(B), static_cast<const bf16*>(C),
      static_cast<float*>(ws_g), H, HB, S, N, Q, nc, q_pad, st, vec_b, vec_c);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const int rt = (Q + kOutRows - 1) / kOutRows;
  ssd_tc_out_kernel<TX><<<(unsigned)(bh * nc * rt), kOutThreads,
                          tc_out_smem<TX>(q_pad), stream>>>(
      static_cast<const TX*>(x), static_cast<const bf16*>(C),
      static_cast<const float*>(ws_state), static_cast<const double*>(ws_acs),
      static_cast<const float*>(ws_g), static_cast<TX*>(y), H, HB, S, P, N, Q,
      nc, q_pad, st, vec_x, vec_c);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// Backward of the chunk scan, the "fma" route (float32 B and C; see the
// header): three launches a call, the backward's own chunks of kBQ steps,
// float32 FMAs on the CUDA cores, the cumsums in float64, every sum in a
// fixed order
// ---------------------------------------------------------------------------

constexpr int kBQ = 64;            // the backward's chunk (any chunk gives the
                                   // same function; 64 keeps a chunk's Q x Q
                                   // matrices in shared memory)
constexpr int kBThreads = 256;

// the row's inclusive cumsum of dA over chunk [t0, t0 + kBQ) in float64, 0
// past S (identity steps), by one thread, in order
__device__ __forceinline__ void bwd_cumsum(double* cs, const float* dA,
                                           long long ds, int t0, int S) {
  if (threadIdx.x == 0) {
    double acc = 0.0;
    for (int i = 0; i < kBQ; ++i) {
      if (t0 + i < S) acc += (double)dA[(long long)(t0 + i) * ds];
      cs[i] = acc;
    }
  }
}

// rows [t0, t0 + kBQ) of a (b, s, h, width) row-strided input as float32 into
// tile[kBQ][stride], each row scaled by scale[r] (or not, if null); 0 past S
template <typename T>
__device__ __forceinline__ void bwd_stage(float* tile, int stride, const T* src,
                                          long long row_stride, int t0, int S,
                                          int width, const float* scale) {
  for (int e = threadIdx.x; e < kBQ * width; e += kBThreads) {
    const int r = e / width, c = e % width;
    float v = t0 + r < S ? to_f(src[(long long)(t0 + r) * row_stride + c]) : 0.f;
    if (scale) v *= scale[r];
    tile[r * stride + c] = v;
  }
}

// (1) grid (nc, b * H): the chunk's own state U = sum_s exp(a_end - a_s)
//     x_s B_s^T and its state gradient D = sum_l exp(a_l) dy_l C_l^T (both
//     P x N), and its decay exp(a_end).
template <typename TX, typename TBC>
__global__ void __launch_bounds__(kBThreads)
ssd_bwd_chunk_kernel(const TX* __restrict__ x, const float* __restrict__ dA,
                     const TBC* __restrict__ B, const TBC* __restrict__ C,
                     const TX* __restrict__ dy, float* __restrict__ ws_u,
                     float* __restrict__ ws_d, float* __restrict__ ws_a, int H,
                     int S, int P, int N, int nc, Strides st) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  double* cs = reinterpret_cast<double*>(smem_raw);
  float* ev = reinterpret_cast<float*>(cs + kBQ);  // exp(a_end - a_s)
  float* fv = ev + kBQ;                            // exp(a_l)
  float* Xs = fv + kBQ;                            // [kBQ][P], scaled by ev
  float* Ys = Xs + kBQ * P;                        // [kBQ][P], dy scaled by fv
  float* Bs = Ys + kBQ * P;                        // [kBQ][N]
  float* Cs = Bs + kBQ * N;                        // [kBQ][N]

  const int c = blockIdx.x, t0 = c * kBQ;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const float* dAp = dA + b * st.db + h * st.dh;
  bwd_cumsum(cs, dAp, st.ds, t0, S);
  __syncthreads();
  for (int i = threadIdx.x; i < kBQ; i += kBThreads) {
    ev[i] = expf((float)(cs[kBQ - 1] - cs[i]));
    fv[i] = expf((float)cs[i]);
  }
  __syncthreads();
  bwd_stage(Xs, P, x + b * st.xb + h * st.xh, st.xs, t0, S, P, ev);
  bwd_stage(Ys, P, dy + ((long long)b * S * H + h) * P, (long long)H * P, t0, S,
            P, fv);
  bwd_stage(Bs, N, B + b * st.bb + h * st.bh, st.bs, t0, S, N, nullptr);
  bwd_stage(Cs, N, C + b * st.cb + h * st.ch, st.cs, t0, S, N, nullptr);
  __syncthreads();
  const size_t base = ((size_t)blockIdx.y * nc + c) * P * N;
  for (int e = threadIdx.x; e < P * N; e += kBThreads) {
    const int p = e / N, n = e % N;
    float u = 0.f, d = 0.f;
    for (int r = 0; r < kBQ; ++r) {
      u = fmaf(Xs[r * P + p], Bs[r * N + n], u);
      d = fmaf(Ys[r * P + p], Cs[r * N + n], d);
    }
    ws_u[base + e] = u;
    ws_d[base + e] = d;
  }
  if (threadIdx.x == 0) ws_a[(size_t)blockIdx.y * nc + c] = fv[kBQ - 1];
}

// (2) grid (ceil(P N / 256), b * H): along each (b, h) row, in place, the
//     state entering each chunk, H_in[c] = exp(a_end[c-1]) H_in[c-1] +
//     U[c-1] (H_in[0] = 0) over ws_u, and the gradient of the state leaving
//     it, G[c] = exp(a_end[c+1]) G[c+1] + D[c+1] (G[last] = the final
//     state's gradient) over ws_d.
__global__ void __launch_bounds__(kBThreads)
ssd_bwd_pass_kernel(float* __restrict__ ws_u, float* __restrict__ ws_d,
                    const float* __restrict__ ws_a,
                    const float* __restrict__ dstate, int P, int N, int nc) {
  const int e = blockIdx.x * kBThreads + threadIdx.x;
  if (e >= P * N) return;
  const size_t row = blockIdx.y;
  const size_t pn = (size_t)P * N;
  float* u = ws_u + row * nc * pn + e;
  float* d = ws_d + row * nc * pn + e;
  const float* a = ws_a + row * nc;
  float hs = 0.f;
  for (int c = 0; c < nc; ++c) {
    const float uc = u[c * pn];
    u[c * pn] = hs;
    hs = fmaf(a[c], hs, uc);
  }
  float g = dstate[row * pn + e];
  for (int c = nc - 1; c >= 0; --c) {
    const float dc = d[c * pn];
    d[c * pn] = g;
    g = fmaf(a[c], g, dc);
  }
}

// deterministic sum over a block of kWarps warps (a fixed tree, then the
// warps in order); every thread gets it
template <int kWarps>
__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float t = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) t += red[w];
  return t;
}

// (3) grid (nc, b * H): the chunk's gradients, from its inputs, dy, the state
//     entering it (H_in, ws_u after (2)) and the gradient of the state
//     leaving it (G, ws_d after (2)); with L[l, s] = exp(a_l - a_s) for
//     s <= l (else 0), e_s = exp(a_end - a_s), f_l = exp(a_l):
//   dx_s  = sum_{l >= s} L[l,s] (C_l . B_s) dy_l + e_s G B_s
//   dB_s  = sum_{l >= s} L[l,s] (dy_l . x_s) C_l + e_s G^T x_s
//   dC_l  = sum_{s <= l} L[l,s] (dy_l . x_s) B_s + f_l H_in^T dy_l
//   da_l  = sum_s T[l,s] - sum_s T[s,l] + f_l dy_l . (H_in C_l) - F_l
//           (+ f_end <G, H_in> + sum_s F_s at l = end),
//           T[l,s] = L[l,s] (C_l . B_s)(dy_l . x_s), F_s = e_s x_s . (G B_s)
//   d(dA)_t = sum_{l >= t} da_l within the chunk (a_l sums dA over [0, l]).
// dB and dC are written per head, float32; summing them over heads that
// share B and C is left to the caller (autograd's expand).
template <typename TX, typename TBC>
__global__ void __launch_bounds__(kBThreads)
ssd_bwd_grad_kernel(const TX* __restrict__ x, const float* __restrict__ dA,
                    const TBC* __restrict__ B, const TBC* __restrict__ C,
                    const TX* __restrict__ dy, const float* __restrict__ ws_h,
                    const float* __restrict__ ws_g, TX* __restrict__ dx,
                    float* __restrict__ ddA, float* __restrict__ dB,
                    float* __restrict__ dC, int H, int S, int P, int N, int nc,
                    Strides st) {
  constexpr int QS = kBQ + 1;
  const int PS = P + 1, NS = N + 1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  double* cs = reinterpret_cast<double*>(smem_raw);
  float* ev = reinterpret_cast<float*>(cs + kBQ);
  float* fv = ev + kBQ;
  float* Fv = fv + kBQ;        // F_s
  float* dcs = Fv + kBQ;       // da_l
  float* red = dcs + kBQ;      // [kBThreads / 32]
  float* Xs = red + kBThreads / 32;  // [kBQ][P + 1]
  float* Ys = Xs + kBQ * PS;         // dy, [kBQ][P + 1]
  float* Bs = Ys + kBQ * PS;         // [kBQ][N + 1]
  float* Cs = Bs + kBQ * NS;         // [kBQ][N + 1]
  float* Hs = Cs + kBQ * NS;         // G, then H_in: [P][N + 1]
  float* M = Hs + P * NS;            // L (C . B), [l][s]
  float* LX = M + kBQ * QS;          // L (dy . x), [l][s]
  float* Tt = LX + kBQ * QS;         // T, then scratch [kBQ][P + 1]

  const int c = blockIdx.x, t0 = c * kBQ;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  bwd_cumsum(cs, dA + b * st.db + h * st.dh, st.ds, t0, S);
  const size_t wbase = ((size_t)blockIdx.y * nc + c) * P * N;
  for (int e = threadIdx.x; e < P * N; e += kBThreads)
    Hs[(e / N) * NS + e % N] = ws_g[wbase + e];
  const long long y_rows = (long long)H * P;
  const TX* dyp = dy + ((long long)b * S * H + h) * P;
  bwd_stage(Xs, PS, x + b * st.xb + h * st.xh, st.xs, t0, S, P, nullptr);
  bwd_stage(Ys, PS, dyp, y_rows, t0, S, P, nullptr);
  bwd_stage(Bs, NS, B + b * st.bb + h * st.bh, st.bs, t0, S, N, nullptr);
  bwd_stage(Cs, NS, C + b * st.cb + h * st.ch, st.cs, t0, S, N, nullptr);
  __syncthreads();
  for (int i = threadIdx.x; i < kBQ; i += kBThreads) {
    ev[i] = expf((float)(cs[kBQ - 1] - cs[i]));
    fv[i] = expf((float)cs[i]);
  }
  // the Q x Q matrices of the chunk
  for (int e = threadIdx.x; e < kBQ * kBQ; e += kBThreads) {
    const int l = e / kBQ, s = e % kBQ;
    float m = 0.f, lx = 0.f, t = 0.f;
    if (s <= l) {
      const float L = expf((float)(cs[l] - cs[s]));
      float cb = 0.f, xd = 0.f;
      for (int n = 0; n < N; ++n) cb = fmaf(Cs[l * NS + n], Bs[s * NS + n], cb);
      for (int p = 0; p < P; ++p) xd = fmaf(Ys[l * PS + p], Xs[s * PS + p], xd);
      m = L * cb;
      lx = L * xd;
      t = m * xd;
    }
    M[l * QS + s] = m;
    LX[l * QS + s] = lx;
    Tt[l * QS + s] = t;
  }
  __syncthreads();
  for (int l = threadIdx.x; l < kBQ; l += kBThreads) {
    float row = 0.f, col = 0.f;
    for (int s = 0; s < kBQ; ++s) {
      row += Tt[l * QS + s];
      col += Tt[s * QS + l];
    }
    dcs[l] = row - col;
  }
  __syncthreads();  // T's readers are done: Tt is scratch from here

  // dx, with x_s . (G B_s) into the scratch
  TX* dxp = dx + ((long long)b * S * H + h) * P;
  for (int e = threadIdx.x; e < kBQ * P; e += kBThreads) {
    const int s = e / P, p = e % P;
    float acc = 0.f, r = 0.f;
    for (int l = s; l < kBQ; ++l) acc = fmaf(M[l * QS + s], Ys[l * PS + p], acc);
    for (int n = 0; n < N; ++n) r = fmaf(Hs[p * NS + n], Bs[s * NS + n], r);
    Tt[s * PS + p] = Xs[s * PS + p] * r;
    if (t0 + s < S) from_f(fmaf(ev[s], r, acc), dxp + (long long)(t0 + s) * y_rows + p);
  }
  // dB
  const long long g_rows = (long long)H * N;
  float* dBp = dB + ((long long)b * S * H + h) * N;
  float* dCp = dC + ((long long)b * S * H + h) * N;
  for (int e = threadIdx.x; e < kBQ * N; e += kBThreads) {
    const int s = e / N, n = e % N;
    float acc = 0.f, r = 0.f;
    for (int l = s; l < kBQ; ++l) acc = fmaf(LX[l * QS + s], Cs[l * NS + n], acc);
    for (int p = 0; p < P; ++p) r = fmaf(Hs[p * NS + n], Xs[s * PS + p], r);
    if (t0 + s < S) dBp[(long long)(t0 + s) * g_rows + n] = fmaf(ev[s], r, acc);
  }
  __syncthreads();
  for (int s = threadIdx.x; s < kBQ; s += kBThreads) {
    float f = 0.f;
    for (int p = 0; p < P; ++p) f += Tt[s * PS + p];
    Fv[s] = ev[s] * f;
  }
  // <G, H_in>, and H_in over G in Hs (each thread its own entries)
  float hd = 0.f;
  for (int e = threadIdx.x; e < P * N; e += kBThreads) {
    const float hin = ws_h[wbase + e];
    float* at = Hs + (e / N) * NS + e % N;
    hd = fmaf(*at, hin, hd);
    *at = hin;
  }
  const float hdot = block_sum<kBThreads / 32>(hd, red);  // its barriers also end F's reads

  // dC, with dy_l . (H_in C_l) into the scratch
  for (int e = threadIdx.x; e < kBQ * N; e += kBThreads) {
    const int l = e / N, n = e % N;
    float acc = 0.f, w = 0.f;
    for (int s = 0; s <= l; ++s) acc = fmaf(LX[l * QS + s], Bs[s * NS + n], acc);
    for (int p = 0; p < P; ++p) w = fmaf(Hs[p * NS + n], Ys[l * PS + p], w);
    if (t0 + l < S) dCp[(long long)(t0 + l) * g_rows + n] = fmaf(fv[l], w, acc);
  }
  for (int e = threadIdx.x; e < kBQ * P; e += kBThreads) {
    const int l = e / P, p = e % P;
    float v = 0.f;
    for (int n = 0; n < N; ++n) v = fmaf(Hs[p * NS + n], Cs[l * NS + n], v);
    Tt[l * PS + p] = Ys[l * PS + p] * v;
  }
  __syncthreads();
  for (int l = threadIdx.x; l < kBQ; l += kBThreads) {
    float ev_l = 0.f;
    for (int p = 0; p < P; ++p) ev_l += Tt[l * PS + p];
    dcs[l] += fv[l] * ev_l - Fv[l];
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float fsum = 0.f;
    for (int s = 0; s < kBQ; ++s) fsum += Fv[s];
    dcs[kBQ - 1] += fv[kBQ - 1] * hdot + fsum;
    float acc = 0.f;
    float* ddAp = ddA + ((long long)b * S * H + h);
    for (int t = kBQ - 1; t >= 0; --t) {
      acc += dcs[t];
      if (t0 + t < S) ddAp[(long long)(t0 + t) * H] = acc;
    }
  }
}

size_t bwd_chunk_smem(int P, int N) {
  return sizeof(double) * kBQ + sizeof(float) * (2 * kBQ + 2 * kBQ * P + 2 * kBQ * N);
}

size_t bwd_grad_smem(int P, int N) {
  return sizeof(double) * kBQ +
         sizeof(float) * (4 * kBQ + kBThreads / 32 + 2 * kBQ * (P + 1) +
                          2 * kBQ * (N + 1) + P * (N + 1) + 3 * kBQ * (kBQ + 1));
}

template <typename TX, typename TBC>
int launch_bwd(const void* x, const void* dA, const void* B, const void* C,
               const void* dy, const void* dstate, void* dx, void* ddA,
               void* dB, void* dC, void* ws_u, void* ws_d, void* ws_a, int b,
               int S, int H, int P, int N, const Strides& st,
               cudaStream_t stream) {
  const int nc = (S + kBQ - 1) / kBQ;
  const dim3 grid(nc, b * H);
  const size_t smem1 = bwd_chunk_smem(P, N), smem3 = bwd_grad_smem(P, N);
  cudaError_t err = cudaFuncSetAttribute(ssd_bwd_chunk_kernel<TX, TBC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem1);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(ssd_bwd_grad_kernel<TX, TBC>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem3);
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_bwd_chunk_kernel<TX, TBC><<<grid, kBThreads, smem1, stream>>>(
      static_cast<const TX*>(x), static_cast<const float*>(dA),
      static_cast<const TBC*>(B), static_cast<const TBC*>(C),
      static_cast<const TX*>(dy), static_cast<float*>(ws_u),
      static_cast<float*>(ws_d), static_cast<float*>(ws_a), H, S, P, N, nc, st);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_bwd_pass_kernel<<<dim3((P * N + kBThreads - 1) / kBThreads, b * H),
                        kBThreads, 0, stream>>>(
      static_cast<float*>(ws_u), static_cast<float*>(ws_d),
      static_cast<const float*>(ws_a), static_cast<const float*>(dstate), P, N,
      nc);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_bwd_grad_kernel<TX, TBC><<<grid, kBThreads, smem3, stream>>>(
      static_cast<const TX*>(x), static_cast<const float*>(dA),
      static_cast<const TBC*>(B), static_cast<const TBC*>(C),
      static_cast<const TX*>(dy), static_cast<const float*>(ws_u),
      static_cast<const float*>(ws_d), static_cast<TX*>(dx),
      static_cast<float*>(ddA), static_cast<float*>(dB), static_cast<float*>(dC),
      H, S, P, N, nc, st);
  return static_cast<int>(cudaGetLastError());
}


// ---------------------------------------------------------------------------
// Backward of the chunk scan on the tensor cores (bf16 B and C; x float32 or
// bf16): two launches a call in chunks of kBQ, the same function as the
// CUDA-core kernels above with every product an `mma.sync`
// ---------------------------------------------------------------------------

constexpr int kLdF = kMaxP + 4;     // float x and dy tile rows: the fragment
                                    // reads (row g, column t) and (row 2t,
                                    // column g) fall on 32 distinct banks
constexpr int kLdGH = kMaxN + 8;    // G / H_in rows (float): (row g, columns
                                    // 2t, 2t + 1) and (row t, column g) too
constexpr int kTbStateThreads = 256;   // (1): 8 warps, 16 p x 64 n each
constexpr int kTbGradThreads = 128;    // (2): 4 warps, 16 rows of the chunk each
constexpr int kTbPassGroup = 8;        // (1): chunk states loaded at once
constexpr int kTbTileF = kBQ * kLdF * 4;       // 17,408 B
constexpr int kTbTileBC = kBQ * kTcLdB * 2;    // 17,408 B
constexpr int kTbTileGH = kMaxP * kLdGH * 4;   // 34,816 B

// x and dy tiles, B and C tiles, the cumsum (float64), e and f
constexpr size_t tb_state_smem() {
  return 2 * kTbTileF + 2 * kTbTileBC + kBQ * (sizeof(double) + 2 * sizeof(float));
}
// x, dy, B, C, the G / H_in tile, the cumsum, e, f and four row vectors
// (column and row sums of T, F, w), and a block sum's warp partials
constexpr size_t tb_grad_smem() {
  return 2 * kTbTileF + 2 * kTbTileBC + kTbTileGH +
         kBQ * (sizeof(double) + 6 * sizeof(float)) +
         (kTbGradThreads / 32) * sizeof(float);
}

// rows [0, kBQ) of a (b, s, h, width) input as float32 into a tile of kLdF
// columns, zeros at rows >= rows_in and columns >= width up to kMaxP: copies
// of vec bytes in flight for float (committed by the caller), plain loads
// converted for bf16
template <typename TX>
__device__ __forceinline__ void stage_f32(float* dst, const TX* src,
                                          long long rs, int rows_in,
                                          int width, int vec) {
  if constexpr (sizeof(TX) == 4) {
    stage_tile(dst, kLdF, src, rs, rows_in, width, kMaxP, vec);
  } else {
    for (int e = threadIdx.x; e < kBQ * kMaxP; e += blockDim.x) {
      const int r = e / kMaxP, c = e % kMaxP;
      dst[r * kLdF + c] =
          r < rows_in && c < width ? to_f(src[(long long)r * rs + c]) : 0.f;
    }
  }
}

// the chunk's inclusive cumsum of dA in float64 by one warp, 32 steps a
// pass; steps at or past len add 0, so they hold a_last
__device__ __forceinline__ void chunk_cumsum(double* acs, const float* d,
                                             long long ds, int len) {
  const int lane = threadIdx.x & 31;
  double carry = 0.0;
  for (int base = 0; base < kBQ; base += 32) {
    const int k = base + lane;
    double v = k < len ? static_cast<double>(d[(long long)k * ds]) : 0.0;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const double u = __shfl_up_sync(0xffffffffu, v, off);
      if (lane >= off) v += u;
    }
    v += carry;
    acs[k] = v;
    carry = __shfl_sync(0xffffffffu, v, 31);
  }
}

// the sum over a warp's 4 lanes of one row (lanes g * 4 + [0, 4)), the
// same bits on each
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// A fragment (16 x 8, k = t and t + 4) of rows r, r + 8 of a float tile, split
__device__ __forceinline__ void a_split(uint32_t (&hi)[4], uint32_t (&lo)[4],
                                        const float* tile, int ld, int r,
                                        int k) {
  split_tf32(tile[r * ld + k], hi[0], lo[0]);
  split_tf32(tile[(r + 8) * ld + k], hi[1], lo[1]);
  split_tf32(tile[r * ld + k + 4], hi[2], lo[2]);
  split_tf32(tile[(r + 8) * ld + k + 4], hi[3], lo[3]);
}

// the A fragment of an accumulator tile (rows g, g + 8; columns 2t, 2t + 1)
// with the k index permuted, k = t <-> column 2t, k = t + 4 <-> 2t + 1; split
__device__ __forceinline__ void acc_split(uint32_t (&hi)[4], uint32_t (&lo)[4],
                                          const float (&v)[4]) {
  split_tf32(v[0], hi[0], lo[0]);
  split_tf32(v[2], hi[1], lo[1]);
  split_tf32(v[1], hi[2], lo[2]);
  split_tf32(v[3], hi[3], lo[3]);
}

// d += a b with a split (two products; b exact in TF32)
__device__ __forceinline__ void mma2(float (&d)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], uint32_t b0,
                                     uint32_t b1) {
  mma_tf32(d, al, b0, b1);
  mma_tf32(d, ah, b0, b1);
}

// d += a b with both split: lo.hi + hi.lo + hi.hi
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], float b0,
                                     float b1) {
  uint32_t bh0, bl0, bh1, bl1;
  split_tf32(b0, bh0, bl0);
  split_tf32(b1, bh1, bl1);
  mma_tf32(d, al, bh0, bh1);
  mma_tf32(d, ah, bl0, bl1);
  mma_tf32(d, ah, bh0, bh1);
}

// The states passed along one (b, h) row by a whole block: the chunk states
// U (ws_u) replaced by the states entering each chunk, H_in[c] = H_in[c-1]
// exp(a_end[c-1]) + U[c-1] (H_in[0] = 0), and the state gradients D (ws_d)
// by the gradients of the states leaving each chunk, G[c] = G[c+1]
// exp(a_end[c+1]) + D[c+1] (G[last] = dstate). The two chains run in the
// same loop, kTbPassGroup chunks of each a step, so that a thread keeps 2
// kTbPassGroup loads in flight. V = 4 (T float4) where the rows allow, else
// 1. Other blocks wrote ws_u, ws_d and ws_a (exp(a_end) a chunk), so all
// three are read from L2.
template <typename T>
__device__ __forceinline__ void pass_row_bwd(float* __restrict__ ws_u,
                                             float* __restrict__ ws_d,
                                             const float* __restrict__ ws_a,
                                             const float* __restrict__ dstate,
                                             int PN, int nc) {
  constexpr int kV = sizeof(T) / sizeof(float);
  const int cols = PN / kV;
  T* u = reinterpret_cast<T*>(ws_u);
  T* d = reinterpret_cast<T*>(ws_d);
  for (int e = threadIdx.x; e < cols; e += blockDim.x) {
    T vu[kTbPassGroup], vd[kTbPassGroup];
    float fu[kTbPassGroup], fd[kTbPassGroup];
    T carry{};
    T grad = reinterpret_cast<const T*>(dstate)[e];
    for (int k0 = 0; k0 < nc; k0 += kTbPassGroup) {   // a step's loads in flight
#pragma unroll
      for (int k = 0; k < kTbPassGroup; ++k)
        if (k0 + k < nc) {
          const int cu = k0 + k, cd = nc - 1 - k0 - k;
          vu[k] = __ldcg(u + (long long)cu * cols + e);
          vd[k] = __ldcg(d + (long long)cd * cols + e);
          fu[k] = __ldcg(ws_a + cu);
          fd[k] = __ldcg(ws_a + cd);
        }
#pragma unroll
      for (int k = 0; k < kTbPassGroup; ++k)
        if (k0 + k < nc) {
          const int cu = k0 + k, cd = nc - 1 - k0 - k;
          u[(long long)cu * cols + e] = carry;
          carry = decay_add(carry, fu[k], vu[k]);
          d[(long long)cd * cols + e] = grad;
          grad = decay_add(grad, fd[k], vd[k]);
        }
    }
  }
}

// (1) grid: b * H * nc blocks, one (b, h, chunk) each. block: 8 warps; warp
// w owns rows p in [16 (w & 3), +16) and columns n in [64 (w >> 2), +64) of
// the chunk's own state U = sum_s e_s x_s B_s^T and its state gradient D =
// sum_l f_l dy_l C_l^T (e_s = exp(a_end - a_s), f_l = exp(a_l)): TF32 with x
// e and dy f split, two products each (B and C are exact in TF32), the k
// index permuted as in ssd_tc_state_kernel so that B's and C's fragments are
// transposed ldmatrix reads of bf16 pairs. Writes exp(a_end) to ws_a. The
// last of a (b, h) row's blocks to finish (an integer counter a row, zero
// when the call starts, left at zero) passes U and D along the row.
template <typename TX>
__global__ void __launch_bounds__(kTbStateThreads, 2)
ssd_bwd_tc_state_kernel(const TX* __restrict__ x, const float* __restrict__ dA,
                        const bf16* __restrict__ Bm, const bf16* __restrict__ Cm,
                        const TX* __restrict__ dy,
                        const float* __restrict__ dstate,
                        float* __restrict__ ws_u, float* __restrict__ ws_d,
                        float* __restrict__ ws_a, int* __restrict__ counters,
                        int H, int S, int P, int N, int nc, Strides st,
                        int vec_x, int vec_b, int vec_c, int vec_dy) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* xs = reinterpret_cast<float*>(smem);
  float* ys = xs + kBQ * kLdF;
  bf16* bs = reinterpret_cast<bf16*>(ys + kBQ * kLdF);
  bf16* cs = bs + kBQ * kTcLdB;
  double* acs = reinterpret_cast<double*>(cs + kBQ * kTcLdB);
  float* ev = reinterpret_cast<float*>(acs + kBQ);
  float* fv = ev + kBQ;

  const long long bhi = blockIdx.x / nc;
  const int c = blockIdx.x % nc;
  const int bi = (int)(bhi / H), hi = (int)(bhi % H);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int t0 = c * kBQ, len = min(kBQ, S - t0);

  stage_f32(xs, x + bi * st.xb + hi * st.xh + (long long)t0 * st.xs, st.xs,
            len, P, vec_x);
  stage_f32(ys, dy + ((long long)bi * S + t0) * H * P + (long long)hi * P,
            (long long)H * P, len, P, vec_dy);
  stage_tile(bs, kTcLdB, Bm + bi * st.bb + hi * st.bh + (long long)t0 * st.bs,
             st.bs, len, N, kMaxN, vec_b);
  stage_tile(cs, kTcLdB, Cm + bi * st.cb + hi * st.ch + (long long)t0 * st.cs,
             st.cs, len, N, kMaxN, vec_c);
  copy_commit();
  if (warp == 0)
    chunk_cumsum(acs, dA + bi * st.db + hi * st.dh + (long long)t0 * st.ds,
                 st.ds, len);
  __syncthreads();
  const double a_last = acs[kBQ - 1];
  for (int k = tid; k < kBQ; k += kTbStateThreads) {
    ev[k] = k < len ? expf(static_cast<float>(a_last - acs[k])) : 0.f;
    fv[k] = k < len ? expf(static_cast<float>(acs[k])) : 0.f;
  }
  if (tid == 0) ws_a[bhi * nc + c] = expf(static_cast<float>(a_last));
  copy_wait<0>();
  __syncthreads();

  const int pw = warp & 3, nw = warp >> 2;
  float au[8][4] = {}, ad[8][4] = {};
#pragma unroll 2
  for (int ks = 0; ks < kBQ / 8; ++ks) {
    const int j = 8 * ks + 2 * t;
    const float e0 = ev[j], e1 = ev[j + 1], f0 = fv[j], f1 = fv[j + 1];
    const float* xr = xs + j * kLdF + 16 * pw + g;
    const float* yr = ys + j * kLdF + 16 * pw + g;
    uint32_t xh[4], xl[4], yh[4], yl[4];
    split_tf32(xr[0] * e0, xh[0], xl[0]);           // (p g, j 2t)
    split_tf32(xr[8] * e0, xh[1], xl[1]);           // (p g + 8, j 2t)
    split_tf32(xr[kLdF] * e1, xh[2], xl[2]);        // (p g, j 2t + 1)
    split_tf32(xr[kLdF + 8] * e1, xh[3], xl[3]);    // (p g + 8, j 2t + 1)
    split_tf32(yr[0] * f0, yh[0], yl[0]);
    split_tf32(yr[8] * f0, yh[1], yl[1]);
    split_tf32(yr[kLdF] * f1, yh[2], yl[2]);
    split_tf32(yr[kLdF + 8] * f1, yh[3], yl[3]);
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int o = (8 * ks + (lane & 7)) * kTcLdB + 64 * nw + 32 * q + 8 * (lane >> 3);
      uint32_t rb[4], rc[4];
      ldsm_x4_t(rb, bs + o);
      ldsm_x4_t(rc, cs + o);
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        mma2(au[4 * q + m], xh, xl, bf_lo(rb[m]), bf_hi(rb[m]));
        mma2(ad[4 * q + m], yh, yl, bf_lo(rc[m]), bf_hi(rc[m]));
      }
    }
  }

  const long long base = (bhi * nc + c) * P * N;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const int n = 64 * nw + 8 * nt + 2 * t;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int p = 16 * pw + g + 8 * half;
      if (p >= P) continue;
      if ((N & 1) == 0 && n < N) {   // even N: one 8-byte store each
        *reinterpret_cast<float2*>(ws_u + base + p * N + n) =
            make_float2(au[nt][2 * half], au[nt][2 * half + 1]);
        *reinterpret_cast<float2*>(ws_d + base + p * N + n) =
            make_float2(ad[nt][2 * half], ad[nt][2 * half + 1]);
        continue;
      }
      if (n < N) {
        ws_u[base + p * N + n] = au[nt][2 * half];
        ws_d[base + p * N + n] = ad[nt][2 * half];
      }
      if (n + 1 < N) {
        ws_u[base + p * N + n + 1] = au[nt][2 * half + 1];
        ws_d[base + p * N + n + 1] = ad[nt][2 * half + 1];
      }
    }
  }

  // the last of the row's nc blocks to finish passes the states along it,
  // and leaves the row's counter at 0
  __shared__ int last;
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    last = atomicAdd(counters + bhi, 1) == nc - 1;
    if (last) counters[bhi] = 0;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  const int PN = P * N;
  float* row_u = ws_u + bhi * nc * PN;
  float* row_d = ws_d + bhi * nc * PN;
  const float* row_a = ws_a + bhi * nc;
  const float* ds = dstate + bhi * PN;
  if (PN % 4 == 0 && (reinterpret_cast<uintptr_t>(dstate) & 15) == 0)
    pass_row_bwd<float4>(row_u, row_d, row_a, ds, PN, nc);
  else
    pass_row_bwd<float>(row_u, row_d, row_a, ds, PN, nc);
}

// (2) grid: b * H * nc blocks, one (b, h, chunk) each, after (1). block: 4
// warps; warp w owns rows [16 w, +16) of the chunk, first as s (dx and dB),
// then as l (dC). With L[l, s] = exp(a_l - a_s) for s <= l (else 0), e_s,
// f_l as in (1), H_in the state entering the chunk and G the gradient of the
// state leaving it (ws_u and ws_d after (1)):
//   dx_s = e_s G B_s + sum_{l >= s} M[l,s] dy_l,  M = L (C_l . B_s)
//   dB_s = e_s G^T x_s + sum_{l >= s} LX[l,s] C_l,  LX = L (dy_l . x_s)
//   dC_l = f_l H_in^T dy_l + sum_{s <= l} LX[l,s] B_s
//   da_l = sum_s T[l,s] - sum_s T[s,l] + f_l w_l - F_l
//          (+ f_end <G, H_in> + sum_s F_s at l = end),  T = M (dy_l . x_s),
//   F_s = e_s x_s . (G B_s), the row sum of x (.) the first term of dx before
//   it is scaled, w_l = dy_l . (H_in C_l), the row sum of C (.) the first
//   term of dC before it is scaled; d(dA)_t = sum_{l >= t} da_l in the chunk.
// Each warp takes the inter-chunk products first (B G^T, x G; then dy H_in),
// then its 16 rows against the chunk's other rows 16 at a time on or below
// the diagonal: x.dy (three TF32 products) and C.B (bf16 m16n8k16, exact
// products) into registers, decayed and masked there, T's sums taken, and
// M, LX (split) multiplied into dx, dB or dC as A fragments in place. G is
// read from shared memory for the rows s, then replaced by H_in for the rows
// l. dB and dC are written per head, float32; summing them over heads that
// share B and C is left to the caller (autograd's expand).
template <typename TX>
__global__ void __launch_bounds__(kTbGradThreads, 2)
ssd_bwd_tc_grad_kernel(const TX* __restrict__ x, const float* __restrict__ dA,
                       const bf16* __restrict__ Bm, const bf16* __restrict__ Cm,
                       const TX* __restrict__ dy,
                       const float* __restrict__ ws_h,
                       const float* __restrict__ ws_g, TX* __restrict__ dx,
                       float* __restrict__ ddA, float* __restrict__ dB,
                       float* __restrict__ dC, int H, int S, int P, int N,
                       int nc, Strides st, int vec_x, int vec_b, int vec_c,
                       int vec_dy) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* xs = reinterpret_cast<float*>(smem);
  float* ys = xs + kBQ * kLdF;
  bf16* bs = reinterpret_cast<bf16*>(ys + kBQ * kLdF);
  bf16* cs = bs + kBQ * kTcLdB;
  float* gh = reinterpret_cast<float*>(cs + kBQ * kTcLdB);   // G, then H_in
  double* acs = reinterpret_cast<double*>(gh + kMaxP * kLdGH);  // a log2(e)
  float* ev = reinterpret_cast<float*>(acs + kBQ);
  float* fv = ev + kBQ;
  float* colT = fv + kBQ;
  float* Fv = colT + kBQ;
  float* rowT = Fv + kBQ;
  float* wv = rowT + kBQ;
  float* red = wv + kBQ;

  const long long bhi = blockIdx.x / nc;
  const int c = blockIdx.x % nc;
  const int bi = (int)(bhi / H), hi = (int)(bhi % H);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int t0 = c * kBQ, len = min(kBQ, S - t0);
  const long long wbase = (bhi * nc + c) * P * N;
  const int vec_s = N % 4 == 0 ? 16 : 4;

  stage_f32(xs, x + bi * st.xb + hi * st.xh + (long long)t0 * st.xs, st.xs,
            len, P, vec_x);
  stage_f32(ys, dy + ((long long)bi * S + t0) * H * P + (long long)hi * P,
            (long long)H * P, len, P, vec_dy);
  stage_tile(bs, kTcLdB, Bm + bi * st.bb + hi * st.bh + (long long)t0 * st.bs,
             st.bs, len, N, kMaxN, vec_b);
  stage_tile(cs, kTcLdB, Cm + bi * st.cb + hi * st.ch + (long long)t0 * st.cs,
             st.cs, len, N, kMaxN, vec_c);
  stage_tile(gh, kLdGH, ws_g + wbase, N, P, N, kMaxN, vec_s, kMaxP);
  copy_commit();
  if (warp == 0)
    chunk_cumsum(acs, dA + bi * st.db + hi * st.dh + (long long)t0 * st.ds,
                 st.ds, len);
  __syncthreads();
  const double a_last = acs[kBQ - 1];
  const double a_own = tid < kBQ ? acs[tid] : 0.0;
  const float f_last = expf(static_cast<float>(a_last));
  __syncthreads();   // every thread has read a_last
  if (tid < kBQ) {
    ev[tid] = tid < len ? expf(static_cast<float>(a_last - a_own)) : 0.f;
    fv[tid] = tid < len ? expf(static_cast<float>(a_own)) : 0.f;
    acs[tid] = a_own * kLog2e;
  }
  copy_wait<0>();
  __syncthreads();

  const int R = 16 * warp;                  // the warp's rows
  const int r_lo = R + g, r_hi = R + g + 8;
  const double A_lo = acs[r_lo], A_hi = acs[r_hi];
  // B's (then C's) rows R.. as bf16 A fragments, 16 n a step
  const int a_row = R + (lane & 7) + 8 * ((lane >> 3) & 1), a_col = 8 * (lane >> 4);
  // the other operand's rows of a 16-row step: bf16 B fragments, 16 n a step
  const int b_row = (lane & 7) + 8 * (lane >> 4), b_col = 8 * ((lane >> 3) & 1);

  // ---- the rows as s: dx (16 x P) and dB (16 x N)
  float ax[8][4] = {}, ab[16][4] = {};
  // B_s G^T: B exact, G split (two products); k = n permuted as C.S_in^T in
  // ssd_tc_out_kernel, so that the A fragment is the halves of B's pairs
#pragma unroll 1
  for (int ks = 0; ks < kMaxN / 16; ++ks) {
    uint32_t bf[4];
    ldsm_x4(bf, bs + a_row * kTcLdB + 16 * ks + a_col);
#pragma unroll
    for (int h8 = 0; h8 < 2; ++h8) {
      const uint32_t a[4] = {bf_lo(bf[2 * h8]), bf_lo(bf[2 * h8 + 1]),
                             bf_hi(bf[2 * h8]), bf_hi(bf[2 * h8 + 1])};
      const int n0 = 16 * ks + 8 * h8;
#pragma unroll
      for (int pt = 0; pt < 8; ++pt) {
        const float2 gv = *reinterpret_cast<const float2*>(gh + (8 * pt + g) * kLdGH + n0 + 2 * t);
        uint32_t h0, l0, h1, l1;
        split_tf32(gv.x, h0, l0);
        split_tf32(gv.y, h1, l1);
        mma_tf32(ax[pt], a, l0, l1);
        mma_tf32(ax[pt], a, h0, h1);
      }
    }
  }
  // x_s G: both split (three products), k = p
#pragma unroll 1
  for (int ks = 0; ks < kMaxP / 8; ++ks) {
    uint32_t ah[4], al[4];
    a_split(ah, al, xs, kLdF, r_lo, 8 * ks + t);
    const float* gr = gh + (8 * ks + t) * kLdGH + g;
#pragma unroll
    for (int nt = 0; nt < 16; ++nt)
      mma3(ab[nt], ah, al, gr[8 * nt], gr[4 * kLdGH + 8 * nt]);
  }
  {
    // F_s from dx's first term, then both terms scaled by e_s
    float fl = 0.f, fh = 0.f;
#pragma unroll
    for (int pt = 0; pt < 8; ++pt) {
      const int p = 8 * pt + 2 * t;
      fl += xs[r_lo * kLdF + p] * ax[pt][0] + xs[r_lo * kLdF + p + 1] * ax[pt][1];
      fh += xs[r_hi * kLdF + p] * ax[pt][2] + xs[r_hi * kLdF + p + 1] * ax[pt][3];
    }
    fl = quad_sum(fl);
    fh = quad_sum(fh);
    const float e_lo = ev[r_lo], e_hi = ev[r_hi];
    if (t == 0) {
      Fv[r_lo] = e_lo * fl;
      Fv[r_hi] = e_hi * fh;
    }
#pragma unroll
    for (int pt = 0; pt < 8; ++pt) {
      ax[pt][0] *= e_lo; ax[pt][1] *= e_lo; ax[pt][2] *= e_hi; ax[pt][3] *= e_hi;
    }
#pragma unroll
    for (int nt = 0; nt < 16; ++nt) {
      ab[nt][0] *= e_lo; ab[nt][1] *= e_lo; ab[nt][2] *= e_hi; ab[nt][3] *= e_hi;
    }
  }
  float t_lo = 0.f, t_hi = 0.f;   // column sums of T
#pragma unroll 1
  for (int l0 = R; l0 < kBQ; l0 += 16) {
    float xd[2][4] = {}, cb[2][4] = {};
    // x_s . dy_l: both split; k = p
#pragma unroll 2
    for (int ks = 0; ks < kMaxP / 8; ++ks) {
      uint32_t ah[4], al[4];
      a_split(ah, al, xs, kLdF, r_lo, 8 * ks + t);
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const float* yr = ys + (l0 + 8 * nt + g) * kLdF + 8 * ks + t;
        mma3(xd[nt], ah, al, yr[0], yr[4]);
      }
    }
    // B_s . C_l: bf16, exact products
#pragma unroll
    for (int ks = 0; ks < kMaxN / 16; ++ks) {
      uint32_t a[4], r[4];
      ldsm_x4(a, bs + a_row * kTcLdB + 16 * ks + a_col);
      ldsm_x4(r, cs + (l0 + b_row) * kTcLdB + 16 * ks + b_col);
      mma_bf16(cb[0], a, r[0], r[1]);
      mma_bf16(cb[1], a, r[2], r[3]);
    }
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      const int l = l0 + 8 * nt + 2 * t;   // columns l, l + 1
      const double Al0 = acs[l], Al1 = acs[l + 1];
      // the decay 2^(log2(e) (a_l - a_s)) where l >= s (never a positive power)
      const float d[4] = {
          l >= r_lo ? ex2(static_cast<float>(Al0 - A_lo)) : 0.f,
          l + 1 >= r_lo ? ex2(static_cast<float>(Al1 - A_lo)) : 0.f,
          l >= r_hi ? ex2(static_cast<float>(Al0 - A_hi)) : 0.f,
          l + 1 >= r_hi ? ex2(static_cast<float>(Al1 - A_hi)) : 0.f};
      float m[4], lx[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        m[k] = cb[nt][k] * d[k];
        lx[k] = xd[nt][k] * d[k];
      }
      t_lo += m[0] * xd[nt][0] + m[1] * xd[nt][1];
      t_hi += m[2] * xd[nt][2] + m[3] * xd[nt][3];
      uint32_t mh[4], ml[4], lh[4], ll[4];
      acc_split(mh, ml, m);
      acc_split(lh, ll, lx);
      // dx += M^T dy: dy's rows l, l + 1 (split; three products)
      const float* yr = ys + l * kLdF + g;
#pragma unroll
      for (int pt = 0; pt < 8; ++pt)
        mma3(ax[pt], mh, ml, yr[8 * pt], yr[kLdF + 8 * pt]);
      // dB += LX^T C: C's pairs of rows l, l + 1 by transposed ldmatrix
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        uint32_t r[4];
        ldsm_x4_t(r, cs + (l0 + 8 * nt + (lane & 7)) * kTcLdB + 32 * q + 8 * (lane >> 3));
#pragma unroll
        for (int mm = 0; mm < 4; ++mm)
          mma2(ab[4 * q + mm], lh, ll, bf_lo(r[mm]), bf_hi(r[mm]));
      }
    }
  }
  t_lo = quad_sum(t_lo);
  t_hi = quad_sum(t_hi);
  if (t == 0) {
    colT[r_lo] = t_lo;
    colT[r_hi] = t_hi;
  }
  const long long xrs = (long long)H * P, grs = (long long)H * N;
  TX* dxb = dx + ((long long)bi * S + t0) * xrs + (long long)hi * P;
  float* dBb = dB + ((long long)bi * S + t0) * grs + (long long)hi * N;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = half ? r_hi : r_lo;
    if (r >= len) continue;
#pragma unroll
    for (int pt = 0; pt < 8; ++pt) {
      const int p = 8 * pt + 2 * t;
      if (p < P) from_f(ax[pt][2 * half], dxb + r * xrs + p);
      if (p + 1 < P) from_f(ax[pt][2 * half + 1], dxb + r * xrs + p + 1);
    }
#pragma unroll
    for (int nt = 0; nt < 16; ++nt) {
      const int n = 8 * nt + 2 * t;
      if ((N & 1) == 0 && n < N) {   // even N: one 8-byte store
        *reinterpret_cast<float2*>(dBb + r * grs + n) =
            make_float2(ab[nt][2 * half], ab[nt][2 * half + 1]);
        continue;
      }
      if (n < N) dBb[r * grs + n] = ab[nt][2 * half];
      if (n + 1 < N) dBb[r * grs + n + 1] = ab[nt][2 * half + 1];
    }
  }

  // G -> H_in in place, with <G, H_in>: a thread's 16 rows of 4 loaded at
  // once where N % 4 == 0 (H_in's rows, and each chunk's, are then 16-byte
  // aligned), else one float at a time
  __syncthreads();   // every warp is done with G
  float hd = 0.f;
  const float* hsrc = ws_h + wbase;
  if (N % 4 == 0) {
    constexpr int kQuads = kMaxN / 4, kPer = kMaxP * kQuads / kTbGradThreads;
    float4 hv[kPer];
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int e = tid + k * kTbGradThreads, p = e / kQuads, n = 4 * (e % kQuads);
      hv[k] = p < P && n < N ? *reinterpret_cast<const float4*>(hsrc + p * N + n)
                             : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int e = tid + k * kTbGradThreads;
      float4* at = reinterpret_cast<float4*>(gh + (e / kQuads) * kLdGH + 4 * (e % kQuads));
      const float4 gv = *at;
      hd = fmaf(gv.x, hv[k].x, hd);
      hd = fmaf(gv.y, hv[k].y, hd);
      hd = fmaf(gv.z, hv[k].z, hd);
      hd = fmaf(gv.w, hv[k].w, hd);
      *at = hv[k];
    }
  } else {
#pragma unroll 8
    for (int e = tid; e < kMaxP * kMaxN; e += kTbGradThreads) {
      const int p = e / kMaxN, n = e % kMaxN;
      const float v = p < P && n < N ? hsrc[p * N + n] : 0.f;
      float* at = gh + p * kLdGH + n;
      hd = fmaf(*at, v, hd);
      *at = v;
    }
  }
  const float hdot = block_sum<kTbGradThreads / 32>(hd, red);  // its barriers
                                                               // end the swap

  // ---- the rows as l: dC (16 x N)
  float ac[16][4] = {};
  // dy_l H_in: both split (three products), k = p
#pragma unroll 1
  for (int ks = 0; ks < kMaxP / 8; ++ks) {
    uint32_t ah[4], al[4];
    a_split(ah, al, ys, kLdF, r_lo, 8 * ks + t);
    const float* hr = gh + (8 * ks + t) * kLdGH + g;
#pragma unroll
    for (int nt = 0; nt < 16; ++nt)
      mma3(ac[nt], ah, al, hr[8 * nt], hr[4 * kLdGH + 8 * nt]);
  }
  {
    // w_l from dC's first term, then that term scaled by f_l
    float wl = 0.f, wh = 0.f;
#pragma unroll
    for (int nt = 0; nt < 16; ++nt) {
      const int n = 8 * nt + 2 * t;
      const uint32_t c_lo = *reinterpret_cast<const uint32_t*>(cs + r_lo * kTcLdB + n);
      const uint32_t c_hi = *reinterpret_cast<const uint32_t*>(cs + r_hi * kTcLdB + n);
      wl += ac[nt][0] * __uint_as_float(bf_lo(c_lo)) + ac[nt][1] * __uint_as_float(bf_hi(c_lo));
      wh += ac[nt][2] * __uint_as_float(bf_lo(c_hi)) + ac[nt][3] * __uint_as_float(bf_hi(c_hi));
    }
    wl = quad_sum(wl);
    wh = quad_sum(wh);
    if (t == 0) {
      wv[r_lo] = wl;
      wv[r_hi] = wh;
    }
    const float f_lo = fv[r_lo], f_hi = fv[r_hi];
#pragma unroll
    for (int nt = 0; nt < 16; ++nt) {
      ac[nt][0] *= f_lo; ac[nt][1] *= f_lo; ac[nt][2] *= f_hi; ac[nt][3] *= f_hi;
    }
  }
  t_lo = t_hi = 0.f;   // row sums of T
#pragma unroll 1
  for (int s0 = 0; s0 <= R; s0 += 16) {
    float xd[2][4] = {}, cb[2][4] = {};
    // dy_l . x_s: both split; k = p
#pragma unroll 2
    for (int ks = 0; ks < kMaxP / 8; ++ks) {
      uint32_t ah[4], al[4];
      a_split(ah, al, ys, kLdF, r_lo, 8 * ks + t);
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const float* xr = xs + (s0 + 8 * nt + g) * kLdF + 8 * ks + t;
        mma3(xd[nt], ah, al, xr[0], xr[4]);
      }
    }
    // C_l . B_s: bf16, exact products
#pragma unroll
    for (int ks = 0; ks < kMaxN / 16; ++ks) {
      uint32_t a[4], r[4];
      ldsm_x4(a, cs + a_row * kTcLdB + 16 * ks + a_col);
      ldsm_x4(r, bs + (s0 + b_row) * kTcLdB + 16 * ks + b_col);
      mma_bf16(cb[0], a, r[0], r[1]);
      mma_bf16(cb[1], a, r[2], r[3]);
    }
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      const int s = s0 + 8 * nt + 2 * t;   // columns s, s + 1
      const double As0 = acs[s], As1 = acs[s + 1];
      const float d[4] = {
          s <= r_lo ? ex2(static_cast<float>(A_lo - As0)) : 0.f,
          s + 1 <= r_lo ? ex2(static_cast<float>(A_lo - As1)) : 0.f,
          s <= r_hi ? ex2(static_cast<float>(A_hi - As0)) : 0.f,
          s + 1 <= r_hi ? ex2(static_cast<float>(A_hi - As1)) : 0.f};
      float lx[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) lx[k] = xd[nt][k] * d[k];
      t_lo += cb[nt][0] * d[0] * xd[nt][0] + cb[nt][1] * d[1] * xd[nt][1];
      t_hi += cb[nt][2] * d[2] * xd[nt][2] + cb[nt][3] * d[3] * xd[nt][3];
      uint32_t lh[4], ll[4];
      acc_split(lh, ll, lx);
      // dC += LX B: B's pairs of rows s, s + 1 by transposed ldmatrix
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        uint32_t r[4];
        ldsm_x4_t(r, bs + (s0 + 8 * nt + (lane & 7)) * kTcLdB + 32 * q + 8 * (lane >> 3));
#pragma unroll
        for (int mm = 0; mm < 4; ++mm)
          mma2(ac[4 * q + mm], lh, ll, bf_lo(r[mm]), bf_hi(r[mm]));
      }
    }
  }
  t_lo = quad_sum(t_lo);
  t_hi = quad_sum(t_hi);
  if (t == 0) {
    rowT[r_lo] = t_lo;
    rowT[r_hi] = t_hi;
  }
  float* dCb = dC + ((long long)bi * S + t0) * grs + (long long)hi * N;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = half ? r_hi : r_lo;
    if (r >= len) continue;
#pragma unroll
    for (int nt = 0; nt < 16; ++nt) {
      const int n = 8 * nt + 2 * t;
      if ((N & 1) == 0 && n < N) {
        *reinterpret_cast<float2*>(dCb + r * grs + n) =
            make_float2(ac[nt][2 * half], ac[nt][2 * half + 1]);
        continue;
      }
      if (n < N) dCb[r * grs + n] = ac[nt][2 * half];
      if (n + 1 < N) dCb[r * grs + n + 1] = ac[nt][2 * half + 1];
    }
  }

  // d(dA): da_l, then its reverse cumsum over the chunk by warp 0 (a suffix
  // scan of each half, the upper half's total added to the lower)
  __syncthreads();
  if (warp != 0) return;
  float d_lo = rowT[lane] - colT[lane] + fv[lane] * wv[lane] - Fv[lane];
  float d_hi = rowT[lane + 32] - colT[lane + 32] + fv[lane + 32] * wv[lane + 32] -
               Fv[lane + 32];
  float fs = Fv[lane] + Fv[lane + 32];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) fs += __shfl_xor_sync(0xffffffffu, fs, o);
  if (lane == 31) d_hi += f_last * hdot + fs;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float u_hi = __shfl_down_sync(0xffffffffu, d_hi, off);
    const float u_lo = __shfl_down_sync(0xffffffffu, d_lo, off);
    if (lane + off < 32) {
      d_hi += u_hi;
      d_lo += u_lo;
    }
  }
  d_lo += __shfl_sync(0xffffffffu, d_hi, 0);
  float* ddAb = ddA + ((long long)bi * S + t0) * H + hi;
  if (lane < len) ddAb[(long long)lane * H] = d_lo;
  if (lane + 32 < len) ddAb[(long long)(lane + 32) * H] = d_hi;
}

// (1) then (2) on one stream
template <typename TX>
int launch_bwd_tc(const void* x, const void* dA, const void* B, const void* C,
                  const void* dy, const void* dstate, void* dx, void* ddA,
                  void* dB, void* dC, void* ws_u, void* ws_d, void* ws_a,
                  int* counters, int b, int S, int H, int P, int N,
                  const Strides& st, int vec_x, int vec_b, int vec_c,
                  int vec_dy, cudaStream_t stream) {
  const int nc = (S + kBQ - 1) / kBQ;
  const unsigned blocks = (unsigned)((long long)b * H * nc);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_bwd_tc_state_kernel<TX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)tb_state_smem());
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(ssd_bwd_tc_grad_kernel<TX>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)tb_grad_smem());
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_bwd_tc_state_kernel<TX><<<blocks, kTbStateThreads, tb_state_smem(), stream>>>(
      static_cast<const TX*>(x), static_cast<const float*>(dA),
      static_cast<const bf16*>(B), static_cast<const bf16*>(C),
      static_cast<const TX*>(dy), static_cast<const float*>(dstate),
      static_cast<float*>(ws_u), static_cast<float*>(ws_d),
      static_cast<float*>(ws_a), counters, H, S, P, N, nc, st, vec_x, vec_b,
      vec_c, vec_dy);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_bwd_tc_grad_kernel<TX><<<blocks, kTbGradThreads, tb_grad_smem(), stream>>>(
      static_cast<const TX*>(x), static_cast<const float*>(dA),
      static_cast<const bf16*>(B), static_cast<const bf16*>(C),
      static_cast<const TX*>(dy), static_cast<const float*>(ws_u),
      static_cast<const float*>(ws_d), static_cast<TX*>(dx),
      static_cast<float*>(ddA), static_cast<float*>(dB), static_cast<float*>(dC),
      H, S, P, N, nc, st, vec_x, vec_b, vec_c, vec_dy);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (b, S, H, P), dA (b, S, H), B/C (b, S, H, N), each through its element
// strides (the last dimension of x, B and C contiguous); y (b, S, H, P)
// contiguous in x's dtype, state (b, H, P, N) contiguous float32.
// route: 0 "fma" (float32 B and C), 1 "tc" (bf16 B and C), which also takes
// the workspaces ws_state (float32, b H nc P N), ws_acs (float64, b H nc Q)
// and ws_g (float32, b HB nc q_pad q_pad), nc = ceil(S / Q), q_pad = Q
// rounded up to 64, HB = 1 where the heads share B and C (stride 0 over h)
// and H otherwise, and the copy widths vec_x, vec_b, vec_c (16, 8, 4 or 2
// bytes, dividing each tensor's base, row strides and row bytes).
// x_bf16 / bc_bf16: 1 for bfloat16, 0 for float32. Sets *ran to the route
// it launched. Returns 0 on success, a cudaError_t, or -1 for arguments
// the kernels do not take (the Python wrapper checks these first).
extern "C" int ssd_chunk_scan(const void* x, const void* dA, const void* B,
                              const void* C, void* y, void* state,
                              void* ws_state, void* ws_acs, void* ws_g,
                              int* counters, int route, int x_bf16,
                              int bc_bf16, int b, int S,
                              int H, int HB, int P, int N, int Q, int vec_x,
                              int vec_b, int vec_c, long long sxb,
                              long long sxs, long long sxh, long long sdb,
                              long long sds, long long sdh, long long sbb,
                              long long sbs, long long sbh, long long scb,
                              long long scs, long long sch, void* stream,
                              int* ran) {
  if (b < 1 || S < 1 || H < 1 || P < 1 || P > kMaxP || N < 1 || N > kMaxN ||
      Q < 1 || Q > kMaxChunk || (long long)b * H > 0x7fffffffLL)
    return -1;
  const Strides st{sxb, sxs, sxh, sdb, sds, sdh, sbb, sbs, sbh, scb, scs, sch};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err = -1;
  if (route == 1) {
    const long long nc = (S + Q - 1) / Q;
    const long long rows = (long long)b * H * nc * ((Q + kOutRows - 1) / kOutRows);
    const bool vec_ok = copy_width_ok(vec_b, 1) && copy_width_ok(vec_c, 1) &&
                        copy_width_ok(vec_x, x_bf16);
    if (!bc_bf16 || !vec_ok || (HB != 1 && HB != H) || rows > 0x7fffffffLL)
      return -1;
    err = x_bf16 ? launch_tc<bf16>(x, dA, B, C, y, state, ws_state, ws_acs,
                                   ws_g, counters, b, S, H, HB, P, N, Q, st,
                                   vec_x, vec_b, vec_c, s)
                 : launch_tc<float>(x, dA, B, C, y, state, ws_state, ws_acs,
                                    ws_g, counters, b, S, H, HB, P, N, Q, st,
                                    vec_x, vec_b, vec_c, s);
  } else if (route == 0 && !bc_bf16) {
    err = x_bf16 ? launch<bf16, float>(x, dA, B, C, y, state, b, S, H, P, N, Q, st, s)
                 : launch<float, float>(x, dA, B, C, y, state, b, S, H, P, N, Q, st, s);
  }
  if (err == 0) *ran = route;
  return err;
}

// dynamic shared memory of the tc route's kernels a block: kernel 0 (a),
// 1 (c); x_bf16 as for ssd_chunk_scan
extern "C" int ssd_chunk_scan_smem(int kernel, int x_bf16, int Q) {
  const int q_pad = round_up(Q, kTile);
  if (kernel == 0)
    return (int)(x_bf16 ? tc_state_smem<bf16>(q_pad) : tc_state_smem<float>(q_pad));
  return (int)(x_bf16 ? tc_out_smem<bf16>(q_pad) : tc_out_smem<float>(q_pad));
}

// The backward: x, dA, B, C as for ssd_chunk_scan (the same strides); dy
// (b, S, H, P) contiguous in x's dtype, dstate (b, H, P, N) contiguous
// float32; out dx (b, S, H, P) contiguous in x's dtype, ddA (b, S, H)
// float32, dB and dC (b, S, H, N) float32, per head; workspaces ws_u and
// ws_d (float32, b H nc P N) and ws_a (float32, b H nc), nc = ceil(S / 64).
// route: 0 "fma" (float32 B and C: the CUDA-core kernels), 1 "tc" (bf16 B
// and C: the tensor-core kernels), which also takes counters (int32, b H,
// zero) and the copy widths vec_x, vec_b, vec_c, vec_dy (as for
// ssd_chunk_scan). Sets *ran to the route it launched. Returns 0, a
// cudaError_t, or -1 for arguments the kernels do not take.
extern "C" int ssd_chunk_scan_bwd(const void* x, const void* dA,
                                  const void* B, const void* C,
                                  const void* dy, const void* dstate,
                                  void* dx, void* ddA, void* dB, void* dC,
                                  void* ws_u, void* ws_d, void* ws_a,
                                  int* counters, int route, int x_bf16,
                                  int bc_bf16, int b, int S, int H, int P,
                                  int N, int vec_x, int vec_b, int vec_c,
                                  int vec_dy, long long sxb, long long sxs,
                                  long long sxh, long long sdb, long long sds,
                                  long long sdh, long long sbb, long long sbs,
                                  long long sbh, long long scb, long long scs,
                                  long long sch, void* stream, int* ran) {
  if (b < 1 || S < 1 || H < 1 || P < 1 || P > kMaxP || N < 1 || N > kMaxN ||
      (long long)b * H > 65535)
    return -1;
  const Strides st{sxb, sxs, sxh, sdb, sds, sdh, sbb, sbs, sbh, scb, scs, sch};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err = -1;
  if (route == 1) {
    const bool vec_ok = copy_width_ok(vec_b, 1) && copy_width_ok(vec_c, 1) &&
                        copy_width_ok(vec_x, x_bf16) &&
                        copy_width_ok(vec_dy, x_bf16);
    if (!bc_bf16 || !vec_ok || counters == nullptr) return -1;
    err = x_bf16 ? launch_bwd_tc<bf16>(x, dA, B, C, dy, dstate, dx, ddA, dB, dC,
                                       ws_u, ws_d, ws_a, counters, b, S, H, P,
                                       N, st, vec_x, vec_b, vec_c, vec_dy, s)
                 : launch_bwd_tc<float>(x, dA, B, C, dy, dstate, dx, ddA, dB,
                                        dC, ws_u, ws_d, ws_a, counters, b, S, H,
                                        P, N, st, vec_x, vec_b, vec_c, vec_dy, s);
  } else if (route == 0 && !bc_bf16) {
    err = x_bf16 ? launch_bwd<bf16, float>(x, dA, B, C, dy, dstate, dx, ddA, dB, dC, ws_u, ws_d, ws_a, b, S, H, P, N, st, s)
                 : launch_bwd<float, float>(x, dA, B, C, dy, dstate, dx, ddA, dB, dC, ws_u, ws_d, ws_a, b, S, H, P, N, st, s);
  }
  if (err == 0) *ran = route;
  return err;
}

// dynamic shared memory a block of the backward's tc route: kernel 0 (1),
// the state kernel, or 1 (2), the grad kernel
extern "C" int ssd_chunk_scan_bwd_smem(int kernel) {
  return (int)(kernel == 0 ? tb_state_smem() : tb_grad_smem());
}

extern "C" const char* ssd_chunk_scan_error_string(int code) {
  if (code == -1) return "argument the SSD chunk-scan kernel does not take";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

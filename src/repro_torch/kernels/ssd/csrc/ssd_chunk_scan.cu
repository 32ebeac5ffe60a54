// Mamba-2 SSD chunk scan for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `ssd_hm` (body `_ssd_kernel`),
// src/repro/kernels/ssd/kernel.py:67. Same function: with the state S (P x N)
// starting at 0 and carried from chunk to chunk, each chunk of Q steps, with
// a = the inclusive cumsum of dA over the chunk, gives
//   y[i, p] = sum_{j <= i} (C_i . B_j) exp(a_i - a_j) x[j, p]
//             + exp(a_i) sum_n C[i, n] S[p, n]
//   S[p, n] <- S[p, n] exp(a_last) + sum_j x[j, p] B[j, n] exp(a_last - a_j)
// and the last S is the final state. Float32 arithmetic and accumulation
// throughout, but for the cumsum a of dA, which is kept in float64: at the
// model's decay a reaches -200 within a chunk of 256 steps, where a float32
// difference a_i - a_j near the diagonal keeps only about 5 of its digits
// (the reference kernel's float32 difference loses them there). y is
// written in x's dtype, the state in float32.
//
// Differences from the TPU kernel, all in what it takes, none in what it
// computes: any S >= 1 (the ragged last chunk is cut to its length inside
// the kernel, which is what padding it with identity steps x = 0, dA = 0
// amounts to, so no padded copy is made); the model's layout x (b, s, h, p),
// dA (b, s, h), B/C (b, s, h, n) read through strides, so the head-broadcast
// B and C of the model (stride 0 over h) are never copied per head, and y is
// written in the same layout; float32 or bfloat16 x, B and C.
//
// What bounds it: operations. At mamba2-370m's prefill shape (b 8, s 4096,
// 32 heads, P 64, N 128, Q 256) one call does about 9e10 float32 operations
// (the C.B scores and their product with x over the j <= i half of each
// chunk, the C.S^T term and the state update: 1.3 ms at the card's 67
// TFLOP/s outside the tensor cores) and moves about 0.57 GB (x read and y
// written in float32, B and C read once per (b, s) in bf16: 0.17 ms at
// 3.35 TB/s).
//
// What the design does about it. The TPU kernel holds a whole chunk's
// (Q, Q) decay and score tile (256 KB in float32 at Q 256) in VMEM, over the
// 227 KB a block may have here. This kernel gives one block of 256 threads
// to one (b, h) row; the chunk loop is a loop inside the block, and the
// state (P x N float32, 32 KB) stays in shared memory for the whole
// sequence. Within a chunk the rows are taken 64 at a time: a row tile's C
// is staged in shared memory, its C.S^T term formed first, then for each
// 64-row tile of columns j at or before it, B and x are staged, the 64 x 64
// score tile is formed, masked and decayed (exp only where j <= i, so no inf
// is formed; tiles above the diagonal are skipped), and multiplied into y
// in registers. The last row tile's column loop has seen every tile of the
// chunk, so the state update is accumulated there, in registers, and
// written back once the chunk's y no longer reads the old state. Each
// thread owns a 4 x 4 micro-tile of every 64 x 64 product and a 8 x 4 one of
// the state. B and C stay in their input type in shared memory: 106 KB a
// block for bf16, so two blocks share an SM and the 256 (b, h) rows of the
// prefill run in one wave on the 132 SMs (140 KB, one block an SM, for
// float32 B and C).
//
// The limit of this simple design: float32 FMAs on the CUDA cores fed from
// shared memory (8 shared loads per 16 FMAs in the score and y products), a
// bf16 tensor-core version (mma.sync/wgmma tiles) is the later step, and
// only b * h blocks of parallelism (256 at the prefill shape).

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

}  // namespace

// x (b, S, H, P), dA (b, S, H), B/C (b, S, H, N), each through its element
// strides (the last dimension of x, B and C contiguous); y (b, S, H, P)
// contiguous in x's dtype, state (b, H, P, N) contiguous float32.
// x_bf16 / bc_bf16: 1 for bfloat16, 0 for float32. Returns 0 on success, a
// cudaError_t, or -1 for arguments the kernel does not take (the Python
// wrapper checks these first).
extern "C" int ssd_chunk_scan(const void* x, const void* dA, const void* B,
                              const void* C, void* y, void* state, int x_bf16,
                              int bc_bf16, int b, int S, int H, int P, int N,
                              int Q, long long sxb, long long sxs,
                              long long sxh, long long sdb, long long sds,
                              long long sdh, long long sbb, long long sbs,
                              long long sbh, long long scb, long long scs,
                              long long sch, void* stream) {
  if (b < 1 || S < 1 || H < 1 || P < 1 || P > kMaxP || N < 1 || N > kMaxN ||
      Q < 1 || Q > kMaxChunk || (long long)b * H > 0x7fffffffLL)
    return -1;
  const Strides st{sxb, sxs, sxh, sdb, sds, sdh, sbb, sbs, sbh, scb, scs, sch};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  if (x_bf16) {
    return bc_bf16 ? launch<bf16, bf16>(x, dA, B, C, y, state, b, S, H, P, N, Q, st, s)
                   : launch<bf16, float>(x, dA, B, C, y, state, b, S, H, P, N, Q, st, s);
  }
  return bc_bf16 ? launch<float, bf16>(x, dA, B, C, y, state, b, S, H, P, N, Q, st, s)
                 : launch<float, float>(x, dA, B, C, y, state, b, S, H, P, N, Q, st, s);
}

extern "C" const char* ssd_chunk_scan_error_string(int code) {
  if (code == -1) return "argument the SSD chunk-scan kernel does not take";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

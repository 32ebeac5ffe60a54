// Flash attention forward and backward for Hopper (sm_90a): causal,
// sliding-window and non-causal GQA, float32 or bfloat16 in, float32 math.
//
// What each entry replaces:
// - flash_attention_fwd: the Pallas TPU kernel `flash_attention_hm` (body
//   `_attn_kernel`), src/repro/kernels/attention/kernel.py:69. It also
//   writes the per-row log-sum-exp that the reference's training forward
//   `_flash_fwd_impl` (src/repro/models/layers.py:116) keeps for the
//   backward: lse = m + log(max(l, 1e-30)).
// - flash_attention_bwd: `_flash_bwd` (src/repro/models/layers.py:170), the
//   pure-JAX custom-VJP backward of the reference's training path. Two
//   kernels, no atomics, so the result is the same on every run:
//   a dK/dV kernel and a dQ kernel, both recomputing score tiles from lse.
//   delta = rowsum(dO * O) comes in from the wrapper.
//
// Layout: q, o, dO, dq (B, Sq, H, D); k, v, dk, dv (B, Sk, K, D), all
// contiguous; lse and delta (B, H, Sq) float32. Query head h reads KV head
// h / (H / K) inside the kernel: KV is never repeated in memory. Masks are
// the reference's: a key is visible when kpos < Sk, (causal) qpos >= kpos
// and (window) qpos - kpos < window; masked scores are -1e30 before the
// softmax, and the normaliser is clamped to 1e-30.
//
// What bounds it at the training shape (granite-3-2b: B 2, S 4096, H 32,
// K 8, D 64, bf16): operations. The forward does 2*B*H*S^2*D causal FLOPs
// (1.37e11), the backward 2.5 times that; the bytes (q, k, v, o, lse, dO,
// dq, dk, dv, each once) are tens of MB. Against 989 TFLOP/s of bf16
// tensor cores that is 0.139 ms forward and 0.347 ms backward.
//
// What this first design does: it is simple and exact, not yet fast. Every
// product runs in float32 on the CUDA cores (no tensor cores), so it is
// bound by the CUDA cores' float32 rate and shared-memory traffic, far from
// the tensor-core bound. A block of 256 threads owns a 64-row tile; tiles
// of 64 rows of Q, K, V (and dO) are staged in shared memory as float32,
// zero-padded to DMAX (64 or 128; the forward also 256) columns, rows
// strided DMAX + 1 so that the 16 lanes of a half-warp reading 16 rows hit
// 16 banks. Each thread holds a 4 x 4 block of the 64 x 64 score tile (rows
// ty + 16 i, keys tx + 16 j, with ty = tid / 16 and tx = tid % 16), so row
// reductions are four xor-shuffles inside a half-warp. The forward keeps
// the running max, normaliser and output accumulator of its 4 rows in
// registers, skips the KV tiles the mask hides (causal: it stops at the
// diagonal tile; window: it starts at the first tile inside the window) and
// starts the heaviest causal query tiles first. Still to do for speed (a
// later change): bf16 mma.sync / wgmma tiles with TMA loads, and a
// warp-specialised pipeline.
//
// Head dim 256 (RecurrentGemma-2B: H 10, K 1, window 2048), forward only.
// Q, K and V tiles of 64 x 257 floats and the score tile would take 214 KB
// of the 227 KB a block may have. So at DMAX 256 the V tile reuses the K
// tile's buffer: a KV step loads K, forms the scores and P, then loads V
// over K and applies P (one more barrier per KV tile), and the block holds
// 148 KB. The D <= 128 instantiations keep their separate K and V buffers
// and their code. At RecurrentGemma's prefill shape (B 8, S 4096, bf16)
// the forward does 5.15e11 FLOPs: 0.52 ms on the tensor cores. The backward
// keeps D <= 128 (the hybrid family's training is a later slice).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;          // query rows and key rows per tile
constexpr int kThreads = 256;      // 16 x 16 threads
constexpr int kPS = kTile + 1;     // row stride of a score tile in shared memory
constexpr float kNegInf = -1e30f;  // the reference's mask value

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// reductions over the 16 lanes of a half-warp (one tile row's threads)
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ bool visible(int qpos, int kpos, int Sq, int Sk,
                                        int causal, int window) {
  return qpos < Sq && kpos < Sk && (!causal || qpos >= kpos) &&
         (window <= 0 || qpos - kpos < window);
}

// Stage rows [row0, row0 + kTile) of a (S, stride) row-major view as float32
// in dst[kTile][DMAX + 1]; rows past S and columns past D are zero.
template <typename T, int DMAX>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int row0,
                                          int S, size_t stride, int D) {
  for (int idx = threadIdx.x; idx < kTile * DMAX; idx += kThreads) {
    const int r = idx / DMAX, d = idx % DMAX;
    const int row = row0 + r;
    dst[r * (DMAX + 1) + d] =
        (row < S && d < D) ? to_float(src[(size_t)row * stride + d]) : 0.f;
  }
}

// Rows [row0, row0 + kTile) of a (S,) float32 vector; zero past S.
__device__ __forceinline__ void load_row_vec(float* dst, const float* src,
                                             int row0, int S) {
  for (int r = threadIdx.x; r < kTile; r += kThreads)
    dst[r] = row0 + r < S ? src[row0 + r] : 0.f;
}

// The KV rows a query tile [q0, q0 + kTile) can see: [k_lo, k_hi).
__device__ __forceinline__ void kv_range(int q0, int Sq, int Sk, int causal,
                                         int window, int* k_lo, int* k_hi) {
  *k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  *k_hi = causal ? min(Sk, min(q0 + kTile, Sq)) : Sk;
}

// grid: x = query tiles (heaviest first), y = B * H. block: kThreads.
template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int Sq, int Sk, int H, int K, int D,
                 int causal, int window, float scale) {
  constexpr int DS = DMAX + 1, CPT = DMAX / 16;
  // at DMAX 256 the V tile reuses the K tile's buffer (see the header)
  constexpr bool kShareKV = DMAX > 128;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + kTile * DS;
  float* Vs = kShareKV ? Ks : Ks + kTile * DS;
  float* Ps = Vs + kTile * DS;

  const int n_qt = (Sq + kTile - 1) / kTile;
  const int q0 = (n_qt - 1 - blockIdx.x) * kTile;
  const int b = blockIdx.y / H, h = blockIdx.y % H, kh = h / (H / K);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const size_t q_stride = (size_t)H * D, kv_stride = (size_t)K * D;
  const T* qb = q + ((size_t)b * Sq * H + h) * D;
  const T* kb = k + ((size_t)b * Sk * K + kh) * D;
  const T* vb = v + ((size_t)b * Sk * K + kh) * D;

  load_tile<T, DMAX>(Qs, qb, q0, Sq, q_stride, D);

  float m[4], l[4], acc[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[i][c] = 0.f;
  }

  int k_lo, k_hi;
  kv_range(q0, Sq, Sk, causal, window, &k_lo, &k_hi);
  for (int k0 = (k_lo / kTile) * kTile; k0 < k_hi; k0 += kTile) {
    __syncthreads();  // the previous tile's readers are done
    load_tile<T, DMAX>(Ks, kb, k0, Sk, kv_stride, D);
    if constexpr (!kShareKV) load_tile<T, DMAX>(Vs, vb, k0, Sk, kv_stride, D);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty + 16 * i) * DS + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * DS + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty + 16 * i;
      float mt = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        s[i][j] = visible(qpos, kpos, Sq, Sk, causal, window) ? s[i][j] * scale
                                                              : kNegInf;
        mt = fmaxf(mt, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mt));
      const float corr = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        Ps[(ty + 16 * i) * kPS + tx + 16 * j] = p;
        rs += p;
      }
      l[i] = l[i] * corr + row_sum(rs);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[i][c] *= corr;
    }
    __syncthreads();
    if constexpr (kShareKV) {  // the scores are formed: V goes over K
      load_tile<T, DMAX>(Vs, vb, k0, Sk, kv_stride, D);
      __syncthreads();
    }

#pragma unroll 4
    for (int j = 0; j < kTile; ++j) {
      float pv[4], vv[CPT];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty + 16 * i) * kPS + j];
#pragma unroll
      for (int c = 0; c < CPT; ++c) vv[c] = Vs[j * DS + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < CPT; ++c) acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + ty + 16 * i;
    if (qpos >= Sq) continue;
    const float lc = fmaxf(l[i], 1e-30f);
    T* orow = o + (((size_t)b * Sq + qpos) * H + h) * D;
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int d = tx + 16 * c;
      if (d < D) orow[d] = from_float<T>(acc[i][c] / lc);
    }
    if (tx == 0) lse[((size_t)b * H + h) * Sq + qpos] = m[i] + logf(lc);
  }
}

// The score tile of rows (ty + 16 i) of Qs/dOs against keys (tx + 16 j) of
// Ks/Vs, turned into P = exp(s - lse) and dS = P (dP - delta) scale under
// the mask; written to Ps (if given) and dSs as [query][key].
template <int DMAX>
__device__ __forceinline__ void grad_scores(
    const float* Qs, const float* dOs, const float* Ks, const float* Vs,
    const float* lse_s, const float* dl_s, float* Ps, float* dSs, int q0,
    int k0, int Sq, int Sk, int D, int causal, int window, float scale) {
  constexpr int DS = DMAX + 1;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float s[4][4], dp[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 2
  for (int d = 0; d < D; ++d) {
    float qv[4], dov[4], kv[4], vv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      qv[i] = Qs[(ty + 16 * i) * DS + d];
      dov[i] = dOs[(ty + 16 * i) * DS + d];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      kv[j] = Ks[(tx + 16 * j) * DS + d];
      vv[j] = Vs[(tx + 16 * j) * DS + d];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
        dp[i][j] = fmaf(dov[i], vv[j], dp[i][j]);
      }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tx + 16 * j;
      const float p = visible(q0 + r, k0 + c, Sq, Sk, causal, window)
                          ? expf(s[i][j] * scale - lse_s[r])
                          : 0.f;
      if (Ps) Ps[r * kPS + c] = p;
      dSs[r * kPS + c] = p * (dp[i][j] - dl_s[r]) * scale;
    }
  }
}

// dK, dV. grid: x = key tiles, y = B * K. block: kThreads. Walks the query
// tiles of all H / K heads of its KV head that the mask lets reach it.
template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, T* __restrict__ dk,
                      T* __restrict__ dv, int Sq, int Sk, int H, int K, int D,
                      int causal, int window, float scale) {
  constexpr int DS = DMAX + 1, CPT = DMAX / 16;
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + kTile * DS;
  float* Qs = Vs + kTile * DS;
  float* dOs = Qs + kTile * DS;
  float* Ps = dOs + kTile * DS;
  float* dSs = Ps + kTile * kPS;
  float* lse_s = dSs + kTile * kPS;
  float* dl_s = lse_s + kTile;

  const int k0 = blockIdx.x * kTile;
  const int b = blockIdx.y / K, kh = blockIdx.y % K, G = H / K;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const size_t q_stride = (size_t)H * D, kv_stride = (size_t)K * D;
  load_tile<T, DMAX>(Ks, k + ((size_t)b * Sk * K + kh) * D, k0, Sk, kv_stride, D);
  load_tile<T, DMAX>(Vs, v + ((size_t)b * Sk * K + kh) * D, k0, Sk, kv_stride, D);

  float dka[4][CPT], dva[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < CPT; ++c) dka[i][c] = dva[i][c] = 0.f;

  // the queries that can see a key of this tile: [q_lo, q_hi)
  const int q_lo = causal ? k0 : 0;
  const int q_hi = window > 0 ? min(Sq, k0 + kTile - 1 + window) : Sq;
  for (int g = 0; g < G; ++g) {
    const int h = kh * G + g;
    const T* qb = q + ((size_t)b * Sq * H + h) * D;
    const T* dob = dout + ((size_t)b * Sq * H + h) * D;
    const float* lse_b = lse + ((size_t)b * H + h) * Sq;
    const float* dl_b = delta + ((size_t)b * H + h) * Sq;
    for (int q0 = (q_lo / kTile) * kTile; q0 < q_hi; q0 += kTile) {
      __syncthreads();  // the previous tile's readers are done
      load_tile<T, DMAX>(Qs, qb, q0, Sq, q_stride, D);
      load_tile<T, DMAX>(dOs, dob, q0, Sq, q_stride, D);
      load_row_vec(lse_s, lse_b, q0, Sq);
      load_row_vec(dl_s, dl_b, q0, Sq);
      __syncthreads();
      grad_scores<DMAX>(Qs, dOs, Ks, Vs, lse_s, dl_s, Ps, dSs, q0, k0, Sq, Sk,
                        D, causal, window, scale);
      __syncthreads();
#pragma unroll 2
      for (int r = 0; r < kTile; ++r) {
        float pv[4], dsv[4], dov[CPT], qv[CPT];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pv[i] = Ps[r * kPS + ty + 16 * i];
          dsv[i] = dSs[r * kPS + ty + 16 * i];
        }
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
          dov[c] = dOs[r * DS + tx + 16 * c];
          qv[c] = Qs[r * DS + tx + 16 * c];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < CPT; ++c) {
            dva[i][c] = fmaf(pv[i], dov[c], dva[i][c]);
            dka[i][c] = fmaf(dsv[i], qv[c], dka[i][c]);
          }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kpos = k0 + ty + 16 * i;
    if (kpos >= Sk) continue;
    const size_t row = (((size_t)b * Sk + kpos) * K + kh) * D;
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int d = tx + 16 * c;
      if (d < D) {
        dk[row + d] = from_float<T>(dka[i][c]);
        dv[row + d] = from_float<T>(dva[i][c]);
      }
    }
  }
}

// dQ. grid: x = query tiles (heaviest first), y = B * H. block: kThreads.
template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int Sq, int Sk, int H, int K, int D, int causal, int window,
                    float scale) {
  constexpr int DS = DMAX + 1, CPT = DMAX / 16;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* dOs = Qs + kTile * DS;
  float* Ks = dOs + kTile * DS;
  float* Vs = Ks + kTile * DS;
  float* dSs = Vs + kTile * DS;
  float* lse_s = dSs + kTile * kPS;
  float* dl_s = lse_s + kTile;

  const int n_qt = (Sq + kTile - 1) / kTile;
  const int q0 = (n_qt - 1 - blockIdx.x) * kTile;
  const int b = blockIdx.y / H, h = blockIdx.y % H, kh = h / (H / K);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const size_t q_stride = (size_t)H * D, kv_stride = (size_t)K * D;
  const T* kb = k + ((size_t)b * Sk * K + kh) * D;
  const T* vb = v + ((size_t)b * Sk * K + kh) * D;
  load_tile<T, DMAX>(Qs, q + ((size_t)b * Sq * H + h) * D, q0, Sq, q_stride, D);
  load_tile<T, DMAX>(dOs, dout + ((size_t)b * Sq * H + h) * D, q0, Sq, q_stride, D);
  load_row_vec(lse_s, lse + ((size_t)b * H + h) * Sq, q0, Sq);
  load_row_vec(dl_s, delta + ((size_t)b * H + h) * Sq, q0, Sq);

  float dqa[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < CPT; ++c) dqa[i][c] = 0.f;

  int k_lo, k_hi;
  kv_range(q0, Sq, Sk, causal, window, &k_lo, &k_hi);
  for (int k0 = (k_lo / kTile) * kTile; k0 < k_hi; k0 += kTile) {
    __syncthreads();  // the previous tile's readers are done
    load_tile<T, DMAX>(Ks, kb, k0, Sk, kv_stride, D);
    load_tile<T, DMAX>(Vs, vb, k0, Sk, kv_stride, D);
    __syncthreads();
    grad_scores<DMAX>(Qs, dOs, Ks, Vs, lse_s, dl_s, nullptr, dSs, q0, k0, Sq,
                      Sk, D, causal, window, scale);
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < kTile; ++j) {
      float dsv[4], kv[CPT];
#pragma unroll
      for (int i = 0; i < 4; ++i) dsv[i] = dSs[(ty + 16 * i) * kPS + j];
#pragma unroll
      for (int c = 0; c < CPT; ++c) kv[c] = Ks[j * DS + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < CPT; ++c) dqa[i][c] = fmaf(dsv[i], kv[c], dqa[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + ty + 16 * i;
    if (qpos >= Sq) continue;
    T* row = dq + (((size_t)b * Sq + qpos) * H + h) * D;
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int d = tx + 16 * c;
      if (d < D) row[d] = from_float<T>(dqa[i][c]);
    }
  }
}

template <typename F>
cudaError_t set_smem(F* kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <typename T, int DMAX>
cudaError_t fwd_typed(const void* q, const void* k, const void* v, void* o,
                      float* lse, int B, int Sq, int Sk, int H, int K, int D,
                      int causal, int window, float scale, cudaStream_t stream) {
  const int tiles = DMAX > 128 ? 2 : 3;  // Q, K and V; V over K at 256
  const size_t smem =
      sizeof(float) * (tiles * kTile * (DMAX + 1) + kTile * kPS);
  cudaError_t err = set_smem(flash_fwd_kernel<T, DMAX>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + kTile - 1) / kTile, B * H);
  flash_fwd_kernel<T, DMAX><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, Sq, Sk, H, K, D,
      causal, window, scale);
  return cudaGetLastError();
}

template <typename T, int DMAX>
cudaError_t bwd_typed(const void* q, const void* k, const void* v,
                      const void* dout, const float* lse, const float* delta,
                      void* dq, void* dk, void* dv, int B, int Sq, int Sk,
                      int H, int K, int D, int causal, int window, float scale,
                      cudaStream_t stream) {
  const T* tq = static_cast<const T*>(q);
  const T* tk = static_cast<const T*>(k);
  const T* tv = static_cast<const T*>(v);
  const T* tdo = static_cast<const T*>(dout);
  const size_t smem_kv =
      sizeof(float) * (4 * kTile * (DMAX + 1) + 2 * kTile * kPS + 2 * kTile);
  cudaError_t err = set_smem(flash_bwd_dkdv_kernel<T, DMAX>, smem_kv);
  if (err != cudaSuccess) return err;
  flash_bwd_dkdv_kernel<T, DMAX>
      <<<dim3((Sk + kTile - 1) / kTile, B * K), kThreads, smem_kv, stream>>>(
          tq, tk, tv, tdo, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv),
          Sq, Sk, H, K, D, causal, window, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t smem_q =
      sizeof(float) * (4 * kTile * (DMAX + 1) + kTile * kPS + 2 * kTile);
  err = set_smem(flash_bwd_dq_kernel<T, DMAX>, smem_q);
  if (err != cudaSuccess) return err;
  flash_bwd_dq_kernel<T, DMAX>
      <<<dim3((Sq + kTile - 1) / kTile, B * H), kThreads, smem_q, stream>>>(
          tq, tk, tv, tdo, lse, delta, static_cast<T*>(dq), Sq, Sk, H, K, D,
          causal, window, scale);
  return cudaGetLastError();
}

// d_max: 256 for the forward, 128 for the backward
bool bad_args(int B, int Sq, int Sk, int H, int K, int D, int dtype,
              int d_max) {
  return B < 1 || Sq < 1 || Sk < 1 || K < 1 || H % K != 0 || D < 8 ||
         D > d_max || D % 8 != 0 || dtype < 0 || dtype > 1 || B * H > 65535;
}

template <typename T>
cudaError_t fwd_dispatch(const void* q, const void* k, const void* v, void* o,
                         float* lse, int B, int Sq, int Sk, int H, int K,
                         int D, int causal, int w, float scale,
                         cudaStream_t s) {
  if (D <= 64)
    return fwd_typed<T, 64>(q, k, v, o, lse, B, Sq, Sk, H, K, D, causal, w, scale, s);
  if (D <= 128)
    return fwd_typed<T, 128>(q, k, v, o, lse, B, Sq, Sk, H, K, D, causal, w, scale, s);
  return fwd_typed<T, 256>(q, k, v, o, lse, B, Sq, Sk, H, K, D, causal, w, scale, s);
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16 (q, k, v, o, dO, dq, dk, dv alike).
// The forward takes D <= 256, the backward D <= 128. causal is 0 or 1;
// window <= 0 means no window. Each returns 0 on success, a cudaError_t from
// a launch, or -1 for arguments the kernels do not take (the Python wrapper
// checks these first).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* o, void* lse, int B, int Sq, int Sk,
                                   int H, int K, int D, int causal, int window,
                                   float scale, int dtype, void* stream) {
  if (bad_args(B, Sq, Sk, H, K, D, dtype, 256)) return -1;
  const auto s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  const int w = window > 0 ? window : 0;
  const cudaError_t err =
      dtype == 0
          ? fwd_dispatch<float>(q, k, v, o, l, B, Sq, Sk, H, K, D, causal, w, scale, s)
          : fwd_dispatch<__nv_bfloat16>(q, k, v, o, l, B, Sq, Sk, H, K, D, causal, w, scale, s);
  return static_cast<int>(err);
}

extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v,
                                   const void* dout, const void* lse,
                                   const void* delta, void* dq, void* dk,
                                   void* dv, int B, int Sq, int Sk, int H,
                                   int K, int D, int causal, int window,
                                   float scale, int dtype, void* stream) {
  if (bad_args(B, Sq, Sk, H, K, D, dtype, 128)) return -1;
  const auto s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  const int w = window > 0 ? window : 0;
  cudaError_t err;
  if (dtype == 0)
    err = D <= 64 ? bwd_typed<float, 64>(q, k, v, dout, l, dl, dq, dk, dv, B, Sq, Sk, H, K, D, causal, w, scale, s)
                  : bwd_typed<float, 128>(q, k, v, dout, l, dl, dq, dk, dv, B, Sq, Sk, H, K, D, causal, w, scale, s);
  else
    err = D <= 64 ? bwd_typed<__nv_bfloat16, 64>(q, k, v, dout, l, dl, dq, dk, dv, B, Sq, Sk, H, K, D, causal, w, scale, s)
                  : bwd_typed<__nv_bfloat16, 128>(q, k, v, dout, l, dl, dq, dk, dv, B, Sq, Sk, H, K, D, causal, w, scale, s);
  return static_cast<int>(err);
}

extern "C" const char* flash_attention_error_string(int code) {
  if (code == -1) return "argument the flash-attention kernels do not take";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

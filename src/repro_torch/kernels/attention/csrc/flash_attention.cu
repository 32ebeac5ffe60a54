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
//   pure-JAX custom-VJP backward of the reference's training path. A pre-pass
//   kernel writes delta = rowsum(dO * O) in float32 (`_flash_bwd` computes it
//   outside its tile loops too, :188); then a dK/dV kernel and a dQ kernel,
//   both recomputing score tiles from lse. No atomics, so the result is the
//   same bits on every run.
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
// Which kernel runs, by dtype and D (no flag or fallback chooses):
//   forward   bfloat16, any D      tensor cores   flash_fwd_mma_kernel
//             float32, any D       CUDA cores     flash_fwd_kernel
//   backward  bfloat16, D <= 128   tensor cores   flash_bwd_dkdv_mma_kernel,
//                                                 flash_bwd_dq_mma_kernel
//             bfloat16, D 256      tensor cores   flash_bwd_dkdv_d256_kernel,
//                                                 flash_bwd_d256_sum_kernel
//                                                 (G > 1), flash_bwd_dq_mma_kernel
//             float32, D <= 128    CUDA cores     flash_bwd_dkdv_kernel,
//                                                 flash_bwd_dq_kernel
//             float32, D 256       CUDA cores     flash_bwd_dkdv_seq_kernel,
//                                                 flash_bwd_dq_seq_kernel
// and flash_bwd_delta_kernel before either backward.
//
// The tensor-core kernels are FlashAttention-2 built from mma.sync m16n8k16
// pieces (bf16 in, float32 accumulators), 4 warps of 16 rows each:
//   * forward, one block per (64-query tile, b, head), heaviest causal tiles
//     first: the Q tile lands once in shared memory and each step reads its A
//     fragments again through ldmatrix (held in registers instead, they cost a
//     block an SM at D 64 and measured slower); K and V tiles of 64 rows (32
//     at D 256, below) pass through a cp.async double buffer (one barrier a
//     step). Each warp forms
//     S = Q K^T for its 16 queries in float32 registers, each k step's 16
//     products summed in a fresh accumulator and added to S in float32 with
//     Kahan's compensation. Why: an mma adds its products to its accumulator
//     at the precision of the largest term, and a float32 add rounds at the
//     precision of the running sum; on scores whose large terms cancel
//     (grok-1's prefill at full width: lse about 0.3 from products summing
//     in magnitude to thousands) a running sum in the accumulator, and
//     fresh sums added in plain float32, both left a row's lse further than
//     2e-5 + 2e-5 |lse| from float64 and from the float32 plain version;
//     compensated, the only rounding left is inside each step's mma. The
//     compensation costs about a quarter of the forward's time; at D 64 the
//     launch bounds hold it to 128 registers (68 bytes spilled) and 4 blocks
//     an SM, which measured faster than 184 registers and 2 blocks, or 168
//     and 3. It masks S only
//     on tiles not wholly visible, keeps the running max and its part of the
//     normaliser in registers (row maxima from the 4 lanes that share a row,
//     ex2.approx with log2 e folded into the scale), rescales its O accumulator
//     (16 x D float32) once a step, splits P into bf16 hi + lo repacked as A
//     fragments in registers and adds P V (two mma on each V fragment, through
//     ldmatrix.trans). o = O / max(l, 1e-30), lse in nats.
//   * dK/dV kernel, one block per (64-key tile, b, KV head): K and V stay in
//     shared memory as bf16; for each of the G = H / K query heads and each
//     query tile the mask lets reach the key tile, Q and dO tiles (QT rows:
//     64 at D <= 64, 16 at D <= 128, where dK and dV alone hold 128 float32
//     a thread) with their lse and delta rows pass through the double
//     buffer. Each warp forms, for its 16 keys, S^T = K Q^T, then P^T =
//     exp(S^T scale - lse) under the mask in float32 registers, splits P^T
//     into hi + lo A fragments, and adds P^T dO to dV; then dP^T = V dO^T,
//     dS^T = P^T (dP^T - delta) scale with P^T read back from hi + lo,
//     split the same way, and dK += dS^T Q. Formed in that order, no two of
//     S^T, P^T, dP^T and dS^T are live at once, so the D 64 instantiation
//     fits 168 registers (3 blocks an SM) with no spill. dK and dV
//     accumulate in float32 over all G heads.
//   * dQ kernel, one block per (64-query tile, b, head), heaviest causal
//     tiles first: Q, dO, lse and delta resident, 64-row K and V tiles
//     through the double buffer; S and dP again, then dQ += dS K.
//   Tiles are bf16 rows padded by 8 elements (ldmatrix reads no bank twice),
//   loaded with 16-byte cp.async (so q, k, v, o and dO must be 16-byte
//   aligned), zero past S and past D up to the next multiple of 16 (the k
//   depth of an mma); each k step's B fragments are loaded together before
//   their mma. Why hi + lo: one bf16 rounding of P and dS (FlashAttention-
//   2's) takes all of the gradients' bound at S 4096, where the first rows'
//   large terms meet a tensor whose scale the many small late rows set; in
//   the forward one rounding of P takes most of o's bound at S 4096 and,
//   through delta = rowsum(dO o), pushes dq to its bound; the split leaves
//   the outputs' own rounding. So the forward does 3 products' worth of mma
//   where the bound counts 2, the backward 10 where it counts 5. What bounds
//   them now: mma.sync (not wgmma), the warps an SM has to hide the chains
//   of dependent mma, and the elementwise work between the products. Left
//   for later: wgmma with TMA and a warp-specialised pipeline.
//
// The forward at head dim 256 (RecurrentGemma-2B's prefill: H 10, K 1,
// window 2048) is the same kernel with a 32-key step. A warp's O
// accumulator, 16 rows x 256 float32, is 128 registers a thread of the 255
// a thread may have; at a 64-key step S, its compensation and P's hi + lo
// fragments would add 96 more and spill, at 32 keys they add 48 (249
// registers, no spill). The Q tile (64 x 264 bf16, 33.8 KB) and the
// two-stage ring of 32-row K and V tiles (67.6 KB) take 101 KB of shared
// memory: two blocks, 8 warps, an SM, as at D 128 and half D 64's. The
// window's leading key steps are skipped (kv_range), and the masks,
// numerics and outputs are those of D <= 128. At
// RecurrentGemma's prefill shape (B 8, S 4096, bf16) the forward does
// 5.15e11 FLOPs: 0.52 ms on the tensor cores.
//
// The backward at head dim 256 (RecurrentGemma-2B's training: B 1 or 2, S
// 4096, H 10, K 1, window 2048). bf16: a warp's dK and dV accumulators
// together would be 2 x 16 x 256 float32, 256 registers a thread before
// anything else, and at MQA a grid over (key tile, KV head) is 64 blocks
// for 132 SMs at B 1. So flash_bwd_dkdv_d256_kernel takes one block per
// (query head, 64-key tile), B * H x Sk / 64 (640 at B 1), x fastest so
// that the heaviest causal key tiles start first. A block is two
// warpgroups on the same 64 keys, 16 a warp: warps 0-3 hold dV, warps 4-7
// dK, one 128-register accumulator each. A step's 64 query rows of Q and dO
// (with lse and delta) land in shared memory once, through the double
// buffer, for both. The dV warps form S^T = K Q^T and P^T and hand P^T to
// the dK warps as bf16 hi + lo A fragments in shared memory while the dK
// warps form dP^T = V dO^T; after a barrier the dV warps add P^T dO, and the
// dK warps form dS^T from that hi + lo P^T and add dS^T Q. So a visible pair
// costs 6 products' worth of mma (S^T, dP^T, and two hi + lo products),
// 3 in each warpgroup, in one launch.
// With G = H / K > 1 a block writes its head's float32 share of dK and dV
// to a workspace ((B, Sk, H, D) each, 84 MB at B 1), and
// flash_bwd_d256_sum_kernel adds the G shares of each KV head in head
// order, in float32, and rounds once to bf16: no atomics, the same bits on
// every run; with G 1 the share is the gradient and is stored as bf16. The
// dQ kernel takes 16-key steps: its accumulator holds 128 float32 a thread,
// and the smaller K and V ring (101,376 B a block) lets two blocks (8
// warps) share an SM. Whatever the step, each product adds its 16-query
// or 16-key sums to its accumulator in the same order, so the step sizes
// leave the bits alone. -Xptxas -v: 249 registers a dK/dV
// thread, 208 a dQ thread, no spill; 220,160 B shared a dK/dV block, one
// block (8 warps) an SM. Masks, hi + lo splits of P and dS, delta and the
// window's skipped tiles are those of D <= 128. At the training shape the
// backward does 1.61e11 FLOPs at B 1 (5 products a pair): 0.163 ms on the
// tensor cores. What bounds it now: mma.sync's issue and the chains
// between products (the dK/dV kernel runs its 6 products at about 190
// TFLOP/s, the dQ kernel its 4 at about 100), not bytes.
//
// The CUDA-core design (float32) is simple and exact, not fast. Every
// product runs in float32 on the CUDA cores, so
// it is bound by the CUDA cores' float32 rate and shared-memory traffic, far
// from the tensor-core bound. A block of 256 threads owns a 64-row tile;
// tiles of 64 rows of Q, K, V (and dO) are staged in shared memory as
// float32, zero-padded to DMAX (64 or 128; the forward also 256) columns,
// rows strided DMAX + 1 so that the 16 lanes of a half-warp reading 16 rows
// hit 16 banks. Each thread holds a 4 x 4 block of the 64 x 64 score tile
// (rows ty + 16 i, keys tx + 16 j, with ty = tid / 16 and tx = tid % 16), so
// row reductions are four xor-shuffles inside a half-warp. The forward keeps
// the running max, normaliser and output accumulator of its 4 rows in
// registers, skips the KV tiles the mask hides (causal: it stops at the
// diagonal tile; window: it starts at the first tile inside the window) and
// starts the heaviest causal query tiles first.
//
// The float32 forward at head dim 256: Q, K and V tiles of 64 x 257 floats
// and the score tile would take 214 KB of the 227 KB a block may have. So
// at DMAX 256 the V tile reuses the K tile's buffer: a KV step loads K,
// forms the scores and P, then loads V over K and applies P (one more
// barrier per KV tile), and the block holds 148 KB. The D <= 128
// instantiations keep their separate K and V buffers and their code. The
// float32 backward at head dim 256 does the same with its own two kernels
// (flash_bwd_dkdv_seq_kernel, flash_bwd_dq_seq_kernel): K and V (or Q and
// dO) stay resident and one staging tile takes Q, dO and Q again (or K, V
// and K again) in turn, 231,168 B (214,528 B) a block.

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

// acc[i][j] = sum_d A[ty + 16 i][d] Bm[tx + 16 j][d] over [0, D): a 64 x 64
// score tile from two staged tiles, in grad_scores' order of operations.
template <int DMAX>
__device__ __forceinline__ void tile_dot(const float* A, const float* Bm, int D,
                                         float (&acc)[4][4]) {
  constexpr int DS = DMAX + 1;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 2
  for (int d = 0; d < D; ++d) {
    float av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = A[(ty + 16 * i) * DS + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = Bm[(tx + 16 * j) * DS + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// P = exp(s scale - lse) under the mask, for the 4 x 4 entries a thread owns
// (rows q0 + ty + 16 i, keys k0 + tx + 16 j): s is overwritten by P.
__device__ __forceinline__ void tile_p(float (&s)[4][4], const float* lse_s,
                                       int q0, int k0, int Sq, int Sk,
                                       int causal, int window, float scale) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = ty + 16 * i, c = tx + 16 * j;
      s[i][j] = visible(q0 + r, k0 + c, Sq, Sk, causal, window)
                    ? expf(s[i][j] * scale - lse_s[r])
                    : 0.f;
    }
}

// dS = P (dP - delta) scale into dSs[query][key] (kPS stride).
__device__ __forceinline__ void tile_ds(float* dSs, const float (&p)[4][4],
                                        const float (&dp)[4][4],
                                        const float* dl_s, float scale) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = ty + 16 * i;
      dSs[r * kPS + tx + 16 * j] = p[i][j] * (dp[i][j] - dl_s[r]) * scale;
    }
}

// The float32 backward at head dim 256 (see the header): four 64 x 257
// float32 tiles do not fit a block's shared memory, so one staging buffer
// takes Q, dO and Q again in turn (dK/dV kernel), or K, V and K again (dQ
// kernel), with a barrier between; the arithmetic is that of the D <= 128
// kernels.
//
// dK, dV. grid: x = key tiles, y = B * K. block: kThreads.
template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_seq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const T* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta, T* __restrict__ dk,
                          T* __restrict__ dv, int Sq, int Sk, int H, int K,
                          int D, int causal, int window, float scale) {
  constexpr int DS = DMAX + 1, CPT = DMAX / 16;
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + kTile * DS;
  float* Xs = Vs + kTile * DS;  // Q, dO, then Q again
  float* Ps = Xs + kTile * DS;
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

  const int q_lo = causal ? k0 : 0;
  const int q_hi = window > 0 ? min(Sq, k0 + kTile - 1 + window) : Sq;
  for (int g = 0; g < G; ++g) {
    const int h = kh * G + g;
    const T* qb = q + ((size_t)b * Sq * H + h) * D;
    const T* dob = dout + ((size_t)b * Sq * H + h) * D;
    for (int q0 = (q_lo / kTile) * kTile; q0 < q_hi; q0 += kTile) {
      __syncthreads();  // the previous tile's readers are done
      load_tile<T, DMAX>(Xs, qb, q0, Sq, q_stride, D);
      load_row_vec(lse_s, lse + ((size_t)b * H + h) * Sq, q0, Sq);
      load_row_vec(dl_s, delta + ((size_t)b * H + h) * Sq, q0, Sq);
      __syncthreads();
      float p[4][4], dp[4][4];
      tile_dot<DMAX>(Xs, Ks, D, p);  // S = Q K^T
      tile_p(p, lse_s, q0, k0, Sq, Sk, causal, window, scale);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) Ps[(ty + 16 * i) * kPS + tx + 16 * j] = p[i][j];
      __syncthreads();  // Q's readers are done
      load_tile<T, DMAX>(Xs, dob, q0, Sq, q_stride, D);
      __syncthreads();
      tile_dot<DMAX>(Xs, Vs, D, dp);  // dP = dO V^T
      tile_ds(dSs, p, dp, dl_s, scale);
      __syncthreads();
#pragma unroll 2
      for (int r = 0; r < kTile; ++r) {  // dV += P^T dO
        float pv[4], dov[CPT];
#pragma unroll
        for (int i = 0; i < 4; ++i) pv[i] = Ps[r * kPS + ty + 16 * i];
#pragma unroll
        for (int c = 0; c < CPT; ++c) dov[c] = Xs[r * DS + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < CPT; ++c) dva[i][c] = fmaf(pv[i], dov[c], dva[i][c]);
      }
      __syncthreads();  // dO's readers are done
      load_tile<T, DMAX>(Xs, qb, q0, Sq, q_stride, D);
      __syncthreads();
#pragma unroll 2
      for (int r = 0; r < kTile; ++r) {  // dK += dS^T Q
        float dsv[4], qv[CPT];
#pragma unroll
        for (int i = 0; i < 4; ++i) dsv[i] = dSs[r * kPS + ty + 16 * i];
#pragma unroll
        for (int c = 0; c < CPT; ++c) qv[c] = Xs[r * DS + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < CPT; ++c) dka[i][c] = fmaf(dsv[i], qv[c], dka[i][c]);
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

// dQ at head dim 256. grid: x = query tiles (heaviest first), y = B * H.
// block: kThreads.
template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_seq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, T* __restrict__ dq,
                        int Sq, int Sk, int H, int K, int D, int causal,
                        int window, float scale) {
  constexpr int DS = DMAX + 1, CPT = DMAX / 16;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* dOs = Qs + kTile * DS;
  float* Xs = dOs + kTile * DS;  // K, V, then K again
  float* dSs = Xs + kTile * DS;
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
    load_tile<T, DMAX>(Xs, kb, k0, Sk, kv_stride, D);
    __syncthreads();
    float p[4][4], dp[4][4];
    tile_dot<DMAX>(Qs, Xs, D, p);  // S = Q K^T
    tile_p(p, lse_s, q0, k0, Sq, Sk, causal, window, scale);
    __syncthreads();  // K's readers are done
    load_tile<T, DMAX>(Xs, vb, k0, Sk, kv_stride, D);
    __syncthreads();
    tile_dot<DMAX>(dOs, Xs, D, dp);  // dP = dO V^T
    tile_ds(dSs, p, dp, dl_s, scale);
    __syncthreads();  // V's readers are done, dS is whole
    load_tile<T, DMAX>(Xs, kb, k0, Sk, kv_stride, D);
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < kTile; ++j) {  // dQ += dS K
      float dsv[4], kv[CPT];
#pragma unroll
      for (int i = 0; i < 4; ++i) dsv[i] = dSs[(ty + 16 * i) * kPS + j];
#pragma unroll
      for (int c = 0; c < CPT; ++c) kv[c] = Xs[j * DS + tx + 16 * c];
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

// delta[b, h, s] = sum_d dO[b, s, h, d] O[b, s, h, d] in float32, one thread
// a row, the rows in memory order, 16-byte loads (D is a multiple of 8, the
// rows 16-byte aligned).
template <typename T>
__global__ void __launch_bounds__(256)
flash_bwd_delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                       float* __restrict__ delta, long long rows, int Sq,
                       int H, int D) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= rows) return;
  const long long bs = i / H;  // row i is (b, s, h)
  const int h = static_cast<int>(i % H), s = static_cast<int>(bs % Sq);
  const size_t off = (size_t)i * D;
  constexpr int kPer = 16 / sizeof(T);
  const uint4* o4 = reinterpret_cast<const uint4*>(o + off);
  const uint4* d4 = reinterpret_cast<const uint4*>(dout + off);
  float acc = 0.f;
  for (int c = 0; c < D / kPer; ++c) {
    const uint4 a = o4[c], b = d4[c];
    const T* ea = reinterpret_cast<const T*>(&a);
    const T* eb = reinterpret_cast<const T*>(&b);
#pragma unroll
    for (int j = 0; j < kPer; ++j) acc = fmaf(to_float(eb[j]), to_float(ea[j]), acc);
  }
  delta[((size_t)(bs / Sq) * H + h) * Sq + s] = acc;
}

// ---------------------------------------------------------------------------
// bfloat16 backward on the tensor cores (mma.sync m16n8k16, float32
// accumulators); see the header
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int kMmaThreads = 128;  // 4 warps of 16 rows
constexpr int kMmaTile = 64;      // key rows of a dK/dV block, query rows of a
                                  // dQ block, key rows of a dQ step
constexpr int kStages = 2;        // steps in each kernel's cp.async ring (a
                                  // double buffer: deeper rings measured no
                                  // faster)
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
static_assert(kMmaTile == kTile, "the dQ kernel takes kv_range's query tile");

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

// 4 bytes global -> shared; zero-filled when src_bytes is 0
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
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

// d = a (16 x 16, row) * b (16 x 8, col), bf16 in, float32 out: a fresh
// accumulator, its input taken as 0
__device__ __forceinline__ void mma_bf16_fresh(float (&d)[4],
                                               const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(0.f));
}

// 2^x on the special-function unit; a result below float32's normal range
// is flushed to 0 (exp2f spends instructions to return it as a denormal)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// two floats -> one bf16x2 register, x0 in the low half (the lower column)
__device__ __forceinline__ uint32_t pack_bf16(float x0, float x1) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(x0, x1);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// two floats -> two bf16x2 registers: hi = x cut to bf16 (its top 16
// bits, x - hi exact in float32) and lo = bf16(x - hi); hi + lo carries x
// to about 16 bits
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  const uint32_t u0 = __float_as_uint(x0) & 0xffff0000u;
  const uint32_t u1 = __float_as_uint(x1) & 0xffff0000u;
  hi = __byte_perm(u0, u1, 0x7632);  // x0's top half low, x1's high
  lo = pack_bf16(x0 - __uint_as_float(u0), x1 - __uint_as_float(u1));
}

// Rows [row0, row0 + ROWS) of a (S, stride) row-major bf16 view into
// dst[ROWS][DMAX + 8], columns [0, round16(D)): zero past S and past D.
template <int ROWS, int DMAX>
__device__ __forceinline__ void load_tile_async(bf16* dst, const bf16* src,
                                                int row0, int S, size_t stride,
                                                int D) {
  constexpr int LD = DMAX + 8;
  const int chunks = (D + 15) / 16 * 2;  // of 8 columns
  for (int i = threadIdx.x; i < ROWS * chunks; i += kMmaThreads) {
    const int r = i / chunks, c = (i % chunks) * 8;
    const bool in = row0 + r < S && c < D;
    cp_async16(dst + r * LD + c, in ? src + (size_t)(row0 + r) * stride + c : src,
               in ? 16 : 0);
  }
}

// Rows [row0, row0 + ROWS) of a (S,) float32 vector; zero past S.
template <int ROWS>
__device__ __forceinline__ void load_rows_async(float* dst, const float* src,
                                                int row0, int S) {
  for (int r = threadIdx.x; r < ROWS; r += kMmaThreads) {
    const bool in = row0 + r < S;
    cp_async4(dst + r, in ? src + row0 + r : src, in ? 4 : 0);
  }
}

// The products below load kBatch B fragments (ldmatrix.x4) at a time before
// their mma, so the loads' latencies overlap one another.
constexpr int kBatch = 4;

// s += x in float32 with Kahan's compensation: comp carries the negative
// of what the sums so far have lost, and s - comp is the sum
__device__ __forceinline__ void kahan_add(float& s, float& comp, float x) {
  const float y = x - comp, t = s + y;
  comp = (t - s) - y;
  s = t;
}

// How a k step's products meet the accumulator: kAdd, acc += A B^T inside
// the mma; kFresh, acc = A B^T of this step alone (acc's input unread);
// kKahan, this step's products (in a fresh accumulator) added to acc in
// float32 by kahan_add, with comp the compensation.
enum StepMode { kAdd, kFresh, kKahan };

// One k step of acc (16 x 8 NT) += A B^T, columns [16 kk, 16 kk + 16): A
// the warp's 16 rows at a, B the NT * 8 rows at b, both [rows][DMAX + 8] in
// shared memory; see StepMode.
template <int NT, int DMAX, StepMode MODE = kAdd>
__device__ __forceinline__ void mma_abt_step(float (&acc)[NT][4],
                                             const bf16* a, const bf16* b,
                                             int kk, float (&comp)[NT][4]) {
  constexpr int LD = DMAX + 8, NP = NT / 2, NB = NP < kBatch ? NP : kBatch;
  static_assert(NP % NB == 0, "whole batches of B fragments");
  const int lane = threadIdx.x & 31;
  uint32_t af[4];
  ldmatrix_x4(af, a + (lane & 15) * LD + kk * 16 + (lane >> 4) * 8);
#pragma unroll
  for (int p0 = 0; p0 < NP; p0 += NB) {
    // (rows 0-7 | 8-15 of pair p) x (k 0-7 | 8-15): b0, b1 of each n8 tile
    uint32_t bf[NB][4];
#pragma unroll
    for (int p = 0; p < NB; ++p)
      ldmatrix_x4(bf[p], b + ((p0 + p) * 16 + (lane & 7) + (lane >> 4) * 8) * LD +
                             kk * 16 + ((lane >> 3) & 1) * 8);
#pragma unroll
    for (int p = 0; p < NB; ++p) {
      const int j = 2 * (p0 + p);
      if constexpr (MODE == kFresh) {
        mma_bf16_fresh(acc[j], af, bf[p][0], bf[p][1]);
        mma_bf16_fresh(acc[j + 1], af, bf[p][2], bf[p][3]);
      } else if constexpr (MODE == kKahan) {
        float c[2][4];
        mma_bf16_fresh(c[0], af, bf[p][0], bf[p][1]);
        mma_bf16_fresh(c[1], af, bf[p][2], bf[p][3]);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            kahan_add(acc[j + i][e], comp[j + i][e], c[i][e]);
      } else {
        mma_bf16(acc[j], af, bf[p][0], bf[p][1]);
        mma_bf16(acc[j + 1], af, bf[p][2], bf[p][3]);
      }
    }
  }
}

template <int NT, int DMAX, StepMode MODE = kAdd>
__device__ __forceinline__ void mma_abt_step(float (&acc)[NT][4],
                                             const bf16* a, const bf16* b,
                                             int kk) {
  static_assert(MODE != kKahan, "kKahan needs its compensation");
  mma_abt_step<NT, DMAX, MODE>(acc, a, b, kk, acc);
}

// acc (16 x 8 NT) += A B^T summed over columns [0, 16 nk16).
template <int NT, int DMAX>
__device__ __forceinline__ void mma_abt(float (&acc)[NT][4], const bf16* a,
                                        const bf16* b, int nk16) {
#pragma unroll
  for (int kk = 0; kk < DMAX / 16; ++kk)
    if (kk < nk16) mma_abt_step<NT, DMAX>(acc, a, b, kk);
}

// acc (16 x DMAX) += A B: A (16 x 16 NK) as bf16 A fragments hi + lo (two
// products on each B fragment), B the 16 NK rows at b ([rows][DMAX + 8],
// row-major, so through ldmatrix.trans), columns [0, 16 nd16).
template <int NK, int DMAX>
__device__ __forceinline__ void mma_ab(float (&acc)[DMAX / 8][4],
                                       const uint32_t (&hi)[NK][4],
                                       const uint32_t (&lo)[NK][4],
                                       const bf16* b, int nd16) {
  constexpr int LD = DMAX + 8, NP = DMAX / 16;
  static_assert(NP % kBatch == 0, "whole batches of B fragments");
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int kk = 0; kk < NK; ++kk) {
#pragma unroll
    for (int p0 = 0; p0 < NP; p0 += kBatch) {
      if (p0 < nd16) {
        uint32_t bf[kBatch][4];
#pragma unroll
        for (int p = 0; p < kBatch; ++p)
          if (p0 + p < nd16)
            ldmatrix_x4_trans(bf[p], b + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                                         (p0 + p) * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int p = 0; p < kBatch; ++p) {
          if (p0 + p < nd16) {
            mma_bf16(acc[2 * (p0 + p)], hi[kk], bf[p][0], bf[p][1]);
            mma_bf16(acc[2 * (p0 + p)], lo[kk], bf[p][0], bf[p][1]);
            mma_bf16(acc[2 * (p0 + p) + 1], hi[kk], bf[p][2], bf[p][3]);
            mma_bf16(acc[2 * (p0 + p) + 1], lo[kk], bf[p][2], bf[p][3]);
          }
        }
      }
    }
  }
}

// Accumulator fragments (16 x 16 NK: n8 tiles 2kk, 2kk + 1) split into bf16
// hi + lo and repacked as the A fragments of the next product, in
// registers: the C layout's (row g | g + 8, columns 2t, 2t + 1) is the A
// layout's. Why hi + lo rather than one rounding: see the header.
template <int NK>
__device__ __forceinline__ void to_a_frags(uint32_t (&hi)[NK][4],
                                           uint32_t (&lo)[NK][4],
                                           const float (&c)[2 * NK][4]) {
#pragma unroll
  for (int kk = 0; kk < NK; ++kk) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float* x = c[2 * kk + (r >> 1)] + 2 * (r & 1);
      split_bf16(x[0], x[1], hi[kk][r], lo[kk][r]);
    }
  }
}

// dS^T = P^T (dP^T - delta) scale in place of dP^T (fragment c), P^T read
// back from its hi + lo A fragments (to about 16 bits), delta by query
// column (dl).
template <int NK>
__device__ __forceinline__ void ds_from_p(float (&c)[2 * NK][4],
                                          const uint32_t (&hi)[NK][4],
                                          const uint32_t (&lo)[NK][4],
                                          const float* dl, float scale) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int kk = 0; kk < NK; ++kk) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      float* x = c[2 * kk + (r >> 1)] + 2 * (r & 1);
      const int qc = (2 * kk + (r >> 1)) * 8 + 2 * t;
      const float p0 = __uint_as_float(hi[kk][r] << 16) + __uint_as_float(lo[kk][r] << 16);
      const float p1 = __uint_as_float(hi[kk][r] & 0xffff0000u) +
                       __uint_as_float(lo[kk][r] & 0xffff0000u);
      x[0] = p0 * (x[0] - dl[qc]) * scale;
      x[1] = p1 * (x[1] - dl[qc + 1]) * scale;
    }
  }
}

template <int N>
__device__ __forceinline__ void zero(float (&x)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i) x[i][0] = x[i][1] = x[i][2] = x[i][3] = 0.f;
}

// Store a warp's (16 x D) float32 accumulator as bf16 rows row0 + r (r < 16,
// rows past S skipped) of a view with row stride `stride`.
template <int DT>
__device__ __forceinline__ void store_rows(bf16* dst, const float (&acc)[DT][4],
                                           int row0, int S, size_t stride,
                                           int D) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < DT; ++nt) {
    if (nt < D / 8) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int row = row0 + g + hf * 8;
        if (row < S)
          *reinterpret_cast<uint32_t*>(dst + (size_t)row * stride + nt * 8 + 2 * t) =
              pack_bf16(acc[nt][2 * hf], acc[nt][2 * hf + 1]);
      }
    }
  }
}

// Whether every (query, key) pair of a tile is visible (no mask to apply).
__device__ __forceinline__ bool tile_visible(int q0, int qrows, int k0,
                                             int krows, int Sq, int Sk,
                                             int causal, int window) {
  return q0 + qrows <= Sq && k0 + krows <= Sk &&
         (!causal || q0 >= k0 + krows - 1) &&
         (window <= 0 || q0 + qrows - 1 - k0 < window);
}

// One dK/dV step's Q and dO rows [q0, q0 + QT) of head h, with their lse
// and delta, into buffer `buf`.
template <int DMAX, int QT>
__device__ __forceinline__ void load_q_step(
    bf16* Qs, bf16* dOs, float* lse_s, float* dl_s, int buf,
    const bf16* __restrict__ q, const bf16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta, int b,
    int h, int q0, int Sq, int H, int D) {
  constexpr int LD = DMAX + 8;
  const size_t head = ((size_t)b * Sq * H + h) * D, row = ((size_t)b * H + h) * Sq;
  load_tile_async<QT, DMAX>(Qs + buf * QT * LD, q + head, q0, Sq, (size_t)H * D, D);
  load_tile_async<QT, DMAX>(dOs + buf * QT * LD, dout + head, q0, Sq, (size_t)H * D, D);
  load_rows_async<QT>(lse_s + buf * QT, lse + row, q0, Sq);
  load_rows_async<QT>(dl_s + buf * QT, delta + row, q0, Sq);
}

// dK, dV at D <= 128. grid: x = 64-key tiles, y = B * K. block:
// kMmaThreads; warp w owns keys k0 + 16 w .. + 16. QT query rows a step.
template <int DMAX, int QT>
__global__ void __launch_bounds__(kMmaThreads, DMAX == 64 ? 3 : 1)  // 168 registers
flash_bwd_dkdv_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                          const bf16* __restrict__ v,
                          const bf16* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta, bf16* __restrict__ dk,
                          bf16* __restrict__ dv, int Sq, int Sk, int H, int K,
                          int D, int causal, int window, float scale) {
  constexpr int LD = DMAX + 8, NT = QT / 8, NK = QT / 16, DT = DMAX / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* Vs = Ks + kMmaTile * LD;
  bf16* Qs = Vs + kMmaTile * LD;       // [kStages][QT][LD]
  bf16* dOs = Qs + kStages * QT * LD;  // [kStages][QT][LD]
  float* lse_s = reinterpret_cast<float*>(dOs + kStages * QT * LD);  // [kStages][QT]
  float* dl_s = lse_s + kStages * QT;  // [kStages][QT]

  const int k0 = blockIdx.x * kMmaTile;
  const int b = blockIdx.y / K, kh = blockIdx.y % K, G = H / K;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const size_t kv_stride = (size_t)K * D, kv_base = ((size_t)b * Sk * K + kh) * D;
  const int n16 = (D + 15) / 16;

  load_tile_async<kMmaTile, DMAX>(Ks, k + kv_base, k0, Sk, kv_stride, D);
  load_tile_async<kMmaTile, DMAX>(Vs, v + kv_base, k0, Sk, kv_stride, D);

  // the queries that can see a key of this tile: [q_lo, q_hi); steps of QT
  // rows from q_first, for each of the G heads in turn
  const int q_lo = causal ? k0 : 0;
  const int q_hi = window > 0 ? min(Sq, k0 + kMmaTile - 1 + window) : Sq;
  const int q_first = (q_lo / QT) * QT;
  const int n_q = q_hi > q_first ? (q_hi - q_first + QT - 1) / QT : 0;
  const int n_it = G * n_q;
  // the ring's first kStages - 1 steps (the first group also holds K and V)
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < n_it)
      load_q_step<DMAX, QT>(Qs, dOs, lse_s, dl_s, st, q, dout, lse, delta, b,
                            kh * G + st / n_q, q_first + (st % n_q) * QT, Sq,
                            H, D);
    cp_async_commit();
  }

  float dka[DT][4], dva[DT][4];
  zero(dka);
  zero(dva);
  const int kw = k0 + warp * 16;  // this warp's first key
  const float scale_l2 = scale * kLog2e;
  for (int it = 0; it < n_it; ++it) {
    cp_async_wait<kStages - 2>();  // step it has landed
    __syncthreads();              // ... for every thread; and the stage
                                  // refilled next was read last step
    const int nx = it + kStages - 1;
    if (nx < n_it)
      load_q_step<DMAX, QT>(Qs, dOs, lse_s, dl_s, nx % kStages, q, dout, lse,
                            delta, b, kh * G + nx / n_q,
                            q_first + (nx % n_q) * QT, Sq, H, D);
    cp_async_commit();
    const int buf = it % kStages, q0 = q_first + (it % n_q) * QT;
    const bf16* Qb = Qs + buf * QT * LD;
    const bf16* dOb = dOs + buf * QT * LD;
    const float* lse_b = lse_s + buf * QT;
    const float* dl_b = dl_s + buf * QT;

    // S^T, P^T, dP^T and dS^T (rows the warp's keys g, g + 8, columns
    // queries) in turn, so that no two are live at once
    const bool all = tile_visible(q0, QT, k0, kMmaTile, Sq, Sk, causal, window);
    float x[NT][4];
    uint32_t hi[NK][4], lo[NK][4];
    zero(x);
    mma_abt<NT, DMAX>(x, Ks + warp * 16 * LD, Qb, n16);  // S^T = K Q^T
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qc = j * 8 + 2 * t + (e & 1);
        x[j][e] = all || visible(q0 + qc, kw + g + (e >> 1) * 8, Sq, Sk,
                                 causal, window)
                      ? exp2f(fmaf(x[j][e], scale_l2, -lse_b[qc] * kLog2e))
                      : 0.f;
      }
    }
    to_a_frags(hi, lo, x);                    // P^T as hi + lo
    mma_ab<NK, DMAX>(dva, hi, lo, dOb, n16);  // dV += P^T dO
    zero(x);
    mma_abt<NT, DMAX>(x, Vs + warp * 16 * LD, dOb, n16);  // dP^T = V dO^T
    ds_from_p(x, hi, lo, dl_b, scale);        // dS^T = P^T (dP^T - delta) scale
    to_a_frags(hi, lo, x);
    mma_ab<NK, DMAX>(dka, hi, lo, Qb, n16);   // dK += dS^T Q
  }
  cp_async_wait<0>();

  store_rows(dk + kv_base, dka, kw, Sk, kv_stride, D);
  store_rows(dv + kv_base, dva, kw, Sk, kv_stride, D);
}

// ---------------------------------------------------------------------------
// bfloat16 dK and dV at head dim 256 (see the header): one block per (query
// head, 64-key tile), two warpgroups on the same keys
// ---------------------------------------------------------------------------

constexpr int kD256Threads = 256;  // warps 0-3 form dV, warps 4-7 dK
constexpr int kD256QT = 64;        // query rows a step

// A (16 x D) float32 accumulator as float32 rows row0 + r (r < 16, rows
// past S skipped) of a view with row stride `stride`: a query head's share.
template <int DT>
__device__ __forceinline__ void store_rows_f32(float* dst,
                                               const float (&acc)[DT][4],
                                               int row0, int S, size_t stride,
                                               int D) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < DT; ++nt) {
    if (nt < D / 8) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int row = row0 + g + hf * 8;
        if (row < S)
          *reinterpret_cast<float2*>(dst + (size_t)row * stride + nt * 8 + 2 * t) =
              make_float2(acc[nt][2 * hf], acc[nt][2 * hf + 1]);
      }
    }
  }
}

// dK and dV of query head h's share of a 64-key tile. grid: x = B * H
// (query heads, fastest, so the heaviest causal key tiles start first), y =
// 64-key tiles. block: kD256Threads; warp w owns keys k0 + 16 (w % 4) .. +
// 16, as its dV (w < 4) or its dK (w >= 4). A step's Q and dO rows land in
// shared memory once for both. The dV warps form S^T = K Q^T and P^T, and
// pass P^T as bf16 hi + lo A fragments through shared memory while the dK
// warps form dP^T = V dO^T; after a barrier the dV warps add P^T dO and the
// dK warps form dS^T from the same hi + lo P^T and add dS^T Q. With G = H /
// K > 1 each block writes its head's float32 share to ws_dk / ws_dv ((B,
// Sk, H, D)), which flash_bwd_d256_sum_kernel sums over the group in head
// order; with G 1 the share is the gradient, stored as bf16.
template <int QT>
__global__ void __launch_bounds__(kD256Threads, 1)
flash_bwd_dkdv_d256_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                           const bf16* __restrict__ v,
                           const bf16* __restrict__ dout,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta,
                           bf16* __restrict__ dk, bf16* __restrict__ dv,
                           float* __restrict__ ws_dk, float* __restrict__ ws_dv,
                           int Sq, int Sk, int H, int K, int D, int causal,
                           int window, float scale) {
  constexpr int DMAX = 256, LD = DMAX + 8, NT = QT / 8, NK = QT / 16,
                DT = DMAX / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* Vs = Ks + kMmaTile * LD;
  bf16* Qs = Vs + kMmaTile * LD;       // [kStages][QT][LD]
  bf16* dOs = Qs + kStages * QT * LD;  // [kStages][QT][LD]
  float* lse_s = reinterpret_cast<float*>(dOs + kStages * QT * LD);  // [kStages][QT]
  float* dl_s = lse_s + kStages * QT;  // [kStages][QT]
  // P^T of the dV warps: [warp][hi, lo][NK][4][lane]
  uint32_t* Ps = reinterpret_cast<uint32_t*>(dl_s + kStages * QT);

  const int b = blockIdx.x / H, h = blockIdx.x % H, kh = h / (H / K);
  const int k0 = blockIdx.y * kMmaTile;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int t = lane & 3, g = lane >> 2;
  const bool dv_warp = warp < 4;
  const int kw = k0 + (warp & 3) * 16;  // this warp's first key
  const size_t kv_stride = (size_t)K * D, kv_base = ((size_t)b * Sk * K + kh) * D;
  const int n16 = (D + 15) / 16;
  // the loads are issued by the dV warps (the helpers stride kMmaThreads)
  const bool loader = threadIdx.x < kMmaThreads;

  if (loader) {
    load_tile_async<kMmaTile, DMAX>(Ks, k + kv_base, k0, Sk, kv_stride, D);
    load_tile_async<kMmaTile, DMAX>(Vs, v + kv_base, k0, Sk, kv_stride, D);
  }
  // the queries that can see a key of this tile: [q_lo, q_hi), in steps of
  // QT rows from q_first
  const int q_lo = causal ? k0 : 0;
  const int q_hi = window > 0 ? min(Sq, k0 + kMmaTile - 1 + window) : Sq;
  const int q_first = (q_lo / QT) * QT;
  const int n_it = q_hi > q_first ? (q_hi - q_first + QT - 1) / QT : 0;
  // the ring's first kStages - 1 steps (the first group also holds K and V)
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (loader && st < n_it)
      load_q_step<DMAX, QT>(Qs, dOs, lse_s, dl_s, st, q, dout, lse, delta, b,
                            h, q_first + st * QT, Sq, H, D);
    cp_async_commit();
  }

  float acc[DT][4];  // dV (warps 0-3) or dK (warps 4-7)
  zero(acc);
  const float scale_l2 = scale * kLog2e;
  uint32_t* Pw = Ps + (warp & 3) * 2 * NK * 4 * 32 + lane;
  for (int it = 0; it < n_it; ++it) {
    cp_async_wait<kStages - 2>();  // step it has landed
    __syncthreads();              // ... for every thread; the stage refilled
                                  // next and Ps were read last step
    const int nx = it + kStages - 1;
    if (loader && nx < n_it)
      load_q_step<DMAX, QT>(Qs, dOs, lse_s, dl_s, nx % kStages, q, dout, lse,
                            delta, b, h, q_first + nx * QT, Sq, H, D);
    cp_async_commit();
    const int buf = it % kStages, q0 = q_first + it * QT;
    const bf16* Qb = Qs + buf * QT * LD;
    const bf16* dOb = dOs + buf * QT * LD;

    // dV warps: S^T = K Q^T; dK warps: dP^T = V dO^T (rows the warp's keys
    // g, g + 8, columns queries)
    float x[NT][4];
    uint32_t hi[NK][4], lo[NK][4];
    zero(x);
    mma_abt<NT, DMAX>(x, (dv_warp ? Ks : Vs) + (warp & 3) * 16 * LD,
                      dv_warp ? Qb : dOb, n16);
    if (dv_warp) {
      const float* lse_b = lse_s + buf * QT;
      const bool all = tile_visible(q0, QT, k0, kMmaTile, Sq, Sk, causal, window);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qc = j * 8 + 2 * t + (e & 1);
          x[j][e] = all || visible(q0 + qc, kw + g + (e >> 1) * 8, Sq, Sk,
                                   causal, window)
                        ? exp2f(fmaf(x[j][e], scale_l2, -lse_b[qc] * kLog2e))
                        : 0.f;
        }
      }
      to_a_frags(hi, lo, x);  // P^T as hi + lo
#pragma unroll
      for (int kk = 0; kk < NK; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          Pw[((0 * NK + kk) * 4 + r) * 32] = hi[kk][r];
          Pw[((1 * NK + kk) * 4 + r) * 32] = lo[kk][r];
        }
    }
    __syncthreads();  // P^T is in Ps
    if (!dv_warp) {
#pragma unroll
      for (int kk = 0; kk < NK; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          hi[kk][r] = Pw[((0 * NK + kk) * 4 + r) * 32];
          lo[kk][r] = Pw[((1 * NK + kk) * 4 + r) * 32];
        }
      ds_from_p(x, hi, lo, dl_s + buf * QT, scale);  // dS^T = P^T (dP^T - delta) scale
      to_a_frags(hi, lo, x);
    }
    mma_ab<NK, DMAX>(acc, hi, lo, dv_warp ? dOb : Qb, n16);  // dV += P^T dO, dK += dS^T Q
  }
  cp_async_wait<0>();

  if (ws_dk != nullptr) {  // a share of the group's sum
    const size_t ws_stride = (size_t)H * D, ws_base = ((size_t)b * Sk * H + h) * D;
    store_rows_f32(dv_warp ? ws_dv + ws_base : ws_dk + ws_base, acc, kw, Sk,
                   ws_stride, D);
  } else {  // G 1: the share is the gradient
    store_rows(dv_warp ? dv + kv_base : dk + kv_base, acc, kw, Sk, kv_stride, D);
  }
}

// dk, dv (B, Sk, K, D) bf16 = the sum of the G query heads' float32 shares
// in ws_dk, ws_dv ((B, Sk, H, D)), head kh * G first, in head order, each
// gradient rounded to bf16 once. One thread takes 4 columns of a row of
// both; n4 = B * Sk * K * D / 4.
__global__ void __launch_bounds__(256)
flash_bwd_d256_sum_kernel(const float* __restrict__ ws_dk,
                          const float* __restrict__ ws_dv,
                          bf16* __restrict__ dk, bf16* __restrict__ dv,
                          long long n4, int K, int G, int D) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n4) return;
  const int d4 = D / 4;
  const long long row = i / d4;  // (b, s, kh)
  const int c = static_cast<int>(i % d4) * 4;
  const long long bs = row / K;
  const int kh = static_cast<int>(row % K);
  const size_t src = ((size_t)bs * K * G + (size_t)kh * G) * D + c;
  float4 sk = *reinterpret_cast<const float4*>(ws_dk + src);
  float4 sv = *reinterpret_cast<const float4*>(ws_dv + src);
  for (int j = 1; j < G; ++j) {
    const float4 a = *reinterpret_cast<const float4*>(ws_dk + src + (size_t)j * D);
    const float4 e = *reinterpret_cast<const float4*>(ws_dv + src + (size_t)j * D);
    sk.x += a.x; sk.y += a.y; sk.z += a.z; sk.w += a.w;
    sv.x += e.x; sv.y += e.y; sv.z += e.z; sv.w += e.w;
  }
  const size_t dst = (size_t)row * D + c;
  *reinterpret_cast<uint2*>(dk + dst) = make_uint2(pack_bf16(sk.x, sk.y), pack_bf16(sk.z, sk.w));
  *reinterpret_cast<uint2*>(dv + dst) = make_uint2(pack_bf16(sv.x, sv.y), pack_bf16(sv.z, sv.w));
}

// Keys a dQ step takes: 64, and 16 at D 256, where the warp's dQ
// accumulator alone holds 128 float32 a thread and 16-key steps let two
// blocks share an SM (see the header).
__host__ __device__ constexpr int bwd_kt(int dmax) {
  return dmax > 128 ? 16 : kMmaTile;
}

// dQ. grid: x = 64-query tiles (heaviest causal first), y = B * H. block:
// kMmaThreads; warp w owns queries q0 + 16 w .. + 16.
template <int DMAX>
__global__ void __launch_bounds__(kMmaThreads)
flash_bwd_dq_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const bf16* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, bf16* __restrict__ dq,
                        int Sq, int Sk, int H, int K, int D, int causal,
                        int window, float scale) {
  constexpr int LD = DMAX + 8, KT = bwd_kt(DMAX), NT = KT / 8, NK = KT / 16,
                DT = DMAX / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* dOs = Qs + kMmaTile * LD;
  bf16* Ks = dOs + kMmaTile * LD;     // [kStages][KT][LD]
  bf16* Vs = Ks + kStages * KT * LD;  // [kStages][KT][LD]

  const int n_qt = (Sq + kMmaTile - 1) / kMmaTile;
  const int q0 = (n_qt - 1 - blockIdx.x) * kMmaTile;
  const int b = blockIdx.y / H, h = blockIdx.y % H, kh = h / (H / K);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const size_t q_stride = (size_t)H * D, kv_stride = (size_t)K * D;
  const int n16 = (D + 15) / 16;
  const size_t q_head = ((size_t)b * Sq * H + h) * D;
  const bf16* kb = k + ((size_t)b * Sk * K + kh) * D;
  const bf16* vb = v + ((size_t)b * Sk * K + kh) * D;

  load_tile_async<kMmaTile, DMAX>(Qs, q + q_head, q0, Sq, q_stride, D);
  load_tile_async<kMmaTile, DMAX>(dOs, dout + q_head, q0, Sq, q_stride, D);

  // lse and delta of this thread's two query rows (g, g + 8 of the warp's)
  const int qw = q0 + warp * 16;
  float lse_r[2], dl_r[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int row = qw + g + hf * 8;
    const size_t at = ((size_t)b * H + h) * Sq + row;
    lse_r[hf] = row < Sq ? lse[at] * kLog2e : 0.f;  // in base 2
    dl_r[hf] = row < Sq ? delta[at] : 0.f;
  }
  const float scale_l2 = scale * kLog2e;

  int k_lo, k_hi;
  kv_range(q0, Sq, Sk, causal, window, &k_lo, &k_hi);
  const int k_first = (k_lo / KT) * KT;
  const int n_it = k_hi > k_first ? (k_hi - k_first + KT - 1) / KT : 0;
  // the ring's first kStages - 1 steps (the first group also holds Q and dO)
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < n_it) {
      load_tile_async<KT, DMAX>(Ks + st * KT * LD, kb, k_first + st * KT, Sk,
                                kv_stride, D);
      load_tile_async<KT, DMAX>(Vs + st * KT * LD, vb, k_first + st * KT, Sk,
                                kv_stride, D);
    }
    cp_async_commit();
  }

  float dqa[DT][4];
  zero(dqa);
  for (int it = 0; it < n_it; ++it) {
    cp_async_wait<kStages - 2>();  // step it has landed
    __syncthreads();              // ... for every thread; and the stage
                                  // refilled next was read last step
    const int nx = it + kStages - 1;
    if (nx < n_it) {
      const int nb = nx % kStages, nk0 = k_first + nx * KT;
      load_tile_async<KT, DMAX>(Ks + nb * KT * LD, kb, nk0, Sk, kv_stride, D);
      load_tile_async<KT, DMAX>(Vs + nb * KT * LD, vb, nk0, Sk, kv_stride, D);
    }
    cp_async_commit();
    const int buf = it % kStages, kt0 = k_first + it * KT;
    const bf16* Kb = Ks + buf * KT * LD;
    const bf16* Vb = Vs + buf * KT * LD;

    // S and dP: rows the warp's queries (g, g + 8), columns keys
    float s[NT][4], dp[NT][4];
    zero(s);
    zero(dp);
    mma_abt<NT, DMAX>(s, Qs + warp * 16 * LD, Kb, n16);
    mma_abt<NT, DMAX>(dp, dOs + warp * 16 * LD, Vb, n16);
    const bool all = tile_visible(q0, kMmaTile, kt0, KT, Sq, Sk, causal, window);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hf = e >> 1;
        const int kpos = kt0 + j * 8 + 2 * t + (e & 1);
        const float p =
            all || visible(qw + g + hf * 8, kpos, Sq, Sk, causal, window)
                ? exp2f(fmaf(s[j][e], scale_l2, -lse_r[hf]))
                : 0.f;
        dp[j][e] = p * (dp[j][e] - dl_r[hf]) * scale;
      }
    }
    uint32_t hi[NK][4], lo[NK][4];
    to_a_frags(hi, lo, dp);
    mma_ab<NK, DMAX>(dqa, hi, lo, Kb, n16);  // dQ += dS K
  }
  cp_async_wait<0>();

  store_rows(dq + q_head, dqa, qw, Sq, q_stride, D);
}

// Keys a forward step takes: 64, and 32 at D 256, where the warp's O
// accumulator alone holds 128 float32 a thread (see the header).
__host__ __device__ constexpr int fwd_kt(int dmax) {
  return dmax > 128 ? 32 : kMmaTile;
}

// The bfloat16 forward on the tensor cores (see the header).
// grid: x = 64-query tiles (heaviest causal first), y = B * H. block:
// kMmaThreads; warp w owns queries q0 + 16 w .. + 16. Scores and the
// running max are in base 2 (scale * log2 e folded in); a masked score is
// the reference's -1e30 in those units, so a row that has seen only masked
// keys weighs them alike, as the reference does, until a visible key's
// correction zeroes them.
template <int DMAX>
__global__ void __launch_bounds__(kMmaThreads, DMAX == 64 ? 4 : 2)
flash_fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ o,
                     float* __restrict__ lse, int Sq, int Sk, int H, int K,
                     int D, int causal, int window, float scale) {
  constexpr int LD = DMAX + 8, KT = fwd_kt(DMAX), NT = KT / 8, NK = KT / 16,
                DT = DMAX / 8;
  constexpr float kNegInf2 = kNegInf * kLog2e;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Ks = Qs + kMmaTile * LD;      // [kStages][KT][LD]
  bf16* Vs = Ks + kStages * KT * LD;  // [kStages][KT][LD]

  const int n_qt = (Sq + kMmaTile - 1) / kMmaTile;
  const int q0 = (n_qt - 1 - blockIdx.x) * kMmaTile;
  const int b = blockIdx.y / H, h = blockIdx.y % H, kh = h / (H / K);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const size_t q_stride = (size_t)H * D, kv_stride = (size_t)K * D;
  const int n16 = (D + 15) / 16;
  const size_t q_head = ((size_t)b * Sq * H + h) * D;
  const bf16* kb = k + ((size_t)b * Sk * K + kh) * D;
  const bf16* vb = v + ((size_t)b * Sk * K + kh) * D;
  const int qw = q0 + warp * 16;  // this warp's first query

  load_tile_async<kMmaTile, DMAX>(Qs, q + q_head, q0, Sq, q_stride, D);
  int k_lo, k_hi;
  kv_range(q0, Sq, Sk, causal, window, &k_lo, &k_hi);
  const int k_first = (k_lo / KT) * KT;
  const int n_it = k_hi > k_first ? (k_hi - k_first + KT - 1) / KT : 0;
  // the ring's first kStages - 1 steps (the first group also holds Q)
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < n_it) {
      load_tile_async<KT, DMAX>(Ks + st * KT * LD, kb, k_first + st * KT, Sk,
                                kv_stride, D);
      load_tile_async<KT, DMAX>(Vs + st * KT * LD, vb, k_first + st * KT, Sk,
                                kv_stride, D);
    }
    cp_async_commit();
  }

  // the running max (base 2) and this thread's part of the normaliser of
  // its two rows (g, g + 8), and their output rows
  float m2[2] = {kNegInf2, kNegInf2}, l[2] = {0.f, 0.f};
  float oacc[DT][4];
  zero(oacc);
  const float scale_l2 = scale * kLog2e;
  for (int it = 0; it < n_it; ++it) {
    cp_async_wait<kStages - 2>();  // step it has landed
    __syncthreads();              // ... for every thread; and the stage
                                  // refilled next was read last step
    const int nx = it + kStages - 1;
    if (nx < n_it) {
      const int nb = nx % kStages, nk0 = k_first + nx * KT;
      load_tile_async<KT, DMAX>(Ks + nb * KT * LD, kb, nk0, Sk, kv_stride, D);
      load_tile_async<KT, DMAX>(Vs + nb * KT * LD, vb, nk0, Sk, kv_stride, D);
    }
    cp_async_commit();
    const int buf = it % kStages, kt0 = k_first + it * KT;
    const bf16* Kb = Ks + buf * KT * LD;
    const bf16* Vb = Vs + buf * KT * LD;

    // S = Q K^T: rows the warp's queries (g, g + 8), columns keys; each k
    // step's 16 products in a fresh accumulator, added to S in float32
    // with Kahan's compensation (see the header)
    float s[NT][4], sc[NT][4];
    mma_abt_step<NT, DMAX, kFresh>(s, Qs + warp * 16 * LD, Kb, 0);
    zero(sc);
#pragma unroll
    for (int kk = 1; kk < DMAX / 16; ++kk)
      if (kk < n16)
        mma_abt_step<NT, DMAX, kKahan>(s, Qs + warp * 16 * LD, Kb, kk, sc);
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] -= sc[j][e];

    // online softmax: the mask only where the warp's tile is not wholly
    // visible; row maxima over the 4 lanes that share a row
    const bool all = tile_visible(qw, 16, kt0, KT, Sq, Sk, causal, window);
    float mx[2] = {m2[0], m2[1]};
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hf = e >> 1;
        float x = s[j][e] * scale_l2;
        if (!all && !visible(qw + g + hf * 8, kt0 + j * 8 + 2 * t + (e & 1),
                             Sq, Sk, causal, window))
          x = kNegInf2;
        s[j][e] = x;
        mx[hf] = fmaxf(mx[hf], x);
      }
    }
    float corr[2];
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      mx[hf] = fmaxf(mx[hf], __shfl_xor_sync(0xffffffffu, mx[hf], 1));
      mx[hf] = fmaxf(mx[hf], __shfl_xor_sync(0xffffffffu, mx[hf], 2));
      corr[hf] = ex2(m2[hf] - mx[hf]);
      m2[hf] = mx[hf];
      l[hf] *= corr[hf];
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hf = e >> 1;
        s[j][e] = ex2(s[j][e] - m2[hf]);
        l[hf] += s[j][e];
      }
    }
#pragma unroll
    for (int nt = 0; nt < DT; ++nt) {
      oacc[nt][0] *= corr[0];
      oacc[nt][1] *= corr[0];
      oacc[nt][2] *= corr[1];
      oacc[nt][3] *= corr[1];
    }

    // O += P V, P as bf16 hi + lo A fragments in registers
    uint32_t hi[NK][4], lo[NK][4];
    to_a_frags(hi, lo, s);
    mma_ab<NK, DMAX>(oacc, hi, lo, Vb, n16);
  }
  cp_async_wait<0>();

  // o = O / max(l, 1e-30) (l summed over the row's 4 lanes), lse in nats
  float lc[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    l[hf] += __shfl_xor_sync(0xffffffffu, l[hf], 1);
    l[hf] += __shfl_xor_sync(0xffffffffu, l[hf], 2);
    lc[hf] = fmaxf(l[hf], 1e-30f);
  }
#pragma unroll
  for (int nt = 0; nt < DT; ++nt) {
    oacc[nt][0] /= lc[0];
    oacc[nt][1] /= lc[0];
    oacc[nt][2] /= lc[1];
    oacc[nt][3] /= lc[1];
  }
  store_rows(o + q_head, oacc, qw, Sq, q_stride, D);
  if (t == 0) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int row = qw + g + hf * 8;
      if (row < Sq)
        lse[((size_t)b * H + h) * Sq + row] = m2[hf] * kLn2 + logf(lc[hf]);
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

template <int DMAX>
cudaError_t fwd_mma(const void* q, const void* k, const void* v, void* o,
                    float* lse, int B, int Sq, int Sk, int H, int K, int D,
                    int causal, int window, float scale, cudaStream_t stream) {
  // Q; K and V in each stage
  constexpr size_t smem =
      sizeof(bf16) * (kMmaTile + 2 * kStages * fwd_kt(DMAX)) * (DMAX + 8);
  cudaError_t err = set_smem(flash_fwd_mma_kernel<DMAX>, smem);
  if (err != cudaSuccess) return err;
  flash_fwd_mma_kernel<DMAX>
      <<<dim3((Sq + kMmaTile - 1) / kMmaTile, B * H), kMmaThreads, smem, stream>>>(
          static_cast<const bf16*>(q), static_cast<const bf16*>(k),
          static_cast<const bf16*>(v), static_cast<bf16*>(o), lse, Sq, Sk, H,
          K, D, causal, window, scale);
  return cudaGetLastError();
}

template <typename T, int DMAX>
cudaError_t bwd_seq(const void* q, const void* k, const void* v,
                    const void* dout, const float* lse, const float* delta,
                    void* dq, void* dk, void* dv, int B, int Sq, int Sk, int H,
                    int K, int D, int causal, int window, float scale,
                    cudaStream_t stream) {
  const T* tq = static_cast<const T*>(q);
  const T* tk = static_cast<const T*>(k);
  const T* tv = static_cast<const T*>(v);
  const T* tdo = static_cast<const T*>(dout);
  // K, V, the staging tile, P, dS, lse, delta: 231,168 B at DMAX 256
  const size_t smem_kv =
      sizeof(float) * (3 * kTile * (DMAX + 1) + 2 * kTile * kPS + 2 * kTile);
  cudaError_t err = set_smem(flash_bwd_dkdv_seq_kernel<T, DMAX>, smem_kv);
  if (err != cudaSuccess) return err;
  flash_bwd_dkdv_seq_kernel<T, DMAX>
      <<<dim3((Sk + kTile - 1) / kTile, B * K), kThreads, smem_kv, stream>>>(
          tq, tk, tv, tdo, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv),
          Sq, Sk, H, K, D, causal, window, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // Q, dO, the staging tile, dS, lse, delta: 214,528 B at DMAX 256
  const size_t smem_q =
      sizeof(float) * (3 * kTile * (DMAX + 1) + kTile * kPS + 2 * kTile);
  err = set_smem(flash_bwd_dq_seq_kernel<T, DMAX>, smem_q);
  if (err != cudaSuccess) return err;
  flash_bwd_dq_seq_kernel<T, DMAX>
      <<<dim3((Sq + kTile - 1) / kTile, B * H), kThreads, smem_q, stream>>>(
          tq, tk, tv, tdo, lse, delta, static_cast<T*>(dq), Sq, Sk, H, K, D,
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

template <int DMAX>
cudaError_t dq_mma(const bf16* q, const bf16* k, const bf16* v,
                   const bf16* dout, const float* lse, const float* delta,
                   void* dq, int B, int Sq, int Sk, int H, int K, int D,
                   int causal, int window, float scale, cudaStream_t stream) {
  // Q, dO; K and V in each stage
  constexpr size_t smem =
      sizeof(bf16) * (2 * kMmaTile + 2 * kStages * bwd_kt(DMAX)) * (DMAX + 8);
  cudaError_t err = set_smem(flash_bwd_dq_mma_kernel<DMAX>, smem);
  if (err != cudaSuccess) return err;
  flash_bwd_dq_mma_kernel<DMAX>
      <<<dim3((Sq + kMmaTile - 1) / kMmaTile, B * H), kMmaThreads, smem, stream>>>(
          q, k, v, dout, lse, delta, static_cast<bf16*>(dq), Sq, Sk, H, K, D,
          causal, window, scale);
  return cudaGetLastError();
}

template <int DMAX, int QT>
cudaError_t bwd_mma(const void* q, const void* k, const void* v,
                    const void* dout, const float* lse, const float* delta,
                    void* dq, void* dk, void* dv, int B, int Sq, int Sk, int H,
                    int K, int D, int causal, int window, float scale,
                    cudaStream_t stream) {
  static_assert(DMAX <= 128, "D 256 runs bwd_d256");
  const bf16* tq = static_cast<const bf16*>(q);
  const bf16* tk = static_cast<const bf16*>(k);
  const bf16* tv = static_cast<const bf16*>(v);
  const bf16* tdo = static_cast<const bf16*>(dout);
  constexpr int LD = DMAX + 8;
  // K, V; Q and dO, lse and delta in each stage
  constexpr size_t smem_kv = sizeof(bf16) * (2 * kMmaTile + 2 * kStages * QT) * LD +
                             sizeof(float) * 2 * kStages * QT;
  const dim3 grid_kv((Sk + kMmaTile - 1) / kMmaTile, B * K);
  cudaError_t err = set_smem(flash_bwd_dkdv_mma_kernel<DMAX, QT>, smem_kv);
  if (err != cudaSuccess) return err;
  flash_bwd_dkdv_mma_kernel<DMAX, QT>
      <<<grid_kv, kMmaThreads, smem_kv, stream>>>(
          tq, tk, tv, tdo, lse, delta, static_cast<bf16*>(dk),
          static_cast<bf16*>(dv), Sq, Sk, H, K, D, causal, window, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return dq_mma<DMAX>(tq, tk, tv, tdo, lse, delta, dq, B, Sq, Sk, H, K, D,
                      causal, window, scale, stream);
}

// The bf16 backward at D 256: the dK/dV kernel over (query head, key tile),
// with G > 1 the head-order sum of its float32 shares (ws: 2 B Sk H D
// floats, dK's then dV's), then the dQ kernel.
cudaError_t bwd_d256(const void* q, const void* k, const void* v,
                     const void* dout, const float* lse, const float* delta,
                     void* dq, void* dk, void* dv, float* ws, int B, int Sq,
                     int Sk, int H, int K, int D, int causal, int window,
                     float scale, cudaStream_t stream) {
  const bf16* tq = static_cast<const bf16*>(q);
  const bf16* tk = static_cast<const bf16*>(k);
  const bf16* tv = static_cast<const bf16*>(v);
  const bf16* tdo = static_cast<const bf16*>(dout);
  constexpr int QT = kD256QT, LD = 256 + 8;
  // K, V; Q and dO, lse and delta in each stage; the dV warps' P^T
  constexpr size_t smem = sizeof(bf16) * (2 * kMmaTile + 2 * kStages * QT) * LD +
                          sizeof(float) * 2 * kStages * QT +
                          sizeof(uint32_t) * 4 * 2 * (QT / 16) * 4 * 32;
  const int G = H / K;
  float* ws_dk = G > 1 ? ws : nullptr;
  float* ws_dv = G > 1 ? ws + (size_t)B * Sk * H * D : nullptr;
  cudaError_t err = set_smem(flash_bwd_dkdv_d256_kernel<QT>, smem);
  if (err != cudaSuccess) return err;
  flash_bwd_dkdv_d256_kernel<QT>
      <<<dim3(B * H, (Sk + kMmaTile - 1) / kMmaTile), kD256Threads, smem, stream>>>(
          tq, tk, tv, tdo, lse, delta, static_cast<bf16*>(dk),
          static_cast<bf16*>(dv), ws_dk, ws_dv, Sq, Sk, H, K, D, causal,
          window, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (G > 1) {
    const long long n4 = (long long)B * Sk * K * D / 4;
    flash_bwd_d256_sum_kernel<<<(unsigned)((n4 + 255) / 256), 256, 0, stream>>>(
        ws_dk, ws_dv, static_cast<bf16*>(dk), static_cast<bf16*>(dv), n4, K,
        G, D);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return dq_mma<256>(tq, tk, tv, tdo, lse, delta, dq, B, Sq, Sk, H, K, D,
                     causal, window, scale, stream);
}

template <typename T>
cudaError_t delta_typed(const void* o, const void* dout, float* delta, int B,
                        int Sq, int H, int D, cudaStream_t stream) {
  const long long rows = (long long)B * H * Sq;
  flash_bwd_delta_kernel<T><<<(unsigned)((rows + 255) / 256), 256, 0, stream>>>(
      static_cast<const T*>(o), static_cast<const T*>(dout), delta, rows, Sq, H,
      D);
  return cudaGetLastError();
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

bool bad_args(int B, int Sq, int Sk, int H, int K, int D, int dtype,
              int d_max) {
  return B < 1 || Sq < 1 || Sk < 1 || K < 1 || H % K != 0 || D < 8 ||
         D > d_max || D % 8 != 0 || dtype < 0 || dtype > 1 || B * H > 65535;
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16 (q, k, v, o, dO, dq, dk, dv alike).
// Both take D <= 256. causal is 0 or 1;
// window <= 0 means no window. Each returns 0 on success, a cudaError_t from
// a launch, or -1 for arguments the kernels do not take (the Python wrapper
// checks these first).
//
// The forward's route is by dtype: bfloat16 runs on the tensor cores (q, k
// and v must be 16-byte aligned), float32 on the CUDA cores, at any D.
// *route is set to the route launched: 1 for the tensor-core kernel, 0 for
// the CUDA-core one.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* o, void* lse, int B, int Sq, int Sk,
                                   int H, int K, int D, int causal, int window,
                                   float scale, int dtype, void* stream,
                                   int* route) {
  if (bad_args(B, Sq, Sk, H, K, D, dtype, 256)) return -1;
  const auto s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  const int w = window > 0 ? window : 0;
  cudaError_t err;
  if (dtype == 1) {  // bfloat16: the tensor cores
    const void* tensors[] = {q, k, v};
    for (const void* p : tensors)
      if (!aligned16(p)) return -1;
    *route = 1;
    err = D <= 64    ? fwd_mma<64>(q, k, v, o, l, B, Sq, Sk, H, K, D, causal, w, scale, s)
          : D <= 128 ? fwd_mma<128>(q, k, v, o, l, B, Sq, Sk, H, K, D, causal, w, scale, s)
                     : fwd_mma<256>(q, k, v, o, l, B, Sq, Sk, H, K, D, causal, w, scale, s);
    return static_cast<int>(err);
  }
  *route = 0;  // float32: the CUDA cores
  err = D <= 64    ? fwd_typed<float, 64>(q, k, v, o, l, B, Sq, Sk, H, K, D, causal, w, scale, s)
        : D <= 128 ? fwd_typed<float, 128>(q, k, v, o, l, B, Sq, Sk, H, K, D, causal, w, scale, s)
                   : fwd_typed<float, 256>(q, k, v, o, l, B, Sq, Sk, H, K, D, causal, w, scale, s);
  return static_cast<int>(err);
}

// delta (B, H, Sq) float32 is written here (rowsum(dO * O)), then read by
// the dK/dV and dQ kernels. q, k, v, o and dout must be 16-byte aligned.
// ws is the bf16 D 256 route's float32 workspace of per-head dK and dV
// shares, 2 * B * Sk * H * D floats, 16-byte aligned; it is read only there
// and only when H > K (may be null otherwise). *route is set to the route
// launched: 2 for bf16 at D 256 (flash_bwd_dkdv_d256_kernel), 1 for bf16
// at D <= 128 (flash_bwd_dkdv_mma_kernel), 0 for float32.
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v,
                                   const void* o, const void* dout,
                                   const void* lse, void* delta, void* dq,
                                   void* dk, void* dv, void* ws, int B, int Sq,
                                   int Sk, int H, int K, int D, int causal,
                                   int window, float scale, int dtype,
                                   void* stream, int* route) {
  if (bad_args(B, Sq, Sk, H, K, D, dtype, 256)) return -1;
  const void* tensors[] = {q, k, v, o, dout};
  for (const void* p : tensors)
    if (!aligned16(p)) return -1;
  const bool d256_route = dtype == 1 && D > 128;
  if (d256_route && H > K && (ws == nullptr || !aligned16(ws))) return -1;
  if (d256_route && Sk > 65535 * kMmaTile) return -1;  // the grid's y
  const auto s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  const int w = window > 0 ? window : 0;
  cudaError_t err = dtype == 0 ? delta_typed<float>(o, dout, dl, B, Sq, H, D, s)
                               : delta_typed<bf16>(o, dout, dl, B, Sq, H, D, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  *route = dtype == 0 ? 0 : d256_route ? 2 : 1;
  if (dtype == 0)  // float32: the CUDA-core kernels
    err = D <= 64    ? bwd_typed<float, 64>(q, k, v, dout, l, dl, dq, dk, dv, B, Sq, Sk, H, K, D, causal, w, scale, s)
          : D <= 128 ? bwd_typed<float, 128>(q, k, v, dout, l, dl, dq, dk, dv, B, Sq, Sk, H, K, D, causal, w, scale, s)
                     : bwd_seq<float, 256>(q, k, v, dout, l, dl, dq, dk, dv, B, Sq, Sk, H, K, D, causal, w, scale, s);
  else  // bfloat16: the tensor cores
    err = D <= 64    ? bwd_mma<64, 64>(q, k, v, dout, l, dl, dq, dk, dv, B, Sq, Sk, H, K, D, causal, w, scale, s)
          : D <= 128 ? bwd_mma<128, 16>(q, k, v, dout, l, dl, dq, dk, dv, B, Sq, Sk, H, K, D, causal, w, scale, s)
                     : bwd_d256(q, k, v, dout, l, dl, dq, dk, dv, static_cast<float*>(ws), B, Sq, Sk, H, K, D, causal, w, scale, s);
  return static_cast<int>(err);
}

extern "C" const char* flash_attention_error_string(int code) {
  if (code == -1) return "argument the flash-attention kernels do not take";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

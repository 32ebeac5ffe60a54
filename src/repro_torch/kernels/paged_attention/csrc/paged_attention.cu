// Paged single-query GQA decode attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `paged_attention_kernel` (body
// `_paged_kernel`) in src/repro/kernels/paged_attention/kernel.py. Same
// function: each slot's one query attends over that slot's KV, which lives
// in place in a global page pool (P, ps, K, D) reached through a block table
// (B, NP); query head h reads KV head h / (H / K); with a window the table
// is a ring (entry e holds the newest block = e mod NP) and only positions
// in [len - window, len) attend. Online softmax in fp32 with the reference's
// constants: running max starts at -1e30, the normaliser is clamped to
// 1e-30.
//
// What bounds it on the card: the bytes of KV it reads, len*K*D*2*2 bytes
// per slot per layer for a bf16 pool (k and v), against 3.35 TB/s; the
// arithmetic is 4*H*D operations per position, far below the card's rate.
// What the design does about that: every KV byte is read exactly once per
// call. One block serves one (slot, KV head) pair and packs the G = H/K
// query heads of that KV head together, so a KV row loaded once feeds all G
// heads (the GQA fold); the block walks only the pages that cover
// [max(0, len - window), len), never the unused table entries or the null
// page. Each warp takes every NW-th position, lanes split the head dim, and
// the per-warp softmax states are merged through shared memory at the end.
// Still to do for speed (a later change): split long chains across blocks
// with a second reduce pass, wider loads, TMA/wgmma for large G.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;          // warps per block
constexpr int kMaxGroup = 8;       // query heads one block packs
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

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// grid: x = K * ceil(G / kMaxGroup), y = B. block: 32 * kWarps threads.
// DPL = ceil(D / 32) head-dim elements per lane.
template <typename TQ, typename TKV, int DPL>
__global__ void __launch_bounds__(32 * kWarps)
paged_attention_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k_pool,
                       const TKV* __restrict__ v_pool,
                       const int32_t* __restrict__ tables,
                       const int32_t* __restrict__ lengths, TQ* __restrict__ out,
                       int H, int K, int D, int P, int ps, int NP, int window,
                       float scale) {
  const int G = H / K;
  const int n_chunks = (G + kMaxGroup - 1) / kMaxGroup;
  const int kh = blockIdx.x / n_chunks;
  const int g0 = (blockIdx.x % n_chunks) * kMaxGroup;
  const int ng = min(kMaxGroup, G - g0);
  const int b = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int h0 = kh * G + g0;  // first query head of this block

  // the positions this slot attends: [lo, hi)
  const int len = max(lengths[b], 0);
  int lo = 0, hi = 0;
  if (len > 0) {
    const int cur = (len - 1) / ps;  // the tail block
    if (window > 0) {
      // ring table: blocks older than cur - NP + 1 have no entry left
      const int start = max(0, len - window);
      const int blk_lo = max(start / ps, max(cur - NP + 1, 0));
      lo = max(start, blk_lo * ps);
      hi = len;
    } else {
      // contiguous table: entry j covers [j*ps, (j+1)*ps)
      hi = min(len, NP * ps);
    }
  }

  float qv[kMaxGroup][DPL];
#pragma unroll
  for (int g = 0; g < kMaxGroup; ++g)
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      const int d = lane + 32 * i;
      qv[g][i] = (g < ng && d < D)
                     ? to_float(q[((size_t)b * H + h0 + g) * D + d])
                     : 0.f;
    }

  float m[kMaxGroup], l[kMaxGroup], acc[kMaxGroup][DPL];
#pragma unroll
  for (int g = 0; g < kMaxGroup; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[g][i] = 0.f;
  }

  const int32_t* row = tables + (size_t)b * NP;
  for (int pos = lo + warp; pos < hi; pos += kWarps) {
    const int blk = pos / ps;
    const int page = row[window > 0 ? blk % NP : blk];
    if ((unsigned)page >= (unsigned)P) continue;  // never read outside the pool
    const size_t base = (((size_t)page * ps + pos % ps) * K + kh) * D;
    float kv[DPL], vv[DPL];
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      const int d = lane + 32 * i;
      kv[i] = d < D ? to_float(k_pool[base + d]) : 0.f;
      vv[i] = d < D ? to_float(v_pool[base + d]) : 0.f;
    }
#pragma unroll
    for (int g = 0; g < kMaxGroup; ++g) {
      if (g >= ng) break;
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < DPL; ++i) s += qv[g][i] * kv[i];
      s = warp_sum(s) * scale;
      const float m_new = fmaxf(m[g], s);
      const float corr = expf(m[g] - m_new);
      const float p = expf(s - m_new);
      l[g] = l[g] * corr + p;
#pragma unroll
      for (int i = 0; i < DPL; ++i) acc[g][i] = acc[g][i] * corr + p * vv[i];
      m[g] = m_new;
    }
  }

  // merge the warps' states: shared layout [warp][g] for m and l,
  // [warp][g][d] for acc
  extern __shared__ float smem[];
  float* sm = smem;
  float* sl = sm + kWarps * kMaxGroup;
  float* sacc = sl + kWarps * kMaxGroup;
  if (lane == 0) {
#pragma unroll
    for (int g = 0; g < kMaxGroup; ++g) {
      sm[warp * kMaxGroup + g] = m[g];
      sl[warp * kMaxGroup + g] = l[g];
    }
  }
#pragma unroll
  for (int g = 0; g < kMaxGroup; ++g)
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      const int d = lane + 32 * i;
      if (g < ng && d < D) sacc[(warp * kMaxGroup + g) * D + d] = acc[g][i];
    }
  __syncthreads();

  for (int idx = threadIdx.x; idx < ng * D; idx += blockDim.x) {
    const int g = idx / D, d = idx % D;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sm[w * kMaxGroup + g]);
    float den = 0.f, num = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float c = expf(sm[w * kMaxGroup + g] - mx);
      den += sl[w * kMaxGroup + g] * c;
      num += sacc[(w * kMaxGroup + g) * D + d] * c;
    }
    out[((size_t)b * H + h0 + g) * D + d] = from_float<TQ>(num / fmaxf(den, 1e-30f));
  }
}

template <typename TQ, typename TKV, int DPL>
cudaError_t launch_typed(const void* q, const void* k_pool, const void* v_pool,
                         const int32_t* tables, const int32_t* lengths, void* out,
                         int B, int H, int K, int D, int P, int ps, int NP,
                         int window, float scale, cudaStream_t stream) {
  const int n_chunks = (H / K + kMaxGroup - 1) / kMaxGroup;
  const dim3 grid(K * n_chunks, B);
  const size_t smem = sizeof(float) * kWarps * kMaxGroup * (2 + D);
  paged_attention_kernel<TQ, TKV, DPL><<<grid, 32 * kWarps, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k_pool),
      static_cast<const TKV*>(v_pool), tables, lengths, static_cast<TQ*>(out), H,
      K, D, P, ps, NP, window, scale);
  return cudaGetLastError();
}

template <typename TQ, typename TKV>
cudaError_t launch_dpl(const void* q, const void* k_pool, const void* v_pool,
                       const int32_t* tables, const int32_t* lengths, void* out,
                       int B, int H, int K, int D, int P, int ps, int NP,
                       int window, float scale, cudaStream_t stream) {
  switch ((D + 31) / 32) {
    case 1: return launch_typed<TQ, TKV, 1>(q, k_pool, v_pool, tables, lengths, out, B, H, K, D, P, ps, NP, window, scale, stream);
    case 2: return launch_typed<TQ, TKV, 2>(q, k_pool, v_pool, tables, lengths, out, B, H, K, D, P, ps, NP, window, scale, stream);
    case 3: return launch_typed<TQ, TKV, 3>(q, k_pool, v_pool, tables, lengths, out, B, H, K, D, P, ps, NP, window, scale, stream);
    default: return launch_typed<TQ, TKV, 4>(q, k_pool, v_pool, tables, lengths, out, B, H, K, D, P, ps, NP, window, scale, stream);
  }
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16. window <= 0 means no window.
// Returns 0 on success, a cudaError_t from the launch, or -1 for arguments
// the kernel does not take (the Python wrapper checks these first).
extern "C" int paged_attention_launch(const void* q, const void* k_pool,
                                      const void* v_pool, const void* tables,
                                      const void* lengths, void* out, int B,
                                      int H, int K, int D, int P, int ps, int NP,
                                      int window, float scale, int q_dtype,
                                      int kv_dtype, void* stream) {
  if (B < 1 || K < 1 || H % K != 0 || D < 1 || D > 128 || P < 1 || ps < 1 ||
      NP < 1 || q_dtype < 0 || q_dtype > 1 || kv_dtype < 0 || kv_dtype > 1)
    return -1;
  const auto* t = static_cast<const int32_t*>(tables);
  const auto* n = static_cast<const int32_t*>(lengths);
  const auto s = static_cast<cudaStream_t>(stream);
  const int w = window > 0 ? window : 0;
  cudaError_t err;
  if (q_dtype == 0 && kv_dtype == 0)
    err = launch_dpl<float, float>(q, k_pool, v_pool, t, n, out, B, H, K, D, P, ps, NP, w, scale, s);
  else if (q_dtype == 0)
    err = launch_dpl<float, __nv_bfloat16>(q, k_pool, v_pool, t, n, out, B, H, K, D, P, ps, NP, w, scale, s);
  else if (kv_dtype == 0)
    err = launch_dpl<__nv_bfloat16, float>(q, k_pool, v_pool, t, n, out, B, H, K, D, P, ps, NP, w, scale, s);
  else
    err = launch_dpl<__nv_bfloat16, __nv_bfloat16>(q, k_pool, v_pool, t, n, out, B, H, K, D, P, ps, NP, w, scale, s);
  return static_cast<int>(err);
}

extern "C" const char* paged_attention_error_string(int code) {
  if (code == -1) return "argument the paged-attention kernel does not take";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Paged single-query GQA decode attention for Hopper (sm_90a): a split-KV
// ("flash-decoding") kernel.
//
// Replaces the Pallas TPU kernel `paged_attention_kernel` (body
// `_paged_kernel`) in src/repro/kernels/paged_attention/kernel.py. Same
// function: each slot's one query attends over that slot's KV, which lives
// in place in a global page pool (P, ps, K, D) reached through a block table
// (B, NP); query head h reads KV head h / (H / K); with a window the table
// is a ring (entry e holds the newest block = e mod NP) and only positions
// in [len - window, len) attend. Online softmax in fp32 with the reference's
// constants: running max starts at -1e30, the normaliser is clamped to
// 1e-30. A page id outside the pool is never read (its positions are left
// out), and a slot of length 0 gives zeros.
//
// What bounds it on the card: the bytes of KV it reads, len*K*D*2*elt bytes
// per slot per layer (k and v) against 3.35 TB/s. The arithmetic, 4*H*D
// operations per position on 4*K*D bytes, is G = H/K operations a byte, far
// below what the CUDA cores give, so no tensor cores. A decode call moves a
// few MB: at that size what costs is latency (chains of dependent reads and
// barriers), not bandwidth. The design keeps as many bytes in flight,
// across as many blocks, as it can, and its chains short:
//
// * Split KV. The grid is (split, KV head x query-head chunk, slot). Split s
//   of a slot covers positions [lo + s*L, lo + (s+1)*L) of its attended
//   range [lo, hi), with L a multiple of the page size chosen by the host
//   (`kernel.plan`: 64 positions at 16-token pages, longer where a table
//   holds more than kMaxSplits of them). The grid's split count is the most
//   the table can hold; blocks past a slot's own ceil((hi - lo) / L) splits
//   return at once.
// * Every byte of a split in flight before any arithmetic. A block reads
//   the length, its query heads and (for a contiguous table, whose entries
//   do not depend on the length) its page ids at once, one thread a page;
//   then issues all of its K and V rows as cp.async copies of VEC bytes (16
//   where D*elt and the pool allow; 8, 4 or 2 otherwise: one kernel,
//   instantiated per width), waits once, and only then computes the G x L
//   scores (two threads a row), their max and sum, and P.V from shared
//   memory. A split longer than the shared buffer (fp32 at large D, pages
//   longer than 64 positions, tables past 64 splits) walks it in tiles of
//   `tile` positions with the same online softmax.
// * The GQA fold: a block serves all G query heads of its KV head (up to
//   kMaxGroup, else a chunk of them), so each KV byte is read once a call.
// * Merge in the same launch, in a fixed order. A slot with one active split
//   writes o directly. Otherwise each split writes its fp32 (m, l, acc) to a
//   workspace; after a barrier one thread fences and counts the split on a
//   per-(slot, KV-head chunk) counter. The block that arrives last merges
//   all the splits in split order, whichever block that is, so two calls
//   give the same bits, and sets the counter back to 0: the maxima and
//   normalisers through __ldcg, the accumulators brought into the K and V
//   tiles' room a chunk of splits at a time by cp.async.cg (both read L2,
//   not a stale L1). The counters are zeroed once by the host and always
//   left zeroed. No float atomics.
//
// The floor: the length, the table and the KV rows are dependent reads (the
// first two overlap for a contiguous table), and the merge adds a fence, an
// atomic and a read of the partials, so a call takes a few microseconds even
// where its bytes need less.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kThreads = 128;             // threads per block
constexpr int kWarps = kThreads / 32;
constexpr int kMaxGroup = 8;              // query heads one block packs
constexpr int kMaxSplits = 64;            // splits a slot's range is cut into, at most
constexpr float kNegInf = -1e30f;         // the reference's mask value
constexpr uint32_t kMinusInfBits = 0xff800000u;  // a row left out scores -inf
constexpr size_t kMaxSmem = 48 * 1024;    // no opt-in needed below this

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
__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// a VEC-byte word
template <int VEC> struct Word;
template <> struct Word<16> { using type = uint4; };
template <> struct Word<8> { using type = uint2; };
template <> struct Word<4> { using type = uint32_t; };
template <> struct Word<2> { using type = uint16_t; };

// the elements of one 32-bit word as floats (bf16 -> fp32 is a shift)
__device__ __forceinline__ void unpack(uint32_t w, float* f, float) {
  f[0] = __uint_as_float(w);
}
__device__ __forceinline__ void unpack(uint32_t w, float* f, __nv_bfloat16) {
  f[0] = __uint_as_float(w << 16);
  f[1] = __uint_as_float(w & 0xffff0000u);
}

// VEC bytes of shared memory at `src` as N = VEC / sizeof(T) floats
template <typename T, int VEC>
__device__ __forceinline__ void load_floats(const T* src, float* f) {
  constexpr int per = 4 / sizeof(T);      // elements a 32-bit word holds
  const auto w = *reinterpret_cast<const typename Word<VEC>::type*>(src);
  if constexpr (VEC == 16) {
    unpack(w.x, f, T()); unpack(w.y, f + per, T());
    unpack(w.z, f + 2 * per, T()); unpack(w.w, f + 3 * per, T());
  } else if constexpr (VEC == 8) {
    unpack(w.x, f, T()); unpack(w.y, f + per, T());
  } else if constexpr (VEC == 4) {
    unpack(w, f, T());
  } else {
    f[0] = __uint_as_float(static_cast<uint32_t>(w) << 16);   // one bf16
  }
}

// start a VEC-byte copy global -> shared (cp.async for 4, 8 and 16 bytes; a
// plain load and store for 2, which cp.async does not take)
template <int VEC>
__device__ __forceinline__ void copy_async(void* dst, const void* src) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  if constexpr (VEC == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
  else if constexpr (VEC == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(src) : "memory");
  else if constexpr (VEC == 4)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
  else
    *static_cast<uint16_t*>(dst) = *static_cast<const uint16_t*>(src);
}
__device__ __forceinline__ void copy_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}
template <int VEC> __device__ __forceinline__ void zero_word(void* dst) {
  *static_cast<typename Word<VEC>::type*>(dst) = typename Word<VEC>::type{};
}

__host__ __device__ inline size_t align16(size_t n) { return (n + 15) & ~size_t(15); }
__host__ __device__ inline int round4(int n) { return (n + 3) & ~3; }

// Dynamic shared memory of one block: K and V tiles (tile rows of
// row_stride elements: D plus one word of padding, so that neighbouring
// rows start in other banks), the scores (GC rows of round4(tile)), q and
// acc (GC x D floats), the merge's weights (kMaxSplits x kMaxGroup), m, l
// and the correction (kMaxGroup each), the page ids (tile + 1) and a flag.
__host__ __device__ inline size_t smem_bytes(int tile, int row_stride, int elt,
                                             int gc, int d) {
  return 2 * align16(size_t(tile) * row_stride * elt) +
         sizeof(float) * (size_t(gc) * round4(tile) + 2 * size_t(gc) * d +
                          kMaxSplits * kMaxGroup + 3 * kMaxGroup) +
         sizeof(int) * (size_t(tile) + 2);
}

struct Args {
  const void* q;
  const void* k_pool;
  const void* v_pool;
  const int32_t* tables;
  const int32_t* lengths;
  void* out;
  float* work;        // (B, KC, n_split, round4(GC (D + 2))) fp32; unused with one split
  int32_t* counters;  // (B, KC), all zero between calls
  int H, K, D, P, ps, NP, window;
  float scale;
  int split_len, n_split, tile, row_stride;
};

// grid: x = n_split, y = KC = K * ceil(G / kMaxGroup), z = B.
template <typename TQ, typename TKV, int VEC>
__global__ void __maxnreg__(80)  // 128 threads; room for every instantiation without a spill
paged_attention_kernel(const Args a) {
  constexpr int N = VEC / sizeof(TKV);    // elements one copy moves
  const int G = a.H / a.K;
  const int GC = min(G, kMaxGroup);
  const int n_chunks = (G + kMaxGroup - 1) / kMaxGroup;
  const int split = blockIdx.x, kc = blockIdx.y, b = blockIdx.z;
  const int kh = kc / n_chunks;
  const int g0 = (kc % n_chunks) * kMaxGroup;
  const int ng = min(kMaxGroup, G - g0);
  const int h0 = kh * G + g0;             // first query head of this block
  const int D = a.D, ps = a.ps, tile = a.tile, rs = a.row_stride;
  const int ts = round4(tile);            // a score row, 16-byte aligned
  const int L = a.split_len;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  extern __shared__ __align__(16) unsigned char smem[];
  const size_t kv_bytes = align16(size_t(tile) * rs * sizeof(TKV));
  TKV* sK = reinterpret_cast<TKV*>(smem);
  TKV* sV = reinterpret_cast<TKV*>(smem + kv_bytes);
  float* sS = reinterpret_cast<float*>(smem + 2 * kv_bytes);  // [GC][ts]
  float* sQ = sS + GC * ts;                                    // [GC][D]
  float* sAcc = sQ + GC * D;                                   // [GC][D]
  float* sW = sAcc + GC * D;                       // [kMaxSplits][kMaxGroup]
  float* sM = sW + kMaxSplits * kMaxGroup;
  float* sL = sM + kMaxGroup;
  float* sC = sL + kMaxGroup;
  int* sPage = reinterpret_cast<int*>(sC + kMaxGroup);         // [tile + 1]
  int* sFlag = sPage + tile + 1;

  // three independent reads at once: the length, the query, and (for a
  // contiguous table, whose entries do not depend on the length) the page
  // ids of this split's first tile
  const int len_read = a.lengths[b];
  const int32_t* row = a.tables + (size_t)b * a.NP;
  int first_page = 0;
  if (a.window == 0) {
    const int blk = split * L / ps + tid;
    if (tid <= tile && blk < a.NP) first_page = row[blk];
  }
  const TQ* q = static_cast<const TQ*>(a.q) + ((size_t)b * a.H + h0) * D;
  for (int i = tid; i < ng * D; i += kThreads) {
    sQ[i] = to_float(q[i]);
    sAcc[i] = 0.f;
  }
  if (tid < kMaxGroup) {
    sM[tid] = kNegInf;
    sL[tid] = 0.f;
  }

  // the positions this slot attends: [lo, hi)
  const int len = max(len_read, 0);
  int lo = 0, hi = 0;
  if (len > 0) {
    const int cur = (len - 1) / ps;  // the tail block
    if (a.window > 0) {
      // ring table: blocks older than cur - NP + 1 have no entry left
      const int start = max(0, len - a.window);
      const int blk_lo = max(start / ps, max(cur - a.NP + 1, 0));
      lo = max(start, blk_lo * ps);
      hi = len;
    } else {
      // contiguous table: entry j covers [j*ps, (j+1)*ps)
      hi = min(len, a.NP * ps);
    }
  }
  const int n_active = max(1, (hi - lo + L - 1) / L);  // an empty slot keeps split 0
  if (split >= n_active) return;
  const int p0 = lo + split * L;
  const int p1 = min(hi, p0 + L);

  const TKV* kp = static_cast<const TKV*>(a.k_pool);
  const TKV* vp = static_cast<const TKV*>(a.v_pool);
  const int cpr = D / N;  // copies per row
  for (int t0 = p0; t0 < p1; t0 += tile) {
    const int n = min(tile, p1 - t0);
    const int blk0 = t0 / ps;
    const int n_blk = (t0 + n - 1) / ps - blk0 + 1;
    if (a.window == 0 && t0 == p0) {
      if (tid < n_blk) sPage[tid] = first_page;
    } else {
      for (int i = tid; i < n_blk; i += kThreads) {
        const int blk = blk0 + i;
        sPage[i] = row[a.window > 0 ? blk % a.NP : blk];
      }
    }
    __syncthreads();

    // every K and V row of the tile in flight at once
    for (int c = tid; c < n * cpr; c += kThreads) {
      const int r = c / cpr, j = c - r * cpr;
      const int pos = t0 + r;
      const int page = sPage[pos / ps - blk0];
      TKV* dk = sK + r * rs + j * N;
      TKV* dv = sV + r * rs + j * N;
      if ((unsigned)page < (unsigned)a.P) {
        const size_t off = (((size_t)page * ps + pos % ps) * a.K + kh) * D + j * N;
        copy_async<VEC>(dk, kp + off);
        copy_async<VEC>(dv, vp + off);
      } else {  // never read outside the pool: the row is left out below
        zero_word<VEC>(dk);
        zero_word<VEC>(dv);
      }
    }
    copy_wait_all();
    __syncthreads();

    // scores: two threads a row, each half of its D, all ng query heads
    // (a K vector is unpacked once for all of them); the halves add up
    // through a shuffle
    {
      const int r = tid >> 1, part = tid & 1;
      const int half = (cpr + 1) / 2;
      float s[kMaxGroup];
#pragma unroll
      for (int g = 0; g < kMaxGroup; ++g) s[g] = 0.f;
      if (r < n) {
        const TKV* kr = sK + r * rs;
        for (int c = part ? half : 0; c < (part ? cpr : half); ++c) {
          const int d0 = c * N;
          float kf[N];
          load_floats<TKV, VEC>(kr + d0, kf);
#pragma unroll
          for (int g = 0; g < kMaxGroup; ++g) {
            if (g < ng) {
              const float* qg = sQ + g * D + d0;
              if constexpr (N % 4 == 0) {  // then D % 4 == 0: q is float4-aligned
#pragma unroll
                for (int i = 0; i < N; i += 4) {
                  const float4 qv = *reinterpret_cast<const float4*>(qg + i);
                  s[g] += qv.x * kf[i];
                  s[g] += qv.y * kf[i + 1];
                  s[g] += qv.z * kf[i + 2];
                  s[g] += qv.w * kf[i + 3];
                }
              } else {
#pragma unroll
                for (int i = 0; i < N; ++i) s[g] += qg[i] * kf[i];
              }
            }
          }
        }
      }
#pragma unroll
      for (int g = 0; g < kMaxGroup; ++g) s[g] += __shfl_xor_sync(0xffffffffu, s[g], 1);
      if (r < n && part == 0) {
        const bool in_pool = (unsigned)sPage[(t0 + r) / ps - blk0] < (unsigned)a.P;
#pragma unroll
        for (int g = 0; g < kMaxGroup; ++g)
          if (g < ng)
            sS[g * ts + r] = in_pool ? s[g] * a.scale : __uint_as_float(kMinusInfBits);
      }
    }
    __syncthreads();

    // online softmax, one warp a query head: the tile's max, p, its sum
    for (int g = warp; g < ng; g += kWarps) {
      float* sg = sS + g * ts;
      float mx = kNegInf;
      for (int r = lane; r < n; r += 32) mx = fmaxf(mx, sg[r]);
      const float m_old = sM[g];
      const float m_new = fmaxf(m_old, warp_max(mx));
      float sum = 0.f;
      for (int r = lane; r < n; r += 32) {
        const float p = expf(sg[r] - m_new);  // 0 for a row outside the pool
        sg[r] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        sC[g] = corr;
        sL[g] = sL[g] * corr + sum;
        sM[g] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * corr + P.V, one thread an output element, p four rows at
    // a time
    for (int i = tid; i < ng * D; i += kThreads) {
      const int g = i / D, d = i - g * D;
      const float* p = sS + g * ts;
      const TKV* v = sV + d;
      float acc = sAcc[i] * sC[g];
      int r = 0;
      for (; r + 4 <= n; r += 4) {
        const float4 pr = *reinterpret_cast<const float4*>(p + r);
        acc += pr.x * to_float(v[r * rs]);
        acc += pr.y * to_float(v[(r + 1) * rs]);
        acc += pr.z * to_float(v[(r + 2) * rs]);
        acc += pr.w * to_float(v[(r + 3) * rs]);
      }
      for (; r < n; ++r) acc += p[r] * to_float(v[r * rs]);
      sAcc[i] = acc;
    }
    __syncthreads();
  }
  __syncthreads();  // an empty slot skips the loop: m, l and acc as set above

  TQ* o = static_cast<TQ*>(a.out) + ((size_t)b * a.H + h0) * D;
  if (n_active == 1) {
    for (int i = tid; i < ng * D; i += kThreads)
      o[i] = from_float<TQ>(sAcc[i] / fmaxf(sL[i / D], 1e-30f));
    return;
  }

  // this split's (m, l, acc) to the workspace, then count it: the block's
  // writes, a barrier, then one thread's fence and atomic (the pattern of
  // cooperative groups' grid sync)
  const int stride = round4(GC * (D + 2));  // a split's record, 16-byte aligned
  const int slot = b * gridDim.y + kc;
  const float* w0 = a.work + (size_t)slot * a.n_split * stride;
  float* wp = a.work + ((size_t)slot * a.n_split + split) * stride;
  if (tid < ng) {
    wp[tid] = sM[tid];
    wp[GC + tid] = sL[tid];
  }
  for (int i = tid; i < ng * D; i += kThreads) wp[2 * GC + i] = sAcc[i];
  __syncthreads();
  if (tid == 0) {
    __threadfence();
    const int last = atomicAdd(a.counters + slot, 1) == n_active - 1;
    if (last) {
      a.counters[slot] = 0;  // every split has counted: leave it zeroed
      __threadfence();
    }
    *sFlag = last;
  }
  __syncthreads();
  if (!*sFlag) return;

  // The last block merges every split in split order, from L2. First, one
  // warp a query head: the max M over the splits, each split's weight
  // exp(m_s - M) and the normaliser (lane-ordered sums, then a fixed tree).
  constexpr int kPerLane = kMaxSplits / 32;
  for (int g = warp; g < ng; g += kWarps) {
    float ms[kPerLane], ls[kPerLane];
    float mx = kNegInf;
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) {
      const int s = lane + 32 * j;
      const float* ws = w0 + (size_t)s * stride;
      ms[j] = s < n_active ? __ldcg(ws + g) : kNegInf;
      ls[j] = s < n_active ? __ldcg(ws + GC + g) : 0.f;
      mx = fmaxf(mx, ms[j]);
    }
    mx = warp_max(mx);
    float den = 0.f;
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) {
      const int s = lane + 32 * j;
      if (s < n_active) {
        const float w = expf(ms[j] - mx);
        sW[s * kMaxGroup + g] = w;
        den += ls[j] * w;
      }
    }
    den = warp_sum(den);
    if (lane == 0) sL[g] = den;
  }
  // Then the numerators: the splits' records come into the K and V tiles'
  // room a chunk at a time, every copy of a chunk in flight at once
  // (cp.async.cg reads L2), and each output adds them in split order.
  float* sBuf = reinterpret_cast<float*>(smem);
  const int per_chunk = int(2 * kv_bytes / (sizeof(float) * stride));  // >= 1
  for (int i = tid; i < ng * D; i += kThreads) sAcc[i] = 0.f;
  for (int s0 = 0; s0 < n_active; s0 += per_chunk) {
    const int cn = min(per_chunk, n_active - s0);
    const float* src = w0 + (size_t)s0 * stride;
    for (int c = tid; c < cn * stride / 4; c += kThreads)
      copy_async<16>(sBuf + 4 * c, src + 4 * c);
    copy_wait_all();
    __syncthreads();
    for (int i = tid; i < ng * D; i += kThreads) {
      const float* w = sW + s0 * kMaxGroup + i / D;
      float num = sAcc[i];
      for (int s = 0; s < cn; ++s) num += sBuf[s * stride + 2 * GC + i] * w[s * kMaxGroup];
      sAcc[i] = num;
    }
    __syncthreads();
  }
  for (int i = tid; i < ng * D; i += kThreads)
    o[i] = from_float<TQ>(sAcc[i] / fmaxf(sL[i / D], 1e-30f));
}

template <typename TQ, typename TKV, int VEC>
cudaError_t launch_typed(const Args& a, int B, int KC, size_t smem,
                         cudaStream_t stream) {
  const dim3 grid(a.n_split, KC, B);
  paged_attention_kernel<TQ, TKV, VEC><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename TQ, typename TKV>
cudaError_t launch_vec(const Args& a, int B, int KC, size_t smem, int vec,
                       cudaStream_t stream) {
  switch (vec) {
    case 16: return launch_typed<TQ, TKV, 16>(a, B, KC, smem, stream);
    case 8: return launch_typed<TQ, TKV, 8>(a, B, KC, smem, stream);
    case 4: return launch_typed<TQ, TKV, 4>(a, B, KC, smem, stream);
    default:
      if constexpr (sizeof(TKV) == 2) return launch_typed<TQ, TKV, 2>(a, B, KC, smem, stream);
      return cudaErrorInvalidValue;  // not reached: the entry checks vec
  }
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16. window <= 0 means no window.
// split_len, n_split, vec_bytes and tile are `kernel.plan`'s. `work` holds
// B * KC * n_split * round4(GC (D + 2)) floats and `counters` B * KC zeroed int32
// (KC = K * ceil(G / 8), GC = min(G, 8)); both may be null with one split.
// Returns 0 on success, a cudaError_t from the launch, or -1 for arguments
// the kernel does not take (the Python wrapper checks these first).
extern "C" int paged_attention_launch(
    const void* q, const void* k_pool, const void* v_pool, const void* tables,
    const void* lengths, void* out, void* work, void* counters, int B, int H,
    int K, int D, int P, int ps, int NP, int window, float scale, int q_dtype,
    int kv_dtype, int split_len, int n_split, int vec_bytes, int tile,
    void* stream) {
  if (B < 1 || B > 65535 || K < 1 || H % K != 0 || D < 1 || D > 128 || P < 1 ||
      ps < 1 || NP < 1 || q_dtype < 0 || q_dtype > 1 || kv_dtype < 0 ||
      kv_dtype > 1)
    return -1;
  const int elt = kv_dtype == 0 ? 4 : 2;
  const int w = window > 0 ? window : 0;
  const long long span = w > 0 ? std::min<long long>((long long)NP * ps, w)
                               : (long long)NP * ps;
  const bool vec_ok = (vec_bytes == 2 || vec_bytes == 4 || vec_bytes == 8 ||
                       vec_bytes == 16) && vec_bytes >= elt &&
                      (D * elt) % vec_bytes == 0 &&
                      (reinterpret_cast<uintptr_t>(k_pool) % vec_bytes) == 0 &&
                      (reinterpret_cast<uintptr_t>(v_pool) % vec_bytes) == 0;
  if (!vec_ok || split_len < 1 || split_len % ps != 0 || n_split < 1 ||
      n_split > kMaxSplits || (long long)n_split * split_len < span ||
      tile < 1 || tile > split_len || 2 * tile > kThreads)
    return -1;
  const int G = H / K;
  const int KC = K * ((G + kMaxGroup - 1) / kMaxGroup);
  if (KC > 65535 ||
      (n_split > 1 && (work == nullptr || counters == nullptr ||
                       reinterpret_cast<uintptr_t>(work) % 16 != 0)))
    return -1;
  const int row_stride = D + vec_bytes / elt;
  const int gc = std::min(G, kMaxGroup);
  const size_t smem = smem_bytes(tile, row_stride, elt, gc, D);
  // the merge reads the splits' records through the K and V tiles' room:
  // one record must fit
  const size_t record = sizeof(float) * round4(gc * (D + 2));
  if (smem > kMaxSmem ||
      (n_split > 1 && record > 2 * align16(size_t(tile) * row_stride * elt)))
    return -1;

  Args a;
  a.q = q;
  a.k_pool = k_pool;
  a.v_pool = v_pool;
  a.tables = static_cast<const int32_t*>(tables);
  a.lengths = static_cast<const int32_t*>(lengths);
  a.out = out;
  a.work = static_cast<float*>(work);
  a.counters = static_cast<int32_t*>(counters);
  a.H = H;
  a.K = K;
  a.D = D;
  a.P = P;
  a.ps = ps;
  a.NP = NP;
  a.window = w;
  a.scale = scale;
  a.split_len = split_len;
  a.n_split = n_split;
  a.tile = tile;
  a.row_stride = row_stride;
  const auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (q_dtype == 0 && kv_dtype == 0)
    err = launch_vec<float, float>(a, B, KC, smem, vec_bytes, s);
  else if (q_dtype == 0)
    err = launch_vec<float, __nv_bfloat16>(a, B, KC, smem, vec_bytes, s);
  else if (kv_dtype == 0)
    err = launch_vec<__nv_bfloat16, float>(a, B, KC, smem, vec_bytes, s);
  else
    err = launch_vec<__nv_bfloat16, __nv_bfloat16>(a, B, KC, smem, vec_bytes, s);
  return static_cast<int>(err);
}

extern "C" const char* paged_attention_error_string(int code) {
  if (code == -1) return "argument the paged-attention kernel does not take";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// RG-LRU linear scan for Hopper (sm_90a): h_t = a_t * h_{t-1} + b_t over the
// time axis of (B, S, W) float32 inputs, and its gradient.
//
// rglru_scan replaces the Pallas TPU kernel `rglru_scan` (body
// `_rglru_kernel`), src/repro/kernels/rglru/kernel.py:46. Same function: y
// (B, S, W) holds every h_t and h_final (B, W) the last one, float32
// throughout, h starting at 0 (the wrapper folds an initial state into
// b[:, 0], as the reference's wrapper does).
//
// rglru_scan_bwd replaces no TPU kernel: the reference trains through
// `linear_scan_blocked` (src/repro/models/griffin.py:87) under jax.grad, and
// the port's training path needs a backward of its own kernel. Walking time
// backwards from g = dy_{S-1} + dh (dh the gradient of h_final),
// g_t = dy_t + a_{t+1} g_{t+1}; then db_t = g_t and da_t = g_t y_{t-1}
// (y_{-1} = 0: the wrapper's h0 fold carries h0's share).
//
// The order of roundings is kept from the first port: each forward step is
// a multiply, rounded, then an add, rounded (__fmul_rn / __fadd_rn, so nvcc
// does not contract them into one FMA), and each backward step the same on
// g, in the order above. These are the two roundings of the plain PyTorch
// versions (ref.rglru, ref.rglru_bwd), so both kernels equal them bit for
// bit, and the card's checks compare with torch.equal. A chunked scan
// (carries per chunk first, then the chunks in parallel) would reassociate
// the products and lose that equality; at these shapes the chain is not
// the limit, so it is not needed.
//
// What bounds them: bytes. A forward step is 2 float operations per lane
// against 12 bytes (a and b read, y written); a backward step 3 against 20
// (dy, a, y read; da, db written). Every input read once, every output
// written once, at 3.35 TB/s:
//   forward, recurrentgemma-2b's training microbatch (B 1, S 4096, W 2560):
//     125.8 MB, 0.0376 ms; its prefill (B 8): 1.007 GB, 0.3005 ms;
//   backward, B 1: 209.7 MB, 0.0626 ms; the recipe's microbatch (B 2):
//     419.4 MB, 0.1252 ms.
// On an H100 80GB HBM3 at 700 W (tools/rglru_variants.py), torch.add(a, b,
// out=y), which moves the forward's bytes with no scan, takes 0.045-0.046
// ms at B 1 and 0.33-0.34 ms at B 8 (2.75-3.07 TB/s): the practical floor.
// The chain alone (a multiply, then an add, S times from registers) takes
// 4.65 ns a step, 0.019 ms at S 4096, so one lane's walk fits under the B 1
// bounds.
//
// The first port gave one thread a lane in blocks of 64 with 16 steps loaded
// ahead in registers: at B 1 that was 40 blocks on 40 of the 132 SMs with
// about 0.5 MB in flight, 470-700 GB/s. This design keeps tiles of many
// steps in flight through shared memory:
// - A block owns L = 32 lanes of one batch row (128-byte rows), grid
//   (ceil(W / 32), B): 80 blocks at B 1, W 2560, 640 at B 8, two blocks an
//   SM forward. Wider rows on fewer SMs reach more of the memory's rate.
//   64-lane blocks lose at B 1 (the training microbatch), win by 4% at B 8
//   and by 15% at B 2, which no path runs (tools/rglru_variants.py times
//   the shapes the templates take), so one shape ships.
// - The time axis arrives in tiles of T = 128 steps x L lanes through a
//   ring of NS = 3 stages in dynamic shared memory (forward: a and b,
//   backward: dy, a and y), filled with cp.async by the copy warps:
//   16-byte copies where W % 4 == 0 and the inputs lie on 16 bytes (then a
//   16-byte piece of a row is all in W or all past it), 4-byte copies
//   otherwise; steps and lanes past the edge are zero-filled. 96 KB a block
//   forward, 144 KB backward.
// - The walking warps (one thread a lane) keep h (or g) in a float32
//   register across tiles and read a tile's steps from shared memory; four
//   copy warps only copy. The two sides meet at mbarriers, one pair a stage:
//   a copy thread's cp.async.mbarrier.arrive.noinc completes the stage's
//   `full` phase when its copies land, the walk arrives on `empty` when it
//   has left the stage. No __syncthreads inside the loop.
// - Outputs go straight from the walking threads: each step one coalesced
//   row of y (forward) or of da and db (backward).
// - The backward walks tiles from the last down and loads y shifted by one
//   row (tile rows t - 1), so y_{t-1} sits beside dy_t; a_{t+1} carries in a
//   register from the step before, starting at 1 (1 * g is g exactly, so
//   step S - 1 gives dy + dh as the plain version does).
// Each call is one launch. Kernel names keep the prefix rglru_scan, which
// chip_smoke.py uses to find the port's kernels in a profile.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kCopiers = 128;   // threads of the copy warps
// the shape that ships: lanes a block, steps a tile, ring stages (the
// templates take others for tools/rglru_variants.py; L whole warps)
constexpr int kLanes = 32, kTile = 128, kStages = 3;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// cp.async of VEC bytes (16 or 4) from global to shared memory; with `ok`
// false nothing is read and the destination is zero-filled
template <int VEC>
__device__ __forceinline__ void copy_async(float* dst, const float* src,
                                           bool ok) {
  const int n = ok ? VEC : 0;
  if constexpr (VEC == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "r"(n)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "r"(n)
                 : "memory");
  }
}

// mbarriers in shared memory: init (count arrivals a phase), arrive, the
// arrival of this thread's cp.async copies once they have landed, and a
// wait for the phase of the given parity to complete
__device__ __forceinline__ void bar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile(
      "{\n .reg .b64 state;\n mbarrier.arrive.shared::cta.b64 state, [%0];\n}\n" ::"r"(
          smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void bar_arrive_copies(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void bar_wait(uint64_t* bar, int parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
}

__device__ __forceinline__ void copy_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// One tile of J tensors into one stage: stage[j][r][l] = src[j][row0 + t0 +
// r + shift[j]][w0 + l], zero where that row is outside [0, S) or the lane
// outside W. Called by the copy warps only.
template <int VEC, int L, int T, int J>
__device__ __forceinline__ void load_tile(float (&stage)[J][T][L],
                                          const float* const (&src)[J],
                                          const int (&shift)[J], size_t row0,
                                          int t0, int w0, int S, int W) {
  constexpr int kPerRow = L * 4 / VEC;   // copies a row of a tile
  constexpr int kEach = T * kPerRow / kCopiers;
  static_assert(T * kPerRow % kCopiers == 0, "copies split evenly");
  const int copier = threadIdx.x - L;
#pragma unroll
  for (int j = 0; j < J; ++j) {
#pragma unroll
    for (int i = 0; i < kEach; ++i) {
      const int c = copier + i * kCopiers;
      const int r = c / kPerRow, l = (c % kPerRow) * (VEC / 4);
      const int t = t0 + r + shift[j];
      const bool ok = t >= 0 && t < S && w0 + l < W;
      const float* p = ok ? src[j] + (row0 + t) * W + w0 + l : src[j];
      copy_async<VEC>(&stage[j][r][l], p, ok);
    }
  }
}

// The pipeline both kernels share: the copy warps fill stage i % NS with
// tile i (`load(i, stage)`) once the walk has left it (mbarrier `empty`),
// and their copies' landing completes that stage's `full` phase; the walking
// warps wait on `full`, walk the tile (`walk(i, stage)`) and arrive on
// `empty`. No block-wide barrier inside the loop: a stage is refilled as
// soon as the walk has left it.
template <int L, int NS, typename Stage, typename Load, typename Walk>
__device__ __forceinline__ void pipeline(Stage* ring, uint64_t* bars,
                                         int tiles, Load load, Walk walk) {
  static_assert(L % 32 == 0, "the walking threads are whole warps");
  uint64_t* full = bars;
  uint64_t* empty = bars + NS;
  if (threadIdx.x == 0)
    for (int s = 0; s < NS; ++s) {
      bar_init(full + s, kCopiers);
      bar_init(empty + s, L / 32);
    }
  __syncthreads();
  if (threadIdx.x >= L) {
    for (int i = 0; i < tiles; ++i) {
      const int s = i % NS;
      if (i >= NS) bar_wait(empty + s, (i / NS - 1) & 1);
      load(i, ring[s]);
      bar_arrive_copies(full + s);
    }
    copy_wait_all();
    return;
  }
  for (int i = 0; i < tiles; ++i) {
    const int s = i % NS;
    bar_wait(full + s, (i / NS) & 1);
    walk(i, ring[s]);
    __syncwarp();
    if (threadIdx.x % 32 == 0) bar_arrive(empty + s);
  }
}

template <int T, int L, int J>
constexpr int smem_bytes(int NS) {
  return NS * J * T * L * 4 + 2 * NS * 8;
}

// grid: x = ceil(W / L), y = B. block: L + kCopiers threads.
// dynamic shared memory: NS stages of a and b (T steps x L lanes each),
// then the stages' mbarriers.
template <int VEC, int L, int T, int NS>
__global__ void __launch_bounds__(L + kCopiers)
rglru_scan_kernel(const float* __restrict__ a, const float* __restrict__ b,
                  float* __restrict__ y, float* __restrict__ h_final, int S,
                  int W) {
  using Stage = float[2][T][L];
  extern __shared__ __align__(16) unsigned char smem[];
  Stage* ring = reinterpret_cast<Stage*>(smem);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + NS * sizeof(Stage));
  const int w0 = blockIdx.x * L;
  const size_t row0 = (size_t)blockIdx.y * S;
  const int tiles = (S + T - 1) / T;
  const float* const src[2] = {a, b};
  const int shift[2] = {0, 0};
  const int lane = threadIdx.x, w = w0 + lane;
  const bool walks = lane < L && w < W;
  float h = 0.f;
  pipeline<L, NS>(
      ring, bars, tiles,
      [&](int i, Stage& stage) {   // tile i: steps i * T ...
        load_tile<VEC>(stage, src, shift, row0, i * T, w0, S, W);
      },
      [&](int i, const Stage& ab) {
        if (!walks) return;
        const int t0 = i * T, n = min(T, S - t0);
        float* yp = y + (row0 + t0) * W + w;
#pragma unroll 16
        for (int r = 0; r < n; ++r) {
          h = __fadd_rn(__fmul_rn(ab[0][r][lane], h), ab[1][r][lane]);
          yp[(size_t)r * W] = h;
        }
      });
  if (walks) h_final[(size_t)blockIdx.y * W + w] = h;
}

// grid and block as the forward's; NS stages of dy, a and y (T x L each),
// then the mbarriers.
template <int VEC, int L, int T, int NS>
__global__ void __launch_bounds__(L + kCopiers)
rglru_scan_bwd_kernel(const float* __restrict__ a, const float* __restrict__ y,
                      const float* __restrict__ dy,
                      const float* __restrict__ dh, float* __restrict__ da,
                      float* __restrict__ db, int S, int W) {
  // a stage holds dy_t, a_t and y_{t-1} for the tile's steps t
  using Stage = float[3][T][L];
  extern __shared__ __align__(16) unsigned char smem[];
  Stage* ring = reinterpret_cast<Stage*>(smem);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + NS * sizeof(Stage));
  const int w0 = blockIdx.x * L;
  const size_t row0 = (size_t)blockIdx.y * S;
  const int tiles = (S + T - 1) / T;
  const float* const src[3] = {dy, a, y};
  const int shift[3] = {0, 0, -1};
  const int lane = threadIdx.x, w = w0 + lane;
  const bool walks = lane < L && w < W;
  float g = walks ? dh[(size_t)blockIdx.y * W + w] : 0.f;
  float a_next = 1.f;   // a_{t+1}; 1 at t = S - 1, where 1 * g is g
  pipeline<L, NS>(
      ring, bars, tiles,
      [&](int i, Stage& stage) {   // the i-th tile from the end
        load_tile<VEC>(stage, src, shift, row0, (tiles - 1 - i) * T, w0, S,
                       W);
      },
      [&](int i, const Stage& tile) {
        if (!walks) return;
        const int t0 = (tiles - 1 - i) * T, n = min(T, S - t0);
        float* dap = da + (row0 + t0) * W + w;
        float* dbp = db + (row0 + t0) * W + w;
#pragma unroll 16
        for (int r = n - 1; r >= 0; --r) {
          g = __fadd_rn(tile[0][r][lane], __fmul_rn(a_next, g));
          dbp[(size_t)r * W] = g;
          dap[(size_t)r * W] =
              (t0 + r) ? __fmul_rn(g, tile[2][r][lane]) : 0.f;
          a_next = tile[1][r][lane];
        }
      });
}

// Raises a kernel's dynamic shared memory limit to `smem` on the current
// device, once a device
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int smem,
                       std::atomic<unsigned long long>& done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (done.load() >> dev & 1)) return err;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess) done.fetch_or(1ull << dev);
  return err;
}

template <int VEC, int L, int T, int NS>
int scan(const float* a, const float* b, float* y, float* h, int B, int S,
         int W, cudaStream_t stream) {
  constexpr int smem = smem_bytes<T, L, 2>(NS);
  static std::atomic<unsigned long long> done{0};
  if (const cudaError_t err =
          allow_smem(rglru_scan_kernel<VEC, L, T, NS>, smem, done))
    return static_cast<int>(err);
  rglru_scan_kernel<VEC, L, T, NS>
      <<<dim3((W + L - 1) / L, B), L + kCopiers, smem, stream>>>(
          a, b, y, h, S, W);
  return static_cast<int>(cudaGetLastError());
}

template <int VEC, int L, int T, int NS>
int scan_bwd(const float* a, const float* y, const float* dy,
             const float* dh, float* da, float* db, int B, int S, int W,
             cudaStream_t stream) {
  constexpr int smem = smem_bytes<T, L, 3>(NS);
  static std::atomic<unsigned long long> done{0};
  if (const cudaError_t err =
          allow_smem(rglru_scan_bwd_kernel<VEC, L, T, NS>, smem, done))
    return static_cast<int>(err);
  rglru_scan_bwd_kernel<VEC, L, T, NS>
      <<<dim3((W + L - 1) / L, B), L + kCopiers, smem, stream>>>(
          a, y, dy, dh, da, db, S, W);
  return static_cast<int>(cudaGetLastError());
}

// 16-byte copies need each row's W floats and the inputs' addresses on 16
// bytes; the Python wrapper picks `vec` the same way (kernel.vec_bytes)
bool vec_ok(int vec, int W, const void* p, const void* q, const void* r) {
  if (vec == 4) return true;
  const uintptr_t any = reinterpret_cast<uintptr_t>(p) |
                        reinterpret_cast<uintptr_t>(q) |
                        reinterpret_cast<uintptr_t>(r);
  return vec == 16 && W % 4 == 0 && any % 16 == 0;
}

}  // namespace

// a, b, y: (B, S, W) float32, contiguous; h_final: (B, W) float32; vec: the
// bytes of one copy, 16 or 4 (see vec_ok). Returns 0 on success, a
// cudaError_t from the launch, or -1 for arguments the kernel does not take
// (the Python wrapper checks these first and picks vec: kernel.vec_bytes).
extern "C" int rglru_scan(const void* a, const void* b, void* y,
                          void* h_final, int B, int S, int W, int vec,
                          void* stream) {
  if (B < 1 || B > 65535 || S < 1 || W < 1 || !vec_ok(vec, W, a, b, a))
    return -1;
  const auto pa = static_cast<const float*>(a);
  const auto pb = static_cast<const float*>(b);
  const auto py = static_cast<float*>(y);
  const auto ph = static_cast<float*>(h_final);
  const auto s = static_cast<cudaStream_t>(stream);
  return vec == 16
             ? scan<16, kLanes, kTile, kStages>(pa, pb, py, ph, B, S, W, s)
             : scan<4, kLanes, kTile, kStages>(pa, pb, py, ph, B, S, W, s);
}

// a, y, dy, da, db: (B, S, W) float32, contiguous; dh: (B, W) float32; vec
// as for rglru_scan, over a, y and dy. Returns as rglru_scan does.
extern "C" int rglru_scan_bwd(const void* a, const void* y, const void* dy,
                              const void* dh, void* da, void* db, int B,
                              int S, int W, int vec, void* stream) {
  if (B < 1 || B > 65535 || S < 1 || W < 1 || !vec_ok(vec, W, a, y, dy))
    return -1;
  const auto pa = static_cast<const float*>(a);
  const auto py = static_cast<const float*>(y);
  const auto pdy = static_cast<const float*>(dy);
  const auto pdh = static_cast<const float*>(dh);
  const auto pda = static_cast<float*>(da);
  const auto pdb = static_cast<float*>(db);
  const auto s = static_cast<cudaStream_t>(stream);
  return vec == 16 ? scan_bwd<16, kLanes, kTile, kStages>(pa, py, pdy, pdh,
                                                          pda, pdb, B, S, W, s)
                   : scan_bwd<4, kLanes, kTile, kStages>(pa, py, pdy, pdh,
                                                         pda, pdb, B, S, W, s);
}

extern "C" const char* rglru_scan_error_string(int code) {
  if (code == -1) return "argument the RG-LRU scan kernel does not take";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

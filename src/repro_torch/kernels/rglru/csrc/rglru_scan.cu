// RG-LRU linear scan for Hopper (sm_90a): h_t = a_t * h_{t-1} + b_t over the
// time axis of (B, S, W) float32 inputs.
//
// Replaces the Pallas TPU kernel `rglru_scan` (body `_rglru_kernel`),
// src/repro/kernels/rglru/kernel.py:46. Same function: y (B, S, W) holds
// every h_t and h_final (B, W) the last one, float32 throughout, h starting
// at 0 (the wrapper folds an initial state into b[:, 0], as the reference's
// wrapper does). Each step is a multiply, rounded, then an add, rounded
// (__fmul_rn / __fadd_rn, so nvcc does not contract them into one FMA): the
// same two roundings as the plain PyTorch version, which this kernel
// therefore matches bit for bit.
//
// What bounds it: bytes. A step is 2 float operations per lane against 12
// bytes (a and b read, y written), so at RecurrentGemma-2B's prefill shape
// (B 8, S 4096, W 2560) the call moves 1.007 GB, 0.30 ms at 3.35 TB/s,
// while its 1.7e8 operations would take microseconds.
//
// What the design does about that: one thread owns one (b, w) lane and walks
// its S steps, keeping h in a float32 register; neighbouring threads own
// neighbouring w, so each warp's loads and stores of one step are 128
// contiguous bytes. The recurrence is a chain of dependent operations, so a
// thread hides memory latency by loading ahead: it holds the a and b of
// kUnroll steps in registers and issues the next kUnroll steps' loads before
// it works through the current ones. Blocks are small (kThreads lanes) to
// spread the lanes evenly over the SMs.
//
// The limit of this simple design: the only parallelism is B * W lanes. At
// the prefill shape that is 20480 threads, 155 per SM of the 132, about 5
// warps where an SM holds 64, so the loads in flight per SM (5 warps x 2 x
// kUnroll lines of 128 bytes) are about what the memory's latency needs and
// no more. Still to do for speed (a later change): a chunked two-pass scan
// (per-chunk carries first, then chunks in parallel from their carries) that
// also splits the time axis across blocks.
//
// rglru_scan_bwd: the gradient of that scan. It replaces no TPU kernel: the
// reference trains through `linear_scan_blocked` (src/repro/models/
// griffin.py:87) under jax.grad, and the port's training path needs a
// backward of its own kernel. Walking time backwards from g = dy_{S-1} + dh
// (dh the gradient of h_final), g_t = dy_t + a_{t+1} g_{t+1}; then
// db_t = g_t and da_t = g_t y_{t-1} (y_{-1} = 0: the wrapper's h0 fold
// carries h0's share). The same two roundings a step as the plain version
// (ref.rglru_bwd), so the two agree bit for bit. Bound: bytes again; it
// reads dy, a and y and writes da and db, 20 bytes a step and lane: at the
// training microbatch (B 2, S 4096, W 2560) 419 MB, 0.125 ms at 3.35 TB/s.
// Design: the forward's, mirrored: one thread a lane, kUnroll steps of dy,
// a and y loaded ahead (going down in t) while the current ones are used.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 64;   // lanes per block
constexpr int kUnroll = 16;    // steps loaded ahead per thread

// grid: x = ceil(W / kThreads), y = B. block: kThreads.
__global__ void __launch_bounds__(kThreads)
rglru_scan_kernel(const float* __restrict__ a, const float* __restrict__ b,
                  float* __restrict__ y, float* __restrict__ h_final, int S,
                  int W) {
  const int w = blockIdx.x * kThreads + threadIdx.x;
  if (w >= W) return;
  const size_t base = (size_t)blockIdx.y * S * W + w;
  const float* ap = a + base;
  const float* bp = b + base;
  float* yp = y + base;

  float ca[kUnroll], cb[kUnroll];
#pragma unroll
  for (int i = 0; i < kUnroll; ++i) {
    ca[i] = i < S ? __ldg(ap + (size_t)i * W) : 0.f;
    cb[i] = i < S ? __ldg(bp + (size_t)i * W) : 0.f;
  }
  float h = 0.f;
  for (int t0 = 0; t0 < S; t0 += kUnroll) {
    // the next steps' loads go out before this chunk's dependent chain
    float na[kUnroll], nb[kUnroll];
#pragma unroll
    for (int i = 0; i < kUnroll; ++i) {
      const int t = t0 + kUnroll + i;
      na[i] = t < S ? __ldg(ap + (size_t)t * W) : 0.f;
      nb[i] = t < S ? __ldg(bp + (size_t)t * W) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < kUnroll; ++i) {
      const int t = t0 + i;
      if (t < S) {
        h = __fadd_rn(__fmul_rn(ca[i], h), cb[i]);
        yp[(size_t)t * W] = h;
      }
    }
#pragma unroll
    for (int i = 0; i < kUnroll; ++i) {
      ca[i] = na[i];
      cb[i] = nb[i];
    }
  }
  h_final[(size_t)blockIdx.y * W + w] = h;
}

// grid: x = ceil(W / kThreads), y = B. block: kThreads.
__global__ void __launch_bounds__(kThreads)
rglru_scan_bwd_kernel(const float* __restrict__ a, const float* __restrict__ y,
                      const float* __restrict__ dy,
                      const float* __restrict__ dh, float* __restrict__ da,
                      float* __restrict__ db, int S, int W) {
  const int w = blockIdx.x * kThreads + threadIdx.x;
  if (w >= W) return;
  const size_t base = (size_t)blockIdx.y * S * W + w;
  const float* ap = a + base;
  const float* yp = y + base;
  const float* dyp = dy + base;
  float* dap = da + base;
  float* dbp = db + base;

  // step t needs dy_t, y_{t-1} and (for g_t) a_{t+1}: a_{t+1} is the a
  // loaded one step earlier in this walk, so each step loads dy_t, a_t and
  // y_{t-1}, kUnroll steps ahead
  float cd[kUnroll], ca[kUnroll], cy[kUnroll];
#pragma unroll
  for (int i = 0; i < kUnroll; ++i) {
    const int t = S - 1 - i;
    cd[i] = t >= 0 ? __ldg(dyp + (size_t)t * W) : 0.f;
    ca[i] = t >= 0 ? __ldg(ap + (size_t)t * W) : 0.f;
    cy[i] = t >= 1 ? __ldg(yp + (size_t)(t - 1) * W) : 0.f;
  }
  float g = dh[(size_t)blockIdx.y * W + w];
  float a_next = 0.f;  // a_{t+1}; unused at t = S - 1
  for (int t0 = S - 1; t0 >= 0; t0 -= kUnroll) {
    float nd[kUnroll], na[kUnroll], ny[kUnroll];
#pragma unroll
    for (int i = 0; i < kUnroll; ++i) {
      const int t = t0 - kUnroll - i;
      nd[i] = t >= 0 ? __ldg(dyp + (size_t)t * W) : 0.f;
      na[i] = t >= 0 ? __ldg(ap + (size_t)t * W) : 0.f;
      ny[i] = t >= 1 ? __ldg(yp + (size_t)(t - 1) * W) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < kUnroll; ++i) {
      const int t = t0 - i;
      if (t >= 0) {
        g = t == S - 1 ? __fadd_rn(cd[i], g) : __fadd_rn(cd[i], __fmul_rn(a_next, g));
        dbp[(size_t)t * W] = g;
        dap[(size_t)t * W] = t ? __fmul_rn(g, cy[i]) : 0.f;
        a_next = ca[i];
      }
    }
#pragma unroll
    for (int i = 0; i < kUnroll; ++i) {
      cd[i] = nd[i];
      ca[i] = na[i];
      cy[i] = ny[i];
    }
  }
}

}  // namespace

// a, b, y: (B, S, W) float32, contiguous; h_final: (B, W) float32. Returns 0
// on success, a cudaError_t from the launch, or -1 for arguments the kernel
// does not take (the Python wrapper checks these first).
extern "C" int rglru_scan(const void* a, const void* b, void* y,
                          void* h_final, int B, int S, int W, void* stream) {
  if (B < 1 || B > 65535 || S < 1 || W < 1) return -1;
  const dim3 grid((W + kThreads - 1) / kThreads, B);
  rglru_scan_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<float*>(y), static_cast<float*>(h_final), S, W);
  return static_cast<int>(cudaGetLastError());
}

// a, y, dy, da, db: (B, S, W) float32, contiguous; dh: (B, W) float32.
// Returns as rglru_scan does.
extern "C" int rglru_scan_bwd(const void* a, const void* y, const void* dy,
                              const void* dh, void* da, void* db, int B,
                              int S, int W, void* stream) {
  if (B < 1 || B > 65535 || S < 1 || W < 1) return -1;
  const dim3 grid((W + kThreads - 1) / kThreads, B);
  rglru_scan_bwd_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(y),
      static_cast<const float*>(dy), static_cast<const float*>(dh),
      static_cast<float*>(da), static_cast<float*>(db), S, W);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* rglru_scan_error_string(int code) {
  if (code == -1) return "argument the RG-LRU scan kernel does not take";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

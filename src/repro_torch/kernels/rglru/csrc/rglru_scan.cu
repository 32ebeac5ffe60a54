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

extern "C" const char* rglru_scan_error_string(int code) {
  if (code == -1) return "argument the RG-LRU scan kernel does not take";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Depthwise causal conv1d for Hopper (sm_90a): the CGRA stand-in of the
// paper's healthcare demo.
//
// Replaces the Pallas TPU kernel `conv1d_causal` (body `_conv_kernel`),
// src/repro/kernels/conv1d/kernel.py:36. Same function: for x (B, S, D) and
// taps w (W, D),
//   y[b, t, d] = sum_{i < W} w[i, d] * x[b, t - W + 1 + i, d],
// with x = 0 before t = 0, accumulated in float32 with the taps in the
// reference's order (i = 0 ... W - 1) and y written in x's dtype. Each
// product and each partial sum is rounded once (__fmul_rn / __fadd_rn, so
// nvcc does not contract them into FMAs): the two roundings of the plain
// PyTorch version (layers.causal_conv1d), which this kernel therefore
// matches bit for bit whenever the plain version computes in float32 (float32
// taps, or float32 x). With bfloat16 x and bfloat16 taps the plain version
// rounds every step to bfloat16, and this kernel, like the TPU kernel, keeps
// float32.
//
// Differences from the TPU kernel, all in what it takes, none in what it
// computes: any S >= 1 and D >= 1 (the Pallas wrapper asserts S % s_block ==
// 0 and D % d_block == 0); any width 1 <= W <= kMaxWidth (at W = 1 the TPU
// kernel's halo slice `prev[-(W - 1):]` is `prev[-0:]`, the whole previous
// block, and its result is wrong; here W = 1 is y = w[0] * x); x and w read
// through their strides, so the seizure CNN's channel broadcast (one input
// channel expanded over the output channels, stride 0 along D) is never
// copied; float32 or bfloat16 x and taps.
//
// What bounds it: bytes. A step is 2W float operations per channel against
// x read and y written, so one call moves 2 * B * S * D * elt + W * D * 4
// bytes (at recurrentgemma's conv shape, B 8, S 4096, D 2560 in bf16, 336
// MB: 0.10 ms at 3.35 TB/s). At the healthcare shapes ((1, 1024, 32) and
// smaller, 0.26 MB) the bound is 0.04 us and the launch's own latency, a few
// microseconds, sets the time.
//
// What the design does about it. The TPU kernel tiles (S, D) into blocks and
// stitches each block's W - 1 halo rows from a second BlockSpec view of the
// previous sequence block. Here one thread owns one channel d of one batch
// row and walks a tile of kTile time steps; it reads its W - 1 halo rows
// straight from device memory (they are the previous tile's last rows, so
// they come from L2 or L1 when that tile ran nearby), so the tiles are
// independent and need no second pass. The W taps of its channel and the
// sliding window of the last W inputs stay in registers (W is a template
// parameter, so both arrays are unrolled into registers), and each input is
// loaded once per tile. Neighbouring threads own neighbouring channels, so a
// warp's loads and stores of one step are contiguous when D is; the threads
// of a block that do not fit in D (D < 128) take further time tiles of the
// same channels, so a narrow D still fills the block.
//
// The limit of this simple design: each thread's steps are a chain of
// dependent loads with no loads issued ahead, and the halo is re-read per
// tile ((W - 1) / kTile more reads, 9% at W 4).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;   // threads per block
constexpr int kTile = 32;       // time steps per thread
constexpr int kMaxWidth = 8;    // widest tap count compiled

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float v) {
  return __float2bfloat16_rn(v);
}

// grid: x = ceil(D / d_threads), y = ceil(ceil(S / kTile) / (kThreads /
// d_threads)), z = B. block: kThreads = d_threads channels x (kThreads /
// d_threads) time tiles. y is contiguous (B, S, D).
template <int W, typename TX, typename TW>
__global__ void __launch_bounds__(kThreads)
conv1d_causal_kernel(const TX* __restrict__ x, const TW* __restrict__ w,
                     TX* __restrict__ y, int S, int D, int d_threads,
                     long long sxb, long long sxs, long long sxd,
                     long long swi, long long swd) {
  const int d = blockIdx.x * d_threads + threadIdx.x % d_threads;
  const long long tile =
      (long long)blockIdx.y * (kThreads / d_threads) + threadIdx.x / d_threads;
  const long long t0 = tile * kTile;
  if (d >= D || t0 >= S) return;
  const TX* xp = x + (long long)blockIdx.z * sxb + (long long)d * sxd;
  TX* yp = y + (long long)blockIdx.z * S * D + d;

  float tap[W];
#pragma unroll
  for (int i = 0; i < W; ++i) tap[i] = to_f32(w[i * swi + (long long)d * swd]);

  // win[i] holds x[t - W + 1 + i]; the W - 1 halo rows before t0 first
  float win[W];
#pragma unroll
  for (int i = 0; i < W - 1; ++i) {
    const long long t = t0 - (W - 1) + i;
    win[i] = t >= 0 ? to_f32(xp[t * sxs]) : 0.f;
  }
  const long long t_end = t0 + kTile < S ? t0 + kTile : S;
  for (long long t = t0; t < t_end; ++t) {
    win[W - 1] = to_f32(xp[t * sxs]);
    float acc = __fmul_rn(win[0], tap[0]);
#pragma unroll
    for (int i = 1; i < W; ++i) acc = __fadd_rn(acc, __fmul_rn(win[i], tap[i]));
    yp[t * D] = from_f32<TX>(acc);
#pragma unroll
    for (int i = 0; i < W - 1; ++i) win[i] = win[i + 1];
  }
}

template <int W, typename TX, typename TW>
int launch(const void* x, const void* w, void* y, int B, int S, int D,
           long long sxb, long long sxs, long long sxd, long long swi,
           long long swd, cudaStream_t stream) {
  const int d_threads = D <= 32 ? 32 : (D <= 64 ? 64 : kThreads);
  const long long tiles = (S + (long long)kTile - 1) / kTile;
  const long long per_block = kThreads / d_threads;
  const long long grid_y = (tiles + per_block - 1) / per_block;
  if (grid_y > 65535) return -1;
  const dim3 grid((D + d_threads - 1) / d_threads, (unsigned)grid_y, B);
  conv1d_causal_kernel<W, TX, TW><<<grid, kThreads, 0, stream>>>(
      static_cast<const TX*>(x), static_cast<const TW*>(w),
      static_cast<TX*>(y), S, D, d_threads, sxb, sxs, sxd, swi, swd);
  return static_cast<int>(cudaGetLastError());
}

template <typename TX, typename TW>
int dispatch_width(int W, const void* x, const void* w, void* y, int B, int S,
                   int D, long long sxb, long long sxs, long long sxd,
                   long long swi, long long swd, cudaStream_t s) {
  switch (W) {
#define CONV1D_WIDTH(n) \
  case n:               \
    return launch<n, TX, TW>(x, w, y, B, S, D, sxb, sxs, sxd, swi, swd, s);
    CONV1D_WIDTH(1)
    CONV1D_WIDTH(2)
    CONV1D_WIDTH(3)
    CONV1D_WIDTH(4)
    CONV1D_WIDTH(5)
    CONV1D_WIDTH(6)
    CONV1D_WIDTH(7)
    CONV1D_WIDTH(8)
#undef CONV1D_WIDTH
    default:
      return -1;
  }
}

}  // namespace

// x: (B, S, D) float32 or bfloat16 (x_bf16) at strides (sxb, sxs, sxd), in
// elements, none negative; w: (W, D) float32 or bfloat16 (w_bf16) at strides
// (swi, swd); y: (B, S, D) contiguous, x's dtype. Returns 0 on success, a
// cudaError_t from the launch, or -1 for arguments the kernel does not take
// (the Python wrapper checks these first).
extern "C" int conv1d_causal(const void* x, const void* w, void* y,
                             int x_bf16, int w_bf16, int B, int S, int D,
                             int W, long long sxb, long long sxs,
                             long long sxd, long long swi, long long swd,
                             void* stream) {
  if (B < 1 || B > 65535 || S < 1 || D < 1 || W < 1 || W > kMaxWidth ||
      sxb < 0 || sxs < 0 || sxd < 0 || swi < 0 || swd < 0)
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16) {
    return w_bf16 ? dispatch_width<bf16, bf16>(W, x, w, y, B, S, D, sxb, sxs, sxd, swi, swd, s)
                  : dispatch_width<bf16, float>(W, x, w, y, B, S, D, sxb, sxs, sxd, swi, swd, s);
  }
  return w_bf16 ? dispatch_width<float, bf16>(W, x, w, y, B, S, D, sxb, sxs, sxd, swi, swd, s)
                : dispatch_width<float, float>(W, x, w, y, B, S, D, sxb, sxs, sxd, swi, swd, s);
}

extern "C" const char* conv1d_causal_error_string(int code) {
  if (code == -1) return "argument the conv1d kernel does not take";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

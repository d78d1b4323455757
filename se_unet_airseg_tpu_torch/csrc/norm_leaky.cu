// InstanceNorm + LeakyReLU(0.01) over (B, S, C) and its backward, for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of se_unet_airseg_tpu/ops/pallas_norm.py:
//   forward  instance_norm_leaky (_forward, _fwd_kernel):
//     per (b, c) over the S rows, in f32: mean = s1 / S,
//     var = s2 / S - mean^2 (not clamped), rstd = rsqrt(var + 1e-5),
//     y = LeakyReLU((x - mean) * rstd) with the f32 slope 0.01, rounded once
//     to x's type; rstd (B, C) f32 is kept for the backward;
//   backward (_bwd_rule, _bwd_kernel), from the saved rounded y and rstd:
//     xhat = y >= 0 ? y : y / 0.01, g' = y >= 0 ? g : 0.01 g,
//     dx = rstd * (g' - mean(g') - xhat * mean(g' xhat)), rounded once to g's
//     type.
// The TPU kernels ran a (batch, phase, chunk) grid in order, carrying the
// sums in VMEM from the statistics phase to the apply phase. Here each is
// two launches over the same grid of blocks, (row chunks, 32-channel
// tiles, batch): the first reduces its chunk in registers and shared memory
// and adds one atomicAdd per (batch, channel) into the f32 sums, which the
// caller zeroes; the second computes the per-channel constants once per
// thread and streams its chunk. The sums' order differs from the TPU's.
//
// Bound: device memory. Per element the forward reads x and writes y, the
// backward reads g and y and writes dx, at a few f32 operations each; the
// statistics pass reads the input once more. A warp reads 32 neighbouring
// channels of one row, so every load and store is coalesced (64 bytes per
// warp in bf16, 128 in f32); wider per-thread vectors are later work. The
// kernels allocate nothing, launch on the caller's stream and report launch
// errors through cudaGetLastError(). Offsets are 64-bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCols = 32;  // channels per block, one per lane
constexpr int kRows = 8;   // rows in flight per block, one per warp
constexpr int kTargetBlocks = 2048;
constexpr float kEps = 1e-5f;
constexpr float kSlope = 0.01f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// the backward's masked cotangent g' and xhat from g and the saved y
__device__ __forceinline__ void bwd_terms(float g, float y, float& gy, float& xhat) {
  const bool pos = y >= 0.f;
  gy = pos ? g : __fmul_rn(g, kSlope);
  xhat = pos ? y : __fdiv_rn(y, kSlope);
}

struct Grid {
  int64_t s;      // rows per batch entry
  int c;          // channels
  int64_t chunk;  // rows per block
};

// Sums over a block's rows of channel blockIdx.y * kCols + lane, batch
// blockIdx.z: forward x and x^2 (a = x), backward g' and g' xhat (a = g,
// yv = y); one atomicAdd each into sums[0] and sums[1], (B, C) each.
template <typename T, bool kBwd>
__global__ void __launch_bounds__(kCols * kRows) sums_kernel(
    const T* __restrict__ a, const T* __restrict__ yv, float* __restrict__ sums, const Grid gr) {
  __shared__ float red[kRows][kCols][2];
  const int lane = threadIdx.x, row = threadIdx.y;
  const int ch = blockIdx.y * kCols + lane;
  const int64_t b = blockIdx.z;
  const int64_t r0 = blockIdx.x * gr.chunk;
  const int64_t r1 = r0 + gr.chunk < gr.s ? r0 + gr.chunk : gr.s;
  float u = 0.f, w = 0.f;
  if (ch < gr.c) {
    const int64_t base = b * gr.s * gr.c + ch;
    for (int64_t r = r0 + row; r < r1; r += kRows) {
      const int64_t i = base + r * gr.c;
      if (kBwd) {
        float gy, xhat;
        bwd_terms(to_f32(a[i]), to_f32(yv[i]), gy, xhat);
        u += gy;
        w += gy * xhat;
      } else {
        const float v = to_f32(a[i]);
        u += v;
        w += v * v;
      }
    }
  }
  red[row][lane][0] = u;
  red[row][lane][1] = w;
  __syncthreads();
  if (row != 0 || ch >= gr.c) return;
#pragma unroll
  for (int k = 1; k < kRows; ++k) {
    u += red[k][lane][0];
    w += red[k][lane][1];
  }
  const int64_t bc = b * gr.c + ch;
  const int64_t bcs = static_cast<int64_t>(gridDim.z) * gr.c;
  atomicAdd(sums + bc, u);
  atomicAdd(sums + bcs + bc, w);
}

// Forward apply: y from x and the sums; the row-0 block of each channel
// tile writes rstd.
template <typename T>
__global__ void __launch_bounds__(kCols * kRows) fwd_apply_kernel(
    const T* __restrict__ x, T* __restrict__ y, const float* __restrict__ sums,
    float* __restrict__ rstd_out, const Grid gr) {
  const int lane = threadIdx.x, row = threadIdx.y;
  const int ch = blockIdx.y * kCols + lane;
  if (ch >= gr.c) return;
  const int64_t b = blockIdx.z;
  const int64_t bc = b * gr.c + ch;
  const float ns = static_cast<float>(gr.s);
  const float mean = __fdiv_rn(sums[bc], ns);
  const float var = __fsub_rn(__fdiv_rn(sums[static_cast<int64_t>(gridDim.z) * gr.c + bc], ns),
                              __fmul_rn(mean, mean));
  const float rstd = rsqrtf(__fadd_rn(var, kEps));
  if (blockIdx.x == 0 && row == 0) rstd_out[bc] = rstd;
  const int64_t r0 = blockIdx.x * gr.chunk;
  const int64_t r1 = r0 + gr.chunk < gr.s ? r0 + gr.chunk : gr.s;
  const int64_t base = b * gr.s * gr.c + ch;
  for (int64_t r = r0 + row; r < r1; r += kRows) {
    const int64_t i = base + r * gr.c;
    const float v = __fmul_rn(__fsub_rn(to_f32(x[i]), mean), rstd);
    y[i] = from_f32<T>(v >= 0.f ? v : __fmul_rn(v, kSlope));
  }
}

// Backward apply: dx from g, y, rstd and the sums of g' and g' xhat.
template <typename T>
__global__ void __launch_bounds__(kCols * kRows) bwd_apply_kernel(
    const T* __restrict__ g, const T* __restrict__ y, const float* __restrict__ rstd_in,
    const float* __restrict__ sums, T* __restrict__ dx, const Grid gr) {
  const int lane = threadIdx.x, row = threadIdx.y;
  const int ch = blockIdx.y * kCols + lane;
  if (ch >= gr.c) return;
  const int64_t b = blockIdx.z;
  const int64_t bc = b * gr.c + ch;
  const float ns = static_cast<float>(gr.s);
  const float m1 = __fdiv_rn(sums[bc], ns);
  const float m2 = __fdiv_rn(sums[static_cast<int64_t>(gridDim.z) * gr.c + bc], ns);
  const float rstd = rstd_in[bc];
  const int64_t r0 = blockIdx.x * gr.chunk;
  const int64_t r1 = r0 + gr.chunk < gr.s ? r0 + gr.chunk : gr.s;
  const int64_t base = b * gr.s * gr.c + ch;
  for (int64_t r = r0 + row; r < r1; r += kRows) {
    const int64_t i = base + r * gr.c;
    float gy, xhat;
    bwd_terms(to_f32(g[i]), to_f32(y[i]), gy, xhat);
    const float d = __fsub_rn(__fsub_rn(gy, m1), __fmul_rn(xhat, m2));
    dx[i] = from_f32<T>(__fmul_rn(rstd, d));
  }
}

// The launch grid: enough row chunks for about kTargetBlocks blocks.
bool plan(long long batch, long long s, int c, Grid& gr, dim3& grid) {
  if (batch <= 0 || s <= 0 || c <= 0 || batch > 65535) return false;
  const int64_t ctiles = (c + kCols - 1) / kCols;
  if (ctiles > 65535) return false;
  int64_t chunks = (kTargetBlocks + batch * ctiles - 1) / (batch * ctiles);
  const int64_t most = (s + kRows - 1) / kRows;
  if (chunks > most) chunks = most;
  if (chunks < 1) chunks = 1;
  gr = Grid{s, c, (s + chunks - 1) / chunks};
  grid = dim3(static_cast<unsigned>((s + gr.chunk - 1) / gr.chunk),
              static_cast<unsigned>(ctiles), static_cast<unsigned>(batch));
  return grid.x <= 0x7fffffffu;
}

template <typename T>
int fwd(const void* x, void* y, float* sums, float* rstd, long long batch, long long s, int c,
        cudaStream_t stream) {
  Grid gr;
  dim3 grid;
  if (!plan(batch, s, c, gr, grid)) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 block(kCols, kRows);
  const T* xt = static_cast<const T*>(x);
  sums_kernel<T, false><<<grid, block, 0, stream>>>(xt, nullptr, sums, gr);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  fwd_apply_kernel<T><<<grid, block, 0, stream>>>(xt, static_cast<T*>(y), sums, rstd, gr);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int bwd(const void* g, const void* y, const float* rstd, void* dx, float* sums, long long batch,
        long long s, int c, cudaStream_t stream) {
  Grid gr;
  dim3 grid;
  if (!plan(batch, s, c, gr, grid)) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 block(kCols, kRows);
  const T* gt = static_cast<const T*>(g);
  const T* yt = static_cast<const T*>(y);
  sums_kernel<T, true><<<grid, block, 0, stream>>>(gt, yt, sums, gr);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  bwd_apply_kernel<T><<<grid, block, 0, stream>>>(gt, yt, rstd, sums, static_cast<T*>(dx), gr);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t value.
// x, y (B, S, C) contiguous; sums (2, B, C) f32 zeroed by the caller;
// rstd (B, C) f32 out.
extern "C" int airseg_norm_leaky_fwd(int dtype, const void* x, void* y, float* sums, float* rstd,
                                     long long batch, long long s, int c, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return fwd<float>(x, y, sums, rstd, batch, s, c, st);
  if (dtype == 1) return fwd<__nv_bfloat16>(x, y, sums, rstd, batch, s, c, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// g, y, dx (B, S, C) contiguous, one type; rstd (B, C) f32 from the
// forward; sums (2, B, C) f32 zeroed by the caller.
extern "C" int airseg_norm_leaky_bwd(int dtype, const void* g, const void* y, const float* rstd,
                                     void* dx, float* sums, long long batch, long long s, int c,
                                     void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return bwd<float>(g, y, rstd, dx, sums, batch, s, c, st);
  if (dtype == 1) return bwd<__nv_bfloat16>(g, y, rstd, dx, sums, batch, s, c, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

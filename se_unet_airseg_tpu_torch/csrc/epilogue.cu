// Fused conv epilogue of the s2d SE-UNet blocks, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of se_unet_airseg_tpu/ops/pallas_s2d.py:
//   gathered epilogue: gated_norm_finalize_bm (_gathered_kernel_bm) and
//                      gated_norm_finalize (_gathered_kernel);
//   phased epilogue:   phased_finalize_bm (_pfin_kernel_bm) and
//                      phased_finalize (_epilogue_kernel).
// The TPU's batch-minor / batch-major split was a tiling artifact; one
// kernel per computation serves both here.
//
// Per 8C-lane voxel row of an s2d tensor (8 sub-positions x C channels):
//   e = dtype(LeakyReLU_0.01(f32(y) * scale8 - shift8))
//   for each SE gate g and sub-position p:
//     logit = sum_c f32(e[pC + c]) * f32(w[g, c])            (f32)
//     gate  = dtype(sigmoid(logit))
//     e[pC:(p+1)C] = dtype(e * gate)
// These are the TPU kernel's rounding points, so bf16 results agree with
// the plain PyTorch version to about one ulp (the logit sums in another
// order). The products are written __fmul_rn/__fsub_rn so nvcc does not
// contract them into an FMA the plain version does not have.
//
// The phased form reads the conv's UNGATHERED (n+1)^3 output: sub-position
// q = (a, b, c) of output voxel (z, y, x) comes from y_ext[z+a, y+b, x+c]
// in lane block q. The gathered tensor never reaches device memory.
//
// Bound: device memory. Each kernel reads y (or y_ext) once and writes
// the output once; the arithmetic is a few flops per byte, far below the
// H100's ~295 bf16 flops/byte ridge. Design: a group of C8/V threads per
// voxel row (V = 16 bytes of elements), each thread one 16-byte vector
// load and store; the C/V threads of one sub-position reduce the gate
// logit with warp shuffles. Offsets are 64-bit (dc5's y_ext at batch 8
// holds 5.6e8 elements). The kernels allocate nothing, launch on the
// caller's stream and report launch errors through cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <typename T> struct VecWidth;
template <> struct VecWidth<float> { static constexpr int N = 4; };
template <> struct VecWidth<__nv_bfloat16> { static constexpr int N = 8; };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// round a float to T and back: the rounding points of the TPU kernel
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f32(from_f32<T>(v));
}

template <typename T, bool kPhased>
__global__ void __launch_bounds__(kThreads) epilogue_kernel(
    const T* __restrict__ y, int64_t sb, int64_t sz, int64_t sy, int64_t sx,
    T* __restrict__ out, const float* __restrict__ scale8,
    const float* __restrict__ shift8, const T* __restrict__ wse, int n_gates,
    int64_t n_rows, int n, int c8, int log2_row, int log2_tpp) {
  constexpr int V = VecWidth<T>::N;
  const int c = c8 >> 3;
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t row = t >> log2_row;
  const int j = static_cast<int>(t & ((1 << log2_row) - 1));
  const bool valid = row < n_rows;
  const int64_t r = valid ? row : 0;
  const int p = j >> log2_tpp;                // sub-position (phase)
  const int k = j & ((1 << log2_tpp) - 1);    // vector within the phase
  const int col = p * c + k * V;              // first lane of this thread

  const int64_t n3 = static_cast<int64_t>(n) * n * n;
  const int64_t b = r / n3;
  const T* src;
  if (kPhased) {
    int64_t rem = r - b * n3;
    const int64_t z = rem / (static_cast<int64_t>(n) * n);
    rem -= z * n * n;
    const int64_t yy = rem / n;
    const int64_t x = rem - yy * n;
    const int a = (p >> 2) & 1, bq = (p >> 1) & 1, cq = p & 1;
    src = y + b * sb + (z + a) * sz + (yy + bq) * sy + (x + cq) * sx + col;
  } else {
    src = y + r * c8 + col;
  }

  uint4 raw = make_uint4(0u, 0u, 0u, 0u);
  if (valid) raw = *reinterpret_cast<const uint4*>(src);
  const T* rv = reinterpret_cast<const T*>(&raw);
  const float* sc = scale8 + b * c8 + col;
  const float* sh = shift8 + b * c8 + col;

  float e[V];
#pragma unroll
  for (int v = 0; v < V; ++v) {
    float u = __fsub_rn(__fmul_rn(to_f32(rv[v]), sc[v]), sh[v]);
    u = u >= 0.f ? u : __fmul_rn(0.01f, u);
    e[v] = round_to<T>(u);
  }

  for (int g = 0; g < n_gates; ++g) {
    const T* wg = wse + g * c + k * V;
    float part = 0.f;
#pragma unroll
    for (int v = 0; v < V; ++v) part = __fadd_rn(part, __fmul_rn(e[v], to_f32(wg[v])));
    // every lane of the warp takes part (invalid rows compute on zeros)
    for (int off = (1 << log2_tpp) >> 1; off > 0; off >>= 1)
      part += __shfl_xor_sync(0xffffffffu, part, off);
    const float gate = round_to<T>(1.f / (1.f + expf(-part)));
#pragma unroll
    for (int v = 0; v < V; ++v) e[v] = round_to<T>(__fmul_rn(e[v], gate));
  }

  if (valid) {
    uint4 packed;
    T* pv = reinterpret_cast<T*>(&packed);
#pragma unroll
    for (int v = 0; v < V; ++v) pv[v] = from_f32<T>(e[v]);
    *reinterpret_cast<uint4*>(out + r * c8 + col) = packed;
  }
}

int ilog2_exact(int64_t v) {
  if (v <= 0 || (v & (v - 1))) return -1;
  int l = 0;
  while ((int64_t{1} << l) < v) ++l;
  return l;
}

template <typename T, bool kPhased>
int launch(const void* y, int64_t sb, int64_t sz, int64_t sy, int64_t sx,
           void* out, const float* scale8, const float* shift8, const void* wse,
           int n_gates, int64_t batch, int n, int c8, cudaStream_t stream) {
  constexpr int V = VecWidth<T>::N;
  const int log2_row = ilog2_exact(c8 / V);
  const int log2_tpp = ilog2_exact(c8 / 8 / V);
  if (c8 % (8 * V) || log2_row < 0 || log2_tpp < 0 || (c8 / V) > kThreads ||
      (c8 / 8 / V) > 32 || n_gates < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t n_rows = batch * n * n * static_cast<int64_t>(n);
  const int64_t threads = n_rows << log2_row;
  const int64_t blocks = (threads + kThreads - 1) / kThreads;
  if (blocks == 0) return 0;
  epilogue_kernel<T, kPhased><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const T*>(y), sb, sz, sy, sx, static_cast<T*>(out), scale8, shift8,
      static_cast<const T*>(wse), n_gates, n_rows, n, c8, log2_row, log2_tpp);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t value.
extern "C" int airseg_gathered_epilogue(int dtype, const void* y, void* out,
                                        const float* scale8, const float* shift8,
                                        const void* wse, int n_gates, long long batch,
                                        int n, int c8, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float, false>(y, 0, 0, 0, 0, out, scale8, shift8, wse, n_gates, batch, n, c8, s);
  if (dtype == 1)
    return launch<__nv_bfloat16, false>(y, 0, 0, 0, 0, out, scale8, shift8, wse, n_gates,
                                        batch, n, c8, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// y_ext is (B, n+1, n+1, xw, 8C) with element strides sb, sz, sy, sx.
extern "C" int airseg_phased_epilogue(int dtype, const void* y_ext, long long sb,
                                      long long sz, long long sy, long long sx, void* out,
                                      const float* scale8, const float* shift8,
                                      const void* wse, int n_gates, long long batch,
                                      int n, int c8, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float, true>(y_ext, sb, sz, sy, sx, out, scale8, shift8, wse, n_gates,
                               batch, n, c8, s);
  if (dtype == 1)
    return launch<__nv_bfloat16, true>(y_ext, sb, sz, sy, sx, out, scale8, shift8, wse,
                                       n_gates, batch, n, c8, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

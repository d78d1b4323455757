// Backward of the s2d 2x2x2 max pool, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel se_unet_airseg_tpu/ops/pallas_s2d.py:
//   max_pool_s2d_bwd_mask (_pool_mask_kernel).
// The pool reads x (B, n, n, n, 8C), sub-position major (lane p*C + c), and
// keeps the maximum over the 8 sub-positions p of each (voxel, channel).
// Per (voxel, channel), in f32 (exact for bf16 inputs, as on the TPU):
//   m   = max_p x[p]
//   cnt = #{p : x[p] == m}                      (the tied maxima)
//   mask form  (g == NULL): out[p] = x[p] == m ? dtype(1 / cnt) : 0
//                           (the Pallas kernel's output)
//   fused form (g != NULL): out[p] = x[p] == m ? dtype(f32(g) / cnt) : 0
//                           (dx itself; the division is the one of the JAX
//                           package's default backward, s2d.py:272-273)
// so the cotangent splits evenly among tied maxima.
//
// Bound: device memory. The fused form reads x (8C lanes) and g (C lanes) once
// and writes dx (8C lanes) once, 2.125 elements moved per output element, with
// a few compares per element of arithmetic. Design: one
// thread per (voxel, V-channel vector): it loads the 8 sub-position vectors of
// its channels (16 bytes each where C allows, else one element), reduces them
// in registers and stores the 8 output vectors. Neighbouring threads read
// neighbouring channel vectors of one sub-position, so every load and store is
// coalesced; x is read exactly once. Any C works (the image's C = 2 takes the
// one-element path). The kernel allocates nothing, launches on the caller's
// stream and reports launch errors through cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// V elements moved as one aligned load or store
template <typename T, int V> struct alignas(sizeof(T) * V) Pack { T v[V]; };

template <typename T, int V>
__global__ void __launch_bounds__(kThreads) pool_bwd_kernel(
    const T* __restrict__ x, const T* __restrict__ g, T* __restrict__ out,
    int64_t n_items, int c) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= n_items) return;
  const int cv = c / V;
  const int64_t row = t / cv;
  const int col = static_cast<int>(t - row * cv) * V;
  const int64_t base = row * 8 * c + col;

  float xv[8][V];
#pragma unroll
  for (int p = 0; p < 8; ++p) {
    const Pack<T, V> pk = *reinterpret_cast<const Pack<T, V>*>(x + base + p * c);
#pragma unroll
    for (int v = 0; v < V; ++v) xv[p][v] = to_f32(pk.v[v]);
  }
  float val[V];
  Pack<T, V> gp;
  if (g != nullptr) gp = *reinterpret_cast<const Pack<T, V>*>(g + row * c + col);
  float m[V];
#pragma unroll
  for (int v = 0; v < V; ++v) {
    m[v] = xv[0][v];
#pragma unroll
    for (int p = 1; p < 8; ++p) m[v] = fmaxf(m[v], xv[p][v]);
    float cnt = 0.f;
#pragma unroll
    for (int p = 0; p < 8; ++p) cnt += xv[p][v] == m[v] ? 1.f : 0.f;
    val[v] = __fdiv_rn(g != nullptr ? to_f32(gp.v[v]) : 1.f, cnt);
  }
#pragma unroll
  for (int p = 0; p < 8; ++p) {
    Pack<T, V> o;
#pragma unroll
    for (int v = 0; v < V; ++v) o.v[v] = from_f32<T>(xv[p][v] == m[v] ? val[v] : 0.f);
    *reinterpret_cast<Pack<T, V>*>(out + base + p * c) = o;
  }
}

template <typename T, int V>
int launch(const void* x, const void* g, void* out, int64_t rows, int c,
           cudaStream_t stream) {
  if (c <= 0 || c % V) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t n_items = rows * (c / V);
  const int64_t blocks = (n_items + kThreads - 1) / kThreads;
  if (blocks == 0) return 0;
  pool_bwd_kernel<T, V><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), static_cast<T*>(out), n_items, c);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. x (rows, 8C) and out contiguous, g (rows, C)
// contiguous or NULL (mask form). vec: 1, or 16 bytes of elements (4 float32,
// 8 bfloat16) when C is a multiple of it and every pointer is 16-byte aligned.
// Returns a cudaError_t value.
extern "C" int airseg_max_pool_s2d_bwd(int dtype, const void* x, const void* g, void* out,
                                       long long rows, int c, int vec, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && vec == 4) return launch<float, 4>(x, g, out, rows, c, s);
  if (dtype == 0 && vec == 1) return launch<float, 1>(x, g, out, rows, c, s);
  if (dtype == 1 && vec == 8) return launch<__nv_bfloat16, 8>(x, g, out, rows, c, s);
  if (dtype == 1 && vec == 1) return launch<__nv_bfloat16, 1>(x, g, out, rows, c, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

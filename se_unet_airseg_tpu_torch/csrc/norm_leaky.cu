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
// two launches over the same grid of blocks: the first reduces its rows in
// registers and shared memory and adds one atomicAdd per (block, batch,
// channel) into the f32 sums, which the caller zeroes; the second computes
// the per-channel constants once per thread and streams its rows. The sums'
// order differs from the TPU's.
//
// Bound: device memory. Per element the forward reads x and writes y, the
// backward reads g and y and writes dx, at a few f32 operations each; the
// statistics pass reads the input once more. Neither (B, S, C) tensor fits
// in the 50 MB L2 at the shapes that matter, so two passes read g and y
// twice: 5/3 of the bound's bytes is the backward's floor.
//   * Forward (rows of 32 channels, one per lane, a block of 8 warps over a
//     (row chunk, 32-channel tile, batch) grid of about 2048 blocks): a warp
//     moves 64 bytes per load in bf16, 128 in f32.
//   * Backward: a thread owns V neighbouring channels, one 16-byte vector
//     (V = 8 in bf16, 4 in f32); a block of 256 threads covers
//     min(C/V, 256) vectors of a row and 256 / that many rows per pass, so
//     at C = 32 a warp covers 8 rows and at C = 256 one. The grid is one
//     wave (resident blocks per SM x SMs); each block takes a contiguous
//     row range of one batch entry. Where a block row covers whole rows,
//     that range of g and of y is one contiguous span each: thread 0 copies
//     it in 16 KB stages with cp.async.bulk into a 3-deep mbarrier ring and
//     the threads read their vectors from shared memory, so the bytes in
//     flight do not depend on registers (the register form, kUnroll rows of
//     g and y in flight per thread, held the block to 2 per SM at 102-124
//     registers and left compute and memory unoverlapped). Wider rows take
//     the register form; where C % V != 0 or a base is not 16-byte
//     aligned, the register form with V = 1. All three are chosen by shape
//     before the launch. xhat's y / 0.01 is a reciprocal product corrected
//     once by an FMA, correctly rounded like the IEEE division it replaces
//     (`div_slope`).
// The kernels allocate nothing, launch on the caller's stream and report
// launch errors through cudaGetLastError(). Offsets are 64-bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

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

constexpr float kInvSlope = 1.0f / kSlope;  // RN(1 / 0.01)

// y / 0.01 correctly rounded, as __fdiv_rn gives it: q = RN(y * RN(1/0.01)),
// then one correction by the exact remainder y - q * 0.01 (an FMA), which
// rounds correctly wherever nothing overflows or underflows (Markstein);
// outside 2^-100 <= |y| < 2^100 the IEEE division itself. About 3
// instructions instead of about 12. (ops/norm_leaky.py's
// `div_slope_plain` is the same rule, held to IEEE division on the CPU.)
__device__ __forceinline__ float div_slope(float y) {
  const float a = fabsf(y);
  if (a >= 0x1p-100f && a < 0x1p100f) {
    const float q = __fmul_rn(y, kInvSlope);
    return __fmaf_rn(__fmaf_rn(-q, kSlope, y), kInvSlope, q);
  }
  return __fdiv_rn(y, kSlope);
}

// the backward's masked cotangent g' and xhat from g and the saved y
__device__ __forceinline__ void bwd_terms(float g, float y, float& gy, float& xhat) {
  const bool pos = y >= 0.f;
  gy = pos ? g : __fmul_rn(g, kSlope);
  xhat = pos ? y : div_slope(y);
}

struct Grid {
  int64_t s;      // rows per batch entry
  int c;          // channels
  int64_t chunk;  // rows per block
};

// Forward sums over a block's rows of channel blockIdx.y * kCols + lane,
// batch blockIdx.z: x and x^2; one atomicAdd each into sums[0] and
// sums[1], (B, C) each.
template <typename T>
__global__ void __launch_bounds__(kCols * kRows) sums_kernel(
    const T* __restrict__ a, float* __restrict__ sums, const Grid gr) {
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
      const float v = to_f32(a[base + r * gr.c]);
      u += v;
      w += v * v;
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
  sums_kernel<T><<<grid, block, 0, stream>>>(xt, sums, gr);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  fwd_apply_kernel<T><<<grid, block, 0, stream>>>(xt, static_cast<T*>(y), sums, rstd, gr);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------------------- backward

constexpr int kVThreads = 256;
constexpr int kUnroll = 4;  // rows of g and y in flight per thread

// V elements of one thread: one 16-byte load or store where V fills 16
// bytes, else element by element.
template <typename T, int V>
struct alignas(V * sizeof(T)) Pack {
  T v[V];
};

template <typename T, int V>
__device__ __forceinline__ Pack<T, V> load_pack(const T* p) {
  Pack<T, V> r;
  if constexpr (V * sizeof(T) == 16) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
    r = *reinterpret_cast<const Pack<T, V>*>(&u);
  } else {
#pragma unroll
    for (int v = 0; v < V; ++v) r.v[v] = p[v];
  }
  return r;
}

template <typename T, int V>
__device__ __forceinline__ void store_pack(T* p, const Pack<T, V>& r) {
  if constexpr (V * sizeof(T) == 16) {
    *reinterpret_cast<uint4*>(p) = *reinterpret_cast<const uint4*>(&r);
  } else {
#pragma unroll
    for (int v = 0; v < V; ++v) p[v] = r.v[v];
  }
}

// The backward's partition of (B, S, C) (ops/norm_leaky.py's
// `bwd_partition_plain` states it for the CPU tests).
struct VGrid {
  int64_t s;      // rows per batch entry
  int c;          // channels
  int cv;         // channel vectors per row, C / V
  int width;      // vectors per block row, min(cv, kVThreads)
  int pass;       // rows per pass of a block, kVThreads / width
  int64_t chunk;  // rows per block
};

// The thread's place: its vector of the row and its row slot, and its rows
// [r0, r1) of batch entry blockIdx.z, taken r0 + slot + k * pass.
struct VLane {
  int cvi, slot;
  bool live;
  int64_t r0, r1, rows;  // rows: how many of [r0, r1) are the thread's
};

__device__ __forceinline__ VLane vlane(const VGrid& gr) {
  VLane l;
  const int col = threadIdx.x % gr.width;
  l.slot = threadIdx.x / gr.width;
  l.cvi = blockIdx.y * gr.width + col;
  l.live = l.slot < gr.pass && l.cvi < gr.cv;
  l.r0 = blockIdx.x * gr.chunk;
  l.r1 = l.r0 + gr.chunk < gr.s ? l.r0 + gr.chunk : gr.s;
  l.rows = l.r1 - l.r0 > l.slot ? (l.r1 - l.r0 - l.slot + gr.pass - 1) / gr.pass : 0;
  return l;
}

// Pass 1: per (block, batch, channel) the sums of g' and g' xhat, one
// atomicAdd each into sums[0] and sums[1], (B, C) each.
template <typename T, int V>
__global__ void __launch_bounds__(kVThreads) bwd_sums_kernel(
    const T* __restrict__ g, const T* __restrict__ y, float* __restrict__ sums, const VGrid gr) {
  __shared__ float red[2][kVThreads * V];
  const VLane l = vlane(gr);
  float u[V], w[V];
#pragma unroll
  for (int v = 0; v < V; ++v) u[v] = w[v] = 0.f;
  if (l.live) {
    const int64_t base = static_cast<int64_t>(blockIdx.z) * gr.s * gr.c +
                         (l.r0 + l.slot) * gr.c + static_cast<int64_t>(l.cvi) * V;
    const int64_t step = static_cast<int64_t>(gr.pass) * gr.c;
    for (int64_t k0 = 0; k0 < l.rows; k0 += kUnroll) {
      Pack<T, V> pg[kUnroll], py[kUnroll];
#pragma unroll
      for (int q = 0; q < kUnroll; ++q) {
        if (k0 + q < l.rows) {
          const int64_t i = base + (k0 + q) * step;
          pg[q] = load_pack<T, V>(g + i);
          py[q] = load_pack<T, V>(y + i);
        } else {
#pragma unroll
          for (int v = 0; v < V; ++v) pg[q].v[v] = py[q].v[v] = from_f32<T>(0.f);
        }
      }
#pragma unroll
      for (int q = 0; q < kUnroll; ++q)
#pragma unroll
        for (int v = 0; v < V; ++v) {
          float gy, xhat;
          bwd_terms(to_f32(pg[q].v[v]), to_f32(py[q].v[v]), gy, xhat);
          u[v] += gy;
          w[v] += gy * xhat;
        }
    }
  }
  // thread t = slot * width + col holds channels col * V + v: index t * V + v
  // = slot * (width * V) + channel of the block
#pragma unroll
  for (int v = 0; v < V; ++v) {
    red[0][threadIdx.x * V + v] = u[v];
    red[1][threadIdx.x * V + v] = w[v];
  }
  __syncthreads();
  const int nch = gr.width * V;
  for (int ch = threadIdx.x; ch < nch; ch += kVThreads) {
    const int c = blockIdx.y * nch + ch;
    if (c >= gr.c) break;
    float su = 0.f, sw = 0.f;
    for (int k = 0; k < gr.pass; ++k) {
      su += red[0][k * nch + ch];
      sw += red[1][k * nch + ch];
    }
    const int64_t bc = static_cast<int64_t>(blockIdx.z) * gr.c + c;
    atomicAdd(sums + bc, su);
    atomicAdd(sums + static_cast<int64_t>(gridDim.z) * gr.c + bc, sw);
  }
}

// Pass 2: dx from g, y, rstd and the sums.
template <typename T, int V>
__global__ void __launch_bounds__(kVThreads) bwd_apply_kernel(
    const T* __restrict__ g, const T* __restrict__ y, const float* __restrict__ rstd_in,
    const float* __restrict__ sums, T* __restrict__ dx, const VGrid gr) {
  const VLane l = vlane(gr);
  if (!l.live) return;
  const float ns = static_cast<float>(gr.s);
  float m1[V], m2[V], rs[V];
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const int64_t bc = static_cast<int64_t>(blockIdx.z) * gr.c + l.cvi * V + v;
    m1[v] = __fdiv_rn(sums[bc], ns);
    m2[v] = __fdiv_rn(sums[static_cast<int64_t>(gridDim.z) * gr.c + bc], ns);
    rs[v] = rstd_in[bc];
  }
  const int64_t base = static_cast<int64_t>(blockIdx.z) * gr.s * gr.c +
                       (l.r0 + l.slot) * gr.c + static_cast<int64_t>(l.cvi) * V;
  const int64_t step = static_cast<int64_t>(gr.pass) * gr.c;
  for (int64_t k0 = 0; k0 < l.rows; k0 += kUnroll) {
    Pack<T, V> pg[kUnroll], py[kUnroll];
#pragma unroll
    for (int q = 0; q < kUnroll; ++q)
      if (k0 + q < l.rows) {
        const int64_t i = base + (k0 + q) * step;
        pg[q] = load_pack<T, V>(g + i);
        py[q] = load_pack<T, V>(y + i);
      }
#pragma unroll
    for (int q = 0; q < kUnroll; ++q) {
      if (k0 + q >= l.rows) break;
      Pack<T, V> out;
#pragma unroll
      for (int v = 0; v < V; ++v) {
        float gy, xhat;
        bwd_terms(to_f32(pg[q].v[v]), to_f32(py[q].v[v]), gy, xhat);
        const float d = __fsub_rn(__fsub_rn(gy, m1[v]), __fmul_rn(xhat, m2[v]));
        out.v[v] = from_f32<T>(__fmul_rn(rs[v], d));
      }
      store_pack<T, V>(dx + base + (k0 + q) * step, out);
    }
  }
}

// Resident blocks per SM x SMs for `kernel` at `smem` bytes of dynamic
// shared memory (a kernel's only size) on the current device, with the
// kernel's shared memory limit set: asked of the runtime once per (kernel,
// device) and cached, since the queries cost microseconds.
int wave_blocks(const void* kernel, int smem, int& blocks) {
  struct Known { const void* kernel; int dev, blocks; };
  static Known known[32];
  static int n_known = 0;
  static std::mutex mu;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  std::lock_guard<std::mutex> lock(mu);
  for (int i = 0; i < n_known; ++i)
    if (known[i].kernel == kernel && known[i].dev == dev) {
      blocks = known[i].blocks;
      return cudaSuccess;
    }
  int sms = 0, per_sm = 0;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kVThreads, smem);
  if (e != cudaSuccess) return e;
  blocks = (per_sm > 0 ? per_sm : 1) * sms;
  if (n_known < 32) known[n_known++] = Known{kernel, dev, blocks};
  return cudaSuccess;
}

// One wave (`target` blocks) over (row chunks, channel tiles, batch).
template <int V>
int vplan(int64_t target, long long batch, long long s, int c, VGrid& gr, dim3& grid) {
  if (batch <= 0 || s <= 0 || c <= 0 || batch > 65535 || c % V) return cudaErrorInvalidValue;
  gr.s = s;
  gr.c = c;
  gr.cv = c / V;
  gr.width = gr.cv < kVThreads ? gr.cv : kVThreads;
  gr.pass = kVThreads / gr.width;
  const int64_t ctiles = (gr.cv + gr.width - 1) / gr.width;
  if (ctiles > 65535) return cudaErrorInvalidValue;
  int64_t chunks = (target + batch * ctiles - 1) / (batch * ctiles);
  const int64_t most = (s + gr.pass - 1) / gr.pass;
  if (chunks > most) chunks = most;
  if (chunks < 1) chunks = 1;
  gr.chunk = (s + chunks - 1) / chunks;
  grid = dim3(static_cast<unsigned>((s + gr.chunk - 1) / gr.chunk),
              static_cast<unsigned>(ctiles), static_cast<unsigned>(batch));
  return cudaSuccess;
}

// ---------------------------------------------- backward, bulk-copy ring

// 16 bytes of T from V floats, each rounded once (bf16 in pairs).
template <typename T>
__device__ __forceinline__ uint4 pack16(const float (&o)[16 / sizeof(T)]) {
  uint4 r;
  if constexpr (sizeof(T) == 2) {
    __nv_bfloat162 p[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) p[q] = __floats2bfloat162_rn(o[2 * q], o[2 * q + 1]);
    r = *reinterpret_cast<const uint4*>(p);
  } else {
    r = make_uint4(__float_as_uint(o[0]), __float_as_uint(o[1]), __float_as_uint(o[2]),
                   __float_as_uint(o[3]));
  }
  return r;
}

// Where a block row covers whole rows (C / V <= 256 vectors) and the rows
// are 16-byte vectors, a block's rows [r0, r1) of g and of y are each one
// contiguous span: thread 0 copies them in stages of kRingBytes per tensor
// with cp.async.bulk into a kRingStages-deep mbarrier ring, and the threads
// read their vectors from shared memory. The bytes in flight no longer
// depend on registers.
constexpr int kRingStages = 3;
constexpr int kRingBytes = 16384;  // per tensor and stage

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Wait for the phase `parity` of a barrier; traps after about 10 s at the
// H100's clock instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  const long long t0 = clock64();
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (!done && clock64() - t0 > (1ll << 34)) __trap();
  } while (!done);
}

__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      :: "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

// The ring's walk over a block's rows: stage k holds rows
// [r0 + k * rows, r0 + (k + 1) * rows) of g and y (fewer in the last).
struct Ring {
  int64_t r0;
  int64_t n;    // rows of the block
  int rows;     // rows per stage, kRingBytes / (C * elt)
  int stages;   // stages of the block

  __device__ __forceinline__ int64_t first(int k) const {
    return static_cast<int64_t>(k) * rows;
  }
  __device__ __forceinline__ int count(int k) const {
    const int64_t left = n - first(k);
    return left < rows ? static_cast<int>(left) : rows;
  }
};

template <typename T>
__device__ __forceinline__ void fetch_stage(const Ring& ring, int k, const T* g, const T* y,
                                            int c, unsigned char* stage, uint32_t bar) {
  const uint32_t bytes = static_cast<uint32_t>(ring.count(k)) * c * sizeof(T);
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(bar), "r"(2 * bytes) : "memory");
  const int64_t off = (ring.r0 + ring.first(k)) * c;
  bulk_load(stage, g + off, bytes, bar);
  bulk_load(stage + kRingBytes, y + off, bytes, bar);
}

// Pass 1 (kApply false: sums of g' and g' xhat, one atomicAdd per block and
// channel) or pass 2 (kApply true: dx) over the block's rows of batch entry
// blockIdx.z, fed by the ring.
template <typename T, bool kApply>
__global__ void __launch_bounds__(kVThreads) bwd_ring_kernel(
    const T* __restrict__ g, const T* __restrict__ y, const float* __restrict__ rstd_in,
    float* __restrict__ sums, T* __restrict__ dx, const VGrid gr) {
  constexpr int V = 16 / sizeof(T);
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  unsigned char* stages = smem + 128;
  const VLane l = vlane(gr);
  Ring ring;
  ring.r0 = l.r0;
  ring.n = l.r1 - l.r0;
  ring.rows = kRingBytes / (gr.c * static_cast<int>(sizeof(T)));
  ring.stages = static_cast<int>((ring.n + ring.rows - 1) / ring.rows);
  const int64_t bbase = static_cast<int64_t>(blockIdx.z) * gr.s * gr.c;
  const T* gb = g + bbase;
  const T* yb = y + bbase;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kRingStages; ++s)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" :: "r"(smem_u32(full + s)) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    for (int k = 0; k < kRingStages && k < ring.stages; ++k)
      fetch_stage(ring, k, gb, yb, gr.c, stages + 2 * k * kRingBytes, smem_u32(full + k));
  }
  __syncthreads();
  float u[V], w[V], m1[V], m2[V], rs[V];
#pragma unroll
  for (int v = 0; v < V; ++v) u[v] = w[v] = 0.f;
  if (kApply && l.live) {
    const float ns = static_cast<float>(gr.s);
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const int64_t bc = static_cast<int64_t>(blockIdx.z) * gr.c + l.cvi * V + v;
      m1[v] = __fdiv_rn(sums[bc], ns);
      m2[v] = __fdiv_rn(sums[static_cast<int64_t>(gridDim.z) * gr.c + bc], ns);
      rs[v] = rstd_in[bc];
    }
  }
  for (int k = 0; k < ring.stages; ++k) {
    const int s = k % kRingStages;
    unsigned char* stage = stages + 2 * s * kRingBytes;
    mbar_wait(smem_u32(full + s), (k / kRingStages) & 1);
    const int rows = ring.count(k);
    if (l.live) {
      for (int i = l.slot; i < rows; i += gr.pass) {
        const int e = i * gr.c + l.cvi * V;
        const uint4 rg = *reinterpret_cast<const uint4*>(stage + e * sizeof(T));
        const uint4 ry = *reinterpret_cast<const uint4*>(stage + kRingBytes + e * sizeof(T));
        const T* pg = reinterpret_cast<const T*>(&rg);
        const T* py = reinterpret_cast<const T*>(&ry);
        float o[V];
#pragma unroll
        for (int v = 0; v < V; ++v) {
          float gy, xhat;
          bwd_terms(to_f32(pg[v]), to_f32(py[v]), gy, xhat);
          if (kApply) {
            const float d = __fsub_rn(__fsub_rn(gy, m1[v]), __fmul_rn(xhat, m2[v]));
            o[v] = __fmul_rn(rs[v], d);
          } else {
            u[v] += gy;
            w[v] += gy * xhat;
          }
        }
        if (kApply)
          *reinterpret_cast<uint4*>(dx + bbase + (ring.r0 + ring.first(k) + i) * gr.c +
                                    l.cvi * V) = pack16<T>(o);
      }
    }
    __syncthreads();  // every thread is done with stage s
    if (threadIdx.x == 0 && k + kRingStages < ring.stages)
      fetch_stage(ring, k + kRingStages, gb, yb, gr.c, stage, smem_u32(full + s));
  }
  if (kApply) return;
  // the drained ring holds the block reduction: thread t's channels at t * V
  float* red = reinterpret_cast<float*>(stages);
#pragma unroll
  for (int v = 0; v < V; ++v) {
    red[threadIdx.x * V + v] = u[v];
    red[kVThreads * V + threadIdx.x * V + v] = w[v];
  }
  __syncthreads();
  const int nch = gr.width * V;
  for (int ch = threadIdx.x; ch < nch; ch += kVThreads) {
    float su = 0.f, sw = 0.f;
    for (int k = 0; k < gr.pass; ++k) {
      su += red[k * nch + ch];
      sw += red[kVThreads * V + k * nch + ch];
    }
    const int64_t bc = static_cast<int64_t>(blockIdx.z) * gr.c + ch;
    atomicAdd(sums + bc, su);
    atomicAdd(sums + static_cast<int64_t>(gridDim.z) * gr.c + bc, sw);
  }
}

constexpr int kRingSmem = 128 + kRingStages * 2 * kRingBytes;

template <typename T, int V>
int bwd_v(const T* g, const T* y, const float* rstd, T* dx, float* sums, long long batch,
          long long s, int c, cudaStream_t stream) {
  VGrid gr;
  dim3 grid;
  const bool ring = V * sizeof(T) == 16 && c / V <= kVThreads;
  int blocks = 0, unused = 0;
  int rc = ring ? wave_blocks(reinterpret_cast<const void*>(bwd_ring_kernel<T, false>),
                              kRingSmem, blocks)
                : wave_blocks(reinterpret_cast<const void*>(bwd_sums_kernel<T, V>), 0, blocks);
  if (rc == cudaSuccess && ring)  // sets the apply kernel's shared memory limit
    rc = wave_blocks(reinterpret_cast<const void*>(bwd_ring_kernel<T, true>), kRingSmem, unused);
  if (rc == cudaSuccess) rc = vplan<V>(blocks, batch, s, c, gr, grid);
  if (rc != cudaSuccess) return rc;
  if (ring)
    bwd_ring_kernel<T, false><<<grid, kVThreads, kRingSmem, stream>>>(g, y, rstd, sums, dx, gr);
  else
    bwd_sums_kernel<T, V><<<grid, kVThreads, 0, stream>>>(g, y, sums, gr);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  if (ring)
    bwd_ring_kernel<T, true><<<grid, kVThreads, kRingSmem, stream>>>(g, y, rstd, sums, dx, gr);
  else
    bwd_apply_kernel<T, V><<<grid, kVThreads, 0, stream>>>(g, y, rstd, sums, dx, gr);
  return static_cast<int>(cudaGetLastError());
}

// 16-byte vectors where C and every base allow them, else one channel per
// thread.
template <typename T>
int bwd(const void* g, const void* y, const float* rstd, void* dx, float* sums, long long batch,
        long long s, int c, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const bool vec = c % V == 0 && (reinterpret_cast<uintptr_t>(g) | reinterpret_cast<uintptr_t>(y) |
                                  reinterpret_cast<uintptr_t>(dx)) % 16 == 0;
  const T* gt = static_cast<const T*>(g);
  const T* yt = static_cast<const T*>(y);
  T* dt = static_cast<T*>(dx);
  if (vec) return bwd_v<T, V>(gt, yt, rstd, dt, sums, batch, s, c, stream);
  return bwd_v<T, 1>(gt, yt, rstd, dt, sums, batch, s, c, stream);
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

// Dynamic shared memory of the backward's bulk-copy ring kernels.
extern "C" int airseg_norm_leaky_bwd_ring_smem() { return kRingSmem; }

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
// sums in VMEM from the statistics phase to the apply phase. Here each
// direction is two passes over one partition of the rows: pass 1 reduces
// a block's rows in registers and shared memory and adds one atomicAdd per
// (block, batch, channel) into the f32 sums, which the caller zeroes; pass 2
// computes the per-channel constants once per thread and streams the rows
// again. The sums' order differs from the TPU's.
//
// Bound: device memory. Per element the forward reads x and writes y, the
// backward reads g and y and writes dx, at a few f32 operations each. Pass
// 1 reads the inputs once more, and neither (B, S, C) tensor fits in the
// 50 MB L2 at the shapes that matter: the two-pass floor is 3/2 of the
// bound's bytes forward and 5/3 backward. In bf16 at 3.35 TB/s (H100 SXM)
// the forward's bound is 0.080 ms at (1, 64^3, 256) and 0.641 ms at ec3's
// s2d output (8, 64^3 * 8, 32), its two-pass floor 0.120 and 0.962 ms.
//
// One set of kernels serves both directions, templated on the direction
// (`kBwd`: one input x or two, g and y):
//   * A thread owns V neighbouring channels, one 16-byte vector (V = 8 in
//     bf16, 4 in f32); a block of 256 threads covers min(C/V, 256) vectors
//     of a row and 256 / that many rows per pass, so at C = 32 a warp covers
//     8 rows and at C = 256 one. The grid is one wave (resident blocks per
//     SM x SMs); each block takes a contiguous row range of one batch entry.
//   * Ring form: where a block row covers whole rows, the block's range of
//     each input is one contiguous span. Thread 0 copies it in 16 KB stages
//     per input with cp.async.bulk into a 96 KB mbarrier ring (6 stages of
//     x, or 3 of g and y; two blocks per SM) and the threads read their
//     vectors from shared memory, so the bytes in flight do not depend on
//     registers; pass 2 writes 16-byte packed stores.
//   * Register form: where rows are wider than a block row, kUnroll rows of
//     vectors in flight per thread in registers; where C % V != 0 or a base
//     is not 16-byte aligned, the same with V = 1.
// The form is chosen by shape before the launch. xhat's y / 0.01 is a
// reciprocal product corrected once by an FMA, correctly rounded like the
// IEEE division it replaces (`div_slope`).
// The kernels allocate nothing, launch on the caller's stream and report
// launch errors through cudaGetLastError(). Offsets are 64-bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

namespace {

constexpr float kEps = 1e-5f;
constexpr float kSlope = 0.01f;
constexpr int kVThreads = 256;
constexpr int kUnroll = 4;  // rows of each input in flight per thread, register form

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

// ------------------------------------------------- the two directions

// The tensors of one direction.
template <typename T>
struct Args {
  const T* a;   // x (forward) or g
  const T* b;   // the saved y (backward; unused forward)
  T* out;       // y or dx
  float* rstd;  // (B, C): written by the forward, read by the backward
  float* sums;  // (2, B, C), zeroed by the caller
};

// Pass 1's terms of one element: x and x^2, or g' and g' xhat.
template <bool kBwd>
__device__ __forceinline__ void add_terms(float a, float b, float& u, float& w) {
  if constexpr (kBwd) {
    float gy, xhat;
    bwd_terms(a, b, gy, xhat);
    u += gy;
    w += gy * xhat;
  } else {
    u += a;
    w += a * a;
  }
}

// Pass 2's constants of one channel: mean and rstd, or mean(g'),
// mean(g' xhat) and the saved rstd.
struct Consts {
  float p, q, r;
};

template <bool kBwd>
__device__ __forceinline__ Consts channel_consts(float s1, float s2, float rs, float ns) {
  if constexpr (kBwd) {
    return Consts{__fdiv_rn(s1, ns), __fdiv_rn(s2, ns), rs};
  } else {
    const float mean = __fdiv_rn(s1, ns);
    const float var = __fsub_rn(__fdiv_rn(s2, ns), __fmul_rn(mean, mean));
    return Consts{mean, rsqrtf(__fadd_rn(var, kEps)), 0.f};
  }
}

// Pass 2's output of one element, before its one rounding to T.
template <bool kBwd>
__device__ __forceinline__ float apply(float a, float b, const Consts& k) {
  if constexpr (kBwd) {
    float gy, xhat;
    bwd_terms(a, b, gy, xhat);
    return __fmul_rn(k.r, __fsub_rn(__fsub_rn(gy, k.p), __fmul_rn(xhat, k.q)));
  } else {
    const float v = __fmul_rn(__fsub_rn(a, k.p), k.q);
    return v >= 0.f ? v : __fmul_rn(v, kSlope);
  }
}

// ------------------------------------------------------- the partition

// The partition of (B, S, C) (ops/norm_leaky.py's `partition_plain`
// states it for the CPU tests).
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

// Pass 2's constants of the thread's V channels; in the forward the first
// row block of each (channel tile, batch entry) writes rstd.
template <bool kBwd, int V>
__device__ __forceinline__ void load_consts(Consts (&k)[V], const float* sums, float* rstd,
                                            const VGrid& gr, const VLane& l) {
  const float ns = static_cast<float>(gr.s);
  const int64_t bcs = static_cast<int64_t>(gridDim.z) * gr.c;
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const int64_t bc = static_cast<int64_t>(blockIdx.z) * gr.c + l.cvi * V + v;
    k[v] = channel_consts<kBwd>(sums[bc], sums[bcs + bc], kBwd ? rstd[bc] : 0.f, ns);
    if (!kBwd && blockIdx.x == 0 && l.slot == 0) rstd[bc] = k[v].q;
  }
}

// Pass 1's block reduction: the per-thread sums through `red` (2 *
// kVThreads * V floats of shared memory), then one atomicAdd per channel
// into sums[0] and sums[1]. Thread t = slot * width + col holds channels
// col * V + v at index t * V + v = slot * (width * V) + channel of the block.
template <int V>
__device__ __forceinline__ void block_sums(const float (&u)[V], const float (&w)[V], float* red,
                                           float* sums, const VGrid& gr) {
#pragma unroll
  for (int v = 0; v < V; ++v) {
    red[threadIdx.x * V + v] = u[v];
    red[kVThreads * V + threadIdx.x * V + v] = w[v];
  }
  __syncthreads();
  const int nch = gr.width * V;
  for (int ch = threadIdx.x; ch < nch; ch += kVThreads) {
    const int c = blockIdx.y * nch + ch;
    if (c >= gr.c) break;
    float su = 0.f, sw = 0.f;
    for (int k = 0; k < gr.pass; ++k) {
      su += red[k * nch + ch];
      sw += red[kVThreads * V + k * nch + ch];
    }
    const int64_t bc = static_cast<int64_t>(blockIdx.z) * gr.c + c;
    atomicAdd(sums + bc, su);
    atomicAdd(sums + static_cast<int64_t>(gridDim.z) * gr.c + bc, sw);
  }
}

// ------------------------------------------------------ register form

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

// Pass 1 (kApply false) or pass 2 (kApply true) over the thread's rows,
// kUnroll rows of each input in flight in registers.
template <typename T, int V, bool kBwd, bool kApply>
__global__ void __launch_bounds__(kVThreads) reg_kernel(const Args<T> p, const VGrid gr) {
  __shared__ float red[kApply ? 1 : 2 * kVThreads * V];
  const VLane l = vlane(gr);
  float u[V], w[V];
  Consts k[V];
#pragma unroll
  for (int v = 0; v < V; ++v) u[v] = w[v] = 0.f;
  if (kApply) {
    if (!l.live) return;
    load_consts<kBwd, V>(k, p.sums, p.rstd, gr, l);
  }
  if (l.live) {
    const int64_t base = static_cast<int64_t>(blockIdx.z) * gr.s * gr.c +
                         (l.r0 + l.slot) * gr.c + static_cast<int64_t>(l.cvi) * V;
    const int64_t step = static_cast<int64_t>(gr.pass) * gr.c;
    for (int64_t k0 = 0; k0 < l.rows; k0 += kUnroll) {
      Pack<T, V> pa[kUnroll], pb[kUnroll];
#pragma unroll
      for (int q = 0; q < kUnroll; ++q)
        if (k0 + q < l.rows) {
          pa[q] = load_pack<T, V>(p.a + base + (k0 + q) * step);
          if constexpr (kBwd) pb[q] = load_pack<T, V>(p.b + base + (k0 + q) * step);
        }
#pragma unroll
      for (int q = 0; q < kUnroll; ++q) {
        if (k0 + q >= l.rows) break;
        Pack<T, V> o;
#pragma unroll
        for (int v = 0; v < V; ++v) {
          const float a = to_f32(pa[q].v[v]);
          const float b = kBwd ? to_f32(pb[q].v[v]) : 0.f;
          if (kApply)
            o.v[v] = from_f32<T>(apply<kBwd>(a, b, k[v]));
          else
            add_terms<kBwd>(a, b, u[v], w[v]);
        }
        if (kApply) store_pack<T, V>(p.out + base + (k0 + q) * step, o);
      }
    }
  }
  if constexpr (!kApply) block_sums<V>(u, w, red, p.sums, gr);
}

// ---------------------------------------------------------- ring form

// Where a block row covers whole rows (C / V <= 256 vectors) and the rows
// are 16-byte vectors, a block's rows [r0, r1) of each input are one
// contiguous span: thread 0 copies them in stages of kRingBytes per input
// with cp.async.bulk into an mbarrier ring of kRingSlots x kRingBytes =
// 96 KB: 6 stages of x forward, 3 of g and y backward, two blocks per SM
// either way. (On an H100 80GB HBM3, 6 and 12 forward stages ran the
// docstring shape fastest of 3, 4, 6 and 12, and all four tied at ec3's
// shape; PERF.md has the figures.)
constexpr int kRingBytes = 16384;  // per input and stage
constexpr int kRingSlots = 6;      // stages x inputs

__host__ __device__ constexpr int ring_stages(bool bwd) { return kRingSlots / (bwd ? 2 : 1); }

// Dynamic shared memory of a ring: the stages' barriers, then the stages.
constexpr int kRingSmem = 128 + kRingSlots * kRingBytes;

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
// [r0 + k * rows, r0 + (k + 1) * rows) of each input (fewer in the last).
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

// Stage k of each input (a, and b in the backward) into `stage`.
template <typename T, bool kBwd>
__device__ __forceinline__ void fetch_stage(const Ring& ring, int k, const T* a, const T* b,
                                            int c, unsigned char* stage, uint32_t bar) {
  const uint32_t bytes = static_cast<uint32_t>(ring.count(k)) * c * sizeof(T);
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(bar), "r"((kBwd ? 2 : 1) * bytes) : "memory");
  const int64_t off = (ring.r0 + ring.first(k)) * c;
  bulk_load(stage, a + off, bytes, bar);
  if constexpr (kBwd) bulk_load(stage + kRingBytes, b + off, bytes, bar);
}

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

// The ring form over the block's rows of batch entry blockIdx.z: pass 1
// (kApply false: the sums, one atomicAdd per block and channel) or pass 2
// (kApply true: the outputs).
template <typename T, bool kBwd, bool kApply>
__global__ void __launch_bounds__(kVThreads) ring_kernel(const Args<T> p, const VGrid gr) {
  constexpr int V = 16 / sizeof(T);
  constexpr int kStages = ring_stages(kBwd);
  constexpr int kStage = (kBwd ? 2 : 1) * kRingBytes;
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
  const T* a = p.a + bbase;
  const T* b = kBwd ? p.b + bbase : nullptr;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" :: "r"(smem_u32(full + s)) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    for (int k = 0; k < kStages && k < ring.stages; ++k)
      fetch_stage<T, kBwd>(ring, k, a, b, gr.c, stages + k * kStage, smem_u32(full + k));
  }
  __syncthreads();
  float u[V], w[V];
  Consts kc[V];
#pragma unroll
  for (int v = 0; v < V; ++v) u[v] = w[v] = 0.f;
  if (kApply && l.live) load_consts<kBwd, V>(kc, p.sums, p.rstd, gr, l);
  for (int k = 0; k < ring.stages; ++k) {
    const int s = k % kStages;
    unsigned char* stage = stages + s * kStage;
    mbar_wait(smem_u32(full + s), (k / kStages) & 1);
    const int rows = ring.count(k);
    if (l.live) {
      for (int i = l.slot; i < rows; i += gr.pass) {
        const int e = (i * gr.c + l.cvi * V) * static_cast<int>(sizeof(T));
        const uint4 ra = *reinterpret_cast<const uint4*>(stage + e);
        uint4 rb = ra;
        if constexpr (kBwd) rb = *reinterpret_cast<const uint4*>(stage + kRingBytes + e);
        const T* pa = reinterpret_cast<const T*>(&ra);
        const T* pb = reinterpret_cast<const T*>(&rb);
        float o[V];
#pragma unroll
        for (int v = 0; v < V; ++v) {
          if (kApply)
            o[v] = apply<kBwd>(to_f32(pa[v]), to_f32(pb[v]), kc[v]);
          else
            add_terms<kBwd>(to_f32(pa[v]), to_f32(pb[v]), u[v], w[v]);
        }
        if (kApply)
          *reinterpret_cast<uint4*>(p.out + bbase + (ring.r0 + ring.first(k) + i) * gr.c +
                                    l.cvi * V) = pack16<T>(o);
      }
    }
    __syncthreads();  // every thread is done with stage s
    if (threadIdx.x == 0 && k + kStages < ring.stages)
      fetch_stage<T, kBwd>(ring, k + kStages, a, b, gr.c, stage, smem_u32(full + s));
  }
  // the drained ring holds the block reduction
  if (!kApply) block_sums<V>(u, w, reinterpret_cast<float*>(stages), p.sums, gr);
}

// ------------------------------------------------------------ launches

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

template <typename T, int V, bool kBwd>
int run_reg(const Args<T>& p, long long batch, long long s, int c, cudaStream_t stream) {
  VGrid gr;
  dim3 grid;
  int blocks = 0;
  int rc = wave_blocks(reinterpret_cast<const void*>(reg_kernel<T, V, kBwd, false>), 0, blocks);
  if (rc == cudaSuccess) rc = vplan<V>(blocks, batch, s, c, gr, grid);
  if (rc != cudaSuccess) return rc;
  reg_kernel<T, V, kBwd, false><<<grid, kVThreads, 0, stream>>>(p, gr);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  reg_kernel<T, V, kBwd, true><<<grid, kVThreads, 0, stream>>>(p, gr);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool kBwd>
int run_ring(const Args<T>& p, long long batch, long long s, int c, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  VGrid gr;
  dim3 grid;
  int blocks = 0, unused = 0;
  int rc = wave_blocks(reinterpret_cast<const void*>(ring_kernel<T, kBwd, false>), kRingSmem,
                       blocks);
  if (rc == cudaSuccess)  // sets the apply kernel's shared memory limit
    rc = wave_blocks(reinterpret_cast<const void*>(ring_kernel<T, kBwd, true>), kRingSmem,
                     unused);
  if (rc == cudaSuccess) rc = vplan<V>(blocks, batch, s, c, gr, grid);
  if (rc != cudaSuccess) return rc;
  ring_kernel<T, kBwd, false><<<grid, kVThreads, kRingSmem, stream>>>(p, gr);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  ring_kernel<T, kBwd, true><<<grid, kVThreads, kRingSmem, stream>>>(p, gr);
  return static_cast<int>(cudaGetLastError());
}

// The form by shape: 16-byte vectors where C and every base allow them,
// through the ring where a block row covers whole rows; else one channel
// per thread.
template <typename T, bool kBwd>
int run(const Args<T>& p, long long batch, long long s, int c, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const bool vec = c % V == 0 && (reinterpret_cast<uintptr_t>(p.a) |
                                  reinterpret_cast<uintptr_t>(p.b) |
                                  reinterpret_cast<uintptr_t>(p.out)) % 16 == 0;
  if (!vec) return run_reg<T, 1, kBwd>(p, batch, s, c, stream);
  if (c / V > kVThreads) return run_reg<T, V, kBwd>(p, batch, s, c, stream);
  return run_ring<T, kBwd>(p, batch, s, c, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t value.
// x, y (B, S, C) contiguous; sums (2, B, C) f32 zeroed by the caller;
// rstd (B, C) f32 out.
extern "C" int airseg_norm_leaky_fwd(int dtype, const void* x, void* y, float* sums, float* rstd,
                                     long long batch, long long s, int c, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return run<float, false>(Args<float>{static_cast<const float*>(x), nullptr,
                                         static_cast<float*>(y), rstd, sums},
                             batch, s, c, st);
  if (dtype == 1)
    return run<__nv_bfloat16, false>(
        Args<__nv_bfloat16>{static_cast<const __nv_bfloat16*>(x), nullptr,
                            static_cast<__nv_bfloat16*>(y), rstd, sums},
        batch, s, c, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// g, y, dx (B, S, C) contiguous, one type; rstd (B, C) f32 from the
// forward; sums (2, B, C) f32 zeroed by the caller.
extern "C" int airseg_norm_leaky_bwd(int dtype, const void* g, const void* y, const float* rstd,
                                     void* dx, float* sums, long long batch, long long s, int c,
                                     void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* rs = const_cast<float*>(rstd);  // read only: the backward does not write rstd
  if (dtype == 0)
    return run<float, true>(Args<float>{static_cast<const float*>(g),
                                        static_cast<const float*>(y), static_cast<float*>(dx),
                                        rs, sums},
                            batch, s, c, st);
  if (dtype == 1)
    return run<__nv_bfloat16, true>(
        Args<__nv_bfloat16>{static_cast<const __nv_bfloat16*>(g),
                            static_cast<const __nv_bfloat16*>(y),
                            static_cast<__nv_bfloat16*>(dx), rs, sums},
        batch, s, c, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Dynamic shared memory of the ring kernels, both directions.
extern "C" int airseg_norm_leaky_ring_smem() { return kRingSmem; }

// Phased conv + InstanceNorm statistics in bf16 for Hopper (sm_90a), with
// wgmma.
//
// Replaces the Pallas TPU kernel se_unet_airseg_tpu/ops/pallas_s2d.py::
// phased_conv_stats (:1081) -> _pallas_forward (:212) -> _phased_kernel
// (:125): the pad-1 3^3 conv of the full-resolution grid on its s2d fold,
// as the phase-stacked 2^3 block conv with its 8 phase windows gathered,
// and the per-lane sums s1 = sum(y), s2 = sum(y^2) over the voxels, f32,
// taken after the bias and before y is rounded. The float32 form stays on
// the FMA core of conv_stats.cu.
//
// The identity. The gathered output is a shifted read of the ungathered one:
//   y[v, q*Co + o] = y_ext[v + q, q*Co + o],
//   y_ext[v'] = bias + sum_s sum_c x[v' + s - 1, c] * w_all[s, c, :],
// with y_ext on the (n+1)^3 grid and q = (a, b, c) the phase. So the kernel
// is ONE implicit GEMM with the same tap offsets for all 8Co columns:
// M = the (n+1)^3 voxels of one batch entry, N = 8Co, K = 8 taps x Cin. The
// phase gather is a scatter in the epilogue: accumulator row v', column j
// of phase q = j / Co is written to y[v' - q], and summed, only where every
// axis of v' - q lies in [0, n). The (n+1)^3 grid does 9.7% more FLOPs than
// the function needs at n = 32 and 4.8% at n = 64, so the kernel can reach
// at most about 94% of its bound.
//
// Bound: operations. Per batch of eight 128^3 tiles the model's five calls
// do 8.52 TFLOP (2 B n^3 8Cin 8Co) and move 6.3 GB, 1350 flops per byte:
// 8.616 ms at the H100's 989 bf16 TFLOP/s.
//
// Tile. A block of two warpgroups (256 threads) computes BM = 128 voxels of
// the (n+1)^3 grid of one batch entry (each warpgroup one m64 row slab) by
// BN = min(8Co, 256) columns with wgmma.mma_async m64n{BN}k16, A and B from
// shared memory, f32 accumulators in registers (BN / 2 a thread). K runs in
// steps of BK = 64 bf16 (128 bytes, inside one tap and one input tensor:
// Cin and c0 are multiples of 64) through a 4-stage shared-memory ring.
// A, the tap-shifted rows of x, is gathered with 16-byte cp.async and zero
// fill past the volume, through two base pointers for a channel concat;
// B is the weight, transposed by the caller to K-major (8Co, 8 Cin). Both
// are stored in the 128-byte-swizzled K-major layout that the wgmma
// descriptors name: chunk j of row r at byte r*128 + ((j ^ (r & 7)) * 16).
// cp.async writes through the generic proxy and wgmma reads through the
// async proxy, so every thread fences its landed copies
// (fence.proxy.async.shared::cta) before the barrier that publishes them.
// One wgmma group stays in flight: a stage is refilled two k-steps after
// its group was issued, when every warpgroup has waited for that group.
// Epilogue: the bias in f32, the scatter and mask above, one bf16 rounding;
// the sums from the f32 values, reduced over the warp (shuffles), the
// block (shared memory), then one atomicAdd per (batch, column) per block
// into s1/s2, which the caller zeroes. Offsets are 64-bit. The kernel
// allocates nothing, launches on the caller's stream and returns the
// launch's cudaError_t.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;  // two warpgroups
constexpr int kBM = 128;       // voxels per block, 64 per warpgroup
constexpr int kBK = 64;        // K per stage: 64 bf16, one 128-byte row
constexpr int kRow = 2 * kBK;  // bytes per tile row
constexpr int kStages = 4;

struct Args {
  const bf16* x0;     // (B, n, n, n, c0)
  const bf16* x1;     // (B, n, n, n, c1), or x0 when c1 == 0
  int c0, c1;         // input lane l < c0 reads x0, else x1
  const bf16* wt;     // (8Co, 8 Cin): w_all transposed, K = tap * Cin + lane
  const float* bias;  // (8Co,)
  bf16* y;            // (B, n, n, n, 8Co)
  float* s1;          // (B, 8Co), zeroed by the caller
  float* s2;
  int n, co8;
};

template <int BN> struct Tile {
  static constexpr int kA = kBM * kRow;  // 16 KB
  static constexpr int kStage = kA + BN * kRow;
  static constexpr int kSmem = kStages * kStage + 1024;  // + slack to align to 1024
};

// byte offset of 16-byte chunk j of row r in a 128B-swizzled K-major tile
__device__ __forceinline__ uint32_t swz(int r, int j) {
  return static_cast<uint32_t>(r * kRow + ((j ^ (r & 7)) << 4));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0));  // 0: fill the 16 bytes with zeros
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// wgmma shared-memory descriptor of a K-major, 128B-swizzled tile whose
// 8-row groups lie 1024 bytes apart: start address >> 4, LBO 1 (unused for
// this layout), SBO 1024 >> 4, layout type 1 (128B swizzle). The tile base
// is 1024-byte aligned; a k16 slice inside it starts 32 bytes further.
__device__ __forceinline__ uint64_t desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// d += A (64 x 16, desc a) * B (16 x BN, desc b), K-major both
template <int BN> struct Mma;

#define WG_R0 "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
#define WG_R1 "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
#define WG_R2 "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
#define WG_R3 "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
#define WG_R4 "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79"
#define WG_R5 "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
#define WG_R6 \
  "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111"
#define WG_R7 \
  "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
#define WG_F8(i)                                                                          \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])
#define WG_F32(i) WG_F8(i), WG_F8(i + 8), WG_F8(i + 16), WG_F8(i + 24)
// REGS: the accumulator operands; A, B, S: the operand numbers of the two
// descriptors and of scale-d (1: accumulate)
#define WG_MMA(BN, REGS, A, B, S, ...)                                                    \
  template <> struct Mma<BN> {                                                            \
    __device__ __forceinline__ static void run(float (&d)[BN / 2], uint64_t a, uint64_t b) { \
      asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, " S ", 0;\n"                          \
                   "wgmma.mma_async.sync.aligned.m64n" #BN "k16.f32.bf16.bf16 {" REGS "}, " \
                   A ", " B ", p, 1, 1, 0, 0;\n}\n"                                       \
                   : __VA_ARGS__                                                          \
                   : "l"(a), "l"(b), "r"(1));                                             \
    }                                                                                     \
  };
WG_MMA(64, WG_R0 ", " WG_R1, "%32", "%33", "%34", WG_F32(0))
WG_MMA(128, WG_R0 ", " WG_R1 ", " WG_R2 ", " WG_R3, "%64", "%65", "%66", WG_F32(0), WG_F32(32))
WG_MMA(256,
       WG_R0 ", " WG_R1 ", " WG_R2 ", " WG_R3 ", " WG_R4 ", " WG_R5 ", " WG_R6 ", " WG_R7,
       "%128", "%129", "%130", WG_F32(0), WG_F32(32), WG_F32(64), WG_F32(96))
#undef WG_MMA

// keep the compiler from moving accumulator reads above the wgmma wait
template <int N> __device__ __forceinline__ void pin(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int BN>
__global__ void __launch_bounds__(kThreads, 1) phased_conv_wgmma_kernel(const Args p) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t base = (raw + 1023u) & ~1023u;  // the swizzle atoms are 1024-byte aligned
  const int tid = threadIdx.x;
  const int ct = blockIdx.x;  // column tile
  const int64_t b = blockIdx.z;
  const int n = p.n, m = n + 1;
  const int64_t n3 = static_cast<int64_t>(n) * n * n;
  const int64_t m3 = static_cast<int64_t>(m) * m * m;
  const int64_t vox0 = static_cast<int64_t>(blockIdx.y) * kBM;
  const int cin = p.c0 + p.c1;
  const int ktiles = 8 * cin / kBK;

  // loader: 16-byte chunk j of tile rows (tid >> 3) + 32 i. Row i's voxel
  // v' = (z, y, x) of the (n+1)^3 grid reads input voxel v' + s - 1 at
  // tap s: off[i] = (z n + y) n + x, and bit 8i + s of `taps` says whether
  // that voxel lies inside the volume (never for a row past the grid).
  const int j = tid & 7;
  const int64_t bvox = b * n3;  // first input voxel of batch entry b
  int off[4];
  uint32_t taps = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t v = vox0 + (tid >> 3) + 32 * i;
    off[i] = 0;
    if (v < m3) {
      const int z = static_cast<int>(v / (static_cast<int64_t>(m) * m));
      const int rem = static_cast<int>(v - static_cast<int64_t>(z) * m * m);
      const int y = rem / m, x = rem - (rem / m) * m;
      off[i] = (z * n + y) * n + x;
#pragma unroll
      for (int t = 0; t < 8; ++t) {  // tap t = (sz, sy, sx): z + sz - 1 in [0, n) ...
        const bool in = (t & 4 ? z < n : z > 0) && (t & 2 ? y < n : y > 0) &&
                        (t & 1 ? x < n : x > 0);
        taps |= static_cast<uint32_t>(in) << (8 * i + t);
      }
    }
  }
  const bf16* wrow = p.wt + static_cast<int64_t>(ct * BN + (tid >> 3)) * (8 * cin) + j * 8;

  auto load = [&](int kt, int st) {
    const uint32_t sa = base + st * Tile<BN>::kStage;
    const uint32_t sb = sa + Tile<BN>::kA;
    const int k0 = kt * kBK;
    const int t = k0 / cin, c = k0 - t * cin;  // tap t = (sz, sy, sx) reads v' + s - 1
    const int shift = ((((t >> 2) & 1) - 1) * n + ((t >> 1) & 1) - 1) * n + (t & 1) - 1;
    const bool second = c >= p.c0;
    const bf16* xb = second ? p.x1 : p.x0;
    const int stride = second ? p.c1 : p.c0;
    const int lane = (second ? c - p.c0 : c) + j * 8;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const bool ok = (taps >> (8 * i + t)) & 1u;
      const bf16* src = p.x0;
      if (ok) src = xb + (bvox + off[i] + shift) * stride + lane;
      cp_async16(sa + swz((tid >> 3) + 32 * i, j), src, ok);
    }
#pragma unroll
    for (int i = 0; i < BN / 32; ++i)
      cp_async16(sb + swz((tid >> 3) + 32 * i, j),
                 wrow + static_cast<int64_t>(32 * i) * (8 * cin) + k0, true);
  };

  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  load(0, 0);
  cp_async_commit();
  if (ktiles > 1) load(1, 1);
  cp_async_commit();
  const int wg = tid >> 7;
  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<1>();   // this thread's copies of tile kt landed
    fence_proxy_async();  // ... and are visible to the async proxy
    __syncthreads();      // everyone's; every group up to kt-2 is complete
    const uint32_t sa = base + (kt % kStages) * Tile<BN>::kStage;
    const uint32_t a0 = sa + wg * 64 * kRow, b0 = sa + Tile<BN>::kA;
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < kBK / 16; ++k) Mma<BN>::run(acc, desc(a0 + 32 * k), desc(b0 + 32 * k));
    wgmma_commit();
    wgmma_wait<1>();  // this warpgroup's group kt-1 is done
    if (kt + 2 < ktiles) load(kt + 2, (kt + 2) % kStages);  // the stage of group kt-2
    cp_async_commit();
  }
  wgmma_wait<0>();
  pin(acc);
  cp_async_wait<0>();
  __syncthreads();  // every warpgroup is done with the ring: it becomes red

  // epilogue. Warp w of the warpgroup owns rows 16w + lane/4 (+8) of its
  // slab; lane % 4 owns columns 8i + 2(lane % 4) + {0, 1} of chunk i.
  // Row h's voxel v' = (z, y, x) lands on y[v' - q] for phase q = (a, b, c):
  // dst[h] = (z n + y) n + x, less (a n + b) n + c; bit 8h + q of `lands`
  // says whether every axis of v' - q lies in [0, n).
  const int lane = tid & 31, warp = tid >> 5;
  const int co = p.co8 / 8;
  int dst[2] = {0, 0};
  uint32_t lands = 0;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int64_t v = vox0 + wg * 64 + (warp & 3) * 16 + (lane >> 2) + 8 * h;
    if (v < m3) {
      const int z = static_cast<int>(v / (static_cast<int64_t>(m) * m));
      const int rem = static_cast<int>(v - static_cast<int64_t>(z) * m * m);
      const int y = rem / m, x = rem - (rem / m) * m;
      dst[h] = (z * n + y) * n + x;
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const bool in = (q & 4 ? z > 0 : z < n) && (q & 2 ? y > 0 : y < n) &&
                        (q & 1 ? x > 0 : x < n);
        lands |= static_cast<uint32_t>(in) << (8 * h + q);
      }
    }
  }
  float* red = reinterpret_cast<float*>(smem_raw + (base - raw));  // [8 warps][BN][2]
#pragma unroll
  for (int i = 0; i < BN / 8; ++i) {
    const int col = ct * BN + 8 * i + 2 * (lane & 3);
    const int q = col / co;  // co is even: the pair is in one phase
    const int shift = (((q >> 2) & 1) * n + ((q >> 1) & 1)) * n + (q & 1);
    const float b0 = p.bias[col], b1 = p.bias[col + 1];
    float u0 = 0.f, u1 = 0.f, w0 = 0.f, w1 = 0.f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if ((lands >> (8 * h + q)) & 1u) {
        const float e0 = acc[4 * i + 2 * h] + b0, e1 = acc[4 * i + 2 * h + 1] + b1;
        *reinterpret_cast<__nv_bfloat162*>(p.y + (bvox + dst[h] - shift) * p.co8 + col) =
            __floats2bfloat162_rn(e0, e1);
        u0 += e0;
        u1 += e1;
        w0 += e0 * e0;
        w1 += e1 * e1;
      }
    }
#pragma unroll
    for (int off = 4; off < 32; off <<= 1) {  // over the 8 row groups of the warp
      u0 += __shfl_xor_sync(0xffffffffu, u0, off);
      u1 += __shfl_xor_sync(0xffffffffu, u1, off);
      w0 += __shfl_xor_sync(0xffffffffu, w0, off);
      w1 += __shfl_xor_sync(0xffffffffu, w1, off);
    }
    if (lane < 4) {
      float* r = red + (warp * BN + 8 * i + 2 * lane) * 2;
      r[0] = u0;
      r[1] = w0;
      r[2] = u1;
      r[3] = w1;
    }
  }
  __syncthreads();
  if (tid < BN) {
    float u = 0.f, w = 0.f;
#pragma unroll
    for (int wp = 0; wp < kThreads / 32; ++wp) {
      u += red[(wp * BN + tid) * 2];
      w += red[(wp * BN + tid) * 2 + 1];
    }
    atomicAdd(p.s1 + b * p.co8 + ct * BN + tid, u);
    atomicAdd(p.s2 + b * p.co8 + ct * BN + tid, w);
  }
}

template <int BN>
int launch_bn(const Args& a, long long batch, cudaStream_t stream) {
  const int64_t m = a.n + 1;
  const int64_t tiles = (m * m * m + kBM - 1) / kBM;
  if (tiles > 65535 || batch > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
  if (batch == 0) return 0;
  constexpr int smem = Tile<BN>::kSmem;
  cudaError_t e = cudaFuncSetAttribute(phased_conv_wgmma_kernel<BN>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid(a.co8 / BN, static_cast<unsigned>(tiles), static_cast<unsigned>(batch));
  phased_conv_wgmma_kernel<BN><<<grid, kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x0 (B, n, n, n, c0) and x1 (B, n, n, n, c1) bf16 form a plain channel
// concat of Cin = c0 + c1 lanes (c1 = 0: x0 alone), c0 and c1 multiples of
// 64; wt (8Co, 8 Cin) bf16, the K-major transpose of w_all (8, Cin, 8Co)
// with taps s = sz*4 + sy*2 + sx; b_all (8Co,) f32; 8Co one of 64, 128,
// 256 or a multiple of 256. y (B, n, n, n, 8Co) bf16; s1, s2 (B, 8Co) f32,
// zeroed. Returns a cudaError_t value.
extern "C" int airseg_phased_conv_stats_wgmma(const void* x0, int c0, const void* x1, int c1,
                                              const void* wt, const float* b_all, void* y,
                                              float* s1, float* s2, long long batch, int n,
                                              int co, void* stream) {
  const int co8 = 8 * co;
  if (n <= 0 || c0 <= 0 || c0 % kBK || c1 % kBK || co <= 0 || (co8 > 256 && co8 % 256) ||
      (co8 < 256 && co8 != 64 && co8 != 128))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{static_cast<const bf16*>(x0), static_cast<const bf16*>(c1 ? x1 : x0), c0, c1,
         static_cast<const bf16*>(wt), b_all, static_cast<bf16*>(y), s1, s2, n, co8};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (co8 == 64) return launch_bn<64>(a, batch, s);
  if (co8 == 128) return launch_bn<128>(a, batch, s);
  return launch_bn<256>(a, batch, s);
}

// The dynamic shared memory, in bytes, of a launch with 8Co = 8 * co.
extern "C" int airseg_phased_conv_stats_wgmma_smem(int co) {
  return 8 * co == 64 ? Tile<64>::kSmem : 8 * co == 128 ? Tile<128>::kSmem : Tile<256>::kSmem;
}

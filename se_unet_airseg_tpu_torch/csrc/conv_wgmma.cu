// The s2d convolutions in bf16 for Hopper (sm_90a), with wgmma: one main
// loop, a table of k-steps, three epilogue forms.
//
// Replaces these Pallas TPU kernels of se_unet_airseg_tpu/ops/pallas_s2d.py:
//   (a) phased_conv_stats (:1081) -> _pallas_forward (:212) -> _phased_kernel
//       (:125): the pad-1 3^3 conv of the full-resolution grid on its s2d
//       fold, as the phase-stacked 2^3 block conv with its 8 phase windows
//       gathered, and the per-lane sums s1 = sum(y), s2 = sum(y^2) over the
//       voxels, f32, taken after the bias and before y is rounded;
//   (b) phased_conv_ext_bm (:2179) -> _pconv_kernel_bm (:2071), and its
//       k-grid schedule _pconv_kgrid_forward (:2131) -> _pconv_kgrid_kernel_bm
//       (:2002): the same 2^3 block conv to its UNGATHERED (n+1)^3 output,
//       y_ext[v'] = bias + sum_s sum_c x[v' + s - 1, c] * w_all[s, c, :],
//       no sums;
//   (c) dil2_conv_stats_bm (:1714) -> _dil2_kernel_bm (:1654): the dense
//       pad-1 3^3 conv of an s2d tensor with any (3, 3, 3, C8, C8o) kernel,
//       y[v] = bias + sum_d sum_c x[v + d, c] * wd[d + 1, c, :], with the sums.
// The float32 forms stay on the FMA core of conv_stats.cu.
//
// (a)'s identity. The gathered output is a shifted read of the ungathered
// one: y[v, q*Co + o] = y_ext[v + q, q*Co + o] for the phase q = (a, b, c).
// So all three are ONE implicit GEMM with the same tap offsets for every
// output column: M = the voxels of one batch entry ((n+1)^3 for (a) and (b),
// n^3 for (c)), N = the output columns, K = taps x input lanes (8 taps for
// (a) and (b), 27 for (c)). (a)'s phase gather is a scatter in its
// epilogue: accumulator row v', column j of phase q = j / Co is written to
// y[v' - q], and summed, only where every axis of v' - q lies in [0, n).
//
// The k-step table. A k-step is BK = 64 lanes of one tap of one input
// tensor. The caller gives each column tile a list of packed int32 entries
// (tap | input << 5 | valid lanes << 6 | first lane << 13) and a count; the
// block walks its list in order. Lanes past `valid` are zero-filled in A
// and in B, so any input width that is a multiple of 8 lanes (one 16-byte
// chunk) works. For (a) and (b) every column tile walks every entry. For (c)
// the caller lists, per column tile, only the k-steps whose (BN x 64) weight
// tile holds a nonzero, in ascending K order: for the block-diagonal lift of
// a dil-2 kernel that the model passes, 1/2 to 1/4 of them. For finite x a
// skipped tile adds exactly zero, so the result is the dense one; a NaN or
// Inf of x in a skipped lane would give NaN in the dense TPU kernel and not
// here.
//
// Bound: operations. Per batch of eight 128^3 tiles, (a)'s five calls do
// 8.52 TFLOP in 8.616 ms at the H100's 989 bf16 TFLOP/s, (b)'s 9.08 TFLOP
// in 9.176 ms (the (n+1)^3 grid), (c)'s three 6.49 TFLOP dense in 6.566 ms,
// of which the block-diagonal weight's nonzeros need 0.82 TFLOP, 0.833 ms.
// (a) and (b) do 9.7% (n = 32) and 4.8% (n = 64) more FLOPs than (a)'s
// gathered function needs.
//
// Tile. A block of two warpgroups (256 threads) computes BM = 128 rows of
// one batch entry (each warpgroup one m64 row slab) by BN (64, 128 or 256)
// columns with wgmma.mma_async m64n{BN}k16, A and B from shared memory, f32
// accumulators in registers (BN / 2 a thread). K runs in k-steps of BK = 64
// bf16 (128 bytes) through a 4-stage shared-memory ring. A, the tap-shifted
// rows of x, is gathered with 16-byte cp.async and zero fill past the
// volume, through two base pointers for a channel concat; B is the weight,
// transposed by the caller to K-major (N, taps * Cin). Both are stored in
// the 128-byte-swizzled K-major layout that the wgmma descriptors name:
// chunk j of row r at byte r*128 + ((j ^ (r & 7)) * 16). cp.async writes
// through the generic proxy and wgmma reads through the async proxy, so
// every thread fences its landed copies (fence.proxy.async.shared::cta)
// before the barrier that publishes them. One wgmma group stays in flight:
// a stage is refilled two k-steps after its group was issued, when every
// warpgroup has waited for that group.
// Epilogue: the bias in f32, one bf16 rounding, rows stored in place ((a):
// the scatter and mask above); for (a) and (c) the sums from the f32
// values, reduced over the warp (shuffles), the block (shared memory), then
// one atomicAdd per (batch, column) per block into s1/s2, which the caller
// zeroes. Offsets are 64-bit. The kernels allocate nothing, launch on the
// caller's stream and return the launch's cudaError_t.

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

// the epilogue forms: (a) K8, (b) K11, (c) K10 of the header
enum Form { kPhasedStats = 0, kUngathered = 1, kDense = 2 };

struct Args {
  const bf16* x0;     // (B, n, n, n, c0)
  const bf16* x1;     // (B, n, n, n, c1), or x0 when c1 == 0
  int c0, c1;         // lane l < c0 of the concat reads x0, else x1
  const bf16* wt;     // (N, taps * Cin), K-major: K = tap * Cin + lane of the concat
  const int* steps;   // column tile ct walks steps[ct * steps_ld + i], i < its count
  int steps_ld;       // 0: every column tile walks the same list
  const int* count;   // (N / BN,) k-steps of each column tile; null: nsteps each
  int nsteps;
  const float* bias;  // (N,)
  bf16* y;            // (a), (c): (B, n, n, n, N); (b): (B, n+1, n+1, n+1, N)
  float* s1;          // (a), (c): (B, N), zeroed by the caller; (b): unused
  float* s2;
  int n, ncols;       // input grid per axis; N
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

// The block's work; one __global__ per form below, so each form has its own
// kernel name in ptxas's report and in a profile.
template <int BN, int kForm>
__device__ __forceinline__ void conv_wgmma(const Args& p) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t base = (raw + 1023u) & ~1023u;  // the swizzle atoms are 1024-byte aligned
  const int tid = threadIdx.x;
  const int ct = blockIdx.x;  // column tile
  const int64_t b = blockIdx.z;
  const int n = p.n;
  const int m = kForm == kDense ? n : n + 1;  // rows: the voxels of an m^3 grid
  const int64_t n3 = static_cast<int64_t>(n) * n * n;
  const int64_t m3 = static_cast<int64_t>(m) * m * m;
  const int64_t vox0 = static_cast<int64_t>(blockIdx.y) * kBM;
  const int cin = p.c0 + p.c1;
  const int64_t ldk = static_cast<int64_t>(kForm == kDense ? 27 : 8) * cin;
  const int ksteps = p.count ? p.count[ct] : p.nsteps;
  const int* list = p.steps + static_cast<int64_t>(ct) * p.steps_ld;

  // loader: 16-byte chunk j of tile rows (tid >> 3) + 32 i. Row i's voxel
  // (z, y, x) reads input voxel (z + dz, y + dy, x + dx) at a tap of offset
  // d: off[i] = (z n + y) n + x, and bits 8i.. of `edge` say: bit 0, the row
  // lies in the grid; bits 1/2, z - 1 / z + H lies in [0, n); bits 3/4 and
  // 5/6 the same for y and x. H = 0 for (a), (b), whose taps shift by -1
  // or 0, and 1 for (c), whose taps shift by -1, 0 or +1.
  constexpr int H = kForm == kDense ? 1 : 0;
  const int j = tid & 7;
  const int64_t bvox = b * n3;  // first input voxel of batch entry b
  int off[4];
  uint32_t edge = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t v = vox0 + (tid >> 3) + 32 * i;
    off[i] = 0;
    if (v < m3) {
      const int z = static_cast<int>(v / (static_cast<int64_t>(m) * m));
      const int rem = static_cast<int>(v - static_cast<int64_t>(z) * m * m);
      const int y = rem / m, x = rem - (rem / m) * m;
      off[i] = (z * n + y) * n + x;
      const uint32_t e = 1u | static_cast<uint32_t>(z > 0) << 1 |
                         static_cast<uint32_t>(z + H < n) << 2 |
                         static_cast<uint32_t>(y > 0) << 3 |
                         static_cast<uint32_t>(y + H < n) << 4 |
                         static_cast<uint32_t>(x > 0) << 5 | static_cast<uint32_t>(x + H < n) << 6;
      edge |= e << (8 * i);
    }
  }
  const bf16* wrow = p.wt + static_cast<int64_t>(ct * BN + (tid >> 3)) * ldk + j * 8;

  auto load = [&](int kt, int st) {
    const uint32_t sa = base + st * Tile<BN>::kStage;
    const uint32_t sb = sa + Tile<BN>::kA;
    const int e = __ldg(list + kt);
    const int t = e & 31, second = (e >> 5) & 1, valid = (e >> 6) & 127, lane0 = e >> 13;
    int dz, dy, dx;  // (c): t = 9 (dz + 1) + 3 (dy + 1) + dx + 1; (a), (b): t = 4 sz + 2 sy + sx, d = s - 1
    if (kForm == kDense) {
      dz = t / 9 - 1;
      dy = (t / 3) % 3 - 1;
      dx = t % 3 - 1;
    } else {
      dz = ((t >> 2) & 1) - 1;
      dy = ((t >> 1) & 1) - 1;
      dx = (t & 1) - 1;
    }
    // the `edge` bits a row needs for this tap to read inside the volume
    const uint32_t need = 1u | static_cast<uint32_t>(dz < 0) << 1 |
                          static_cast<uint32_t>(dz == H) << 2 | static_cast<uint32_t>(dy < 0) << 3 |
                          static_cast<uint32_t>(dy == H) << 4 | static_cast<uint32_t>(dx < 0) << 5 |
                          static_cast<uint32_t>(dx == H) << 6;
    const int shift = (dz * n + dy) * n + dx;
    const bool lane_ok = j * 8 < valid;  // chunks past the input's width: zeros
    const bf16* xb = second ? p.x1 : p.x0;
    const int stride = second ? p.c1 : p.c0;
    const int lane = lane0 + j * 8;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const bool ok = lane_ok && ((edge >> (8 * i)) & need) == need;
      const bf16* src = p.x0;
      if (ok) src = xb + (bvox + off[i] + shift) * stride + lane;
      cp_async16(sa + swz((tid >> 3) + 32 * i, j), src, ok);
    }
    const int64_t k0 = static_cast<int64_t>(t) * cin + (second ? p.c0 : 0) + lane0;
#pragma unroll
    for (int i = 0; i < BN / 32; ++i)
      cp_async16(sb + swz((tid >> 3) + 32 * i, j),
                 lane_ok ? wrow + static_cast<int64_t>(32 * i) * ldk + k0 : p.wt, lane_ok);
  };

  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  if (ksteps > 0) load(0, 0);
  cp_async_commit();
  if (ksteps > 1) load(1, 1);
  cp_async_commit();
  const int wg = tid >> 7;
  for (int kt = 0; kt < ksteps; ++kt) {
    cp_async_wait<1>();   // this thread's copies of k-step kt landed
    fence_proxy_async();  // ... and are visible to the async proxy
    __syncthreads();      // everyone's; every group up to kt-2 is complete
    const uint32_t sa = base + (kt % kStages) * Tile<BN>::kStage;
    const uint32_t a0 = sa + wg * 64 * kRow, b0 = sa + Tile<BN>::kA;
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < kBK / 16; ++k) Mma<BN>::run(acc, desc(a0 + 32 * k), desc(b0 + 32 * k));
    wgmma_commit();
    wgmma_wait<1>();  // this warpgroup's group kt-1 is done
    if (kt + 2 < ksteps) load(kt + 2, (kt + 2) % kStages);  // the stage of group kt-2
    cp_async_commit();
  }
  wgmma_wait<0>();
  pin(acc);
  cp_async_wait<0>();
  __syncthreads();  // every warpgroup is done with the ring: it becomes red

  // epilogue. Warp w of the warpgroup owns rows 16w + lane/4 (+8) of its
  // slab; lane % 4 owns columns 8i + 2(lane % 4) + {0, 1} of chunk i. Row
  // h's value of phase q is stored to row dst[h] - shift(q) of y where bit
  // 8h + q of `lands` is set. (a): row v' = (z, y, x) lands on v' - q for
  // the phase q = (a, b, c) of its column, dst[h] = (z n + y) n + x, and
  // only where every axis of v' - q lies in [0, n). (b), (c): q = 0, the
  // row in place, where it lies in the grid.
  constexpr bool kSums = kForm != kUngathered;
  const int lane = tid & 31, warp = tid >> 5;
  const int co = p.ncols / 8;
  const int64_t ybase = b * (kForm == kUngathered ? m3 : n3);
  int dst[2] = {0, 0};
  uint32_t lands = 0;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int64_t v = vox0 + wg * 64 + (warp & 3) * 16 + (lane >> 2) + 8 * h;
    if (v < m3) {
      if (kForm == kPhasedStats) {
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
      } else {
        dst[h] = static_cast<int>(v);
        lands |= 1u << (8 * h);
      }
    }
  }
  float* red = reinterpret_cast<float*>(smem_raw + (base - raw));  // [8 warps][BN][2]
#pragma unroll
  for (int i = 0; i < BN / 8; ++i) {
    const int col = ct * BN + 8 * i + 2 * (lane & 3);
    const int q = kForm == kPhasedStats ? col / co : 0;  // co is even: the pair is in one phase
    const int shift = (((q >> 2) & 1) * n + ((q >> 1) & 1)) * n + (q & 1);
    const float b0 = p.bias[col], b1 = p.bias[col + 1];
    float u0 = 0.f, u1 = 0.f, w0 = 0.f, w1 = 0.f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if ((lands >> (8 * h + q)) & 1u) {
        const float e0 = acc[4 * i + 2 * h] + b0, e1 = acc[4 * i + 2 * h + 1] + b1;
        *reinterpret_cast<__nv_bfloat162*>(p.y + (ybase + dst[h] - shift) * p.ncols + col) =
            __floats2bfloat162_rn(e0, e1);
        if (kSums) {
          u0 += e0;
          u1 += e1;
          w0 += e0 * e0;
          w1 += e1 * e1;
        }
      }
    }
    if (kSums) {
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
  }
  if (!kSums) return;
  __syncthreads();
  if (tid < BN) {
    float u = 0.f, w = 0.f;
#pragma unroll
    for (int wp = 0; wp < kThreads / 32; ++wp) {
      u += red[(wp * BN + tid) * 2];
      w += red[(wp * BN + tid) * 2 + 1];
    }
    atomicAdd(p.s1 + b * p.ncols + ct * BN + tid, u);
    atomicAdd(p.s2 + b * p.ncols + ct * BN + tid, w);
  }
}

template <int BN>
__global__ void __launch_bounds__(kThreads, 1) phased_conv_stats_wgmma(const Args p) {
  conv_wgmma<BN, kPhasedStats>(p);
}
template <int BN>
__global__ void __launch_bounds__(kThreads, 1) phased_conv_ungathered_wgmma(const Args p) {
  conv_wgmma<BN, kUngathered>(p);
}
template <int BN>
__global__ void __launch_bounds__(kThreads, 1) dil2_dense_conv_stats_wgmma(const Args p) {
  conv_wgmma<BN, kDense>(p);
}

template <int BN>
int launch_bn(int form, const Args& a, long long batch, cudaStream_t stream) {
  const int64_t m = form == kDense ? a.n : a.n + 1;
  const int64_t tiles = (m * m * m + kBM - 1) / kBM;
  if (tiles > 65535 || batch > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
  if (batch == 0) return 0;
  void (*kernel)(const Args) = form == kPhasedStats  ? &phased_conv_stats_wgmma<BN>
                               : form == kUngathered ? &phased_conv_ungathered_wgmma<BN>
                                                     : &dil2_dense_conv_stats_wgmma<BN>;
  constexpr int smem = Tile<BN>::kSmem;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid(a.ncols / BN, static_cast<unsigned>(tiles), static_cast<unsigned>(batch));
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// form: 0 (a) phased conv stats, 1 (b) ungathered phased conv, 2 (c) dense
// dil-2 conv stats. x0 (B, n, n, n, c0) and x1 (B, n, n, n, c1) bf16 form a
// plain channel concat of Cin = c0 + c1 lanes (c1 = 0: x0 alone; (c) reads
// x0 alone), c0 and c1 multiples of 8; wt (N, taps * Cin) bf16, the
// K-major weight, taps 8 ((a), (b): s = sz*4 + sy*2 + sx) or 27 ((c): t =
// kd*9 + kh*3 + kw); steps: the packed k-step entries of each column tile,
// steps_ld apart (0: one list for all), count (N / bn,) int32 or null (each
// walks nsteps); bias (N,) f32; N = ncols, a multiple of bn (64, 128 or
// 256), and for (a) of 16 (8 phases of an even Co). y bf16: (a), (c) (B, n,
// n, n, N), (b) (B, n+1, n+1, n+1, N); s1, s2 (B, N) f32, zeroed, for (a)
// and (c). Returns a cudaError_t value.
extern "C" int airseg_conv_wgmma(int form, const void* x0, int c0, const void* x1, int c1,
                                 const void* wt, const int* steps, int steps_ld,
                                 const int* count, int nsteps, const float* bias, void* y,
                                 float* s1, float* s2, long long batch, int n, int ncols, int bn,
                                 void* stream) {
  const bool sums = form != kUngathered;
  if (form < 0 || form > 2 || n <= 0 || c0 <= 0 || c0 % 8 || c1 < 0 || c1 % 8 ||
      (form == kDense && c1) || !steps || steps_ld < 0 || nsteps <= 0 ||
      (bn != 64 && bn != 128 && bn != 256) || ncols <= 0 || ncols % bn ||
      (form == kPhasedStats && ncols % 16) || (sums && (!s1 || !s2)))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{static_cast<const bf16*>(x0), static_cast<const bf16*>(c1 ? x1 : x0), c0, c1,
         static_cast<const bf16*>(wt), steps, steps_ld, count, nsteps, bias,
         static_cast<bf16*>(y), s1, s2, n, ncols};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bn == 64) return launch_bn<64>(form, a, batch, s);
  if (bn == 128) return launch_bn<128>(form, a, batch, s);
  return launch_bn<256>(form, a, batch, s);
}

// The dynamic shared memory, in bytes, of a launch with column tile bn.
extern "C" int airseg_conv_wgmma_smem(int bn) {
  return bn == 64 ? Tile<64>::kSmem : bn == 128 ? Tile<128>::kSmem : Tile<256>::kSmem;
}

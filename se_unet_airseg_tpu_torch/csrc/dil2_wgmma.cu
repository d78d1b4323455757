// The dilation-2 s2d conv with statistics in bf16 for Hopper (sm_90a): a
// halo-brick implicit GEMM on wgmma with the shared weight resident in
// shared memory and the im2col done by the A operand's descriptors.
//
// Replaces the Pallas TPU kernel se_unet_airseg_tpu/ops/pallas_s2d.py
// dil2_conv_stats (:405) -> _pallas_dil2_forward (:326, call :353) -> _dil2_kernel
// (:273): the dilation-2 3^3 conv on the s2d fold, as 8 independent dil-1
// convs, one per sub-position p, all with the SAME (27*Ci, Co) kernel,
//   y[v, p*Co + o] = bias[o] + sum_t sum_c x[v + d_t, p*Ci + c] * w[t, c, o],
// zero outside the volume, and the per-lane sums s1 = sum_v y, s2 = sum_v
// y^2 (B, 8Co), f32, taken after the bias and before y is rounded.
// The float32 form stays on the FMA core of conv_stats.cu.
//
// So K9 is one dense implicit GEMM: M = B * n^3 * 8 rows, one per (voxel,
// p); N = Co; K = 27 * Ci, with no structural zeros. Every input voxel is
// read by 27 output voxels, and the weight (at most 27*32*64*2 = 110.6 KB at
// the model's widths) is the same for every row.
//
// Bound: bytes for ec3 (n 64, Ci 16, Co 32), operations for ec5 and ec6.
// Design:
//  * A block of two warpgroups is persistent: it stages its column tile of
//    the K-major weight (BN rows x Kp = 27*Ci rounded up to 64, zero-padded
//    by the caller; BN = 64, 32, 16 or 8 output channels) once, by 16-byte
//    cp.async, in the 128-byte-swizzled K-major layout of the wgmma
//    descriptors (64 K a slab, chunk j of row r at r*128 + ((j ^ (r & 7)) *
//    16)), and then walks bricks of 8 x ty x tz output voxels (x, y, z) of
//    any batch entry, all 8 sub-positions each. BN, ty and tz come from
//    the shapes alone (ops/conv_stats.py::dil2_tile).
//  * Each brick is staged once, by cp.async, as the haloed (tz+2) x (ty+2)
//    x 10 input brick, zero outside the volume, with each voxel's 8*Ci
//    lanes stored chunk-major: chunk j of sub-position p at (voxel * Ci/8 +
//    j) * 128 + p * 16. So the 8 sub-positions' chunk j of one voxel form
//    one 8 x 16-byte core matrix of the wgmma's no-swizzle K-major layout.
//    The brick is single-buffered: a second buffer for the next brick
//    measured no faster than a second block on the SM (PERF.md).
//  * The rows of a slab are the 8 x-neighbouring voxels of one (z, y) row
//    of the brick times the 8 sub-positions, p fastest: 64 rows, one m64
//    tile. For tap (dz, dy, dx) and K chunk j its A operand is a descriptor
//    into the brick: start = the halo voxel (z + dz, y + dy, dx) chunk j,
//    stride to the next 8 rows (SBO) = one voxel, stride to the next 8 K
//    (LBO) = one chunk, or to the next tap's first chunk where a k16 step
//    spans two taps (Ci/8 odd), or to a zero region past the 27 taps. So
//    im2col costs nothing: each k16 step is one wgmma m64n{BN}k16 with A and
//    B read from shared memory. The steps' descriptors are a per-block
//    table; a slab adds its offset to A's start.
//  * A warpgroup takes kG slabs at a time (4 at BN <= 32, else 2) and
//    interleaves their wgmmas, so that no two in a row share an
//    accumulator; then it waits and stores. ptxas serializes wgmmas whose
//    accumulators are read while any wgmma is in flight, or that sit in a
//    branch that depends on the thread: neither happens here. The other
//    warpgroup, and at BN <= 32 a second block on the SM, fill the gaps.
//  * cp.async and the table's stores write through the generic proxy and
//    wgmma reads through the async proxy: every thread fences
//    (fence.proxy.async.shared::cta) before the barrier that publishes them.
//  * Epilogue per slab: the bias in f32, one bf16 rounding into y[v, p*Co +
//    o] by predicated stores where the voxel lies in the volume, and the
//    f32 values, masked likewise, into per-thread sums; each lane's rows
//    have one p. When a block moves to another batch entry, and at its end,
//    every thread adds its sums into s1/s2 (zeroed by the caller) with one
//    atomicAdd per (column, sub-position) it holds. Their order differs
//    from the TPU's.
// Offsets into x and y are 64-bit. The kernel allocates nothing, launches on
// the caller's stream and the launcher returns the launch's cudaError_t.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;  // two warpgroups
constexpr int kTX = 8;         // brick x extent: a slab is 8 voxels x 8 sub-positions
constexpr int kHX = kTX + 2;   // halo x extent
constexpr int kSmemMax = 232448;  // 227 KB, what a block may use
// slabs whose wgmmas a warpgroup interleaves (as many as 64 accumulator
// registers a thread hold)
template <int BN> __host__ __device__ constexpr int kSlabs() { return BN <= 32 ? 4 : 2; }

struct Args {
  const bf16* x;      // (B, n, n, n, 8 ci)
  const bf16* wt;     // (co, kp) K-major: K = tap * ci + c, zero past 27 ci
  const float* bias;  // (co,)
  bf16* y;            // (B, n, n, n, 8 co)
  float* s1;          // (B, 8 co), zeroed by the caller
  float* s2;
  int n, ci, co, kp, ty, tz;
  int items;          // bricks x batch entries, walked by each column tile's blocks
};

// byte offsets from the 1024-aligned base of the dynamic shared memory
struct Layout {
  int vox;     // bytes of one halo voxel: ci / 8 chunks x 8 sub-positions x 16
  int brick;   // the halo brick, after the weight's kp * bn * 2 bytes
  int bbytes;  // bytes of one halo brick
  int zero;    // 8 voxels of zeros, read past the 27 taps when ci / 8 is odd
  int steps;   // the k16 steps' table: (A offset, LBO) each
  int nsteps;  // 27 ci / 16 rounded up
  int bytes;   // dynamic shared memory of a launch, alignment slack included
};
__host__ __device__ inline Layout layout(int ci, int kp, int ty, int tz, int bn) {
  Layout l;
  const int q = ci / 8;
  l.vox = q * 128;
  l.nsteps = (27 * q + 1) / 2;
  l.brick = kp * bn * 2;
  l.bbytes = kHX * (ty + 2) * (tz + 2) * l.vox;
  l.zero = l.brick + l.bbytes;
  l.steps = l.zero + (q % 2 ? 8 * l.vox : 0);
  l.bytes = l.steps + l.nsteps * 16 + 1024;
  return l;
}

// byte offset of 16-byte chunk j of row r in a 128B-swizzled K-major tile
__device__ __forceinline__ uint32_t swz(int r, int j) {
  return static_cast<uint32_t>(r * 128 + ((j ^ (r & 7)) << 4));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0));  // 0: fill the 16 bytes with zeros
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
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

// B: K-major, 128B-swizzled, 8-row groups 1024 bytes apart (as in
// conv_wgmma.cu): start >> 4, LBO 1 (unused), SBO 1024 >> 4, layout type 1
__device__ __forceinline__ uint64_t desc_b(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) |
         (1ull << 62);
}
// A: K-major, no swizzle (layout type 0): 8 x 16-byte core matrices, the
// next 8 K `lbo` bytes on, the next 8 rows `sbo` bytes on
__device__ __forceinline__ uint64_t desc_a(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32;
}

// d (+)= A (64 x 16, desc a) * B (16 x BN, desc b); accumulate = 0 overwrites d
template <int BN> struct Mma;

#define WG_SS_MMA(BN, DREGS, A, B, S, ...)                                                 \
  template <> struct Mma<BN> {                                                             \
    __device__ __forceinline__ static void run(float (&d)[BN / 2], uint64_t a, uint64_t b, \
                                               int accumulate) {                          \
      asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, " S ", 0;\n"                          \
                   "wgmma.mma_async.sync.aligned.m64n" #BN "k16.f32.bf16.bf16 {" DREGS      \
                   "}, " A ", " B ", p, 1, 1, 0, 0;\n}\n"                                \
                   : __VA_ARGS__                                                           \
                   : "l"(a), "l"(b), "r"(accumulate));                                     \
    }                                                                                      \
  };
#define D4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define D16(i) D4(i), D4(i + 4), D4(i + 8), D4(i + 12)
WG_SS_MMA(8, "%0, %1, %2, %3", "%4", "%5", "%6", D4(0))
WG_SS_MMA(16, "%0, %1, %2, %3, %4, %5, %6, %7", "%8", "%9", "%10", D4(0), D4(4))
WG_SS_MMA(32,
          "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15",
          "%16", "%17", "%18", D16(0))
WG_SS_MMA(64,
          "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
          "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31",
          "%32", "%33", "%34", D16(0), D16(16))
#undef WG_SS_MMA
#undef D16
#undef D4

// store v to ptr where pred holds, without a branch
__device__ __forceinline__ void st_pred(bf16* ptr, __nv_bfloat162 v, bool pred) {
  asm volatile("{\n.reg .pred q;\nsetp.ne.b32 q, %2, 0;\n@q st.global.b32 [%0], %1;\n}\n"
               ::"l"(ptr), "r"(*reinterpret_cast<uint32_t*>(&v)), "r"(static_cast<int>(pred))
               : "memory");
}

// keep the compiler from moving accumulator reads above a wgmma wait
template <int N> __device__ __forceinline__ void pin(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int BN>
__global__ void __launch_bounds__(kThreads, BN <= 32 ? 2 : 1) dil2_conv_stats_wgmma(const Args p) {
  constexpr int kG = kSlabs<BN>();
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t base = (raw + 1023u) & ~1023u;  // the weight's swizzle atoms are 1024-aligned
  uint8_t* const gen = smem_raw + (base - raw);  // the same bytes, generic address
  const int tid = threadIdx.x;
  const int n = p.n, ci = p.ci, co = p.co, q = ci / 8, ty = p.ty, tz = p.tz;
  const int hy = ty + 2, hz = tz + 2;  // halo extents in y and z
  const Layout L = layout(ci, p.kp, ty, tz, BN);
  const int nbx = (n + kTX - 1) / kTX, nby = (n + ty - 1) / ty;
  const int nbricks = nbx * nby * ((n + tz - 1) / tz);
  const int col0 = blockIdx.y * BN;
  const int64_t ldy = 8LL * co;

  // the halo brick of item `it` (batch entry it / nbricks)
  const int vch = 8 * q;  // 16-byte chunks of a voxel: chunk c = p * q + j
  auto load_brick = [&](int it) {
    const int64_t b = it / nbricks;
    const int brick = it - static_cast<int>(b) * nbricks;
    const int bx = brick % nbx, by = (brick / nbx) % nby, bz = brick / (nbx * nby);
    const uint32_t dst0 = base + L.brick;
    for (int i = tid; i < kHX * hy * hz * vch; i += kThreads) {
      const int hv = i / vch, c = i - hv * vch;
      const int hx_ = hv % kHX, hy_ = (hv / kHX) % hy, hz_ = hv / (kHX * hy);
      const int gz = bz * tz - 1 + hz_, gy = by * ty - 1 + hy_, gx = bx * kTX - 1 + hx_;
      const bool ok = gz >= 0 && gz < n && gy >= 0 && gy < n && gx >= 0 && gx < n;
      const bf16* src = p.x;
      if (ok) src += (((b * n + gz) * n + gy) * n + gx) * (8LL * ci) + c * 8;
      const int sub = c / q, j = c - sub * q;
      cp_async16(dst0 + (hv * q + j) * 128 + sub * 16, src, ok);
    }
  };

  // the weight's column tile, once; the first brick
  const int wch = p.kp / 8;  // 16-byte chunks of a weight row
  for (int i = tid; i < BN * wch; i += kThreads) {
    const int r = i / wch, k8 = i - r * wch;
    cp_async16(base + (k8 >> 3) * BN * 128 + swz(r, k8 & 7),
               p.wt + static_cast<int64_t>(col0 + r) * p.kp + k8 * 8, true);
  }
  if (blockIdx.x < p.items) load_brick(blockIdx.x);
  cp_async_commit();
  // zeros past the 27 taps, and the k16 steps' descriptors for the slab at
  // the brick's first voxel: chunk k8 = 2 s + h of the K order is chunk k8
  // % q of tap k8 / q, at halo offset (dz * hy + dy) * 10 + dx from the
  // slab's first voxel. Entry s: the low words of A's and B's descriptors,
  // and what a slab's offset (in 16 bytes) multiplies into A's: 1, or 1 -
  // 2^16 where the second half lies past the 27 taps and LBO points at the
  // zero region, so that it shrinks as the start grows
  if (q % 2)
    for (int i = tid; i < L.vox / 2; i += kThreads)
      reinterpret_cast<uint4*>(gen + L.zero)[i] = make_uint4(0u, 0u, 0u, 0u);
  int4* steps = reinterpret_cast<int4*>(gen + L.steps);
  for (int s = tid; s < L.nsteps; s += kThreads) {
    int off[2];
    for (int h = 0; h < 2; ++h) {
      const int k8 = 2 * s + h, t = k8 / q, j = k8 - t * q;
      const int tap = ((t / 9) * hy + (t / 3) % 3) * kHX + t % 3;
      off[h] = t < 27 ? L.brick + (tap * q + j) * 128 : L.zero;
    }
    const bool past = off[1] == L.zero;
    const uint64_t a = desc_a(base + off[0], off[1] - off[0], L.vox);
    const uint64_t b = desc_b(base + (s >> 2) * BN * 128 + 32 * (s & 3));
    steps[s] = make_int4(static_cast<int>(a), static_cast<int>(b), past ? 1 - 65536 : 1, 0);
  }
  const uint32_t a_hi = static_cast<uint32_t>(desc_a(0, 0, L.vox) >> 32);
  const uint32_t b_hi = static_cast<uint32_t>(desc_b(0) >> 32);

  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int nslabs = ty * tz;
  // this thread's columns 8 (i / 2) + 2 (lane % 4) + i % 2 of sub-position
  // lane / 4: their bias, and their sums over the current batch entry
  float bias[BN / 4], cs1[BN / 4], cs2[BN / 4];
#pragma unroll
  for (int i = 0; i < BN / 4; ++i) {
    bias[i] = p.bias[col0 + 8 * (i >> 1) + 2 * (lane & 3) + (i & 1)];
    cs1[i] = cs2[i] = 0.f;
  }
  auto flush = [&](int64_t b) {  // the sums of batch entry b into s1, s2
#pragma unroll
    for (int i = 0; i < BN / 4; ++i) {
      const int64_t at =
          b * ldy + (lane >> 2) * co + col0 + 8 * (i >> 1) + 2 * (lane & 3) + (i & 1);
      atomicAdd(p.s1 + at, cs1[i]);
      atomicAdd(p.s2 + at, cs2[i]);
      cs1[i] = cs2[i] = 0.f;
    }
  };
  // kG slabs at a time, their wgmmas interleaved so that no two in a row
  // share an accumulator
  float acc[kG][BN / 2];
#pragma unroll
  for (int g = 0; g < kG; ++g)
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[g][i] = 0.f;

  int64_t cur_b = -1;
  for (int it = blockIdx.x; it < p.items; it += gridDim.x) {
    const int next = it + gridDim.x;
    cp_async_wait<0>();
    fence_proxy_async();  // this thread's copies and stores are visible to the async proxy
    __syncthreads();      // ... and everyone's
    const int64_t b = it / nbricks;
    const int brick = it - static_cast<int>(b) * nbricks;
    const int bx = brick % nbx, by = (brick / nbx) % nby, bz = brick / (nbx * nby);
    if (b != cur_b) {
      if (cur_b >= 0) flush(cur_b);
      cur_b = b;
    }

    // slabs (sz, sy) = the voxels (sz, sy, 0..7) of the brick; a group is
    // slabs slab0 .. slab0 + kG - 1 (past the last slab: the last again,
    // unstored, so that no wgmma sits in a branch)
    auto issue = [&](int slab0) {
      int d[kG];
#pragma unroll
      for (int g = 0; g < kG; ++g) {
        const int sl = min(slab0 + g, nslabs - 1);
        d[g] = ((sl / ty) * hy + sl % ty) * kHX * L.vox >> 4;
      }
      wgmma_fence();  // the accumulators' earlier reads before the wgmmas write them
#pragma unroll 2
      for (int s = 0; s < L.nsteps; ++s) {
        const int4 e = steps[s];
        const uint64_t bd = static_cast<uint64_t>(b_hi) << 32 | static_cast<uint32_t>(e.y);
#pragma unroll
        for (int g = 0; g < kG; ++g)
          Mma<BN>::run(acc[g], static_cast<uint64_t>(a_hi) << 32 |
                                   static_cast<uint32_t>(e.x + e.z * d[g]),
                       bd, s > 0);
      }
      wgmma_commit();
    };
    // warp w of the warpgroup holds rows 16w + lane/4 (+8) of the slab:
    // voxel x = 2w (+1), sub-position lane/4; lane % 4 holds columns 8i +
    // 2(lane % 4) + {0, 1}. No branch reads an accumulator (a divergent
    // read would make ptxas serialize the wgmmas): voxels past the volume
    // are masked out of the stores and the sums.
    auto epilogue = [&](float (&v)[BN / 2], int slab, bool live) {
      const int gz = bz * tz + slab / ty, gy = by * ty + slab % ty;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int gx = bx * kTX + 2 * warp + h;
        const bool ok = live && gz < n && gy < n && gx < n;
        const float m = ok ? 1.f : 0.f;
        bf16* yrow = p.y + (ok ? (((b * n + gz) * n + gy) * n + gx) * ldy : 0) +
                     (lane >> 2) * co + col0;
#pragma unroll
        for (int i = 0; i < BN / 8; ++i) {
          const float e0 = v[4 * i + 2 * h] + bias[2 * i];
          const float e1 = v[4 * i + 2 * h + 1] + bias[2 * i + 1];
          st_pred(yrow + 8 * i + 2 * (lane & 3), __floats2bfloat162_rn(e0, e1), ok);
          cs1[2 * i] += m * e0;
          cs1[2 * i + 1] += m * e1;
          cs2[2 * i] += m * e0 * e0;
          cs2[2 * i + 1] += m * e1 * e1;
        }
      }
    };
    // warpgroup wg takes the groups wg, wg + 2, ...; both run the same
    // count (one past the last group repeats it, unstored), so no branch
    // around a wgmma depends on the thread. No accumulator is read while
    // a wgmma is in flight (that too would serialize the wgmmas): the
    // other warpgroup, and the other block on the SM, fill the epilogue.
    const int ngroups = (nslabs + kG - 1) / kG, per_wg = (ngroups + 1) / 2;
    for (int i = 0; i < per_wg; ++i) {
      const int grp = min(wg + 2 * i, ngroups - 1);
      const bool live = wg + 2 * i < ngroups;
      issue(grp * kG);
      wgmma_wait<0>();
#pragma unroll
      for (int g = 0; g < kG; ++g) {
        pin(acc[g]);
        epilogue(acc[g], grp * kG + g, live && grp * kG + g < nslabs);
      }
    }
    __syncthreads();  // every wgmma has read this brick before it is refilled
    if (next < p.items) {
      load_brick(next);
      cp_async_commit();
    }
  }
  if (cur_b >= 0) flush(cur_b);
}

template <int BN>
int launch_bn(Args a, long long batch, cudaStream_t stream) {
  const int smem = layout(a.ci, a.kp, a.ty, a.tz, BN).bytes;
  if (smem > kSmemMax) return static_cast<int>(cudaErrorInvalidValue);
  const long long bricks = static_cast<long long>((a.n + kTX - 1) / kTX) *
                           ((a.n + a.ty - 1) / a.ty) * ((a.n + a.tz - 1) / a.tz);
  if (bricks * batch > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  if (batch == 0) return 0;
  a.items = static_cast<int>(bricks * batch);
  // persistent: as many blocks as fit on the card at once, shared out over
  // the column tiles. The shared-memory attribute, the SM count and the
  // occupancy are set and read again when the shared memory changes.
  static int sms = 0, last_smem = -1, per_sm = 0;
  if (smem != last_smem) {
    int dev = 0;
    cudaError_t e;
    if ((e = cudaFuncSetAttribute(dil2_conv_stats_wgmma<BN>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize, smem)) !=
            cudaSuccess ||
        (e = cudaGetDevice(&dev)) != cudaSuccess ||
        (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess ||
        (e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, dil2_conv_stats_wgmma<BN>,
                                                           kThreads, smem)) != cudaSuccess)
      return static_cast<int>(e);
    last_smem = smem;
  }
  const int ctiles = a.co / BN;
  const long long blocks = std::max(1LL, std::min<long long>(a.items, sms * std::max(per_sm, 1) /
                                                                          ctiles));
  dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(ctiles));
  dil2_conv_stats_wgmma<BN><<<grid, kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (B, n, n, n, 8 ci) bf16, ci a multiple of 8; wt (co, kp) bf16, the
// K-major weight: wt[o, t * ci + c] = w[t, c, o] for the 27 taps t = kd*9 +
// kh*3 + kw, zero for K in [27 ci, kp), kp = 27 ci rounded up to 64; bias
// (co,) f32; bricks of 8 x ty x tz output voxels (ty, tz in 1..8); bn the
// column tile (8, 16, 32 or 64, dividing co). y (B, n, n, n, 8 co) bf16;
// s1, s2 (B, 8 co) f32, zeroed. Returns a cudaError_t value.
extern "C" int airseg_dil2_wgmma(const void* x, int ci, const void* wt, int kp, const float* bias,
                                 void* y, float* s1, float* s2, long long batch, int n, int co,
                                 int ty, int tz, int bn, void* stream) {
  if (n <= 0 || ci <= 0 || ci % 8 || kp != (27 * ci + 63) / 64 * 64 || co <= 0 || ty < 1 ||
      ty > 8 || tz < 1 || tz > 8 || (bn != 8 && bn != 16 && bn != 32 && bn != 64) || co % bn ||
      !s1 || !s2 || batch < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{static_cast<const bf16*>(x), static_cast<const bf16*>(wt), bias,
         static_cast<bf16*>(y), s1, s2, n, ci, co, kp, ty, tz, 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bn == 8) return launch_bn<8>(a, batch, s);
  if (bn == 16) return launch_bn<16>(a, batch, s);
  if (bn == 32) return launch_bn<32>(a, batch, s);
  return launch_bn<64>(a, batch, s);
}

// The dynamic shared memory, in bytes, of a launch with these widths and tile.
extern "C" int airseg_dil2_wgmma_smem(int ci, int ty, int tz, int bn) {
  return layout(ci, (27 * ci + 63) / 64 * 64, ty, tz, bn).bytes;
}

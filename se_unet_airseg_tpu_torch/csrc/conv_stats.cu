// Convolution + InstanceNorm statistics of the s2d SE-UNet blocks, and the
// phased conv to its ungathered output, in float32 for Hopper (sm_90a).
//
// Replaces, in float32, the Pallas TPU kernels of
// se_unet_airseg_tpu/ops/pallas_s2d.py (bf16: conv_wgmma.cu for the
// phased, dense dil-2 and ungathered forms, dil2_wgmma.cu for the dil-2
// form):
//   phased conv stats: phased_conv_stats (_pallas_forward, _phased_kernel):
//     the pad-1 3^3 conv of the full-resolution grid on its s2d fold,
//     written as a 2^3 block conv whose output phase q = (a, b, c) reads
//     x at the block offset (a + sz - 1, b + sy - 1, c + sx - 1) for tap
//     s = (sz, sy, sx); y[..., q*Co + o] = bias + sum_s sum_c x * w_all[s, c, q*Co + o];
//   dil-2 conv stats: dil2_conv_stats (_pallas_dil2_forward, _dil2_kernel):
//     the dilation-2 3^3 conv on the s2d fold as 8 independent dil-1 convs,
//     one per sub-position p, all with the same (27*Ci, Co) kernel;
//     y[..., p*Co + o] = bias + sum_t sum_c x[voxel + t - 1, p*Ci + c] * w[t, c, o];
//   dense dil-2 conv stats: dil2_conv_stats_bm (_dil2_kernel_bm): the dense
//     pad-1 3^3 conv of the s2d tensor with any (27*C8, C8o) kernel, with
//     the sums;
//   ungathered phased conv: phased_conv_ext_bm (_pconv_kernel_bm) and its
//     k-grid form (_pconv_kgrid_kernel_bm): the 2^3 block conv to the
//     (n+1)^3 output grid, y_ext[v'] = bias + sum_s sum_c x[v' + s - 1, c] *
//     w_all[s, c, :], the same offsets for every output column, no sums.
// The statistics forms also emit s1, s2 (B, 8Co) f32: the sums of y and y^2
// over the voxels, taken after the bias, as the Pallas kernels do.
//
// One kernel serves all four: an implicit GEMM per group g (phase q or
// sub-position p; the dense and ungathered forms have one group of all
// output columns), M = the output voxels of one batch entry, N = the
// group's columns, K = taps x input lanes. A block computes 128 voxels x BN
// columns of one group; the A operand is gathered from x by tap offset with
// zero fill at the volume's edge (no padded copy of x), in 16-byte cp.async
// vectors through a 3-stage shared-memory ring. The phased forms may read
// two input tensors (a plain channel concat) through two base pointers.
// Each thread owns one row and all BN columns of an FMA loop over the
// tiles. The statistics reduce in registers, then over the warp (shuffles)
// and the block (shared memory), then one atomicAdd per (batch, channel)
// per block into s1/s2, which the caller zeroes. The sums' order differs
// from the TPU's.
//
// Bound: operations, at the H100's 67 TFLOP/s outside the tensor cores.
// The groups of one voxel tile run as neighbouring blocks, so x comes from
// device memory about once, and each x vector is read into shared memory
// once per (group, column tile, tap) that uses it, mostly from L2.
// Offsets are 64-bit. The kernels allocate nothing, launch on the caller's
// stream and report launch errors through cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // 4 warps
constexpr int kBM = 128;       // voxels per block (32 per warp)
constexpr int kStages = 3;

// the tap geometry: which input voxel a tap of a group reads
enum Form { kPhased, kDil2, kExt };
__host__ __device__ constexpr int taps(int form) { return form == kDil2 ? 27 : 8; }

struct Args {
  const void* x0;     // (B, n, n, n, c0)
  const void* x1;     // (B, n, n, n, c1) or x0 when c1 == 0
  int c0, c1;         // lanes of x0 and x1; input lane l < c0 reads x0, else x1
  int glane;          // input lane offset of group g: g * glane
  int cg;             // input lanes per tap
  const void* w;      // (taps * cg, ldw) row-major
  int ldw, wcol;      // group g's columns start at g * wcol
  const float* bias;  // bias of group g, channel o: bias[g * bcol + o]
  int bcol;
  void* y;            // (B, m, m, m, groups * co)
  float* s1;          // (B, groups * co), zeroed by the caller; null: no sums
  float* s2;
  int n, m;           // input and output grid per axis
  int groups, co;     // groups of co output columns each
};

constexpr int kV = 4;  // floats per 16-byte vector

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int size = valid ? 16 : 0;  // 0: fill the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem),
               "r"(size));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// block offset of tap t for group g, in each of z, y, x
template <int kForm>
__device__ __forceinline__ void tap_offset(int g, int t, int& dz, int& dy, int& dx) {
  if (kForm == kPhased) {  // phase g = (a, b, c), tap t = (sz, sy, sx)
    dz = ((g >> 2) & 1) + ((t >> 2) & 1) - 1;
    dy = ((g >> 1) & 1) + ((t >> 1) & 1) - 1;
    dx = (g & 1) + (t & 1) - 1;
  } else if (kForm == kExt) {  // output voxel v' reads v' + s - 1
    dz = ((t >> 2) & 1) - 1;
    dy = ((t >> 1) & 1) - 1;
    dx = (t & 1) - 1;
  } else {  // dil-2: tap t = (dz, dy, dx) of a 3^3 kernel, every group alike
    dz = t / 9 - 1;
    dy = (t / 3) % 3 - 1;
    dx = t % 3 - 1;
  }
}

template <int BN>
struct Smem {
  static constexpr int BK = 4 * kV;      // 64 bytes of K per row and stage
  static constexpr int AS = BK + kV;     // row strides padded by 16 bytes:
  static constexpr int BS = BN + kV;     // conflict-free float4 reads
  float a[kStages][kBM][AS];
  float b[kStages][BK][BS];
  float red[kThreads / 32][BN][2];
};

// Start the cp.async loads of k-tile kt into ring stage st; rz/ry/rx are
// the output coordinates of this thread's 4 loader rows.
template <int BN, int kForm>
__device__ __forceinline__ void load_tile(Smem<BN>& sm, const Args& p, int st, int kt, int g,
                                          int ct, int64_t batch_vox, const int (&rz)[4],
                                          const int (&ry)[4], const int (&rx)[4]) {
  constexpr int V = kV;
  constexpr int BK = Smem<BN>::BK;
  const int tid = threadIdx.x;
  const int ktot = taps(kForm) * p.cg;
  const int n = p.n;
  // A: this thread's 4 rows, vector column tid % 4
  {
    const int vc = tid & 3;
    const int k = kt * BK + vc * V;
    const bool kin = k < ktot;
    int t = 0, c = 0, dz = 0, dy = 0, dx = 0;
    if (kin) {
      t = k / p.cg;
      c = k - t * p.cg;
      tap_offset<kForm>(g, t, dz, dy, dx);
    }
    const int lane = g * p.glane + c;
    const bool second = lane >= p.c0;
    const float* base = static_cast<const float*>(second ? p.x1 : p.x0);
    const int stride = second ? p.c1 : p.c0;
    const int loff = second ? lane - p.c0 : lane;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = (tid >> 2) + 32 * i;
      const int z = rz[i] + dz, yy = ry[i] + dy, x = rx[i] + dx;
      const bool ok = kin && rz[i] >= 0 && z >= 0 && z < n && yy >= 0 && yy < n && x >= 0 &&
                      x < n;
      const float* src = static_cast<const float*>(p.x0);
      if (ok)
        src = base + (batch_vox + (static_cast<int64_t>(z) * n + yy) * n + x) * stride + loff;
      cp_async16(&sm.a[st][r][vc * V], src, ok);
    }
  }
  // B: BK rows x BN columns of group g's weight columns
  constexpr int kVecRow = BN / V;
  for (int idx = tid; idx < BK * kVecRow; idx += kThreads) {
    const int kr = idx / kVecRow, cv = idx - kr * kVecRow;
    const int k = kt * BK + kr;
    const int col = ct * BN + cv * V;
    const bool ok = k < ktot && col < p.co;
    const float* src = static_cast<const float*>(p.w);
    if (ok) src += static_cast<int64_t>(k) * p.ldw + g * p.wcol + col;
    cp_async16(&sm.b[st][kr][cv * V], src, ok);
  }
}

// The per-thread accumulator, the math on one stage and the statistics'
// reduction: thread t owns row t and all BN columns, with per-column partial
// sums c1/c2.
template <int BN> struct Core {
  static constexpr int NS = BN;
  float acc[BN];
  float c1[NS], c2[NS];
  __device__ void zero() {
#pragma unroll
    for (int j = 0; j < BN; ++j) acc[j] = 0.f;
  }
  __device__ void step(const Smem<BN>& sm, int st) {
    const int r = threadIdx.x;
#pragma unroll
    for (int k4 = 0; k4 < Smem<BN>::BK; k4 += 4) {
      const float4 a = *reinterpret_cast<const float4*>(&sm.a[st][r][k4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int j = 0; j < BN; ++j) acc[j] = fmaf(av[kk], sm.b[st][k4 + kk][j], acc[j]);
    }
  }
  template <typename F> __device__ void each(F fn) {
#pragma unroll
    for (int j = 0; j < BN; j += 2) fn(static_cast<int>(threadIdx.x), j, j, acc[j], acc[j + 1]);
  }
  __device__ void reduce(Smem<BN>& sm) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
    for (int j = 0; j < BN; ++j) {
      float u = c1[j], v = c2[j];
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        u += __shfl_xor_sync(0xffffffffu, u, off);
        v += __shfl_xor_sync(0xffffffffu, v, off);
      }
      if (lane == 0) {
        sm.red[warp][j][0] = u;
        sm.red[warp][j][1] = v;
      }
    }
  }
};

__device__ __forceinline__ void store2(float* dst, float v0, float v1) {
  *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
}

template <int BN, int kForm>
__global__ void __launch_bounds__(kThreads) conv_stats_kernel(const Args p) {
  __shared__ __align__(16) Smem<BN> sm;
  const int ctiles = (p.co + BN - 1) / BN;
  const int g = blockIdx.x / ctiles;   // group: phase q or sub-position p
  const int ct = blockIdx.x - g * ctiles;
  const int tile = blockIdx.y;
  const int64_t b = blockIdx.z;
  const int m = p.m;
  const int64_t n3 = static_cast<int64_t>(p.n) * p.n * p.n;
  const int64_t m3 = static_cast<int64_t>(m) * m * m;
  const int64_t vox0 = static_cast<int64_t>(tile) * kBM;

  // output coordinates of this thread's 4 loader rows (rz < 0: past the
  // volume)
  int rz[4], ry[4], rx[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t v = vox0 + (threadIdx.x >> 2) + 32 * i;
    if (v < m3) {
      rz[i] = static_cast<int>(v / (static_cast<int64_t>(m) * m));
      const int rem = static_cast<int>(v - static_cast<int64_t>(rz[i]) * m * m);
      ry[i] = rem / m;
      rx[i] = rem - ry[i] * m;
    } else {
      rz[i] = -1;
      ry[i] = rx[i] = 0;
    }
  }

  const int ktiles = (taps(kForm) * p.cg + Smem<BN>::BK - 1) / Smem<BN>::BK;
  const int64_t batch_vox = b * n3;  // first input voxel of batch entry b
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < ktiles) load_tile<BN, kForm>(sm, p, s, s, g, ct, batch_vox, rz, ry, rx);
    cp_async_commit();
  }
  Core<BN> core;
  core.zero();
  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // tile kt landed; every thread is done with tile kt-1's stage
    const int nk = kt + kStages - 1;
    if (nk < ktiles) load_tile<BN, kForm>(sm, p, nk % kStages, nk, g, ct, batch_vox, rz, ry, rx);
    cp_async_commit();
    core.step(sm, kt % kStages);
  }
  cp_async_wait<0>();

  // epilogue: bias in f32, statistics from the f32 values, y rounded once
  const int ldy = p.groups * p.co;
  const bool sums = p.s1 != nullptr;  // the same for every thread
  float* y = static_cast<float*>(p.y);
#pragma unroll
  for (int s = 0; s < Core<BN>::NS; ++s) core.c1[s] = core.c2[s] = 0.f;
  core.each([&](int row, int col, int s, float v0, float v1) {
    const int gc = ct * BN + col;
    const int64_t v = vox0 + row;
    if (gc >= p.co || v >= m3) return;  // co % 8 == 0: the pair is in or out
    v0 += p.bias[g * p.bcol + gc];
    v1 += p.bias[g * p.bcol + gc + 1];
    store2(y + (b * m3 + v) * ldy + g * p.co + gc, v0, v1);
    if (sums) {
      core.c1[s] += v0;
      core.c1[s + 1] += v1;
      core.c2[s] += v0 * v0;
      core.c2[s + 1] += v1 * v1;
    }
  });
  if (!sums) return;
  core.reduce(sm);
  __syncthreads();
  for (int j = threadIdx.x; j < BN; j += kThreads) {
    const int gc = ct * BN + j;
    if (gc >= p.co) continue;
    float u = 0.f, w = 0.f;
#pragma unroll
    for (int wp = 0; wp < kThreads / 32; ++wp) {
      u += sm.red[wp][j][0];
      w += sm.red[wp][j][1];
    }
    atomicAdd(p.s1 + b * ldy + g * p.co + gc, u);
    atomicAdd(p.s2 + b * ldy + g * p.co + gc, w);
  }
}

template <int BN, int kForm>
int launch_bn(const Args& a, long long batch, cudaStream_t stream) {
  const int64_t m3 = static_cast<int64_t>(a.m) * a.m * a.m;
  const int64_t tiles = (m3 + kBM - 1) / kBM;
  const int ctiles = (a.co + BN - 1) / BN;
  if (tiles > 65535 || batch > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
  if (tiles == 0 || batch == 0) return 0;
  dim3 grid(a.groups * ctiles, static_cast<unsigned>(tiles), static_cast<unsigned>(batch));
  conv_stats_kernel<BN, kForm><<<grid, kThreads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int kForm>
int launch(const Args& a, long long batch, cudaStream_t stream) {
  const bool aligned = a.c0 % kV == 0 && a.c1 % kV == 0 && a.cg % kV == 0 && a.glane % kV == 0 &&
                       a.co % 8 == 0 && a.ldw % kV == 0 && a.wcol % kV == 0 && a.n > 0 &&
                       a.co > 0 && a.cg > 0;
  if (!aligned) return static_cast<int>(cudaErrorInvalidValue);
  if (a.co <= 16) return launch_bn<16, kForm>(a, batch, stream);
  if (a.co <= 32) return launch_bn<32, kForm>(a, batch, stream);
  return launch_bn<64, kForm>(a, batch, stream);
}

}  // namespace

// dtype 0 (float32) only: every entry refuses another dtype (bf16 is
// conv_wgmma.cu or dil2_wgmma.cu). Each returns a cudaError_t value.
// x0 (B, n, n, n, c0) and x1 (B, n, n, n, c1) form a plain channel concat
// of Cin = c0 + c1 lanes (c1 = 0: x0 alone); w_all (8, Cin, 8Co) with taps
// s = sz*4 + sy*2 + sx; b_all (8Co,).
extern "C" int airseg_phased_conv_stats(int dtype, const void* x0, int c0, const void* x1, int c1,
                                        const void* w_all, const float* b_all, void* y,
                                        float* s1, float* s2, long long batch, int n, int co,
                                        void* stream) {
  if (dtype != 0) return static_cast<int>(cudaErrorInvalidValue);
  Args a{x0, c1 ? x1 : x0, c0, c1, 0, c0 + c1, w_all, 8 * co, co, b_all, co, y, s1, s2,
         n, n, 8, co};
  return launch<kPhased>(a, batch, static_cast<cudaStream_t>(stream));
}

// x (B, n, n, n, 8Ci); w (3, 3, 3, Ci, Co); b (Co,).
extern "C" int airseg_dil2_conv_stats(int dtype, const void* x, int ci, const void* w,
                                      const float* b, void* y, float* s1, float* s2,
                                      long long batch, int n, int co, void* stream) {
  if (dtype != 0) return static_cast<int>(cudaErrorInvalidValue);
  Args a{x, x, 8 * ci, 0, ci, ci, w, co, 0, b, 0, y, s1, s2, n, n, 8, co};
  return launch<kDil2>(a, batch, static_cast<cudaStream_t>(stream));
}

// x (B, n, n, n, c8); wd (3, 3, 3, c8, c8o), any dense kernel; bg (c8o,).
// y (B, n, n, n, c8o), s1, s2 (B, c8o).
extern "C" int airseg_dil2_dense_conv_stats(int dtype, const void* x, int c8, const void* wd,
                                            const float* bg, void* y, float* s1, float* s2,
                                            long long batch, int n, int c8o, void* stream) {
  if (dtype != 0) return static_cast<int>(cudaErrorInvalidValue);
  Args a{x, x, c8, 0, 0, c8, wd, c8o, 0, bg, 0, y, s1, s2, n, n, 1, c8o};
  return launch<kDil2>(a, batch, static_cast<cudaStream_t>(stream));
}

// x0, x1 as for airseg_phased_conv_stats; w_all (8, c0 + c1, c8o); b_all
// (c8o,). y (B, n+1, n+1, n+1, c8o), no sums.
extern "C" int airseg_phased_conv_ext(int dtype, const void* x0, int c0, const void* x1, int c1,
                                      const void* w_all, const float* b_all, void* y,
                                      long long batch, int n, int c8o, void* stream) {
  if (dtype != 0) return static_cast<int>(cudaErrorInvalidValue);
  Args a{x0, c1 ? x1 : x0, c0, c1, 0, c0 + c1, w_all, c8o, 0, b_all, 0, y, nullptr, nullptr,
         n, n + 1, 1, c8o};
  return launch<kExt>(a, batch, static_cast<cudaStream_t>(stream));
}

// Convolution + InstanceNorm statistics of the s2d SE-UNet blocks, and the
// phased conv to its ungathered output, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of se_unet_airseg_tpu/ops/pallas_s2d.py:
//   phased conv stats: phased_conv_stats (_pallas_forward, _phased_kernel):
//     the pad-1 3^3 conv of the full-resolution grid on its s2d fold,
//     written as a 2^3 block conv whose output phase q = (a, b, c) reads
//     x at the block offset (a + sz - 1, b + sy - 1, c + sx - 1) for tap
//     s = (sz, sy, sx); y[..., q*Co + o] = bias + sum_s sum_c x * w_all[s, c, q*Co + o];
//     float32 only here: the bf16 form is conv_wgmma.cu;
//   dil-2 conv stats: dil2_conv_stats (_pallas_dil2_forward, _dil2_kernel):
//     the dilation-2 3^3 conv on the s2d fold as 8 independent dil-1 convs,
//     one per sub-position p, all with the same (27*Ci, Co) kernel;
//     y[..., p*Co + o] = bias + sum_t sum_c x[voxel + t - 1, p*Ci + c] * w[t, c, o];
//   dense dil-2 conv stats: dil2_conv_stats_bm (_dil2_kernel_bm): the dense
//     pad-1 3^3 conv of the s2d tensor with any (27*C8, C8o) kernel (the
//     model passes the block-diagonal lift of the dil-2 kernel and pays its
//     8x structural-zero FLOPs, as the TPU kernel does), with the sums;
//     float32 only here: the bf16 form is conv_wgmma.cu;
//   ungathered phased conv: phased_conv_ext_bm (_pconv_kernel_bm) and its
//     k-grid form (_pconv_kgrid_kernel_bm): the 2^3 block conv to the
//     (n+1)^3 output grid, y_ext[v'] = bias + sum_s sum_c x[v' + s - 1, c] *
//     w_all[s, c, :], the same offsets for every output column, no sums;
//     float32 only here: the bf16 form is conv_wgmma.cu.
// The statistics forms also emit s1, s2 (B, 8Co) f32: the sums of y and y^2
// over the voxels, taken from the f32 accumulator after the bias and before
// y is rounded to its storage type, as the Pallas kernels do.
//
// One kernel serves all four: an implicit GEMM per group g (phase q or
// sub-position p; the dense and ungathered forms have one group of all
// output columns), M = the output voxels of one batch entry, N = the
// group's columns, K = taps x input lanes. A block computes 128 voxels x BN
// columns of one group; the A operand is gathered from x by tap offset with
// zero fill at the volume's edge (no padded copy of x), in 16-byte cp.async
// vectors through a 3-stage shared-memory ring. The phased forms may read
// two input tensors (a plain channel concat) through two base pointers.
// bf16: mma.sync m16n8k16 on the tensor cores with f32 accumulation
// (ldmatrix fragments); f32: an FMA loop on the same tiles. The statistics
// reduce in registers, then over the warp (shuffles) and the block (shared
// memory), then one atomicAdd per (batch, channel) per block into s1/s2,
// which the caller zeroes. The sums' order differs from the TPU's.
//
// Bound: operations. Per 8-tile batch of 128^3 tiles the calls do 116 to
// 4600 GFLOP against 268 to 3221 MB moved, 290 to 2700 flops per byte, at
// or above the H100's ~295 bf16 flops-per-byte ridge. The design is the
// simple one: the groups of one voxel tile run as neighbouring blocks, so
// x comes from device memory about once, and each x vector is read into
// shared memory once per (group, column tile, tap) that uses it, mostly
// from L2. The bf16 phased, dense dil-2 and ungathered forms moved to the
// wgmma kernels of conv_wgmma.cu; the bf16 dil-2 form (K9) stays here.
// Offsets are 64-bit. The kernels allocate nothing, launch on the caller's
// stream and report launch errors through cudaGetLastError().

#include <cuda_bf16.h>
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

template <typename T> struct Vec;
template <> struct Vec<float> { static constexpr int N = 4; };
template <> struct Vec<__nv_bfloat16> { static constexpr int N = 8; };

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

template <typename T, int BN>
struct Smem {
  static constexpr int V = Vec<T>::N;
  static constexpr int BK = 4 * V;       // 64 bytes of K per row and stage
  static constexpr int AS = BK + V;      // row strides padded by 16 bytes:
  static constexpr int BS = BN + V;      // conflict-free ldmatrix / float4 reads
  T a[kStages][kBM][AS];
  T b[kStages][BK][BS];
  float red[kThreads / 32][BN][2];
};

// Start the cp.async loads of k-tile kt into ring stage st; rz/ry/rx are
// the output coordinates of this thread's 4 loader rows.
template <typename T, int BN, int kForm>
__device__ __forceinline__ void load_tile(Smem<T, BN>& sm, const Args& p, int st, int kt, int g,
                                          int ct, int64_t batch_vox, const int (&rz)[4],
                                          const int (&ry)[4], const int (&rx)[4]) {
  constexpr int V = Vec<T>::N;
  constexpr int BK = Smem<T, BN>::BK;
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
    const T* base = static_cast<const T*>(second ? p.x1 : p.x0);
    const int stride = second ? p.c1 : p.c0;
    const int loff = second ? lane - p.c0 : lane;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = (tid >> 2) + 32 * i;
      const int z = rz[i] + dz, yy = ry[i] + dy, x = rx[i] + dx;
      const bool ok = kin && rz[i] >= 0 && z >= 0 && z < n && yy >= 0 && yy < n && x >= 0 &&
                      x < n;
      const T* src = static_cast<const T*>(p.x0);
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
    const T* src = static_cast<const T*>(p.w);
    if (ok) src += static_cast<int64_t>(k) * p.ldw + g * p.wcol + col;
    cp_async16(&sm.b[st][kr][cv * V], src, ok);
  }
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The per-thread accumulator, the math on one stage and the statistics'
// reduction; specialised by type. Each thread keeps per-column partial sums
// c1/c2 in NS slots, one per tile column it owns.
template <typename T, int BN> struct Core;

// bf16: warp w owns rows 32w..32w+31 (two m16 tiles) and all BN columns;
// lane l holds columns j*8 + 2(l%4) + {0, 1} of rows l/4 (+8, +16, +24)
template <int BN> struct Core<__nv_bfloat16, BN> {
  using T = __nv_bfloat16;
  static constexpr int NS = BN / 4;
  float acc[2][BN / 8][4];
  float c1[NS], c2[NS];
  __device__ void zero() {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  }
  __device__ void step(const Smem<T, BN>& sm, int st) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
    for (int ks = 0; ks < Smem<T, BN>::BK / 16; ++ks) {
      uint32_t a[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        ldmatrix_x4(a[mi], &sm.a[st][warp * 32 + mi * 16 + (lane & 15)][ks * 16 + (lane >> 4) * 8]);
#pragma unroll
      for (int nj = 0; nj < BN / 16; ++nj) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, &sm.b[st][ks * 16 + (lane & 15)][nj * 16 + (lane >> 4) * 8]);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          mma_bf16(acc[mi][2 * nj], a[mi], b[0], b[1]);
          mma_bf16(acc[mi][2 * nj + 1], a[mi], b[2], b[3]);
        }
      }
    }
  }
  // fn(row in block, even column in tile, its slot, value there, value at
  // column + 1, whose slot is the next)
  template <typename F> __device__ void each(F fn) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          fn(warp * 32 + mi * 16 + (lane >> 2) + 8 * h, j * 8 + (lane & 3) * 2, 2 * j,
             acc[mi][j][2 * h], acc[mi][j][2 * h + 1]);
  }
  // the warp's column totals into sm.red[warp]
  __device__ void reduce(Smem<T, BN>& sm) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      float u = c1[s], v = c2[s];
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {  // over the 8 row groups
        u += __shfl_xor_sync(0xffffffffu, u, off);
        v += __shfl_xor_sync(0xffffffffu, v, off);
      }
      if (lane < 4) {
        const int col = (s >> 1) * 8 + lane * 2 + (s & 1);
        sm.red[warp][col][0] = u;
        sm.red[warp][col][1] = v;
      }
    }
  }
};

// f32: thread t owns row t and all BN columns
template <int BN> struct Core<float, BN> {
  using T = float;
  static constexpr int NS = BN;
  float acc[BN];
  float c1[NS], c2[NS];
  __device__ void zero() {
#pragma unroll
    for (int j = 0; j < BN; ++j) acc[j] = 0.f;
  }
  __device__ void step(const Smem<T, BN>& sm, int st) {
    const int r = threadIdx.x;
#pragma unroll
    for (int k4 = 0; k4 < Smem<T, BN>::BK; k4 += 4) {
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
  __device__ void reduce(Smem<T, BN>& sm) {
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
__device__ __forceinline__ void store2(__nv_bfloat16* dst, float v0, float v1) {
  *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(v0, v1);
}

template <typename T, int BN, int kForm>
__global__ void __launch_bounds__(kThreads) conv_stats_kernel(const Args p) {
  __shared__ __align__(16) Smem<T, BN> sm;
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

  const int ktiles = (taps(kForm) * p.cg + Smem<T, BN>::BK - 1) / Smem<T, BN>::BK;
  const int64_t batch_vox = b * n3;  // first input voxel of batch entry b
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < ktiles) load_tile<T, BN, kForm>(sm, p, s, s, g, ct, batch_vox, rz, ry, rx);
    cp_async_commit();
  }
  Core<T, BN> core;
  core.zero();
  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // tile kt landed; every thread is done with tile kt-1's stage
    const int nk = kt + kStages - 1;
    if (nk < ktiles) load_tile<T, BN, kForm>(sm, p, nk % kStages, nk, g, ct, batch_vox, rz, ry, rx);
    cp_async_commit();
    core.step(sm, kt % kStages);
  }
  cp_async_wait<0>();

  // epilogue: bias in f32, statistics from the f32 values, y rounded once
  const int ldy = p.groups * p.co;
  const bool sums = p.s1 != nullptr;  // the same for every thread
  T* y = static_cast<T*>(p.y);
#pragma unroll
  for (int s = 0; s < Core<T, BN>::NS; ++s) core.c1[s] = core.c2[s] = 0.f;
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

template <typename T, int BN, int kForm>
int launch_bn(const Args& a, long long batch, cudaStream_t stream) {
  const int64_t m3 = static_cast<int64_t>(a.m) * a.m * a.m;
  const int64_t tiles = (m3 + kBM - 1) / kBM;
  const int ctiles = (a.co + BN - 1) / BN;
  if (tiles > 65535 || batch > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
  if (tiles == 0 || batch == 0) return 0;
  dim3 grid(a.groups * ctiles, static_cast<unsigned>(tiles), static_cast<unsigned>(batch));
  conv_stats_kernel<T, BN, kForm><<<grid, kThreads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int kForm>
int launch(const Args& a, long long batch, cudaStream_t stream) {
  constexpr int V = Vec<T>::N;
  const bool aligned = a.c0 % V == 0 && a.c1 % V == 0 && a.cg % V == 0 && a.glane % V == 0 &&
                       a.co % 8 == 0 && a.ldw % V == 0 && a.wcol % V == 0 && a.n > 0 &&
                       a.co > 0 && a.cg > 0;
  if (!aligned) return static_cast<int>(cudaErrorInvalidValue);
  if (a.co <= 16) return launch_bn<T, 16, kForm>(a, batch, stream);
  if (a.co <= 32) return launch_bn<T, 32, kForm>(a, batch, stream);
  return launch_bn<T, 64, kForm>(a, batch, stream);
}

template <int kForm>
int launch_dtype(int dtype, const Args& a, long long batch, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float, kForm>(a, batch, s);
  if (dtype == 1) return launch<__nv_bfloat16, kForm>(a, batch, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t value.
// x0 (B, n, n, n, c0) and x1 (B, n, n, n, c1) form a plain channel concat
// of Cin = c0 + c1 lanes (c1 = 0: x0 alone); w_all (8, Cin, 8Co) in x's
// type with taps s = sz*4 + sy*2 + sx; b_all (8Co,) f32.
extern "C" int airseg_phased_conv_stats(int dtype, const void* x0, int c0, const void* x1, int c1,
                                        const void* w_all, const float* b_all, void* y,
                                        float* s1, float* s2, long long batch, int n, int co,
                                        void* stream) {
  if (dtype != 0) return static_cast<int>(cudaErrorInvalidValue);  // bf16: conv_wgmma.cu
  Args a{x0, c1 ? x1 : x0, c0, c1, 0, c0 + c1, w_all, 8 * co, co, b_all, co, y, s1, s2,
         n, n, 8, co};
  return launch<float, kPhased>(a, batch, static_cast<cudaStream_t>(stream));
}

// x (B, n, n, n, 8Ci); w (3, 3, 3, Ci, Co) in x's type; b (Co,) f32.
extern "C" int airseg_dil2_conv_stats(int dtype, const void* x, int ci, const void* w,
                                      const float* b, void* y, float* s1, float* s2,
                                      long long batch, int n, int co, void* stream) {
  Args a{x, x, 8 * ci, 0, ci, ci, w, co, 0, b, 0, y, s1, s2, n, n, 8, co};
  return launch_dtype<kDil2>(dtype, a, batch, stream);
}

// dtype 0 (float32) only: bf16 is conv_wgmma.cu. x (B, n, n, n, c8); wd
// (3, 3, 3, c8, c8o), any dense kernel; bg (c8o,). y (B, n, n, n, c8o), s1,
// s2 (B, c8o).
extern "C" int airseg_dil2_dense_conv_stats(int dtype, const void* x, int c8, const void* wd,
                                            const float* bg, void* y, float* s1, float* s2,
                                            long long batch, int n, int c8o, void* stream) {
  if (dtype != 0) return static_cast<int>(cudaErrorInvalidValue);
  Args a{x, x, c8, 0, 0, c8, wd, c8o, 0, bg, 0, y, s1, s2, n, n, 1, c8o};
  return launch<float, kDil2>(a, batch, static_cast<cudaStream_t>(stream));
}

// dtype 0 (float32) only: bf16 is conv_wgmma.cu. x0, x1 as for
// airseg_phased_conv_stats; w_all (8, c0 + c1, c8o); b_all (c8o,). y (B,
// n+1, n+1, n+1, c8o), no sums.
extern "C" int airseg_phased_conv_ext(int dtype, const void* x0, int c0, const void* x1, int c1,
                                      const void* w_all, const float* b_all, void* y,
                                      long long batch, int n, int c8o, void* stream) {
  if (dtype != 0) return static_cast<int>(cudaErrorInvalidValue);
  Args a{x0, c1 ? x1 : x0, c0, c1, 0, c0 + c1, w_all, c8o, 0, b_all, 0, y, nullptr, nullptr,
         n, n + 1, 1, c8o};
  return launch<float, kExt>(a, batch, static_cast<cudaStream_t>(stream));
}

// Fused conv epilogue of the s2d SE-UNet blocks, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of se_unet_airseg_tpu/ops/pallas_s2d.py:
//   gathered epilogue: gated_norm_finalize_bm and gated_norm_finalize;
//   phased epilogue:   phased_finalize_bm and phased_finalize;
//   phased normalize:  phased_normalize (the phased body with relu=False and
//                      no gates): the phase gather and the InstanceNorm affine
//                      alone, a = dtype(f32(y) * scale8 - shift8), the
//                      normalized pre-activation that the phased block's
//                      backward reads. Same body, activation compiled out.
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
// The phased form reads the conv's UNGATHERED (nz+1, n+1, n+1) output:
// sub-position q = (a, b, c) of output voxel (z, y, x) comes from
// y_ext[z+a, y+b, x+c] in lane block q. The gathered tensor never reaches
// device memory. Each form takes a depth extent nz beside the extent n of y
// and x: a cube is nz = n, a depth slab of the mesh's `space` axis
// (parallel/mesh.py) has nz = n / n_space.
//
// Bound: device memory. Each kernel reads one input element per output
// element (the phased forms only their 8 shifted n^3 windows of y_ext's
// (n+1)^3 voxels) and writes the output once; the arithmetic is a few
// flops per byte, far below the H100's ~295 bf16 flops/byte ridge. What
// bounds such a kernel is instructions and L1 traffic per byte and the
// bytes in flight, so both designs are persistent:
//   * persistent blocks of 256 threads walk output tiles in a fixed order:
//     a tile is T voxels along x at one (b, z, y) (phased) or T rows of one
//     batch entry (gathered), all 8C lanes; T from `tile_voxels` (about
//     16 KB of rows). A tile is decomposed once, in 32-bit arithmetic;
//     only the element offsets are 64-bit (dc5's y_ext at batch 8 holds
//     5.6e8 elements). The grid is one wave (resident blocks per SM x SMs,
//     asked of the runtime once per kernel and ring size);
//   * a thread owns one 16-byte vector column of the row for the whole
//     kernel: its scale8/shift8 lanes and its SE weight lanes sit in
//     registers, reloaded only when the batch entry changes;
//   * the gather reads y_ext either with 16-byte loads, kRows rows in
//     flight per thread (`persistent_ldg_kernel`; phased reads ask L2 for
//     the 256-byte block), or, for the phased forms, through TMA
//     (`persistent_tma_kernel`): per tile 4 boxes of (T+1 voxels x 2C
//     lanes), one per (a, b) row (lane blocks (a, b, 0) and (a, b, 1) are
//     adjacent; c = 0 reads voxels 0..T-1 of the box, c = 1 voxels 1..T),
//     into a kStages-deep mbarrier ring, so the next tiles' bytes are in
//     flight while this one computes and stores;
//   * bf16 lanes go in pairs: one packed conversion per two lanes and
//     e * gate as mul.rn.bf16x2, the same single rounding of the exact
//     product; the C/V threads of one sub-position reduce a gate logit with
//     warp shuffles, every lane taking part (rows past the tile's end
//     compute on zeros); 16-byte stores.
// The gathered form has one design, 16-byte loads. The phased forms take
// TMA where a box row (2C lanes) holds 128 bytes or more and the strides
// nest, so that a tensor map can describe y_ext, else 16-byte loads; the
// wrapper decides by shape and strides before the launch
// (ops/epilogue_s2d.py's `pick_design`) and passes the result as `tma`.
// The kernels allocate nothing, launch on the caller's stream and report
// launch errors through cudaGetLastError().

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 4;         // voxel rows a thread has in flight
constexpr int kStages = 3;       // TMA ring depth
constexpr int kMaxGates = 2;     // SE gates held in registers
constexpr int kTileBytes = 16384;

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

// ------------------------------------------------ the persistent kernels

// The tile walk, the same on host and device (ops/epilogue_s2d.py's
// `epilogue_tiles_plain` states it for the CPU tests).
struct Geo {
  int nz, n, c8, c;        // depth extent, y and x extent, lanes
  int log2_row, log2_tpp;  // log2 of threads per voxel row / per sub-position
  int tile;                // T: voxels per tile
  int tiles_x;             // tiles per x row (phased) or per batch entry (gathered)
  int n_tiles;
  int64_t sb, sz, sy, sx;  // element strides of y_ext (phased)
};

struct Tile {
  int b, z, y, x0;  // batch entry; phased: output voxel (z, y, x0); gathered: row x0
  int count;        // voxels of the tile inside the output
};

template <bool kPhased>
__device__ __forceinline__ Tile tile_at(int t, const Geo& g) {
  Tile at;
  const int xt = t % g.tiles_x;
  int r = t / g.tiles_x;
  at.x0 = xt * g.tile;
  if (kPhased) {
    at.y = r % g.n;
    r /= g.n;
    at.z = r % g.nz;
    at.b = r / g.nz;
    at.count = min(g.tile, g.n - at.x0);
  } else {
    at.b = r;
    at.z = at.y = 0;
    at.count = min(g.tile, g.nz * g.n * g.n - at.x0);
  }
  return at;
}

template <bool kPhased>
__device__ __forceinline__ int64_t out_row(const Tile& at, const Geo& g) {
  if (kPhased)
    return ((static_cast<int64_t>(at.b) * g.nz + at.z) * g.n + at.y) * g.n + at.x0;
  return static_cast<int64_t>(at.b) * g.nz * g.n * g.n + at.x0;
}

// One thread's fixed column of the voxel row.
struct Lane {
  int s;     // row slot within a pass
  int k;     // vector within the sub-position
  int p;     // sub-position (a, b, c) = bits (2, 1, 0)
  int col;   // first lane of the thread
};

__device__ __forceinline__ Lane lane_of(const Geo& g, int vec) {
  Lane l;
  const int j = threadIdx.x & ((1 << g.log2_row) - 1);
  l.s = threadIdx.x >> g.log2_row;
  l.p = j >> g.log2_tpp;
  l.k = j & ((1 << g.log2_tpp) - 1);
  l.col = l.p * g.c + l.k * vec;
  return l;
}

// The thread's per-batch-entry constants: scale8/shift8 of its lanes and
// its lanes of each gate vector.
template <typename T>
struct Consts {
  static constexpr int V = VecWidth<T>::N;
  float sc[V], sh[V], w[kMaxGates][V];

  __device__ __forceinline__ void load(int b, const Geo& g, const Lane& l,
                                       const float* __restrict__ scale8,
                                       const float* __restrict__ shift8,
                                       const T* __restrict__ wse, int n_gates) {
    const int64_t base = static_cast<int64_t>(b) * g.c8 + l.col;
#pragma unroll
    for (int v = 0; v < V; ++v) {
      sc[v] = __ldg(scale8 + base + v);
      sh[v] = __ldg(shift8 + base + v);
    }
#pragma unroll
    for (int gi = 0; gi < kMaxGates; ++gi)
#pragma unroll
      for (int v = 0; v < V; ++v) {
        w[gi][v] = 0.f;
        if (gi < n_gates) w[gi][v] = to_f32(wse[gi * g.c + l.k * V + v]);
      }
  }
};

// The epilogue of one 16-byte vector of a voxel row; every lane of the warp
// calls it (the gate shuffles span the sub-position's lanes).
template <typename T, bool kActivate>
__device__ __forceinline__ uint4 finish(const uint4& raw, const Consts<T>& k, int n_gates,
                                        int log2_tpp) {
  constexpr int V = VecWidth<T>::N;
  if constexpr (sizeof(T) == 2) {
    // bf16 pairs: one packed conversion per two lanes, and e * gate as
    // mul.rn.bf16x2, the same single rounding of the exact product
    const uint32_t words[4] = {raw.x, raw.y, raw.z, raw.w};
    __nv_bfloat162 e2[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      float u0 = __fsub_rn(__fmul_rn(__uint_as_float(words[q] << 16), k.sc[2 * q]), k.sh[2 * q]);
      float u1 = __fsub_rn(__fmul_rn(__uint_as_float(words[q] & 0xffff0000u), k.sc[2 * q + 1]),
                           k.sh[2 * q + 1]);
      if (kActivate) {
        u0 = u0 >= 0.f ? u0 : __fmul_rn(0.01f, u0);
        u1 = u1 >= 0.f ? u1 : __fmul_rn(0.01f, u1);
      }
      e2[q] = __floats2bfloat162_rn(u0, u1);
    }
#pragma unroll
    for (int gi = 0; gi < kMaxGates; ++gi) {
      if (gi >= n_gates) break;
      float part = 0.f;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float2 f = __bfloat1622float2(e2[q]);
        part = __fadd_rn(part, __fmul_rn(f.x, k.w[gi][2 * q]));
        part = __fadd_rn(part, __fmul_rn(f.y, k.w[gi][2 * q + 1]));
      }
      for (int off = (1 << log2_tpp) >> 1; off > 0; off >>= 1)
        part += __shfl_xor_sync(0xffffffffu, part, off);
      const __nv_bfloat16 gate = __float2bfloat16_rn(1.f / (1.f + expf(-part)));
      const __nv_bfloat162 g2 = __halves2bfloat162(gate, gate);
#pragma unroll
      for (int q = 0; q < 4; ++q) e2[q] = __hmul2(e2[q], g2);
    }
    uint4 packed;
    packed.x = *reinterpret_cast<const uint32_t*>(&e2[0]);
    packed.y = *reinterpret_cast<const uint32_t*>(&e2[1]);
    packed.z = *reinterpret_cast<const uint32_t*>(&e2[2]);
    packed.w = *reinterpret_cast<const uint32_t*>(&e2[3]);
    return packed;
  }
  const T* rv = reinterpret_cast<const T*>(&raw);
  float e[V];
#pragma unroll
  for (int v = 0; v < V; ++v) {
    float u = __fsub_rn(__fmul_rn(to_f32(rv[v]), k.sc[v]), k.sh[v]);
    if (kActivate) u = u >= 0.f ? u : __fmul_rn(0.01f, u);
    e[v] = round_to<T>(u);
  }
#pragma unroll
  for (int gi = 0; gi < kMaxGates; ++gi) {
    if (gi >= n_gates) break;
    float part = 0.f;
#pragma unroll
    for (int v = 0; v < V; ++v) part = __fadd_rn(part, __fmul_rn(e[v], k.w[gi][v]));
    for (int off = (1 << log2_tpp) >> 1; off > 0; off >>= 1)
      part += __shfl_xor_sync(0xffffffffu, part, off);
    const float gate = round_to<T>(1.f / (1.f + expf(-part)));
#pragma unroll
    for (int v = 0; v < V; ++v) e[v] = round_to<T>(__fmul_rn(e[v], gate));
  }
  uint4 packed;
  T* pv = reinterpret_cast<T*>(&packed);
#pragma unroll
  for (int v = 0; v < V; ++v) pv[v] = from_f32<T>(e[v]);
  return packed;
}

// A 16-byte load; with kWide, L2 fetches the 256-byte block around it. A
// phased read takes 2C lanes of an 8C-lane voxel row, and the tiles that
// need the rest follow within a z plane, so they find it in L2.
template <bool kWide>
__device__ __forceinline__ uint4 ldg16(const void* p) {
  if constexpr (kWide) {
    uint4 r;
    asm volatile("ld.global.nc.L2::256B.v4.u32 {%0, %1, %2, %3}, [%4];"
                 : "=r"(r.x), "=r"(r.y), "=r"(r.z), "=r"(r.w) : "l"(p));
    return r;
  } else {
    return __ldg(reinterpret_cast<const uint4*>(p));
  }
}

// The gather by 16-byte loads, kRows rows in flight per thread.
template <typename T, bool kPhased, bool kActivate>
__global__ void __launch_bounds__(kThreads) persistent_ldg_kernel(
    const T* __restrict__ y, T* __restrict__ out, const float* __restrict__ scale8,
    const float* __restrict__ shift8, const T* __restrict__ wse, int n_gates, const Geo g) {
  constexpr int V = VecWidth<T>::N;
  const Lane l = lane_of(g, V);
  const int pass = kThreads >> g.log2_row;  // rows per pass of the block
  const int a = (l.p >> 2) & 1, bq = (l.p >> 1) & 1, cq = l.p & 1;
  Consts<T> k;
  int cur_b = -1;
  for (int t = blockIdx.x; t < g.n_tiles; t += gridDim.x) {
    const Tile at = tile_at<kPhased>(t, g);
    if (at.b != cur_b) {
      k.load(at.b, g, l, scale8, shift8, wse, n_gates);
      cur_b = at.b;
    }
    const T* src;
    int64_t step;
    if (kPhased) {
      src = y + at.b * g.sb + (at.z + a) * g.sz + (at.y + bq) * g.sy + (at.x0 + cq) * g.sx + l.col;
      step = g.sx;
    } else {
      src = y + out_row<false>(at, g) * g.c8 + l.col;
      step = g.c8;
    }
    T* dst = out + out_row<kPhased>(at, g) * g.c8 + l.col;
    for (int i0 = 0; i0 < g.tile; i0 += pass * kRows) {  // uniform: shuffles inside
      uint4 raw[kRows];
#pragma unroll
      for (int u = 0; u < kRows; ++u) {
        const int i = i0 + l.s + u * pass;
        raw[u] = make_uint4(0u, 0u, 0u, 0u);
        if (i < at.count) raw[u] = ldg16<kPhased>(src + i * step);
      }
#pragma unroll
      for (int u = 0; u < kRows; ++u) {
        const int i = i0 + l.s + u * pass;
        const uint4 o = finish<T, kActivate>(raw[u], k, n_gates, g.log2_tpp);
        if (i < at.count) *reinterpret_cast<uint4*>(dst + static_cast<int64_t>(i) * g.c8) = o;
      }
    }
  }
}

// ------------------------------------------------------------ TMA ring

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Wait for the phase `parity` of a barrier; traps after about 10 s at the
// H100's clock (a byte count that never arrives fails the launch instead
// of hanging the card).
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

// The ring's layout in dynamic shared memory: per stage the 4 boxes of a
// phased tile, each (2C lanes x T+1 voxels).
struct Ring {
  int stage_bytes;  // one stage: the 4 boxes of a tile
  int box_pitch;    // bytes between boxes of a stage (a multiple of 128)
  int row_pitch;    // bytes between voxels of a box, 2C lanes
  uint32_t tx_bytes;
};

// Thread 0: ask TMA for the 4 boxes of phased tile t into `stage`: box
// (a, b) is y_ext[b, z+a, y+b, x0 : x0+T+1, (4a+2b)C : (4a+2b+2)C].
__device__ __forceinline__ void fetch_tile(const CUtensorMap& map, int t, const Geo& g,
                                           const Ring& ring, unsigned char* stage,
                                           uint32_t bar) {
  const Tile at = tile_at<true>(t, g);
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(bar), "r"(ring.tx_bytes) : "memory");
  const uint64_t desc = reinterpret_cast<uint64_t>(&map);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int a = q >> 1, bq = q & 1;
    asm volatile(
        "cp.async.bulk.tensor.5d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
        " [%0], [%1, {%3, %4, %5, %6, %7}], [%2];"
        :: "r"(smem_u32(stage + q * ring.box_pitch)), "l"(desc), "r"(bar),
           "r"((4 * a + 2 * bq) * g.c), "r"(at.x0), "r"(at.y + bq), "r"(at.z + a), "r"(at.b)
        : "memory");
  }
}

// The phased forms' gather by TMA boxes into a kStages-deep ring;
// each thread reads its 16-byte vector of each row from shared memory.
template <typename T, bool kActivate>
__global__ void __launch_bounds__(kThreads) persistent_tma_kernel(
    __grid_constant__ const CUtensorMap map, T* __restrict__ out,
    const float* __restrict__ scale8, const float* __restrict__ shift8,
    const T* __restrict__ wse, int n_gates, const Geo g, const Ring ring) {
  constexpr int V = VecWidth<T>::N;
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  unsigned char* stages = smem + 128;
  const Lane l = lane_of(g, V);
  const int pass = kThreads >> g.log2_row;
  // this thread's vector in a stage: box (a, b), its lanes within the box,
  // and for the c = 1 sub-positions one voxel on
  const int cq = l.p & 1;
  const int off =
      (l.p >> 1) * ring.box_pitch + cq * ring.row_pitch + (cq * g.c + l.k * V) * sizeof(T);
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" :: "r"(smem_u32(full + s)) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    for (int s = 0; s < kStages; ++s) {
      const int t = blockIdx.x + s * gridDim.x;
      if (t < g.n_tiles)
        fetch_tile(map, t, g, ring, stages + s * ring.stage_bytes, smem_u32(full + s));
    }
  }
  __syncthreads();
  Consts<T> k;
  int cur_b = -1;
  int it = 0;
  for (int t = blockIdx.x; t < g.n_tiles; t += gridDim.x, ++it) {
    const int s = it % kStages;
    unsigned char* stage = stages + s * ring.stage_bytes;
    const Tile at = tile_at<true>(t, g);
    if (at.b != cur_b) {
      k.load(at.b, g, l, scale8, shift8, wse, n_gates);
      cur_b = at.b;
    }
    T* dst = out + out_row<true>(at, g) * g.c8 + l.col;
    mbar_wait(smem_u32(full + s), (it / kStages) & 1);
    const unsigned char* src = stage + off;
    for (int i0 = 0; i0 < g.tile; i0 += pass * kRows) {  // uniform: shuffles inside
      uint4 raw[kRows];
#pragma unroll
      for (int u = 0; u < kRows; ++u) {
        const int i = i0 + l.s + u * pass;
        raw[u] = make_uint4(0u, 0u, 0u, 0u);
        if (i < at.count) raw[u] = *reinterpret_cast<const uint4*>(src + i * ring.row_pitch);
      }
#pragma unroll
      for (int u = 0; u < kRows; ++u) {
        const int i = i0 + l.s + u * pass;
        const uint4 o = finish<T, kActivate>(raw[u], k, n_gates, g.log2_tpp);
        if (i < at.count) *reinterpret_cast<uint4*>(dst + static_cast<int64_t>(i) * g.c8) = o;
      }
    }
    __syncthreads();  // every thread is done with this stage
    const int next = t + kStages * gridDim.x;
    if (threadIdx.x == 0 && next < g.n_tiles)
      fetch_tile(map, next, g, ring, stage, smem_u32(full + s));
  }
}

// ------------------------------------------------------------------ host

int ilog2_exact(int64_t v) {
  if (v <= 0 || (v & (v - 1))) return -1;
  int l = 0;
  while ((int64_t{1} << l) < v) ++l;
  return l;
}

// T: about kTileBytes of voxel rows, 16 to 64 voxels (phased: along one x
// row) or 16 to 128 rows (gathered).
int tile_voxels(int row_bytes, bool phased) {
  int t = kTileBytes / row_bytes;
  const int hi = phased ? 64 : 128;
  return t < 16 ? 16 : (t > hi ? hi : t);
}

// The TMA ring of a phased tile: 4 boxes of (2C lanes x T+1 voxels), each
// padded to 128 bytes.
Ring ring_of(int elt, int c8, int tile) {
  Ring ring;
  ring.row_pitch = c8 / 4 * elt;
  ring.box_pitch = (ring.row_pitch * (tile + 1) + 127) / 128 * 128;
  ring.stage_bytes = 4 * ring.box_pitch;
  ring.tx_bytes = 4u * ring.row_pitch * (tile + 1);
  return ring;
}

// the barriers' 128 bytes, then kStages stages
int tma_smem_bytes(const Ring& ring) { return 128 + kStages * ring.stage_bytes; }

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled looked up through the CUDA runtime
// (cudaGetDriverEntryPoint), so the library needs no link against libcuda.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) ==
            cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// Resident blocks per SM x SMs for `kernel` at `smem` bytes on the current
// device, asked of the runtime once per (kernel, device, smem) and cached:
// the queries cost microseconds, a tenth of a small call. The kernel's
// dynamic shared memory limit is raised to the largest size asked so far
// and never lowered, so every cached size stays launchable.
int resident_blocks(const void* kernel, int smem, int& blocks) {
  struct Known { const void* kernel; int dev, smem, blocks; };
  static Known known[64];
  static int n_known = 0;
  static std::mutex mu;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  std::lock_guard<std::mutex> lock(mu);
  int limit = smem;
  for (int i = 0; i < n_known; ++i) {
    if (known[i].kernel != kernel || known[i].dev != dev) continue;
    if (known[i].smem == smem) {
      blocks = known[i].blocks;
      return 0;
    }
    if (known[i].smem > limit) limit = known[i].smem;
  }
  int sms = 0, per_sm = 0;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, limit);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  blocks = per_sm * sms;
  if (n_known < 64) known[n_known++] = Known{kernel, dev, smem, blocks};
  return 0;
}

template <typename K>
int persistent_grid(K kernel, int smem, int n_tiles, int& grid) {
  int blocks = 0;
  const int rc = resident_blocks(reinterpret_cast<const void*>(kernel), smem, blocks);
  grid = blocks < n_tiles ? blocks : n_tiles;
  return rc;
}

// The phased form through TMA: y_ext as a 5-D tensor map (8C, xw, n+1,
// nz+1, B) with its strides, a box (2C lanes, T+1 voxels).
template <typename T, bool kActivate>
int launch_tma(const void* y, int64_t sb, int64_t sz, int64_t sy, int64_t sx, int xw,
               int64_t batch, const Geo& g, T* out, const float* scale8, const float* shift8,
               const T* wse, int n_gates, cudaStream_t stream) {
  constexpr int elt = static_cast<int>(sizeof(T));
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const Ring ring = ring_of(elt, g.c8, g.tile);
  const cuuint64_t dims[5] = {static_cast<cuuint64_t>(g.c8), static_cast<cuuint64_t>(xw),
                              static_cast<cuuint64_t>(g.n + 1), static_cast<cuuint64_t>(g.nz + 1),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[4] = {static_cast<cuuint64_t>(sx * elt), static_cast<cuuint64_t>(sy * elt),
                                 static_cast<cuuint64_t>(sz * elt), static_cast<cuuint64_t>(sb * elt)};
  const cuuint32_t box[5] = {static_cast<cuuint32_t>(g.c8 / 4),
                             static_cast<cuuint32_t>(g.tile + 1), 1, 1, 1};
  const cuuint32_t estr[5] = {1, 1, 1, 1, 1};
  CUtensorMap map;
  if (encode(&map, elt == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
             5, const_cast<void*>(y), dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = tma_smem_bytes(ring);
  auto kernel = persistent_tma_kernel<T, kActivate>;
  int grid = 0;
  const int rc = persistent_grid(kernel, smem, g.n_tiles, grid);
  if (rc) return rc;
  kernel<<<grid, kThreads, smem, stream>>>(map, out, scale8, shift8, wse, n_gates, g, ring);
  return static_cast<int>(cudaGetLastError());
}

// tma: the phased forms' TMA design, where the wrapper found that a tensor
// map can describe y_ext; else (and for the gathered form) 16-byte loads.
template <typename T, bool kPhased, bool kActivate = true>
int launch(bool tma, const void* y, int64_t sb, int64_t sz, int64_t sy, int64_t sx, int xw,
           void* out, const float* scale8, const float* shift8, const void* wse, int n_gates,
           int64_t batch, int nz, int n, int c8, cudaStream_t stream) {
  constexpr int V = VecWidth<T>::N;
  constexpr int elt = static_cast<int>(sizeof(T));
  const int log2_row = ilog2_exact(c8 / V);
  const int log2_tpp = ilog2_exact(c8 / 8 / V);
  if (c8 % (8 * V) || log2_row < 0 || log2_tpp < 0 || (c8 / V) > kThreads ||
      (c8 / 8 / V) > 32 || n_gates < 0 || n_gates > kMaxGates || n < 1 || nz < 1 || batch < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t n3 = static_cast<int64_t>(nz) * n * n;
  Geo g;
  g.nz = nz;
  g.n = n;
  g.c8 = c8;
  g.c = c8 / 8;
  g.log2_row = log2_row;
  g.log2_tpp = log2_tpp;
  g.tile = tile_voxels(c8 * elt, kPhased);
  g.tiles_x = static_cast<int>(((kPhased ? n : n3) + g.tile - 1) / g.tile);
  const int64_t n_tiles = batch * (kPhased ? static_cast<int64_t>(nz) * n : 1) * g.tiles_x;
  if (n_tiles > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  g.n_tiles = static_cast<int>(n_tiles);
  g.sb = sb;
  g.sz = sz;
  g.sy = sy;
  g.sx = sx;
  T* ot = static_cast<T*>(out);
  const T* wt = static_cast<const T*>(wse);
  if constexpr (kPhased) {
    if (tma)
      return launch_tma<T, kActivate>(y, sb, sz, sy, sx, xw, batch, g, ot, scale8, shift8, wt,
                                      n_gates, stream);
  }
  auto kernel = persistent_ldg_kernel<T, kPhased, kActivate>;
  int grid = 0;
  if (const int rc = persistent_grid(kernel, 0, g.n_tiles, grid)) return rc;
  kernel<<<grid, kThreads, 0, stream>>>(static_cast<const T*>(y), ot, scale8, shift8, wt, n_gates,
                                        g);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t value. y is
// (B, nz, n, n, 8C), contiguous.
extern "C" int airseg_gathered_epilogue(int dtype, const void* y, void* out,
                                        const float* scale8, const float* shift8,
                                        const void* wse, int n_gates, long long batch,
                                        int nz, int n, int c8, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float, false>(false, y, 0, 0, 0, 0, 0, out, scale8, shift8, wse, n_gates,
                                batch, nz, n, c8, s);
  if (dtype == 1)
    return launch<__nv_bfloat16, false>(false, y, 0, 0, 0, 0, 0, out, scale8, shift8, wse,
                                        n_gates, batch, nz, n, c8, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// y_ext is (B, nz+1, n+1, xw, 8C) with element strides sb, sz, sy, sx; out
// is (B, nz, n, n, 8C). tma: 1 for the TMA design, 0 for 16-byte loads.
extern "C" int airseg_phased_epilogue(int dtype, int tma, const void* y_ext, long long sb,
                                      long long sz, long long sy, long long sx, int xw,
                                      void* out, const float* scale8, const float* shift8,
                                      const void* wse, int n_gates, long long batch,
                                      int nz, int n, int c8, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float, true>(tma != 0, y_ext, sb, sz, sy, sx, xw, out, scale8, shift8, wse,
                               n_gates, batch, nz, n, c8, s);
  if (dtype == 1)
    return launch<__nv_bfloat16, true>(tma != 0, y_ext, sb, sz, sy, sx, xw, out, scale8, shift8,
                                       wse, n_gates, batch, nz, n, c8, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Phase gather + InstanceNorm affine only (no LeakyReLU, no gates); the
// same y_ext layout, strides and tma flag as airseg_phased_epilogue.
extern "C" int airseg_phased_normalize(int dtype, int tma, const void* y_ext, long long sb,
                                       long long sz, long long sy, long long sx, int xw,
                                       void* out, const float* scale8, const float* shift8,
                                       long long batch, int nz, int n, int c8, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float, true, false>(tma != 0, y_ext, sb, sz, sy, sx, xw, out, scale8, shift8,
                                      nullptr, 0, batch, nz, n, c8, s);
  if (dtype == 1)
    return launch<__nv_bfloat16, true, false>(tma != 0, y_ext, sb, sz, sy, sx, xw, out, scale8,
                                              shift8, nullptr, 0, batch, nz, n, c8, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Dynamic shared memory of the TMA design at element size `elt`, width
// 8C = c8.
extern "C" int airseg_epilogue_tma_smem(int elt, int c8) {
  return tma_smem_bytes(ring_of(elt, c8, tile_voxels(c8 * elt, true)));
}

// InstanceNorm statistics of the s2d conv blocks (K12), for Hopper (sm_90a).
//
// Per (sample b, lane l) of a block's conv output, the f32 sum and sum of
// squares of the lane over the block's voxels:
//   s1[b, l] = sum_v f32(y[b, v, l]),   s2[b, l] = sum_v f32(y[b, v, l])^2,
// (B, 8C) each, in a (2, B, 8C) buffer. The caller folds the 8 sub-positions
// into (B, C) and forms the affine (ops/epilogue_s2d.py). Two forms:
//   gathered: y (B, nz, n, n, 8C) contiguous, v over its nz*n*n voxel rows;
//   phased:   the phased conv's ungathered output y_ext (B, nz+1, n+1, xw, 8C);
//             lane block q = (a, b', c) (lanes qC .. (q+1)C) is summed over
//             the window y_ext[:, a:a+nz, b':b'+n, c:c+n], read in place.
// nz is n for a cube and n / n_space for a depth slab of the mesh's `space`
// axis. The JAX package has no Pallas kernel for this; its statistics were
// XLA reductions. This kernel replaces no TPU kernel: it replaces the port's
// plain-torch sums, which made an f32 copy and an f32 square of every
// element before reducing them.
//
// Bound: device memory. Each window element is read once (2 bytes in bf16)
// and the sums are a few flops per element. Design:
//   * A thread owns one 16-byte vector column of the row (V = 8 lanes in
//     bf16, 4 in f32): neighbouring threads read neighbouring addresses along
//     8C, one lane block (or, gathered, the whole row) per group of threads.
//     A block of 256 threads covers 256 / (8C / V) rows a pass and keeps
//     kRows passes' loads in flight per thread; the sums stay in f32
//     registers.
//   * Both forms stream voxel rows in memory order: the gathered form its
//     nz*n*n rows, the phased form the (nz+1)(n+1)^2 rows of y_ext's grid
//     (x past n+1 is not read), each thread's lane block masked where the
//     voxel lies outside its window (a boundary plane, row or column), so
//     every window element is loaded once, in the order it lies in memory.
//     A walk over the output grid instead (row (z, y, x) of lane block q at
//     y_ext[z+a, y+b', x+c]) reads each voxel row's four (a, b') lane pairs
//     a y row or a z plane apart, from other blocks: on an H100 at batch 8
//     it took dc5's y_ext at 1.74x the bound, this walk at 1.31x (PERF.md
//     §6).
//   * Block (k, b) takes rows [k*chunk, (k+1)*chunk) of batch entry b.
//     `chunk` is chosen by the caller (`norm_stats_chunk` in
//     ops/epilogue_s2d.py): about kBlocksPerSm blocks an SM in all, one
//     wave, so the smallest launch of the model (67M elements, 40 us at
//     the bound) fills the card. A phased row walk steps (z, y, x) by
//     adding, not dividing.
//   * Determinism: no float atomics. A block reduces its threads' sums in
//     shared memory in a fixed order and writes them to its slot of the
//     caller's scratch; a second kernel folds the slots of each (b, lane) in
//     chunk order. Two launches on the same input give the same bits.
// The kernels allocate nothing, launch on the caller's stream and report
// launch errors through cudaGetLastError(). Element offsets are 64-bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 4;         // passes of loads in flight per thread
constexpr int kBlocksPerSm = 4;  // resident blocks an SM (see __launch_bounds__)
constexpr int kFoldWarps = kThreads / 32;

template <typename T> struct VecWidth;
template <> struct VecWidth<float> { static constexpr int N = 4; };
template <> struct VecWidth<__nv_bfloat16> { static constexpr int N = 8; };

// add one 16-byte vector to the thread's sums
__device__ __forceinline__ void accumulate(const uint4& u, float* s1, float* s2, float) {
  const float f[4] = {__uint_as_float(u.x), __uint_as_float(u.y), __uint_as_float(u.z),
                      __uint_as_float(u.w)};
#pragma unroll
  for (int v = 0; v < 4; ++v) {
    s1[v] += f[v];
    s2[v] = fmaf(f[v], f[v], s2[v]);
  }
}

__device__ __forceinline__ void accumulate(const uint4& u, float* s1, float* s2, __nv_bfloat16) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float lo = __uint_as_float(w[i] << 16);          // lane 2i
    const float hi = __uint_as_float(w[i] & 0xffff0000u);  // lane 2i + 1
    s1[2 * i] += lo;
    s2[2 * i] = fmaf(lo, lo, s2[2 * i]);
    s1[2 * i + 1] += hi;
    s2[2 * i + 1] = fmaf(hi, hi, s2[2 * i + 1]);
  }
}

// The voxel-row walk of one thread. Gathered: row r is r * 8C elements in.
// Phased: row r = (z, y, x) of y_ext's (nz+1, n+1, n+1) voxel grid, kept as
// counters and an element offset that advance by `step` rows without a
// division; lane block q = (a, b', c) of the row counts where the voxel lies
// in window q: a <= z < a+nz, b' <= y < b'+n, c <= x < c+n.
template <bool kPhased> struct Walk;

template <> struct Walk<false> {
  int64_t off, delta;
  __device__ Walk(int r, int step, int c8, int, int64_t, int64_t, int64_t)
      : off(static_cast<int64_t>(r) * c8), delta(static_cast<int64_t>(step) * c8) {}
  __device__ __forceinline__ void advance() { off += delta; }
  __device__ __forceinline__ bool in_window(int, int, int, int, int) const { return true; }
};

template <> struct Walk<true> {
  int64_t off, sz, sy, sx, delta;
  int x, y, z, m, step;
  __device__ Walk(int r, int step_, int, int m_, int64_t sz_, int64_t sy_, int64_t sx_)
      : sz(sz_), sy(sy_), sx(sx_), m(m_), step(step_) {
    const int mm = m * m;
    z = r / mm;
    y = (r - z * mm) / m;
    x = r - z * mm - y * m;
    off = z * sz + y * sy + x * sx;
    delta = static_cast<int64_t>(step) * sx;
  }
  __device__ __forceinline__ void advance() {
    x += step;
    off += delta;
    while (x >= m) {  // at most once where step <= m, as at every model shape
      x -= m;
      off += sy - static_cast<int64_t>(m) * sx;
      if (++y == m) {
        y = 0;
        ++z;
        off += sz - static_cast<int64_t>(m) * sy;
      }
    }
  }
  __device__ __forceinline__ bool in_window(int a, int b, int c, int nz, int n) const {
    return static_cast<unsigned>(z - a) < static_cast<unsigned>(nz) &&
           static_cast<unsigned>(y - b) < static_cast<unsigned>(n) &&
           static_cast<unsigned>(x - c) < static_cast<unsigned>(n);
  }
};

// Pass 1: block (k, b) sums rows [k*chunk, min((k+1)*chunk, rows)) of entry
// b (phased: of y_ext's grid, rows = (nz+1)(n+1)^2) and writes its (2, 8C)
// sums to part[b, k].
template <typename T, bool kPhased>
__device__ __forceinline__ void block_sums(const T* __restrict__ y, int64_t sb, int64_t sz,
                                           int64_t sy, int64_t sx, float* __restrict__ part,
                                           int rows, int chunk, int nz, int n, int c8,
                                           int log2_row) {
  constexpr int V = VecWidth<T>::N;
  __shared__ float red[2][kThreads * V];
  const int tid = threadIdx.x;
  const int step = kThreads >> log2_row;  // rows a pass
  const int s = tid >> log2_row;          // this thread's row within a pass
  const int col = (tid & ((1 << log2_row) - 1)) * V;
  const int q = kPhased ? col / (c8 >> 3) : 0;  // lane block (a, b', c)
  const int qa = (q >> 2) & 1, qb = (q >> 1) & 1, qc = q & 1;
  const int b = blockIdx.y, k = blockIdx.x;
  const int r0 = k * chunk;
  const int r1 = min(r0 + chunk, rows);
  const T* base = y + (kPhased ? b * sb : static_cast<int64_t>(b) * rows * c8) + col;
  float s1[V], s2[V];
#pragma unroll
  for (int v = 0; v < V; ++v) s1[v] = s2[v] = 0.f;

  Walk<kPhased> w(r0 + s, step, c8, n + 1, sz, sy, sx);
  for (int r = r0 + s; r < r1; r += kRows * step) {
    uint4 u[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      u[i] = r + i * step < r1 && w.in_window(qa, qb, qc, nz, n)
                 ? __ldg(reinterpret_cast<const uint4*>(base + w.off))
                 : make_uint4(0u, 0u, 0u, 0u);  // +0 in both types
      w.advance();
    }
#pragma unroll
    for (int i = 0; i < kRows; ++i) accumulate(u[i], s1, s2, T());
  }

  // thread (s, col) holds lanes col .. col+V-1 of row s: slot tid*V + v is
  // red[s*8C + col + v]
#pragma unroll
  for (int v = 0; v < V; ++v) {
    red[0][tid * V + v] = s1[v];
    red[1][tid * V + v] = s2[v];
  }
  __syncthreads();
  float* out = part + (static_cast<int64_t>(b) * gridDim.x + k) * 2 * c8;
  for (int l = tid; l < c8; l += kThreads) {
    float a = 0.f, q = 0.f;
    for (int i = 0; i < step; ++i) {
      a += red[0][i * c8 + l];
      q += red[1][i * c8 + l];
    }
    out[l] = a;
    out[c8 + l] = q;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm) norm_stats_gathered(
    const T* __restrict__ y, float* __restrict__ part, int rows, int chunk, int n, int c8,
    int log2_row) {
  block_sums<T, false>(y, 0, 0, 0, 0, part, rows, chunk, 0, n, c8, log2_row);
}

template <typename T>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm) norm_stats_phased(
    const T* __restrict__ y, int64_t sb, int64_t sz, int64_t sy, int64_t sx,
    float* __restrict__ part, int rows, int chunk, int nz, int n, int c8, int log2_row) {
  block_sums<T, true>(y, sb, sz, sy, sx, part, rows, chunk, nz, n, c8, log2_row);
}

// Pass 2: block (j, b) folds 32 lanes of entry b over the chunks: warp w
// adds chunks w, w+8, ... in order, then warp sums add in warp order.
__global__ void __launch_bounds__(kThreads) norm_stats_fold(const float* __restrict__ part,
                                                           float* __restrict__ sums, int chunks,
                                                           int batch, int c8) {
  __shared__ float red[2][kFoldWarps][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = blockIdx.y;
  const int l = blockIdx.x * 32 + lane;
  float a = 0.f, q = 0.f;
  if (l < c8) {
    const float* p = part + static_cast<int64_t>(b) * chunks * 2 * c8 + l;
    for (int k = warp; k < chunks; k += kFoldWarps) {
      a += p[static_cast<int64_t>(k) * 2 * c8];
      q += p[static_cast<int64_t>(k) * 2 * c8 + c8];
    }
  }
  red[0][warp][lane] = a;
  red[1][warp][lane] = q;
  __syncthreads();
  if (warp == 0 && l < c8) {
    a = q = 0.f;
    for (int i = 0; i < kFoldWarps; ++i) {
      a += red[0][i][lane];
      q += red[1][i][lane];
    }
    sums[static_cast<int64_t>(b) * c8 + l] = a;
    sums[(static_cast<int64_t>(batch) + b) * c8 + l] = q;
  }
}

int log2_of(int v) {
  int r = 0;
  while ((1 << r) < v) ++r;
  return (1 << r) == v ? r : -1;
}

template <typename T, bool kPhased>
int launch(const void* y, int64_t sb, int64_t sz, int64_t sy, int64_t sx, float* part,
           float* sums, int batch, int nz, int n, int c8, int chunk, cudaStream_t stream) {
  constexpr int V = VecWidth<T>::N;
  const int log2_row = log2_of(c8 / V);
  if (c8 % V || log2_row < 0 || (c8 / V) > kThreads || (kPhased && (c8 / 8) % V) || chunk < 1 ||
      batch < 1 || batch > 65535 || nz < 1 || n < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t rows = kPhased ? static_cast<int64_t>(nz + 1) * (n + 1) * (n + 1)
                               : static_cast<int64_t>(nz) * n * n;
  if (rows > INT32_MAX - kRows * kThreads) return static_cast<int>(cudaErrorInvalidValue);
  const int chunks = static_cast<int>((rows + chunk - 1) / chunk);
  const dim3 grid(chunks, batch);
  const T* yt = static_cast<const T*>(y);
  if (kPhased)
    norm_stats_phased<T><<<grid, kThreads, 0, stream>>>(yt, sb, sz, sy, sx, part,
                                                        static_cast<int>(rows), chunk, nz, n,
                                                        c8, log2_row);
  else
    norm_stats_gathered<T><<<grid, kThreads, 0, stream>>>(yt, part, static_cast<int>(rows),
                                                          chunk, n, c8, log2_row);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  norm_stats_fold<<<dim3((c8 + 31) / 32, batch), kThreads, 0, stream>>>(part, sums, chunks, batch,
                                                                         c8);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t value.
// y (B, nz, n, n, 8C) contiguous; part (B, ceil(nz*n*n / chunk), 2, 8C) f32
// scratch; sums (2, B, 8C) f32 out.
extern "C" int airseg_norm_stats_gathered(int dtype, const void* y, float* part, float* sums,
                                          int batch, int nz, int n, int c8, int chunk,
                                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float, false>(y, 0, 0, 0, 0, part, sums, batch, nz, n, c8, chunk, s);
  if (dtype == 1)
    return launch<__nv_bfloat16, false>(y, 0, 0, 0, 0, part, sums, batch, nz, n, c8, chunk, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// y_ext (B, nz+1, n+1, xw, 8C) with element strides sb, sz, sy, sx and unit
// lane stride; part (B, ceil((nz+1)(n+1)^2 / chunk), 2, 8C) and sums as
// above.
extern "C" int airseg_norm_stats_phased(int dtype, const void* y_ext, long long sb, long long sz,
                                        long long sy, long long sx, float* part, float* sums,
                                        int batch, int nz, int n, int c8, int chunk,
                                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float, true>(y_ext, sb, sz, sy, sx, part, sums, batch, nz, n, c8, chunk, s);
  if (dtype == 1)
    return launch<__nv_bfloat16, true>(y_ext, sb, sz, sy, sx, part, sums, batch, nz, n, c8,
                                       chunk, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

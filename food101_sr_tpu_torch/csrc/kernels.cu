// Hand-written Hopper (sm_90a) kernels of food101_sr_tpu_torch.
//
// Built by food101_sr_tpu_torch/_build.py with plain nvcc into a shared
// library that exposes a C interface and is loaded with ctypes: no PyTorch
// headers, so the build takes seconds. Every entry point launches on the
// stream it is given (PyTorch's current stream), allocates nothing, and
// returns cudaGetLastError() so the Python wrapper can raise on a refused
// launch.
//
// K1  f101_blur5_f32
//     Replaces food101_sr_tpu/ops/pallas_blur.py::_blur_kernel (launched by
//     _blur_pallas_raw). Depthwise, zero-padded, separable 5-tap Gaussian on
//     every (image, channel) plane of an (N*C, H, W) float32 tensor: a pass
//     along H, then a pass along W, exactly F.conv2d(padding=2, groups=C).
//     Bound: bytes. It reads and writes N*C*H*W*4 bytes once each and does 20
//     flops per pixel, far below the card's flop rate per byte. At the NLPD
//     pyramid's sizes (a few MB) the launch, not the bytes, sets its time.
//     Design: the TPU kernel holds a whole plane in VMEM. Here one warp owns
//     a strip of columns in a band of rows of one plane and walks down it,
//     one row per step: the five rows of the vertical window stay in
//     registers, so every input value is loaded once (plus a 4-row overlap
//     between bands), and the pass along W takes its +-2 neighbours from the
//     neighbouring lanes by warp shuffles. The lanes at the strip's two edges
//     only supply that halo, so neighbouring strips overlap by 4 columns.
//     Where W % 4 == 0 and the pointers are 16-byte aligned (the 200 and
//     100 px levels) a lane owns 4 columns and moves them as one float4;
//     otherwise (50 and 25 px) one column. No shared memory, no block-wide
//     barrier, no TMA (rows of 50 or 25 floats break its 16-byte stride
//     rule). The band height is chosen per launch so that even the 25 px
//     level launches some hundreds of warps.
//
// K2  f101_nhwc_mean_{f32,bf16}   (the main path: channels-last input)
//     f101_plane_mean_{f32,bf16}  (NCHW input)
//     Replace food101_sr_tpu/ops/spatial_mean.py::_mean_kernel (launched by
//     _spatial_mean_raw): the global H*W mean of every (n, c), accumulated
//     in float32 and returned in the input dtype (the SE-block squeeze).
//     Bound: bytes. It reads N*C*H*W elements once and writes N*C.
//
//     nhwc: the TPU kernel's own layout, (bn, bh, W, C) blocks with C the
//     fastest axis, which is also what cuDNN's tensor-core convs produce.
//     The S blocks of one image form a thread-block cluster; each block owns
//     a slab of consecutive pixels, which is contiguous. A lane owns one
//     fixed 16-byte group of channels (8 bf16 or 4 f32) and sums it over
//     the slab's pixels in f32 registers, with 4 independent 16-byte loads
//     in flight; a pass of the block reads whole pixels, so the loads of a
//     warp are contiguous. A block then reduces its lanes to C sums in
//     shared memory, and cluster rank 0 adds the S blocks' sums through
//     distributed shared memory in rank order and writes the (n, c) row:
//     one launch, no atomics, the same result on every run. S is chosen per
//     shape so that N * S blocks fill about one wave of the SMs (16 at
//     8x96x224x224, 8 at 8x96x64x64). Streaming the slab through a ring of
//     shared-memory stages filled by cp.async.bulk on mbarriers, or by
//     per-lane cp.async, was correct but slower at these shapes: both topped
//     out near 1.5 TB/s where these loads reach 2.3
//     (tools/k2_nhwc_variants.cu, PERF.md). Where C * itemsize is not a
//     multiple of 16, a group would be wider than a block, or the pointer
//     is not 16-byte aligned, the same kernel reads element by element.
//
//     plane: one block owns one contiguous NCHW (n, c) plane and streams it
//     with 16-byte loads (8 bf16 or 4 f32 values) where size and alignment
//     allow, sums in float32 registers, then reduces by warp shuffles and
//     one shared-memory step.

#include <algorithm>

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

__host__ __device__ __forceinline__ int ceil_div(long long a, long long b) {
  return static_cast<int>((a + b - 1) / b);
}

// ----------------------------------------------------------------- K1 ----

constexpr int kRadius = 2;
constexpr int kTaps = 2 * kRadius + 1;
constexpr int kBlurWarps = 4;           // warps per block, each independent
constexpr int kBlurTargetWarps = 1024;  // bands are cut until about this many
constexpr int kBlurMinBand = 4;         // rows; a band re-reads 4 halo rows

struct Taps {
  float t[kTaps];
};

// One row's V columns starting at `col` (zeros outside the plane). With
// V == 4, col is a multiple of 4 and W % 4 == 0, so a group is wholly in or
// wholly out.
template <int V>
__device__ __forceinline__ void load_row(const float* __restrict__ plane,
                                         int y, int col, int h, int w,
                                         float (&r)[V]) {
  const bool in = y >= 0 && y < h && col >= 0 && col < w;
  if constexpr (V == 4) {
    float4 q = make_float4(0.f, 0.f, 0.f, 0.f);
    if (in)
      q = __ldg(reinterpret_cast<const float4*>(
          plane + static_cast<size_t>(y) * w + col));
    r[0] = q.x; r[1] = q.y; r[2] = q.z; r[3] = q.w;
  } else {
    r[0] = in ? __ldg(plane + static_cast<size_t>(y) * w + col) : 0.f;
  }
}

template <int V>
__global__ void __launch_bounds__(32 * kBlurWarps)
blur5_kernel(const float* __restrict__ x, float* __restrict__ out,
             long long planes, int h, int w, int bands, int band_h,
             int strips, Taps taps) {
  constexpr int kHaloLanes = (kRadius + V - 1) / V;
  constexpr int kStrip = (32 - 2 * kHaloLanes) * V;  // output columns
  const int lane = threadIdx.x & 31;
  const long long warp =
      static_cast<long long>(blockIdx.x) * kBlurWarps + (threadIdx.x >> 5);
  if (warp >= planes * bands * strips) return;  // whole warps leave together
  const int strip = static_cast<int>(warp % strips);
  const int band = static_cast<int>((warp / strips) % bands);
  const long long plane = warp / (static_cast<long long>(strips) * bands);
  const int col = strip * kStrip + (lane - kHaloLanes) * V;
  const bool owner = lane >= kHaloLanes && lane < 32 - kHaloLanes && col < w;
  const int y0 = band * band_h;
  const int y1 = min(y0 + band_h, h);
  const float* p = x + static_cast<size_t>(plane) * h * w;
  float* q = out + static_cast<size_t>(plane) * h * w;

  float win[kTaps][V];  // rows oy-2 .. oy+2 of this lane's columns
#pragma unroll
  for (int k = 1; k < kTaps; ++k) load_row<V>(p, y0 - 3 + k, col, h, w, win[k]);

#pragma unroll 2
  for (int oy = y0; oy < y1; ++oy) {
#pragma unroll
    for (int k = 0; k + 1 < kTaps; ++k)
#pragma unroll
      for (int j = 0; j < V; ++j) win[k][j] = win[k + 1][j];
    load_row<V>(p, oy + kRadius, col, h, w, win[kTaps - 1]);

    float v[V];  // the pass along H
#pragma unroll
    for (int j = 0; j < V; ++j) {
      float acc = 0.f;
#pragma unroll
      for (int k = 0; k < kTaps; ++k) acc += taps.t[k] * win[k][j];
      v[j] = acc;
    }
    // the pass along W: this lane's V columns with 2 neighbours each side
    float ext[V + 2 * kRadius];
    if constexpr (V == 4) {
      ext[0] = __shfl_up_sync(0xffffffffu, v[2], 1);
      ext[1] = __shfl_up_sync(0xffffffffu, v[3], 1);
      ext[6] = __shfl_down_sync(0xffffffffu, v[0], 1);
      ext[7] = __shfl_down_sync(0xffffffffu, v[1], 1);
    } else {
      ext[0] = __shfl_up_sync(0xffffffffu, v[0], 2);
      ext[1] = __shfl_up_sync(0xffffffffu, v[0], 1);
      ext[3] = __shfl_down_sync(0xffffffffu, v[0], 1);
      ext[4] = __shfl_down_sync(0xffffffffu, v[0], 2);
    }
#pragma unroll
    for (int j = 0; j < V; ++j) ext[kRadius + j] = v[j];
    float o[V];
#pragma unroll
    for (int j = 0; j < V; ++j) {
      float acc = 0.f;
#pragma unroll
      for (int k = 0; k < kTaps; ++k) acc += taps.t[k] * ext[j + k];
      o[j] = acc;
    }
    if (owner) {
      float* dst = q + static_cast<size_t>(oy) * w + col;
      if constexpr (V == 4)
        *reinterpret_cast<float4*>(dst) = make_float4(o[0], o[1], o[2], o[3]);
      else
        *dst = o[0];
    }
  }
}

template <int V>
cudaError_t launch_blur(const float* x, float* out, long long planes, int h,
                        int w, const Taps& taps, cudaStream_t stream) {
  constexpr int kHaloLanes = (kRadius + V - 1) / V;
  constexpr int kStrip = (32 - 2 * kHaloLanes) * V;
  const int strips = ceil_div(w, kStrip);
  const long long per_band = planes * strips;
  int bands = ceil_div(kBlurTargetWarps, per_band);
  bands = std::max(1, std::min(bands, ceil_div(h, kBlurMinBand)));
  const int band_h = ceil_div(h, bands);
  bands = ceil_div(h, band_h);
  const long long warps = per_band * bands;
  blur5_kernel<V><<<ceil_div(warps, kBlurWarps), 32 * kBlurWarps, 0, stream>>>(
      x, out, planes, h, w, bands, band_h, strips, taps);
  return cudaGetLastError();
}

// ----------------------------------------------------------------- K2 ----

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as Tensor.to()
}

// 16 bytes of T summed into V float32 accumulators
template <typename T, int V>
__device__ __forceinline__ void add16(const uint4& raw, float (&acc)[V]) {
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int k = 0; k < V; ++k) acc[k] += to_f32(e[k]);
}

// -- K2 plane (NCHW) ------------------------------------------------------

constexpr int kMeanThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kMeanThreads)
plane_mean_kernel(const T* __restrict__ x, T* __restrict__ out, long long hw,
                  float inv_hw) {
  const T* p = x + static_cast<size_t>(blockIdx.x) * hw;
  constexpr int kVec = 16 / sizeof(T);
  float s = 0.f;
  if (hw % kVec == 0 && reinterpret_cast<uintptr_t>(p) % 16 == 0) {
    const uint4* pv = reinterpret_cast<const uint4*>(p);
    const long long nv = hw / kVec;
    for (long long i = threadIdx.x; i < nv; i += kMeanThreads) {
      const uint4 v = __ldg(pv + i);
      const T* e = reinterpret_cast<const T*>(&v);
#pragma unroll
      for (int k = 0; k < kVec; ++k) s += to_f32(e[k]);
    }
  } else {
    for (long long i = threadIdx.x; i < hw; i += kMeanThreads) s += to_f32(p[i]);
  }

  __shared__ float warp_sums[kMeanThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(0xffffffffu, s, off);
  if (lane == 0) warp_sums[warp] = s;
  __syncthreads();
  if (warp == 0) {
    s = lane < kMeanThreads / 32 ? warp_sums[lane] : 0.f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(0xffffffffu, s, off);
    if (lane == 0) out[blockIdx.x] = from_f32<T>(s * inv_hw);
  }
}

// -- K2 nhwc (channels-last), cluster reduction ----------------------------

constexpr int kNhwcThreads = 512;
constexpr int kNhwcUnroll = 4;       // 16-byte loads in flight per lane
constexpr int kMinSlabBytes = 65536;  // less per block costs more than it hides
constexpr int kMaxCluster = 16;      // non-portable above 8 on H100
constexpr int kSms = 132;            // H100 SXM; only sizes the cluster
constexpr int kMaxNhwcC = 8192;      // the block's C float sums live in smem

// Sum the rows of red[rows][cols] in row order into sums[0:valid).
__device__ __forceinline__ void reduce_rows(const float* red, int rows,
                                            int cols, int valid, float* sums) {
  for (int j = threadIdx.x; j < valid; j += kNhwcThreads) {
    float s = 0.f;
    for (int r = 0; r < rows; ++r) s += red[r * cols + j];
    sums[j] = s;
  }
}

// grid (S, N), cluster (S, 1, 1): cluster n = image n, rank = slab.
// vec != 0: C * sizeof(T) % 16 == 0, C * sizeof(T) <= 16 * threads, and x
// 16-byte aligned.
template <typename T>
__global__ void __launch_bounds__(kNhwcThreads)
nhwc_mean_kernel(const T* __restrict__ x, T* __restrict__ out, int c,
                 long long hw, long long slab, float inv_hw, int vec) {
  extern __shared__ float sums[];              // c: this block's sums
  __shared__ float red[kNhwcThreads * 8];      // per-lane partials
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const long long n = blockIdx.y;
  const long long p0 = min(hw, rank * slab), p1 = min(hw, p0 + slab);
  const int t = threadIdx.x;

  if (vec) {
    // lane (gx, gy) sums 16-byte group gx of pixels p0 + gy, + rows, ...;
    // a pass of the block reads `rows` whole pixels, contiguous
    constexpr int kVec = 16 / sizeof(T);
    const int groups = c / kVec, rows = kNhwcThreads / groups;
    const int gx = t % groups, gy = t / groups;  // gy >= rows: idle lane
    float acc[kVec] = {};
    if (gy < rows) {
      const uint4* px = reinterpret_cast<const uint4*>(x) +
                        static_cast<size_t>(n) * hw * groups + gx;
      long long p = p0 + gy;
      for (; p + (kNhwcUnroll - 1) * rows < p1; p += kNhwcUnroll * rows) {
        uint4 v[kNhwcUnroll];
#pragma unroll
        for (int u = 0; u < kNhwcUnroll; ++u)
          v[u] = __ldg(px + (p + u * rows) * groups);
#pragma unroll
        for (int u = 0; u < kNhwcUnroll; ++u) add16<T, kVec>(v[u], acc);
      }
      for (; p < p1; p += rows) add16<T, kVec>(__ldg(px + p * groups), acc);
#pragma unroll
      for (int k = 0; k < kVec; ++k) red[gy * c + gx * kVec + k] = acc[k];
    }
    __syncthreads();
    reduce_rows(red, rows, c, c, sums);
  } else {
    // element by element: lane (cx, cy) sums channel c0 + cx over pixels
    // p0 + cy, p0 + cy + rows, ...; channels in chunks of `cols`
    const int cols = min(c, kNhwcThreads), rows = kNhwcThreads / cols;
    const int cx = t % cols, cy = t / cols;
    const T* img = x + static_cast<size_t>(n) * hw * c;
    for (int c0 = 0; c0 < c; c0 += cols) {
      float a = 0.f;
      if (cy < rows && c0 + cx < c)
        for (long long p = p0 + cy; p < p1; p += rows)
          a += to_f32(img[static_cast<size_t>(p) * c + c0 + cx]);
      if (cy < rows) red[cy * cols + cx] = a;
      __syncthreads();
      reduce_rows(red, rows, cols, min(cols, c - c0), sums + c0);
      __syncthreads();
    }
  }

  cluster.sync();  // every rank's sums are written
  if (rank == 0) {
    const int ranks = static_cast<int>(cluster.num_blocks());
    for (int j = t; j < c; j += kNhwcThreads) {
      float s = 0.f;
      for (int r = 0; r < ranks; ++r) s += cluster.map_shared_rank(sums, r)[j];
      out[static_cast<size_t>(n) * c + j] = from_f32<T>(s * inv_hw);
    }
  }
  cluster.sync();  // no rank leaves while rank 0 still reads its sums
}

// Largest power-of-two cluster size <= want that can be resident, per
// kernel instance (queried once per size, with the most shared memory the
// kernel can ask for).
template <typename T>
int cluster_size(int want) {
  static int fits[kMaxCluster + 1] = {};  // 0 unknown, 1 yes, -1 no
  int s = 1;
  while (s * 2 <= want) s *= 2;
  for (; s > 1; s /= 2) {
    if (fits[s] == 0) {
      cudaLaunchConfig_t cfg = {};
      cfg.gridDim = dim3(s, 1, 1);
      cfg.blockDim = dim3(kNhwcThreads, 1, 1);
      cfg.dynamicSmemBytes = kMaxNhwcC * sizeof(float);
      cudaLaunchAttribute attr;
      attr.id = cudaLaunchAttributeClusterDimension;
      attr.val.clusterDim.x = s;
      attr.val.clusterDim.y = 1;
      attr.val.clusterDim.z = 1;
      cfg.attrs = &attr;
      cfg.numAttrs = 1;
      int active = 0;
      const cudaError_t err = cudaOccupancyMaxActiveClusters(
          &active, nhwc_mean_kernel<T>, &cfg);
      if (err != cudaSuccess) cudaGetLastError();  // clear it, try smaller
      fits[s] = (err == cudaSuccess && active > 0) ? 1 : -1;
    }
    if (fits[s] > 0) break;
  }
  return s;
}

template <typename T>
int launch_nhwc_mean(const void* x, void* out, long long n, long long c,
                     long long hw, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  static bool ready = false;  // per instance: attributes set once
  if (!ready) {
    err = cudaFuncSetAttribute(nhwc_mean_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(kMaxNhwcC * sizeof(float)));
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          nhwc_mean_kernel<T>,
          cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return static_cast<int>(err);
    ready = true;
  }
  const long long row_bytes = c * static_cast<long long>(sizeof(T));
  const int vec = row_bytes % 16 == 0 && row_bytes <= 16LL * kNhwcThreads &&
                  reinterpret_cast<uintptr_t>(x) % 16 == 0;
  // about one wave of blocks, each with at least kMinSlabBytes to read
  const long long want = std::min(
      {static_cast<long long>(kMaxCluster), std::max(1LL, kSms / n),
       std::max(1LL, hw * row_bytes / kMinSlabBytes)});
  const int s = cluster_size<T>(static_cast<int>(want));
  const long long slab = (hw + s - 1) / s;

  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(s, static_cast<unsigned>(n), 1);
  cfg.blockDim = dim3(kNhwcThreads, 1, 1);
  cfg.dynamicSmemBytes = static_cast<size_t>(c) * sizeof(float);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = s;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, nhwc_mean_kernel<T>,
                           static_cast<const T*>(x), static_cast<T*>(out),
                           static_cast<int>(c), hw, slab,
                           1.0f / static_cast<float>(hw), vec);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_plane_mean(const void* x, void* out, long long planes, long long hw,
                      int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  plane_mean_kernel<T><<<static_cast<unsigned>(planes), kMeanThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<T*>(out), hw,
      1.0f / static_cast<float>(hw));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x, out: (planes, h, w) float32, contiguous, on `device`; taps: 5 floats
// on the host.
int f101_blur5_f32(const void* x, void* out, long long planes, int h, int w,
                   const float* taps, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  Taps t;
  for (int k = 0; k < kTaps; ++k) t.t[k] = taps[k];
  const float* xi = static_cast<const float*>(x);
  float* o = static_cast<float*>(out);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = w % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  err = vec ? launch_blur<4>(xi, o, planes, h, w, t, st)
            : launch_blur<1>(xi, o, planes, h, w, t, st);
  return static_cast<int>(err);
}

// x: (n, hw, c) contiguous, i.e. an (n, c, h, w) tensor in channels-last
// memory; out: (n, c) of the same dtype. n <= 65535 (grid y), c <= 8192;
// the wrapper checks.
int f101_nhwc_mean_f32(const void* x, void* out, long long n, long long c,
                       long long hw, int device, void* stream) {
  return launch_nhwc_mean<float>(x, out, n, c, hw, device, stream);
}

int f101_nhwc_mean_bf16(const void* x, void* out, long long n, long long c,
                        long long hw, int device, void* stream) {
  return launch_nhwc_mean<__nv_bfloat16>(x, out, n, c, hw, device, stream);
}

// x: (planes, hw) contiguous; out: (planes,) of the same dtype.
int f101_plane_mean_f32(const void* x, void* out, long long planes,
                        long long hw, int device, void* stream) {
  return launch_plane_mean<float>(x, out, planes, hw, device, stream);
}

int f101_plane_mean_bf16(const void* x, void* out, long long planes,
                         long long hw, int device, void* stream) {
  return launch_plane_mean<__nv_bfloat16>(x, out, planes, hw, device, stream);
}

}  // extern "C"

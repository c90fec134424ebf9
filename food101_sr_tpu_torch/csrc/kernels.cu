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
//     flops per pixel, far below the card's flop rate per byte.
//     Design: the TPU kernel holds a whole plane in VMEM; a 200x200 float32
//     plane is 160 KB, more than a block's static shared memory. Here a block
//     owns one 32x32 output tile of one plane. It stages the tile plus a
//     2-pixel halo (36x36) in shared memory with zeros outside the plane, so
//     the zero padding costs no branches in the passes. The H pass writes
//     32x36 partial sums to shared memory, the W pass reads them and writes
//     the tile out. Each input byte is read about 1.27 times from device
//     memory (the halo), and loads and stores are coalesced along W.
//
// K2  f101_plane_mean_{f32,bf16}
//     Replaces food101_sr_tpu/ops/spatial_mean.py::_mean_kernel (launched by
//     _spatial_mean_raw): the global H*W mean of every (n, c) plane,
//     accumulated in float32 and returned in the input dtype (the SE-block
//     squeeze). Bound: bytes. It reads N*C*H*W elements once and writes N*C.
//     Design: the TPU kernel carries a sum across sequential grid steps in
//     its output block; CUDA blocks run in no order, so one block owns one
//     whole NCHW plane, which is contiguous. Threads stream it with 16-byte
//     loads (8 bf16 or 4 f32 values) where size and alignment allow, sum in
//     float32 registers, then reduce by warp shuffles and one shared-memory
//     step. No atomics and no second pass.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRadius = 2;
constexpr int kTaps = 2 * kRadius + 1;
constexpr int kTileW = 32;
constexpr int kTileH = 32;
constexpr int kThreadsY = 8;
constexpr int kInW = kTileW + 2 * kRadius;
constexpr int kInH = kTileH + 2 * kRadius;

struct Taps {
  float t[kTaps];
};

__global__ void __launch_bounds__(kTileW * kThreadsY)
blur5_kernel(const float* __restrict__ x, float* __restrict__ out, int h,
             int w, Taps taps) {
  __shared__ float s_in[kInH][kInW];
  __shared__ float s_v[kTileH][kInW];

  const size_t plane = static_cast<size_t>(blockIdx.z) * h * w;
  const int tile_y = blockIdx.y * kTileH;
  const int tile_x = blockIdx.x * kTileW;
  const int tid = threadIdx.y * kTileW + threadIdx.x;
  constexpr int kThreads = kTileW * kThreadsY;

  // tile + halo, zeros outside the plane (the conv's zero padding)
  for (int i = tid; i < kInH * kInW; i += kThreads) {
    const int r = i / kInW, c = i % kInW;
    const int gy = tile_y - kRadius + r, gx = tile_x - kRadius + c;
    s_in[r][c] = (gy >= 0 && gy < h && gx >= 0 && gx < w)
                     ? x[plane + static_cast<size_t>(gy) * w + gx]
                     : 0.f;
  }
  __syncthreads();

  // pass along H, over the full halo width (columns outside the plane stay 0)
  for (int i = tid; i < kTileH * kInW; i += kThreads) {
    const int r = i / kInW, c = i % kInW;
    float acc = 0.f;
#pragma unroll
    for (int k = 0; k < kTaps; ++k) acc += taps.t[k] * s_in[r + k][c];
    s_v[r][c] = acc;
  }
  __syncthreads();

  // pass along W, straight to device memory
  for (int i = tid; i < kTileH * kTileW; i += kThreads) {
    const int r = i / kTileW, c = i % kTileW;
    const int gy = tile_y + r, gx = tile_x + c;
    if (gy < h && gx < w) {
      float acc = 0.f;
#pragma unroll
      for (int k = 0; k < kTaps; ++k) acc += taps.t[k] * s_v[r][c + k];
      out[plane + static_cast<size_t>(gy) * w + gx] = acc;
    }
  }
}

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

// x, out: (planes, h, w) float32, contiguous, on `device`.
// planes <= 65535 (grid z); the wrapper checks.
int f101_blur5_f32(const void* x, void* out, int planes, int h, int w,
                   float t0, float t1, float t2, float t3, float t4,
                   int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Taps taps = {{t0, t1, t2, t3, t4}};
  const dim3 block(kTileW, kThreadsY);
  const dim3 grid((w + kTileW - 1) / kTileW, (h + kTileH - 1) / kTileH, planes);
  blur5_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out), h, w, taps);
  return static_cast<int>(cudaGetLastError());
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

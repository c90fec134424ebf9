// Why K2's NHWC kernel streams with plain 16-byte loads: it against two
// designs that stream each block's slab through shared memory with
// asynchronous copies, on one GPU, at the SE squeeze's serving shapes.
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
//       -o k2_variants tools/k2_nhwc_variants.cu && ./k2_variants
//
// All three share the shipped kernel's work split (a cluster of S blocks
// per image, a slab of pixels per block, one 16-byte channel group per
// lane) and its cluster reduction; they differ in how the bytes arrive:
//
//   shipped  nhwc_mean_kernel of food101_sr_tpu_torch/csrc/kernels.cu:
//            512 lanes, 4 independent __ldg of 16 bytes in flight each
//   bulk     256 lanes; one thread keeps a ring of 4 x 16 KB shared-memory
//            stages filled by cp.async.bulk, each completing on an
//            mbarrier; the block consumes a stage, syncs, refills it
//   cp.async 256 lanes; each lane keeps 8 of its own 16-byte cp.async
//            copies in flight in private shared-memory slots (no barrier)
//
// Also the plane kernel on the same bytes read as NCHW, for scale. Prints
// one line per (shape, design): milliseconds per launch over 50
// back-to-back launches (CUDA events) and one output value (each input
// value is 1 + (i % 7) / 8, so every mean is near 1.375).
#include "../food101_sr_tpu_torch/csrc/kernels.cu"

#include <cstdio>
#include <cstdlib>

namespace {

constexpr int kLanes = 256;
constexpr int kStageBytes = 16384;
constexpr int kStages = 4;
constexpr int kRingBytes = kStages * kStageBytes;
constexpr int kSlots = 8;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  const long long t0 = clock64();
  while (!done) {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (clock64() - t0 > 4000000000LL) __trap();  // never hang the card
  }
}

// this block's lane partials -> C sums; rank 0 adds the cluster's, in order
template <typename T>
__device__ void finish(float (&acc)[16 / sizeof(T)], int c, int rows, int gx,
                       int gy, float* red, float* sums, T* out, long long n,
                       float inv_hw) {
  constexpr int kVec = 16 / sizeof(T);
  cg::cluster_group cluster = cg::this_cluster();
  if (gy < rows)
    for (int k = 0; k < kVec; ++k) red[gy * c + gx * kVec + k] = acc[k];
  __syncthreads();
  for (int j = threadIdx.x; j < c; j += kLanes) {
    float s = 0.f;
    for (int r = 0; r < rows; ++r) s += red[r * c + j];
    sums[j] = s;
  }
  cluster.sync();
  if (cluster.block_rank() == 0)
    for (int j = threadIdx.x; j < c; j += kLanes) {
      float s = 0.f;
      for (int r = 0; r < static_cast<int>(cluster.num_blocks()); ++r)
        s += cluster.map_shared_rank(sums, r)[j];
      out[n * c + j] = from_f32<T>(s * inv_hw);
    }
  cluster.sync();
}

template <typename T>
__global__ void __launch_bounds__(kLanes)
bulk_ring_kernel(const T* __restrict__ x, T* __restrict__ out, int c,
                 long long hw, long long slab, float inv_hw) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ float red[kLanes * 8];
  float* sums = reinterpret_cast<float*>(smem + kRingBytes + kStages * 8);
  const int rank = static_cast<int>(cg::this_cluster().block_rank());
  const long long n = blockIdx.y;
  const long long p0 = min(hw, rank * slab), p1 = min(hw, p0 + slab);
  const int t = threadIdx.x;
  constexpr int kVec = 16 / sizeof(T);
  const int groups = c / kVec, rows = kLanes / groups;
  const int gx = t % groups, gy = t / groups;
  const int row_bytes = c * static_cast<int>(sizeof(T));
  const int stage_pix = kStageBytes / row_bytes;
  const long long npix = p1 - p0;
  const int nst = ceil_div(npix, stage_pix);
  const char* src = reinterpret_cast<const char*>(x) +
                    (static_cast<size_t>(n) * hw + p0) * row_bytes;
  const uint32_t ring0 = smem_addr(smem), bar0 = smem_addr(smem + kRingBytes);
  auto issue = [&](int i) {
    const long long first = static_cast<long long>(i) * stage_pix;
    const uint32_t bytes = static_cast<uint32_t>(
        min(static_cast<long long>(stage_pix), npix - first) * row_bytes);
    const uint32_t bar = bar0 + 8 * (i % kStages);
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                 :: "r"(bar), "r"(bytes) : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];"
        :: "r"(ring0 + (i % kStages) * kStageBytes),
           "l"(src + first * row_bytes), "r"(bytes), "r"(bar) : "memory");
  };
  if (t == 0) {
    for (int s = 0; s < kStages; ++s)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
                   :: "r"(bar0 + 8 * s) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (t == 0)
    for (int i = 0; i < min(kStages, nst); ++i) issue(i);
  float acc[kVec] = {};
  for (int i = 0; i < nst; ++i) {
    const int s = i % kStages;
    const int n_rows = static_cast<int>(
        min(static_cast<long long>(stage_pix),
            npix - static_cast<long long>(i) * stage_pix));
    mbar_wait(bar0 + 8 * s, (i / kStages) & 1);
    if (gy < rows) {
      const uint4* buf = reinterpret_cast<const uint4*>(smem + s * kStageBytes);
      for (int r = gy; r < n_rows; r += rows)
        add16<T, kVec>(buf[r * groups + gx], acc);
    }
    __syncthreads();
    if (t == 0 && i + kStages < nst) issue(i + kStages);
  }
  finish<T>(acc, c, rows, gx, gy, red, sums, out, n, inv_hw);
}

template <typename T>
__global__ void __launch_bounds__(kLanes)
lane_cp_async_kernel(const T* __restrict__ x, T* __restrict__ out, int c,
                     long long hw, long long slab, float inv_hw) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ float red[kLanes * 8];
  uint4* slots = reinterpret_cast<uint4*>(smem);
  float* sums = reinterpret_cast<float*>(smem + kLanes * kSlots * 16);
  const int rank = static_cast<int>(cg::this_cluster().block_rank());
  const long long n = blockIdx.y;
  const long long p0 = min(hw, rank * slab), p1 = min(hw, p0 + slab);
  constexpr int kVec = 16 / sizeof(T);
  const int groups = c / kVec, rows = kLanes / groups;
  const int gx = threadIdx.x % groups, gy = threadIdx.x / groups;
  float acc[kVec] = {};
  if (gy < rows) {
    const uint4* px = reinterpret_cast<const uint4*>(x) +
                      static_cast<size_t>(n) * hw * groups + gx;
    const uint32_t mine = smem_addr(slots + threadIdx.x);
    auto copy = [&](int k, long long p) {
      if (p < p1)
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;"
                     :: "r"(mine + k * kLanes * 16), "l"(px + p * groups)
                     : "memory");
      asm volatile("cp.async.commit_group;" ::: "memory");
    };
    long long p = p0 + gy;
    for (int k = 0; k < kSlots; ++k) copy(k, p + k * rows);
    for (int k = 0; p < p1; p += rows, k = (k + 1) % kSlots) {
      asm volatile("cp.async.wait_group %0;" :: "n"(kSlots - 1) : "memory");
      add16<T, kVec>(slots[k * kLanes + threadIdx.x], acc);
      copy(k, p + kSlots * rows);
    }
    asm volatile("cp.async.wait_group 0;" ::: "memory");
  }
  finish<T>(acc, c, rows, gx, gy, red, sums, out, n, inv_hw);
}

using Kernel = void (*)(const __nv_bfloat16*, __nv_bfloat16*, int, long long,
                        long long, float);

float time_variant(Kernel kernel, size_t dyn, int s, const void* x, void* out,
                   long long n, long long c, long long hw, cudaStream_t st) {
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(dyn));
  cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed,
                       1);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(s, static_cast<unsigned>(n), 1);
  cfg.blockDim = dim3(kLanes, 1, 1);
  cfg.dynamicSmemBytes = dyn;
  cfg.stream = st;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = s;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  const long long slab = (hw + s - 1) / s;
  cudaEvent_t a, b;
  cudaEventCreate(&a);
  cudaEventCreate(&b);
  for (int i = 0; i < 55; ++i) {
    if (i == 5) cudaEventRecord(a, st);
    if (cudaLaunchKernelEx(&cfg, kernel,
                           static_cast<const __nv_bfloat16*>(x),
                           static_cast<__nv_bfloat16*>(out),
                           static_cast<int>(c), hw, slab,
                           1.0f / static_cast<float>(hw)) != cudaSuccess)
      return -1.f;
  }
  cudaEventRecord(b, st);
  cudaEventSynchronize(b);
  float ms;
  cudaEventElapsedTime(&ms, a, b);
  return ms / 50;
}

template <typename F>
float time_launch(F launch, cudaStream_t st) {
  cudaEvent_t a, b;
  cudaEventCreate(&a);
  cudaEventCreate(&b);
  for (int i = 0; i < 55; ++i) {
    if (i == 5) cudaEventRecord(a, st);
    if (launch() != 0) return -1.f;
  }
  cudaEventRecord(b, st);
  cudaEventSynchronize(b);
  float ms;
  cudaEventElapsedTime(&ms, a, b);
  return ms / 50;
}

}  // namespace

int main() {
  const long long n = 8, c = 96;
  const size_t elems = n * c * 224 * 224;
  __nv_bfloat16 *x, *out;
  cudaMalloc(&x, elems * 2);
  cudaMalloc(&out, n * c * 2);
  __nv_bfloat16* h = static_cast<__nv_bfloat16*>(malloc(elems * 2));
  for (size_t i = 0; i < elems; ++i)
    h[i] = __float2bfloat16(1.0f + (i % 7) * 0.125f);
  cudaMemcpy(x, h, elems * 2, cudaMemcpyHostToDevice);
  free(h);
  cudaStream_t st;
  cudaStreamCreate(&st);
  cudaDeviceProp prop;
  cudaGetDeviceProperties(&prop, 0);
  printf("device %s\n", prop.name);
  for (long long side : {64LL, 224LL}) {
    const long long hw = side * side;
    const int s = cluster_size<__nv_bfloat16>(side == 64 ? 8 : 16);
    auto report = [&](const char* name, float ms) {
      __nv_bfloat16 o;
      cudaMemcpy(&o, out, 2, cudaMemcpyDeviceToHost);
      printf("8x96x%lldx%lld bf16 S=%d %-8s %.4f ms/launch (first mean %.4f)\n",
             side, side, s, name, ms, __bfloat162float(o));
    };
    cudaMemset(out, 0, n * c * 2);
    report("shipped", time_launch([&] {
      return f101_nhwc_mean_bf16(x, out, n, c, hw, 0, st); }, st));
    cudaMemset(out, 0, n * c * 2);
    report("bulk", time_variant(bulk_ring_kernel<__nv_bfloat16>,
                                kRingBytes + kStages * 8 + c * 4, s, x, out,
                                n, c, hw, st));
    cudaMemset(out, 0, n * c * 2);
    report("cp.async", time_variant(lane_cp_async_kernel<__nv_bfloat16>,
                                    kLanes * kSlots * 16 + c * 4, s, x, out,
                                    n, c, hw, st));
    cudaMemset(out, 0, n * c * 2);
    report("plane", time_launch([&] {
      return f101_plane_mean_bf16(x, out, n * c, hw, 0, st); }, st));
  }
  const cudaError_t err = cudaDeviceSynchronize();
  printf("status %s\n", cudaGetErrorString(err));
  return err == cudaSuccess ? 0 : 1;
}

// Minibatch standard-deviation statistic for Hopper (sm_90a), CUDA C++.
//
// Replaces the Pallas TPU kernel of the discriminator's last block:
//   minibatch_stddev_stat  <- pggan_tpu/ops/pallas_kernels.py `_mb_stddev_kernel`
//                             (reached through `minibatch_stddev_stat`)
//
// Input: x as [n, f] rows, one contiguous row of f values per sample (the
// channels_last 4x4 activation read as NHWC rows [N, H*W*C]), n = groups * sg.
// Output: out[group] (f32) = mean over the f features of
// sqrt(var + eps), var being the unbiased variance over the sg rows of the
// group (torch.var / jnp.var(ddof=1)). Math is f32; x is f32 or bf16.
//
// What bounds it on an H100: nothing but the launch at the path's size. The
// path calls it on [16, 4*4*512] (256 KB in bf16, 512 KB in f32) three times a
// train step: one read of x and a few FLOPs per element, a microsecond of
// device memory time at 3.35 TB/s.
//
// What the design does about it: one block per group (the Pallas kernel
// unrolled the groups in one grid step; here they run side by side). Each
// thread walks the features j = tid, tid + blockDim, ... ; for a feature it
// reads the sg values of the group (coalesced across the threads of a warp,
// since neighbouring threads take neighbouring features), takes their mean,
// then the sum of squared deviations in a second pass over the same values
// (served from L1), and adds sqrt(var + eps) to its own sum. The block then
// reduces the per-thread sums with warp shuffles and one shared-memory step,
// in a fixed order and without atomics, so the result is deterministic. Any
// sg >= 2 is taken, including sg = n when n is not a multiple of 4.
//
// Plain C interface for ctypes; the entry point returns cudaGetLastError()
// (0 on success) after the launch on the caller's stream. Nothing here
// allocates or synchronises.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__global__ void __launch_bounds__(kThreads)
mb_stddev_kernel(const T* __restrict__ x, float* __restrict__ out, int64_t f, int sg,
                 float eps) {
  const T* xg = x + static_cast<int64_t>(blockIdx.x) * sg * f;
  const float inv_sg = 1.f / static_cast<float>(sg);
  const float inv_dof = 1.f / static_cast<float>(sg - 1);

  float acc = 0.f;
  for (int64_t j = threadIdx.x; j < f; j += kThreads) {
    float mean = 0.f;
    for (int s = 0; s < sg; ++s) mean += to_f32(xg[s * f + j]);
    mean *= inv_sg;
    float ss = 0.f;
    for (int s = 0; s < sg; ++s) {
      const float d = to_f32(xg[s * f + j]) - mean;
      ss += d * d;
    }
    acc += sqrtf(ss * inv_dof + eps);
  }

  __shared__ float partial[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) {
    acc += __shfl_xor_sync(0xffffffffu, acc, offset);
  }
  if (lane == 0) partial[warp] = acc;
  __syncthreads();
  if (warp == 0) {
    float v = lane < kWarps ? partial[lane] : 0.f;
#pragma unroll
    for (int offset = 16; offset > 0; offset >>= 1) {
      v += __shfl_xor_sync(0xffffffffu, v, offset);
    }
    if (lane == 0) out[blockIdx.x] = v / static_cast<float>(f);
  }
}

}  // namespace

extern "C" {

// x: [n, f] of dtype (0 = float32, 1 = bfloat16); out: [n / sg] float32.
int pggan_minibatch_stddev_stat(const void* x, void* out, int64_t n, int64_t f, int sg,
                                int dtype, float eps, void* stream) {
  if (sg < 2 || n <= 0 || f <= 0 || n % sg != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t groups = n / sg;
  if (groups > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned int>(groups));
  const dim3 block(kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    mb_stddev_kernel<float><<<grid, block, 0, s>>>(
        static_cast<const float*>(x), static_cast<float*>(out), f, sg, eps);
  } else if (dtype == 1) {
    mb_stddev_kernel<__nv_bfloat16><<<grid, block, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<float*>(out), f, sg, eps);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

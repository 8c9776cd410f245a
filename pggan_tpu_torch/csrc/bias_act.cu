// Bias + leaky ReLU + gain (+ symmetric clamp) for Hopper (sm_90a), CUDA C++.
//
// Replaces the Pallas TPU kernel
//   bias_lrelu_gain  <- pggan_tpu/ops/pallas_kernels.py `_bias_lrelu_kernel`
//                       (reached through `bias_lrelu_gain` / `_bias_lrelu_core`)
// which serves `bias_act(act='lrelu')` and `filtered_lrelu`; the port's kernel
// also takes the clamp, which the Pallas kernel leaves to XLA, so StyleGAN2's
// clamped conv epilogues (`clamp(lrelu(x + b)·gain, ±256)`) are one launch.
//
// It reads a row-major [rows, cols] view of channel-last memory (a
// channels_last NCHW tensor, a contiguous [B, C] tensor, or any tensor whose
// channel axis is innermost) and writes, per element,
//   y = leaky_relu(x + b[c], slope) * gain,   c = the element's channel,
//   y = min(max(y, -clamp), clamp)            when clamp >= 0,
// in f32, rounded once to x's type. The clamp is two compares, so a NaN
// passes through it as through torch.clamp (fminf/fmaxf would drop it).
// x and y are f32 or bf16; b is f32 or x's type, or null for a zero bias.
//
// What bounds it on an H100: bytes. Three operations per element against
// one read of x and one write of y; the C-wide bias stays in L1/L2. The
// floor is one read and one write of the activation from device memory
// (at [16*256*256, 64] in f32: 268 MB each way, 0.160 ms at 3.35 TB/s).
//
// What the design does about it: one elementwise pass, a grid-stride loop
// over the flat index i with neighbouring threads on neighbouring
// addresses (coalesced). The channel is i % cols, computed once per thread
// and then advanced by the stride (mod cols) with an add and a compare, so
// the loop does no 64-bit division. The grid is a few waves of blocks per SM,
// so every SM streams. Vector loads (16 bytes a thread) are left for later.
//
// Plain C interface for ctypes; the entry point returns cudaGetLastError()
// (0 on success) after the launch on the caller's stream. Nothing here
// allocates or synchronises.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreadsPerBlock = 256;
constexpr int kBlocksPerSm = 8;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch's cast
}

template <typename T, typename B>
__global__ void __launch_bounds__(kThreadsPerBlock)
bias_lrelu_gain_kernel(const T* __restrict__ x, const B* __restrict__ b,
                       T* __restrict__ y, int64_t n, int cols, float slope,
                       float gain, float clamp) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int step = static_cast<int>(stride % cols);
  int c = static_cast<int>(i % cols);
  for (; i < n; i += stride) {
    float z = to_f32(x[i]);
    if (b != nullptr) z += to_f32(b[c]);
    float a = (z >= 0.f ? z : z * slope) * gain;
    if (clamp >= 0.f) a = a < -clamp ? -clamp : (a > clamp ? clamp : a);
    y[i] = from_f32<T>(a);
    c += step;
    if (c >= cols) c -= cols;
  }
}

template <typename T, typename B>
int launch(const void* x, const void* b, void* y, int64_t n, int cols, float slope,
           float gain, float clamp, cudaStream_t stream) {
  int device = 0;
  int sms = 0;
  if (const cudaError_t err = cudaGetDevice(&device)) return static_cast<int>(err);
  if (const cudaError_t err =
          cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) {
    return static_cast<int>(err);
  }
  const int64_t needed = (n + kThreadsPerBlock - 1) / kThreadsPerBlock;
  const int64_t cap = static_cast<int64_t>(sms) * kBlocksPerSm;
  const unsigned int blocks = static_cast<unsigned int>(needed < cap ? needed : cap);
  bias_lrelu_gain_kernel<T, B><<<blocks, kThreadsPerBlock, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const B*>(b), static_cast<T*>(y), n, cols,
      slope, gain, clamp);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x_dtype: 0 = float32, 1 = bfloat16; b_dtype: the same codes for b (ignored
// when b is null). n = rows * cols elements. clamp < 0: no clamp.
int pggan_bias_lrelu_gain(const void* x, const void* b, void* y, int64_t n, int cols,
                          int x_dtype, int b_dtype, float slope, float gain,
                          float clamp, void* stream) {
  if (n < 0 || cols <= 0 || (b != nullptr && b_dtype != 0 && b_dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool b_f32 = b == nullptr || b_dtype == 0;
  if (x_dtype == 0) {
    if (!b_f32) return static_cast<int>(cudaErrorInvalidValue);
    return launch<float, float>(x, b, y, n, cols, slope, gain, clamp, s);
  }
  if (x_dtype == 1) {
    return b_f32
               ? launch<__nv_bfloat16, float>(x, b, y, n, cols, slope, gain, clamp, s)
               : launch<__nv_bfloat16, __nv_bfloat16>(x, b, y, n, cols, slope, gain,
                                                      clamp, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"

// Row-wise pixel normalisation kernels for Hopper (sm_90a), CUDA C++.
//
// Replaces three Pallas TPU kernels of the generator:
//   pixel_norm_fwd        <- pggan_tpu/ops/pallas_kernels.py `_pixel_norm_kernel`
//                            (reached through `pixel_norm`)
//   lrelu_pixel_norm_fwd  <- pggan_tpu/ops/pallas_kernels.py `_lrelu_pn_fwd_kernel`
//                            (reached through `lrelu_pixel_norm` / `_lrelu_pn_call`)
//   lrelu_pixel_norm_bwd  <- pggan_tpu/ops/pallas_kernels.py `_lrelu_pn_bwd_kernel`
//                            (reached through `_lrelu_pn_bwd_rule` / `_lrelu_pn_call`)
//
// All read a row-major [rows, cols] view of channel-last memory (NHWC, i.e.
// a channels_last NCHW tensor, or a contiguous [B, C] latent). The forwards
// compute, per row, y = z * rsqrt(mean(z^2) + eps) with z = x (pixel_norm) or
// z = leaky_relu(x, slope) (lrelu_pixel_norm). The backward recomputes z and
// inv = rsqrt(mean(z^2) + eps) from the saved x and, with the incoming
// gradient g, writes dx = lrelu'(x) * (inv * g - z * inv^3 * mean(z * g)).
// Math is f32; every tensor has one type (f32 or bf16).
//
// What bounds them on an H100: bytes. Each element is read, squared and summed,
// then scaled and written: a few FLOPs per byte, far below the card's ridge
// point, so the floor is one read and one write of the activation from device
// memory (the largest call at 256x256, batch 16, is [16*256*256, 64]: 268 MB
// in and 268 MB out in f32), and for the backward two reads (x, g) and one
// write (dx).
//
// What the design does about it: one warp owns one row. Lanes read
// neighbouring addresses (coalesced), the row's sum of squares is reduced
// with warp shuffles (no shared memory, no second launch), and the scaling
// pass re-reads the row, which the warp touched a moment earlier, so the
// re-read is served mostly from L1/L2 rather than device memory. Any cols
// (ragged tails are handled by the strided loop) and any rows (a ragged last
// block is masked by the row test) are accepted. Vector loads and several rows
// per warp for small cols are left for later.
//
// The backward is the same design with two running sums (z*z and z*g) in the
// first pass and the second pass re-reading both rows.
//
// Plain C interface for ctypes; each entry point returns cudaGetLastError()
// (0 on success) after the launch on the caller's stream. Nothing here
// allocates or synchronises.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kThreadsPerBlock = kWarpsPerBlock * 32;

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

template <bool kLrelu>
__device__ __forceinline__ float activate(float v, float slope) {
  if (kLrelu) return v >= 0.f ? v : v * slope;
  return v;
}

template <typename T, bool kLrelu>
__global__ void __launch_bounds__(kThreadsPerBlock)
norm_rows_kernel(const T* __restrict__ x, T* __restrict__ y, int64_t rows,
                 int cols, float slope, float eps) {
  const int lane = threadIdx.x & 31;
  const int64_t row =
      static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  // The row is the same for all 32 lanes, so a warp leaves as a whole and the
  // full-mask shuffles below never see an exited lane.
  if (row >= rows) return;
  const T* xr = x + row * cols;
  T* yr = y + row * cols;

  float sum_sq = 0.f;
  for (int c = lane; c < cols; c += 32) {
    const float z = activate<kLrelu>(to_f32(xr[c]), slope);
    sum_sq += z * z;
  }
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) {
    sum_sq += __shfl_xor_sync(0xffffffffu, sum_sq, offset);
  }
  const float inv = rsqrtf(sum_sq / static_cast<float>(cols) + eps);

  for (int c = lane; c < cols; c += 32) {
    const float z = activate<kLrelu>(to_f32(xr[c]), slope);
    yr[c] = from_f32<T>(z * inv);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreadsPerBlock)
lrelu_norm_rows_bwd_kernel(const T* __restrict__ x, const T* __restrict__ g,
                           T* __restrict__ dx, int64_t rows, int cols, float slope,
                           float eps) {
  const int lane = threadIdx.x & 31;
  const int64_t row =
      static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;  // whole warps leave, as in norm_rows_kernel
  const T* xr = x + row * cols;
  const T* gr = g + row * cols;
  T* dr = dx + row * cols;

  float sum_zz = 0.f;
  float sum_zg = 0.f;
  for (int c = lane; c < cols; c += 32) {
    const float z = activate<true>(to_f32(xr[c]), slope);
    sum_zz += z * z;
    sum_zg += z * to_f32(gr[c]);
  }
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) {
    sum_zz += __shfl_xor_sync(0xffffffffu, sum_zz, offset);
    sum_zg += __shfl_xor_sync(0xffffffffu, sum_zg, offset);
  }
  const float inv_cols = 1.f / static_cast<float>(cols);
  const float inv = rsqrtf(sum_zz * inv_cols + eps);
  const float k = inv * inv * inv * (sum_zg * inv_cols);

  for (int c = lane; c < cols; c += 32) {
    const float xv = to_f32(xr[c]);
    const float z = activate<true>(xv, slope);
    const float dz = inv * to_f32(gr[c]) - z * k;
    dr[c] = from_f32<T>(xv >= 0.f ? dz : dz * slope);
  }
}

// One warp per row, kWarpsPerBlock rows per block; fails on a grid that
// does not fit.
int row_grid(int64_t rows, int cols, dim3* grid) {
  if (rows < 0 || cols <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t blocks = (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  *grid = dim3(static_cast<unsigned int>(blocks));
  return static_cast<int>(cudaSuccess);
}

// dtype: 0 = float32, 1 = bfloat16.
template <bool kLrelu>
int launch_norm_rows(const void* x, void* y, int64_t rows, int cols, int dtype,
                     float slope, float eps, void* stream) {
  dim3 grid;
  if (const int err = row_grid(rows, cols, &grid)) return err;
  if (rows == 0) return static_cast<int>(cudaSuccess);
  const dim3 block(kThreadsPerBlock);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    norm_rows_kernel<float, kLrelu><<<grid, block, 0, s>>>(
        static_cast<const float*>(x), static_cast<float*>(y), rows, cols, slope, eps);
  } else if (dtype == 1) {
    norm_rows_kernel<__nv_bfloat16, kLrelu><<<grid, block, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(y), rows,
        cols, slope, eps);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

int launch_lrelu_norm_rows_bwd(const void* x, const void* g, void* dx, int64_t rows,
                               int cols, int dtype, float slope, float eps,
                               void* stream) {
  dim3 grid;
  if (const int err = row_grid(rows, cols, &grid)) return err;
  if (rows == 0) return static_cast<int>(cudaSuccess);
  const dim3 block(kThreadsPerBlock);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    lrelu_norm_rows_bwd_kernel<float><<<grid, block, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(g),
        static_cast<float*>(dx), rows, cols, slope, eps);
  } else if (dtype == 1) {
    lrelu_norm_rows_bwd_kernel<__nv_bfloat16><<<grid, block, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(g),
        static_cast<__nv_bfloat16*>(dx), rows, cols, slope, eps);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int pggan_pixel_norm_fwd(const void* x, void* y, int64_t rows, int cols, int dtype,
                         float eps, void* stream) {
  return launch_norm_rows<false>(x, y, rows, cols, dtype, 0.f, eps, stream);
}

int pggan_lrelu_pixel_norm_fwd(const void* x, void* y, int64_t rows, int cols,
                               int dtype, float slope, float eps, void* stream) {
  return launch_norm_rows<true>(x, y, rows, cols, dtype, slope, eps, stream);
}

int pggan_lrelu_pixel_norm_bwd(const void* x, const void* g, void* dx, int64_t rows,
                               int cols, int dtype, float slope, float eps,
                               void* stream) {
  return launch_lrelu_norm_rows_bwd(x, g, dx, rows, cols, dtype, slope, eps, stream);
}

const char* pggan_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

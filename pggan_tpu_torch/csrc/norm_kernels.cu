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
// Math is f32 with one rounding of each output; every tensor has one type
// (f32 or bf16).
//
// What bounds them on an H100: bytes. Each element is read, squared and summed,
// then scaled and written: a few FLOPs per byte, far below the card's ridge
// point, so the floor is one read and one write of the activation from device
// memory (the largest call at 256x256, batch 16, is [16*256*256, 64]: 268 MB
// in and 268 MB out in f32, 134 + 134 MB in bf16), and for the backward two
// reads (x, g) and one write (dx). The smallest calls ([16, 512] and
// [16*4*4, 512]) move a few hundred kB: there the launch is the cost.
//
// What the forward's design does about it (norm_rows_vec_kernel): each row is
// read from device memory once, into registers, in 16-byte vectors (4 f32 or
// 8 bf16 values), neighbouring lanes on neighbouring vectors, so a warp's
// load is one stretch of up to 512 contiguous bytes. A row gets
// L = min(32, vectors a row) lanes, rounded down to a power of two, and a
// warp holds 32 / L rows: at C = 64 a bf16 row is 8 vectors, so a warp
// normalises 4 rows with one load and one store a lane; at C = 512 a row
// takes all 32 lanes with 2 (bf16) or 4 (f32) vectors each. The sum of
// squares is reduced with xor shuffles inside the L-lane segment (offsets
// < L), and the scaling reads the row from the registers it was loaded
// into. The vectors a lane holds are a template parameter, up to
// kMaxVecsPerLane = 8 (rows of up to 4096 bytes: C <= 1024 in f32, 2048 in
// bf16), so the loads are unrolled and kept in registers. A row that is not
// a multiple of 16 bytes, a pointer that is not 16-byte aligned, or a longer
// row goes to norm_rows_kernel, the generic branch: one warp per row, scalar
// loads, the row re-read for the scaling. `norm_rows_plan` picks the branch
// and the launch follows it; `pggan_norm_rows_plan` reports it.
//
// The backward (lrelu_norm_rows_bwd_vec_kernel) follows the same plan over
// its three pointers (x, g and dx): each lane loads its x and g vectors once
// into registers, the two row sums (z*z and z*g) are reduced with xor
// shuffles inside the L-lane segment, and dx is computed from the registers
// and written once as 16-byte vectors, with one rounding to the tensor's
// type. At C = 64 in bf16 a warp holds 4 rows with one x and one g vector a
// lane. Rows the plan refuses go to lrelu_norm_rows_bwd_kernel, the generic
// branch: one warp per row, scalar loads, x and g re-read for the output.
//
// Plain C interface for ctypes; each entry point returns cudaGetLastError()
// (0 on success) after the launch on the caller's stream. Nothing here
// allocates or synchronises.

#include <cstdint>
#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kThreadsPerBlock = kWarpsPerBlock * 32;
constexpr int kVecBytes = 16;
constexpr int kMaxVecsPerLane = 8;

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

// 16 bytes of T as f32 values and back (one rounding to T on the way back).
template <typename T>
struct Vec16;

template <>
struct Vec16<float> {
  static constexpr int kValues = 4;
  __device__ __forceinline__ static void unpack(const uint4& v, float* f) {
    f[0] = __uint_as_float(v.x);
    f[1] = __uint_as_float(v.y);
    f[2] = __uint_as_float(v.z);
    f[3] = __uint_as_float(v.w);
  }
  __device__ __forceinline__ static uint4 pack(const float* f) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]),
                      __float_as_uint(f[3]));
  }
};

template <>
struct Vec16<__nv_bfloat16> {
  static constexpr int kValues = 8;
  __device__ __forceinline__ static void unpack(const uint4& v, float* f) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 p = __bfloat1622float2(h[i]);
      f[2 * i] = p.x;
      f[2 * i + 1] = p.y;
    }
  }
  __device__ __forceinline__ static uint4 pack(const float* f) {
    uint4 v;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);  // round to nearest even
    }
    return v;
  }
};

// The vector branch. x and y are [rows, vecs_per_row] 16-byte vectors; lane
// `seg` of a row's L = 1 << lanes_log2 lanes holds vectors seg, seg + L, ...
// (at most kVecs of them).
template <typename T, bool kLrelu, int kVecs>
__global__ void __launch_bounds__(kThreadsPerBlock)
norm_rows_vec_kernel(const uint4* __restrict__ x, uint4* __restrict__ y, int64_t rows,
                     int vecs_per_row, int lanes_log2, int cols, float slope, float eps) {
  using V = Vec16<T>;
  const int lane = threadIdx.x & 31;
  const int lanes = 1 << lanes_log2;
  const int seg = lane & (lanes - 1);
  const int64_t warp = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  const int64_t first_row = warp << (5 - lanes_log2);
  // Whole warps leave, so the full-mask shuffles below never see an exited
  // lane; a lane past the last row takes part in them with a zero sum.
  if (first_row >= rows) return;
  const int64_t row = first_row + (lane >> lanes_log2);
  const bool live = row < rows;
  const uint4* xr = x + row * vecs_per_row;
  uint4* yr = y + row * vecs_per_row;

  uint4 v[kVecs];
  float sum_sq = 0.f;
#pragma unroll
  for (int k = 0; k < kVecs; ++k) {
    const int c = seg + k * lanes;
    if (live && c < vecs_per_row) {
      v[k] = __ldg(xr + c);
      float f[V::kValues];
      V::unpack(v[k], f);
#pragma unroll
      for (int i = 0; i < V::kValues; ++i) {
        const float z = activate<kLrelu>(f[i], slope);
        sum_sq += z * z;
      }
    }
  }
  for (int offset = lanes >> 1; offset > 0; offset >>= 1) {
    sum_sq += __shfl_xor_sync(0xffffffffu, sum_sq, offset);
  }
  const float inv = rsqrtf(sum_sq / static_cast<float>(cols) + eps);

#pragma unroll
  for (int k = 0; k < kVecs; ++k) {
    const int c = seg + k * lanes;
    if (live && c < vecs_per_row) {
      float f[V::kValues];
      V::unpack(v[k], f);
#pragma unroll
      for (int i = 0; i < V::kValues; ++i) f[i] = activate<kLrelu>(f[i], slope) * inv;
      yr[c] = V::pack(f);
    }
  }
}

// The generic branch: one warp per row, scalar loads, any cols and any
// alignment of the element type.
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

// The backward's vector branch: x, g and dx as [rows, vecs_per_row] 16-byte
// vectors, lanes and rows as in norm_rows_vec_kernel.
template <typename T, int kVecs>
__global__ void __launch_bounds__(kThreadsPerBlock)
lrelu_norm_rows_bwd_vec_kernel(const uint4* __restrict__ x, const uint4* __restrict__ g,
                               uint4* __restrict__ dx, int64_t rows, int vecs_per_row,
                               int lanes_log2, int cols, float slope, float eps) {
  using V = Vec16<T>;
  const int lane = threadIdx.x & 31;
  const int lanes = 1 << lanes_log2;
  const int seg = lane & (lanes - 1);
  const int64_t warp = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  const int64_t first_row = warp << (5 - lanes_log2);
  if (first_row >= rows) return;  // whole warps leave, as in norm_rows_vec_kernel
  const int64_t row = first_row + (lane >> lanes_log2);
  const bool live = row < rows;
  const int64_t base = row * vecs_per_row;

  // All loads first, so a lane has 2 * kVecs 16-byte loads in flight.
  uint4 xv[kVecs], gv[kVecs];
#pragma unroll
  for (int k = 0; k < kVecs; ++k) {
    const int c = seg + k * lanes;
    if (live && c < vecs_per_row) {
      xv[k] = __ldg(x + base + c);
      gv[k] = __ldg(g + base + c);
    }
  }
  float sum_zz = 0.f;
  float sum_zg = 0.f;
#pragma unroll
  for (int k = 0; k < kVecs; ++k) {
    const int c = seg + k * lanes;
    if (live && c < vecs_per_row) {
      float xf[V::kValues], gf[V::kValues];
      V::unpack(xv[k], xf);
      V::unpack(gv[k], gf);
#pragma unroll
      for (int i = 0; i < V::kValues; ++i) {
        const float z = activate<true>(xf[i], slope);
        sum_zz += z * z;
        sum_zg += z * gf[i];
      }
    }
  }
  for (int offset = lanes >> 1; offset > 0; offset >>= 1) {
    sum_zz += __shfl_xor_sync(0xffffffffu, sum_zz, offset);
    sum_zg += __shfl_xor_sync(0xffffffffu, sum_zg, offset);
  }
  const float inv_cols = 1.f / static_cast<float>(cols);
  const float inv = rsqrtf(sum_zz * inv_cols + eps);
  const float k3 = inv * inv * inv * (sum_zg * inv_cols);

#pragma unroll
  for (int k = 0; k < kVecs; ++k) {
    const int c = seg + k * lanes;
    if (live && c < vecs_per_row) {
      float xf[V::kValues], gf[V::kValues];
      V::unpack(xv[k], xf);
      V::unpack(gv[k], gf);
#pragma unroll
      for (int i = 0; i < V::kValues; ++i) {
        const float dz = inv * gf[i] - activate<true>(xf[i], slope) * k3;
        xf[i] = xf[i] >= 0.f ? dz : dz * slope;
      }
      dx[base + c] = V::pack(xf);
    }
  }
}

// Blocks of kThreadsPerBlock threads for `rows` rows at `rows_per_block`;
// fails on a grid that does not fit.
int row_grid(int64_t rows, int cols, int64_t rows_per_block, dim3* grid) {
  if (rows < 0 || cols <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t blocks = (rows + rows_per_block - 1) / rows_per_block;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  *grid = dim3(static_cast<unsigned int>(blocks));
  return static_cast<int>(cudaSuccess);
}

int elem_bytes(int dtype) { return dtype == 0 ? 4 : dtype == 1 ? 2 : 0; }

// The bits of every pointer of a call, ORed: 16-byte aligned iff all are.
uintptr_t pointer_bits(const void* a, const void* b, const void* c = nullptr) {
  return reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b) |
         reinterpret_cast<uintptr_t>(c);
}

// The row kernels' branch for rows of `cols` values of `bytes` bytes at
// pointers whose bits OR to `ptr_bits` (the forwards: x and y; the
// backward: x, g and dx): the vector branch (lanes a row, a power of two
// <= 32, and vectors a lane) when a row is a whole number of 16-byte
// vectors, every pointer is 16-byte aligned and a row fits kMaxVecsPerLane
// vectors a lane; else the generic branch (*lanes = *vecs = 0).
void norm_rows_plan(uintptr_t ptr_bits, int cols, int bytes, int* lanes_log2, int* vecs) {
  *lanes_log2 = 0;
  *vecs = 0;
  const int64_t row_bytes = static_cast<int64_t>(cols) * bytes;
  if (cols <= 0 || row_bytes % kVecBytes != 0 || ptr_bits % kVecBytes != 0 ||
      row_bytes > static_cast<int64_t>(32) * kMaxVecsPerLane * kVecBytes) {
    return;
  }
  const int per_row = static_cast<int>(row_bytes / kVecBytes);
  int lanes_log2_ = 0;
  while (lanes_log2_ < 5 && (2 << lanes_log2_) <= per_row) ++lanes_log2_;
  *lanes_log2 = lanes_log2_;
  *vecs = (per_row + (1 << lanes_log2_) - 1) >> lanes_log2_;
}

// Calls launch(std::integral_constant<int, vecs>) for vecs in 1..8, the
// vector branch's template argument; fails on any other count.
template <typename Launch>
int dispatch_vecs(int vecs, Launch&& launch) {
  switch (vecs) {
    case 1: launch(std::integral_constant<int, 1>{}); break;
    case 2: launch(std::integral_constant<int, 2>{}); break;
    case 3: launch(std::integral_constant<int, 3>{}); break;
    case 4: launch(std::integral_constant<int, 4>{}); break;
    case 5: launch(std::integral_constant<int, 5>{}); break;
    case 6: launch(std::integral_constant<int, 6>{}); break;
    case 7: launch(std::integral_constant<int, 7>{}); break;
    case 8: launch(std::integral_constant<int, 8>{}); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaSuccess);
}

// Rows a block of the plan's branch takes: 8 on the generic branch (a warp
// a row), 8 * 32 / L on the vector one.
int64_t block_rows(int lanes_log2, int vecs) {
  return vecs == 0 ? kWarpsPerBlock : static_cast<int64_t>(kWarpsPerBlock) << (5 - lanes_log2);
}

template <typename T, bool kLrelu>
int launch_norm_rows_typed(const void* x, void* y, int64_t rows, int cols, float slope,
                           float eps, cudaStream_t s) {
  int lanes_log2 = 0, vecs = 0;
  norm_rows_plan(pointer_bits(x, y), cols, static_cast<int>(sizeof(T)), &lanes_log2, &vecs);
  dim3 grid;
  if (const int err = row_grid(rows, cols, block_rows(lanes_log2, vecs), &grid)) return err;
  if (rows == 0) return static_cast<int>(cudaSuccess);
  if (vecs == 0) {
    norm_rows_kernel<T, kLrelu><<<grid, kThreadsPerBlock, 0, s>>>(
        static_cast<const T*>(x), static_cast<T*>(y), rows, cols, slope, eps);
  } else {
    const int per_row = cols * static_cast<int>(sizeof(T)) / kVecBytes;
    const int err = dispatch_vecs(vecs, [&](auto k) {
      norm_rows_vec_kernel<T, kLrelu, decltype(k)::value><<<grid, kThreadsPerBlock, 0, s>>>(
          static_cast<const uint4*>(x), static_cast<uint4*>(y), rows, per_row, lanes_log2,
          cols, slope, eps);
    });
    if (err) return err;
  }
  return static_cast<int>(cudaGetLastError());
}

// dtype: 0 = float32, 1 = bfloat16.
template <bool kLrelu>
int launch_norm_rows(const void* x, void* y, int64_t rows, int cols, int dtype,
                     float slope, float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch_norm_rows_typed<float, kLrelu>(x, y, rows, cols, slope, eps, s);
  }
  if (dtype == 1) {
    return launch_norm_rows_typed<__nv_bfloat16, kLrelu>(x, y, rows, cols, slope, eps, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int launch_lrelu_norm_rows_bwd_typed(const void* x, const void* g, void* dx, int64_t rows,
                                     int cols, float slope, float eps, cudaStream_t s) {
  int lanes_log2 = 0, vecs = 0;
  norm_rows_plan(pointer_bits(x, g, dx), cols, static_cast<int>(sizeof(T)), &lanes_log2,
                 &vecs);
  dim3 grid;
  if (const int err = row_grid(rows, cols, block_rows(lanes_log2, vecs), &grid)) return err;
  if (rows == 0) return static_cast<int>(cudaSuccess);
  if (vecs == 0) {
    lrelu_norm_rows_bwd_kernel<T><<<grid, kThreadsPerBlock, 0, s>>>(
        static_cast<const T*>(x), static_cast<const T*>(g), static_cast<T*>(dx), rows, cols,
        slope, eps);
  } else {
    const int per_row = cols * static_cast<int>(sizeof(T)) / kVecBytes;
    const int err = dispatch_vecs(vecs, [&](auto k) {
      lrelu_norm_rows_bwd_vec_kernel<T, decltype(k)::value><<<grid, kThreadsPerBlock, 0, s>>>(
          static_cast<const uint4*>(x), static_cast<const uint4*>(g), static_cast<uint4*>(dx),
          rows, per_row, lanes_log2, cols, slope, eps);
    });
    if (err) return err;
  }
  return static_cast<int>(cudaGetLastError());
}

int launch_lrelu_norm_rows_bwd(const void* x, const void* g, void* dx, int64_t rows,
                               int cols, int dtype, float slope, float eps,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch_lrelu_norm_rows_bwd_typed<float>(x, g, dx, rows, cols, slope, eps, s);
  }
  if (dtype == 1) {
    return launch_lrelu_norm_rows_bwd_typed<__nv_bfloat16>(x, g, dx, rows, cols, slope, eps,
                                                           s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
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

// The branch the row kernels take for cols values a row at pointers a and b
// (the forwards' x and y; the backward's x and g, or g and dx: the plan is
// the same function of every pointer of the call, and a null pointer
// counts as aligned): *lanes lanes a row and *vecs 16-byte vectors a lane,
// or 0 and 0 for the generic branch. Touches no memory behind a or b.
int pggan_norm_rows_plan(const void* a, const void* b, int cols, int dtype, int* lanes,
                         int* vecs) {
  const int bytes = elem_bytes(dtype);
  if (bytes == 0) return static_cast<int>(cudaErrorInvalidValue);
  int lanes_log2 = 0;
  norm_rows_plan(pointer_bits(a, b), cols, bytes, &lanes_log2, vecs);
  *lanes = *vecs == 0 ? 0 : 1 << lanes_log2;
  return static_cast<int>(cudaSuccess);
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

// Polyphase FIR resampling (upfirdn2d) for Hopper (sm_90a), CUDA C++.
//
// Replaces no TPU kernel: the JAX package computes upfirdn2d in XLA ops
// (pggan_tpu/ops/resample.py:70-116). The port computed it the same way, as
// a zero-inserted padded copy, cast to f32 and run through a depthwise
// F.conv2d, and on an H100 that ran StyleGAN2's 2x upsamples at ~0.7 % of
// their bytes' bound (cuDNN's conv2d_grouped_direct_kernel, 12 of its 16
// taps on inserted zeros). This kernel computes the same function,
//   y[n, oy, ox, c] = sum_{ky < fh, kx < fw} w[ky][kx] * xp[oy*downy + ky][ox*downx + kx],
// where xp is x with up - 1 zeros after each sample along each axis, padded
// by pady0 rows and padx0 columns in front (negative pads crop), and w the
// correlation weights: the filter (its outer product for a 1-D one),
// flipped unless `flip`, times `gain`, rounded to x's type as the
// composition rounds its conv weight. The sum runs in f32 and is rounded to
// x's type once. x is [N, H, W, C] and y [N, OH, OW, C]: the NHWC bytes of
// channels_last NCHW tensors. x and y are f32 or bf16; the filter is f32 on
// the device, up to 8 taps an axis; up and down are 1 or 2 on each axis.
//
// What bounds it on an H100: bytes. A 2x upsample through a 4x4 filter does
// 4 multiply-adds an output element against one read of x and one write of
// y, which is 4x x's size (conv0 at 1024^2: 1.07 GB read and 4.31 GB written
// in bf16, 1.6 ms at 3.35 TB/s).
//
// What the design does about it: each element of x is read from device
// memory once and each element of y written once, in the tensors' own type,
// and no inserted zero is loaded or multiplied.
//  - up 2 and down 1 on both axes (StyleGAN2's upsample2d, filtered_lrelu's
//    up stage): the polyphase kernel. A thread owns one 16-byte channel
//    vector of a 2x2 quad of outputs whose first row and column lie on the
//    phase that takes the filter's odd taps; the second row and column then
//    take its even taps from the same input rows and columns, so all four
//    outputs read the same ceil(fh/2) x ceil(fw/2) input vectors (2x2 for
//    [1,3,3,1]): 4 loads, 4 stores and 16 multiply-adds a vector. Quads
//    that share input rows or columns are neighbours in the grid, so the
//    repeated loads hit L1/L2.
//  - every other (up, down) in {1,2}^2: one output pixel a thread; a tap
//    whose input is an inserted zero or padding is skipped by index
//    arithmetic.
//  - the block's first 64 threads compute the 8x8 (zero-padded) weights
//    into shared memory from the filter on the device, so the host never
//    reads the filter back.
//  - grid: x over (pixel or quad column, channel vector) in 32-bit, y over
//    output rows (quad rows), z over the batch, so no 64-bit division;
//    neighbouring threads on neighbouring 16-byte vectors (coalesced).
//  - vectors: 4 f32 or 8 bf16 a load when C fills whole 16-byte vectors and
//    x and y are 16-byte aligned; one element a load otherwise (StyleGAN2's
//    RGB skip, C = 3).
//
// Plain C interface for ctypes; the entry point returns cudaGetLastError()
// (0 on success) after the launch on the caller's stream. Nothing here
// allocates or synchronises.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreadsPerBlock = 256;
constexpr int kMaxTaps = 8;              // taps an axis
constexpr int kMaxGrid = 65535;          // gridDim.y and gridDim.z

struct Geometry {
  int n, c, h, w;                        // x: [n, h, w, c]
  int oh, ow;                            // y: [n, oh, ow, c]
  int upx, upy, downx, downy;
  int padx0, pady0;                      // leading pads (negative: crops)
  int fh, fw;                            // taps
  int vecs;                              // channel vectors a pixel
  int cols;                              // output pixels (quads) a row
};

struct Filter {
  const float* f;                        // on the device; null: one tap of 1
  int ndim;                              // 1: fh = fw taps, their outer product; 2: [fh, fw]
  int flip;                              // 1: f is the correlation; 0: f is flipped
  float gain;
};

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

template <typename T, int kVec>
struct alignas(sizeof(T) * kVec) Pack {
  T v[kVec];
};

template <typename T, int kVec>
__device__ __forceinline__ void load_vec(const T* p, float (&out)[kVec]) {
  const Pack<T, kVec> pk = *reinterpret_cast<const Pack<T, kVec>*>(p);
#pragma unroll
  for (int e = 0; e < kVec; ++e) out[e] = to_f32(pk.v[e]);
}

template <typename T, int kVec>
__device__ __forceinline__ void store_vec(T* p, const float (&in)[kVec]) {
  Pack<T, kVec> pk;
#pragma unroll
  for (int e = 0; e < kVec; ++e) pk.v[e] = from_f32<T>(in[e]);
  *reinterpret_cast<Pack<T, kVec>*>(p) = pk;
}

// w[ky * kMaxTaps + kx] = the correlation weight of tap (ky, kx), rounded to
// T as the composition rounds its conv weight; 0 outside the filter. Ends
// with the block's barrier.
template <typename T>
__device__ void load_taps(const Geometry& g, const Filter& filt, float* w) {
  for (int i = threadIdx.x; i < kMaxTaps * kMaxTaps; i += blockDim.x) {
    const int ky = i / kMaxTaps;
    const int kx = i % kMaxTaps;
    float v = 0.f;
    if (ky < g.fh && kx < g.fw) {
      const int sy = filt.flip ? ky : g.fh - 1 - ky;
      const int sx = filt.flip ? kx : g.fw - 1 - kx;
      float f = 1.f;
      if (filt.ndim == 1) f = filt.f[sy] * filt.f[sx];
      if (filt.ndim == 2) f = filt.f[sy * g.fw + sx];
      v = to_f32(from_f32<T>(f * filt.gain));
    }
    w[i] = v;
  }
  __syncthreads();
}

__device__ __forceinline__ int64_t pixel(const Geometry& g, int n, int iy, int ix) {
  return ((static_cast<int64_t>(n) * g.h + iy) * g.w + ix) * g.c;
}

// up 2, down 1 on both axes; kWin = ceil(max(fh, fw) / 2) rounded up to 2 or 4.
template <typename T, int kVec, int kWin>
__global__ void __launch_bounds__(kThreadsPerBlock)
upfirdn2d_up2_kernel(const T* __restrict__ x, T* __restrict__ y, Geometry g, Filter filt) {
  __shared__ float w[kMaxTaps * kMaxTaps];
  load_taps<T>(g, filt, w);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= g.cols * g.vecs) return;
  const int c0 = (i % g.vecs) * kVec;
  const int qx = i / g.vecs;
  const int qy = blockIdx.y;
  const int n = blockIdx.z;
  // Output oy0 takes the odd taps when oy0 - pady0 is odd; its input rows
  // are then iy0 + j (tap 2j + 1), and oy0 + 1's the same rows (tap 2j).
  const int oy0 = 2 * qy - 1 + (g.pady0 & 1);
  const int ox0 = 2 * qx - 1 + (g.padx0 & 1);
  const int iy0 = qy - (g.pady0 >> 1);
  const int ix0 = qx - (g.padx0 >> 1);
  const int wh = (g.fh + 1) >> 1;
  const int ww = (g.fw + 1) >> 1;
  float acc[2][2][kVec];
#pragma unroll
  for (int d = 0; d < 4; ++d)
#pragma unroll
    for (int e = 0; e < kVec; ++e) acc[d >> 1][d & 1][e] = 0.f;
#pragma unroll
  for (int j = 0; j < kWin; ++j) {
    const int iy = iy0 + j;
    if (j >= wh || iy < 0 || iy >= g.h) continue;
#pragma unroll
    for (int k = 0; k < kWin; ++k) {
      const int ix = ix0 + k;
      if (k >= ww || ix < 0 || ix >= g.w) continue;
      float xv[kVec];
      load_vec<T, kVec>(x + pixel(g, n, iy, ix) + c0, xv);
#pragma unroll
      for (int dy = 0; dy < 2; ++dy) {
#pragma unroll
        for (int dx = 0; dx < 2; ++dx) {
          const float tap = w[(2 * j + 1 - dy) * kMaxTaps + 2 * k + 1 - dx];
#pragma unroll
          for (int e = 0; e < kVec; ++e) acc[dy][dx][e] += tap * xv[e];
        }
      }
    }
  }
#pragma unroll
  for (int dy = 0; dy < 2; ++dy) {
    const int oy = oy0 + dy;
    if (oy < 0 || oy >= g.oh) continue;
#pragma unroll
    for (int dx = 0; dx < 2; ++dx) {
      const int ox = ox0 + dx;
      if (ox < 0 || ox >= g.ow) continue;
      const int64_t at = ((static_cast<int64_t>(n) * g.oh + oy) * g.ow + ox) * g.c + c0;
      store_vec<T, kVec>(y + at, acc[dy][dx]);
    }
  }
}

// Any (up, down) in {1,2}^2 per axis: one output pixel a thread.
template <typename T, int kVec>
__global__ void __launch_bounds__(kThreadsPerBlock)
upfirdn2d_kernel(const T* __restrict__ x, T* __restrict__ y, Geometry g, Filter filt) {
  __shared__ float w[kMaxTaps * kMaxTaps];
  load_taps<T>(g, filt, w);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= g.cols * g.vecs) return;
  const int c0 = (i % g.vecs) * kVec;
  const int ox = i / g.vecs;
  const int oy = blockIdx.y;
  const int n = blockIdx.z;
  float acc[kVec];
#pragma unroll
  for (int e = 0; e < kVec; ++e) acc[e] = 0.f;
  for (int ky = 0; ky < g.fh; ++ky) {
    // row p of the zero-inserted x: a sample when p % up == 0
    const int p = oy * g.downy + ky - g.pady0;
    if (p < 0 || p >= g.h * g.upy || (p & (g.upy - 1))) continue;
    const int iy = p >> (g.upy - 1);
    for (int kx = 0; kx < g.fw; ++kx) {
      const int q = ox * g.downx + kx - g.padx0;
      if (q < 0 || q >= g.w * g.upx || (q & (g.upx - 1))) continue;
      const int ix = q >> (g.upx - 1);
      float xv[kVec];
      load_vec<T, kVec>(x + pixel(g, n, iy, ix) + c0, xv);
      const float tap = w[ky * kMaxTaps + kx];
#pragma unroll
      for (int e = 0; e < kVec; ++e) acc[e] += tap * xv[e];
    }
  }
  const int64_t at = ((static_cast<int64_t>(n) * g.oh + oy) * g.ow + ox) * g.c + c0;
  store_vec<T, kVec>(y + at, acc);
}

template <typename T, int kVec>
int launch(const void* x, void* y, Geometry g, const Filter& filt, cudaStream_t stream) {
  const bool up2 = g.upx == 2 && g.upy == 2 && g.downx == 1 && g.downy == 1;
  g.vecs = g.c / kVec;
  // A quad's first output row is 2 qy - 1 + (pady0 & 1), so (oh - (pady0 & 1)) / 2 + 1 quads cover oh.
  const int rows = up2 ? (g.oh - (g.pady0 & 1) + 2) / 2 : g.oh;
  g.cols = up2 ? (g.ow - (g.padx0 & 1) + 2) / 2 : g.ow;
  const int64_t threads = static_cast<int64_t>(g.cols) * g.vecs;
  if (rows > kMaxGrid || g.n > kMaxGrid || threads > INT32_MAX - kThreadsPerBlock) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(static_cast<unsigned int>((threads + kThreadsPerBlock - 1) / kThreadsPerBlock),
                  static_cast<unsigned int>(rows), static_cast<unsigned int>(g.n));
  const T* xp = static_cast<const T*>(x);
  T* yp = static_cast<T*>(y);
  if (!up2) {
    upfirdn2d_kernel<T, kVec><<<grid, kThreadsPerBlock, 0, stream>>>(xp, yp, g, filt);
  } else if (g.fh <= 4 && g.fw <= 4) {
    upfirdn2d_up2_kernel<T, kVec, 2><<<grid, kThreadsPerBlock, 0, stream>>>(xp, yp, g, filt);
  } else {
    upfirdn2d_up2_kernel<T, kVec, 4><<<grid, kThreadsPerBlock, 0, stream>>>(xp, yp, g, filt);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* x, void* y, const Geometry& g, const Filter& filt,
             cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const bool vector = g.c % kVec == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(y) % 16 == 0;
  return vector ? launch<T, kVec>(x, y, g, filt, stream) : launch<T, 1>(x, y, g, filt, stream);
}

bool one_or_two(int v) { return v == 1 || v == 2; }

}  // namespace

extern "C" {

// x, y: [n, h, w, c] and [n, oh, ow, c] in dtype (0 = float32, 1 = bfloat16).
// f: f32 on the device; f_ndim 0 (null: one tap of 1, fh = fw = 1), 1 (fh =
// fw taps, their outer product) or 2 ([fh, fw], row-major). flip 1 applies
// f as a correlation, 0 as a convolution. up, down in {1, 2}; taps <= 8 an
// axis; oh and ow are the caller's: (h*up + pad0 + pad1 - taps) / down + 1.
int pggan_upfirdn2d(const void* x, const void* f, void* y, int n, int c, int h, int w,
                    int oh, int ow, int upx, int upy, int downx, int downy, int padx0,
                    int pady0, int fh, int fw, int f_ndim, int flip, float gain, int dtype,
                    void* stream) {
  const bool filter_ok = (f_ndim == 0 && f == nullptr && fh == 1 && fw == 1) ||
                         (f_ndim == 1 && f != nullptr && fh == fw) ||
                         (f_ndim == 2 && f != nullptr);
  if (n <= 0 || c <= 0 || h <= 0 || w <= 0 || oh <= 0 || ow <= 0 || !one_or_two(upx) ||
      !one_or_two(upy) || !one_or_two(downx) || !one_or_two(downy) || fh < 1 ||
      fh > kMaxTaps || fw < 1 || fw > kMaxTaps || !filter_ok) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Geometry g{n, c, h, w, oh, ow, upx, upy, downx, downy, padx0, pady0, fh, fw, 0, 0};
  const Filter filt{static_cast<const float*>(f), f_ndim, flip, gain};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(x, y, g, filt, s);
  if (dtype == 1) return dispatch<__nv_bfloat16>(x, y, g, filt, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"

// Bias + leaky ReLU + gain (+ symmetric clamp), with StyleGAN2's demodulation
// and noise, for Hopper (sm_90a), CUDA C++.
//
// Replaces the Pallas TPU kernel
//   bias_lrelu_gain  <- pggan_tpu/ops/pallas_kernels.py `_bias_lrelu_kernel`
//                       (reached through `bias_lrelu_gain` / `_bias_lrelu_core`)
// which serves `bias_act(act='lrelu')` and `filtered_lrelu`. The port's kernel
// also takes the clamp, which the Pallas kernel leaves to XLA, and two more
// optional inputs, so that a StyleGAN2 modulated conv's whole epilogue is one
// pass over the conv's raw output:
//   z = x * d[s, c] + noise[q] + b[c],     c = the element's channel,
//                                          s = its sample, q = its pixel in the sample,
//   y = leaky_relu(z, slope) * gain,
//   y = min(max(y, -clamp), clamp)         when clamp >= 0.
// d ([S, C] f32, the demodulation coefficients), noise ([H*W] f32, one value a
// pixel) and b ([C], f32 or x's type) are each optional; a null one is left
// out of the sum, so null d and noise give the plain bias-act. The math is
// f32 with every product and sum rounded on its own (__fmul_rn / __fadd_rn:
// no fused multiply-add), in the order above, as the plain version
// `ops/kernels.py:bias_lrelu_gain_plain` computes it, then rounded once to
// x's type; so the two agree bit for bit. The clamp is PTX's NaN-propagating
// max and min, so a NaN passes through it as through torch.clamp (fmaxf and
// fminf would drop it). x and y are f32 or bf16.
//
// Layout: x and y are a row-major [pixels, C] view of channel-last memory (a
// channels_last NCHW tensor, a contiguous [B, C] tensor, or any tensor whose
// channel axis is innermost and the others dense). A pixel's sample is
// pixel / hw and its place in the sample pixel % hw (hw = H*W).
//
// What bounds it on an H100: bytes. A few operations per element against one
// read of x and one write of y; d, noise and b are under 0.3 % of those bytes
// at StyleGAN2 config-f's shapes. The floor is one read and one write of the
// activation from device memory (at [16, 64, 1024, 1024] in bf16: 2.15 GB each
// way, 1.28 ms at 3.35 TB/s).
//
// What the design does about it (variants timed against each other on an
// H100 at config-f's shapes; PERF.md §6):
// - 16-byte vectors: a thread loads and stores 8 bf16 or 4 f32 channels of
//   one pixel. A block is [rows, lanes] threads: threadIdx.x walks a pixel's
//   channel vectors, threadIdx.y the block's pixels, so neighbouring threads
//   touch neighbouring addresses and a warp's accesses are contiguous; the
//   blocks tile the pixels in order, one pixel vector a thread (two or four
//   pixels a thread, or a grid-stride loop, read 0.5-8 % slower).
// - A thread's channel is its lane, so it needs no division; the pixel's
//   sample and place in the sample are one 32-bit division a thread (64-bit
//   only past 2^32 pixels), and none without d and noise.
// - x is loaded and y stored streaming (evict-first: each is touched once),
//   so d (B*C*4 bytes), b and noise stay in L1/L2; noise is one 4-byte load a
//   pixel vector, the same address across the pixel's lanes.
// - StyleGAN2's case (d, noise and b all given) is its own instantiation with
//   the three known present; the flags tested at run time cost ~2 % there.
// - A scalar path, the same kernel with one element a vector, for C not a
//   multiple of the vector width or a pointer (x, y, b, d) that is not 16-byte
//   aligned.
//
// Plain C interface for ctypes; the entry point returns cudaGetLastError()
// (0 on success) after the launch on the caller's stream. Nothing here
// allocates or synchronises.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreadsPerBlock = 256;
constexpr int kVecBytes = 16;

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

// kVec values of type T at p as f32, through the read-only path: 16-byte
// loads where they fill whole 16-byte words (p is then 16-byte aligned), one
// element a load otherwise.
template <typename T, int kVec>
__device__ __forceinline__ void load_vec(const T* __restrict__ p, float (&out)[kVec]) {
  constexpr int kWords = sizeof(T) * kVec / kVecBytes;
  if constexpr (kWords >= 1 && sizeof(T) * kVec % kVecBytes == 0) {
    uint4 raw[kWords];
#pragma unroll
    for (int w = 0; w < kWords; ++w) raw[w] = __ldg(reinterpret_cast<const uint4*>(p) + w);
    const T* t = reinterpret_cast<const T*>(raw);
#pragma unroll
    for (int e = 0; e < kVec; ++e) out[e] = to_f32(t[e]);
  } else {
#pragma unroll
    for (int e = 0; e < kVec; ++e) out[e] = to_f32(__ldg(p + e));
  }
}

// x's vector as f32 and y's from f32: one streaming 16-byte access on the
// vector path, one element an access on the scalar one.
template <typename T, int kVec>
__device__ __forceinline__ void load_x(const T* __restrict__ p, float (&out)[kVec]) {
  Pack<T, kVec> r;
  if constexpr (sizeof(T) * kVec == kVecBytes) {
    *reinterpret_cast<uint4*>(&r) = __ldcs(reinterpret_cast<const uint4*>(p));
  } else {
#pragma unroll
    for (int e = 0; e < kVec; ++e) r.v[e] = p[e];
  }
#pragma unroll
  for (int e = 0; e < kVec; ++e) out[e] = to_f32(r.v[e]);
}

template <typename T, int kVec>
__device__ __forceinline__ void store_y(T* __restrict__ p, const float (&in)[kVec]) {
  Pack<T, kVec> r;
#pragma unroll
  for (int e = 0; e < kVec; ++e) r.v[e] = from_f32<T>(in[e]);
  if constexpr (sizeof(T) * kVec == kVecBytes) {
    __stcs(reinterpret_cast<uint4*>(p), *reinterpret_cast<const uint4*>(&r));
  } else {
#pragma unroll
    for (int e = 0; e < kVec; ++e) p[e] = r.v[e];
  }
}

__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float min_nan(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// kFull: d, noise and b are all given (StyleGAN2's conv epilogue), known at
// compile time; otherwise each is tested at run time.
template <typename T, typename B, int kVec, bool kFull>
__global__ void __launch_bounds__(kThreadsPerBlock)
bias_lrelu_gain_kernel(const T* __restrict__ x, const B* __restrict__ b,
                       const float* __restrict__ d, const float* __restrict__ noise,
                       T* __restrict__ y, int64_t pixels, int cols, uint32_t hw, float slope,
                       float gain, float clamp) {
  const int64_t p = static_cast<int64_t>(blockIdx.x) * blockDim.y + threadIdx.y;
  if (p >= pixels) return;
  const bool has_b = kFull || b != nullptr, has_d = kFull || d != nullptr,
             has_noise = kFull || noise != nullptr;
  uint32_t s = 0, q = 0;  // the pixel's sample and place in it
  if (has_d || has_noise) {
    if (pixels <= static_cast<int64_t>(UINT32_MAX)) {
      const uint32_t p32 = static_cast<uint32_t>(p);
      s = p32 / hw;
      q = p32 - s * hw;
    } else {
      s = static_cast<uint32_t>(p / hw);
      q = static_cast<uint32_t>(p % hw);
    }
  }
  const T* xp = x + p * cols;
  T* yp = y + p * cols;
  for (int c = threadIdx.x * kVec; c < cols; c += blockDim.x * kVec) {
    float z[kVec], bv[kVec], dv[kVec];
    float nz = 0.f;
    load_x<T, kVec>(xp + c, z);
    if (has_b) load_vec<B, kVec>(b + c, bv);
    if (has_d) load_vec<float, kVec>(d + static_cast<int64_t>(s) * cols + c, dv);
    if (has_noise) nz = __ldg(noise + q);
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
      float v = z[e];
      if (has_d) v = __fmul_rn(v, dv[e]);
      if (has_noise) v = __fadd_rn(v, nz);
      if (has_b) v = __fadd_rn(v, bv[e]);
      float a = __fmul_rn(v >= 0.f ? v : __fmul_rn(v, slope), gain);
      if (clamp >= 0.f) a = min_nan(max_nan(a, -clamp), clamp);
      z[e] = a;
    }
    store_y<T, kVec>(yp + c, z);
  }
}

template <typename T, typename B, int kVec>
int launch(const void* x, const void* b, const void* d, const void* noise, void* y,
           int64_t pixels, int cols, uint32_t hw, float slope, float gain, float clamp,
           cudaStream_t stream) {
  // lanes: a pixel's vectors, split into equal passes of at most a block's
  // threads; rows: the pixels a block covers.
  const int vecs = cols / kVec;
  const int passes = (vecs + kThreadsPerBlock - 1) / kThreadsPerBlock;
  const int lanes = (vecs + passes - 1) / passes;
  const int rows = kThreadsPerBlock / lanes;
  const int64_t blocks = (pixels + rows - 1) / rows;
  if (blocks > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned int>(blocks)), block(lanes, rows);
  const T* xt = static_cast<const T*>(x);
  const B* bt = static_cast<const B*>(b);
  const float* dt = static_cast<const float*>(d);
  const float* nt = static_cast<const float*>(noise);
  T* yt = static_cast<T*>(y);
  if (b != nullptr && d != nullptr && noise != nullptr) {
    bias_lrelu_gain_kernel<T, B, kVec, true><<<grid, block, 0, stream>>>(
        xt, bt, dt, nt, yt, pixels, cols, hw, slope, gain, clamp);
  } else {
    bias_lrelu_gain_kernel<T, B, kVec, false><<<grid, block, 0, stream>>>(
        xt, bt, dt, nt, yt, pixels, cols, hw, slope, gain, clamp);
  }
  return static_cast<int>(cudaGetLastError());
}

bool aligned(const void* p) { return reinterpret_cast<uintptr_t>(p) % kVecBytes == 0; }

// Values a load: 16 / sizeof(T) on the vector path, 1 on the scalar one.
// Null pointers count as aligned.
int values_a_load(const void* x, const void* b, const void* d, const void* y, int cols,
                  int x_dtype) {
  const int vec = x_dtype == 0 ? kVecBytes / 4 : kVecBytes / 2;
  return cols % vec == 0 && aligned(x) && aligned(b) && aligned(d) && aligned(y) ? vec : 1;
}

template <typename T, typename B>
int dispatch(const void* x, const void* b, const void* d, const void* noise, void* y,
             int64_t pixels, int cols, uint32_t hw, int x_dtype, float slope, float gain,
             float clamp, cudaStream_t s) {
  constexpr int kVec = kVecBytes / sizeof(T);
  return values_a_load(x, b, d, y, cols, x_dtype) == kVec
             ? launch<T, B, kVec>(x, b, d, noise, y, pixels, cols, hw, slope, gain, clamp, s)
             : launch<T, B, 1>(x, b, d, noise, y, pixels, cols, hw, slope, gain, clamp, s);
}

}  // namespace

extern "C" {

// x_dtype: 0 = float32, 1 = bfloat16; b_dtype: the same codes for b (ignored
// when b is null; bf16 only with a bf16 x). n = pixels * cols elements, hw the
// pixels of a sample (n / cols a multiple of it); d ([n / cols / hw, cols] f32)
// and noise ([hw] f32) may be null. clamp < 0: no clamp.
int pggan_bias_lrelu_gain(const void* x, const void* b, const void* d, const void* noise,
                          void* y, int64_t n, int cols, int64_t hw, int x_dtype, int b_dtype,
                          float slope, float gain, float clamp, void* stream) {
  if (n < 0 || cols <= 0 || hw <= 0 || n % cols != 0 || (n / cols) % hw != 0 ||
      (b != nullptr && b_dtype != 0 && b_dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t pixels = n / cols;
  // the kernel keeps a pixel's sample and place in 32 bits
  if (d == nullptr && noise == nullptr) {
    hw = 1;
  } else if (hw > INT32_MAX || pixels / hw > INT32_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool b_f32 = b == nullptr || b_dtype == 0;
  if (x_dtype == 0) {
    if (!b_f32) return static_cast<int>(cudaErrorInvalidValue);
    return dispatch<float, float>(x, b, d, noise, y, pixels, cols, static_cast<uint32_t>(hw),
                                  x_dtype, slope, gain, clamp, s);
  }
  if (x_dtype == 1) {
    const uint32_t hw32 = static_cast<uint32_t>(hw);
    return b_f32 ? dispatch<__nv_bfloat16, float>(x, b, d, noise, y, pixels, cols, hw32, x_dtype,
                                                  slope, gain, clamp, s)
                 : dispatch<__nv_bfloat16, __nv_bfloat16>(x, b, d, noise, y, pixels, cols, hw32,
                                                          x_dtype, slope, gain, clamp, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// The path a call with these pointers takes: *per_load = 4 (f32) or 8 (bf16)
// values a load on the vector path, 1 on the scalar one. Reads no memory
// behind the pointers.
int pggan_bias_lrelu_gain_plan(const void* x, const void* b, const void* d, const void* y,
                               int cols, int x_dtype, int* per_load) {
  if (cols <= 0 || (x_dtype != 0 && x_dtype != 1)) return static_cast<int>(cudaErrorInvalidValue);
  *per_load = values_a_load(x, b, d, y, cols, x_dtype);
  return static_cast<int>(cudaSuccess);
}

}  // extern "C"

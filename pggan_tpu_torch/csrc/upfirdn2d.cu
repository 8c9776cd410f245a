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
// composition rounds its conv weight (calls beyond the polyphase envelope,
// below, keep a 1-D filter's taps in f32). The sum runs in f32 and is
// rounded to x's type once. x is [N, H, W, C] and y [N, OH, OW, C]: the NHWC
// bytes of channels_last NCHW tensors. x and y are f32 or bf16; the filter
// is f32 on the device. Up is 1, 2 or 4 and down 1 or 2 on each axis; a
// 2-D filter has at most 8 taps an axis, a 1-D one at most 24. Calls with
// up 1 or 2 and at most 8 taps an axis (StyleGAN2's, the polyphase
// envelope) run the first two kernels below; the others (StyleGAN3's) the
// separable kernels, or upfirdn2d_kernel with f32 taps.
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
//  - every other call (upfirdn2d_kernel): one output pixel a thread; a tap
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
// StyleGAN3's filtered leaky ReLU resamples through long 1-D Kaiser filters
// at twice the layer's rate: up 2 through 12 taps or up 4 through 24 on each
// axis, then down 2 through 12 taps (the largest call, up 4 at 1044^2 with
// 81 channels, writes 11.4 GB in bf16: 3.4 ms at 3.35 TB/s). As a 2-D
// outer product these are 36 (up 4) to 144 (down 2) multiply-adds an
// output, which at f32's 67 TFLOP/s would outlast the bytes. So for a 1-D
// filter the separable kernels filter along x and then y, in f32 registers,
// with no trip through memory in between:
//  - up 2 or 4 and down 1 on both axes (upfirdn2d_sep_up_kernel): a thread
//    owns one up x up polyphase cell of outputs (one channel or a pair) and
//    walks down a strip of cells. A cell row reads J = ceil(taps / up) + 1
//    input rows; the thread filters each input row along x once (J loads,
//    `taps` multiply-adds) and keeps the last J filtered rows in registers,
//    so a cell row costs one input row's loads and up x taps multiply-adds
//    for its up^2 outputs (7.5 an output at up 4, 9 at up 2). Every tap
//    index is a compile-time constant: a cell's first row and column lie
//    where the zero-inserted input has a sample (the leading pad modulo up
//    picks the offset, as the up-2 kernel's quads do).
//  - down 2 and up 1 on both axes (upfirdn2d_sep_down_kernel): a thread
//    owns kDownCols neighbouring outputs of a row and walks down a strip of
//    rows, keeping the last `taps` x-filtered input rows in registers; an
//    output row takes two new input rows.
//  - StyleGAN3-T's upper layers have odd channel counts (323, 203, 81, 51)
//    and so no 16-byte vectors: a thread owns one channel, or two where C
//    is even and x and y are aligned to two. Neighbouring threads own
//    neighbouring channels and cells, so loads and stores coalesce and the
//    inputs that neighbouring cells share hit L1/L2.
//  - no branch guards a load of a row (the row and column are
//    clamped into x, the value zeroed after by a select): with a branch
//    around each, the loads ran one after another and the down kernel took
//    17x its bound. The launch bounds hold the registers (the taps, the
//    rows kept) to 3 (up) and 2 (down) blocks a multiprocessor.
//  - what bounds them still (an H100, bf16): one thread's chain of loads
//    and its 2-byte accesses; layer 10's up 4 runs at ~41 % of its bytes'
//    bound and layer 11's down 2 at ~26 %. A y-first down kernel that
//    shares each filtered row through shared memory ran at 12-16 %: it
//    waits on a load and a barrier every row.
//  - the taps stay f32 (the filter, times the gain on the x axis), as in
//    NVIDIA's kernels: the outputs differ from the composition's (2-D taps
//    rounded to x's type, summed in another order) by rounding alone.
// Every other call beyond the polyphase envelope (up 4 on one axis alone, a
// 2-D filter at up 4, a long 1-D filter with up and down on one axis) runs
// upfirdn2d_kernel: its kF32Taps form takes a 1-D filter's taps as the f32
// products wy[ky] * wx[kx] of the separable kernels; a 2-D filter keeps
// the rounded 8x8 table. No StyleGAN3 call runs it.
//
// Plain C interface for ctypes; the entry point returns cudaGetLastError()
// (0 on success) after the launch on the caller's stream. Nothing here
// allocates or synchronises.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreadsPerBlock = 256;
constexpr int kMaxTaps = 8;              // taps an axis of a 2-D filter
constexpr int kMaxSepTaps = 24;          // taps of a 1-D filter
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

// wx[k], wy[k] = the correlation weights of tap k along x and along y, f32,
// the gain on x; 0 beyond the filter. Ends with the block's barrier.
__device__ void load_sep_taps(const Geometry& g, const Filter& filt, float* wx, float* wy) {
  for (int i = threadIdx.x; i < 2 * kMaxSepTaps; i += blockDim.x) {
    const bool along_x = i < kMaxSepTaps;
    const int k = i % kMaxSepTaps;
    const int taps = along_x ? g.fw : g.fh;
    float v = 0.f;
    if (k < taps) {
      v = filt.ndim == 0 ? 1.f : filt.f[filt.flip ? k : taps - 1 - k];
      if (along_x) v *= filt.gain;
    }
    (along_x ? wx : wy)[k] = v;
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

// Any up in {1,2,4} and down in {1,2} per axis: one output pixel a thread.
// The taps: kF32Taps, a 1-D filter (or none) of at most 24 taps as the f32
// products wy[ky] * wx[kx] (load_sep_taps); else load_taps' 8x8 table.
template <typename T, int kVec, bool kF32Taps>
__global__ void __launch_bounds__(kThreadsPerBlock)
upfirdn2d_kernel(const T* __restrict__ x, T* __restrict__ y, Geometry g, Filter filt) {
  __shared__ float w[kF32Taps ? 2 * kMaxSepTaps : kMaxTaps * kMaxTaps];
  if constexpr (kF32Taps) {
    load_sep_taps(g, filt, w, w + kMaxSepTaps);
  } else {
    load_taps<T>(g, filt, w);
  }
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
    // row p of the zero-inserted x: a sample when p % up == 0; up >> 1 is
    // log2(up) for up in {1, 2, 4}
    const int p = oy * g.downy + ky - g.pady0;
    if (p < 0 || p >= g.h * g.upy || (p & (g.upy - 1))) continue;
    const int iy = p >> (g.upy >> 1);
    for (int kx = 0; kx < g.fw; ++kx) {
      const int q = ox * g.downx + kx - g.padx0;
      if (q < 0 || q >= g.w * g.upx || (q & (g.upx - 1))) continue;
      const int ix = q >> (g.upx >> 1);
      float xv[kVec];
      load_vec<T, kVec>(x + pixel(g, n, iy, ix) + c0, xv);
      const float tap = kF32Taps ? w[kMaxSepTaps + ky] * w[kx] : w[ky * kMaxTaps + kx];
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
    upfirdn2d_kernel<T, kVec, false><<<grid, kThreadsPerBlock, 0, stream>>>(xp, yp, g, filt);
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

// ---- beyond the polyphase envelope: the separable kernels -------------------

constexpr int kSepThreads = 256;
// Blocks a multiprocessor holds at least: the bound on registers that let
// enough warps hide the loads' latency (timed on an H100 at StyleGAN3-T's
// largest calls: 1 block 34.8 %, 3 blocks 40.7 % of the bound for layer
// 10's up 4; 2 blocks and 64 rows 25.8 % against 22.4 % for layer 11's down 2).
constexpr int kUpMinBlocks = 3;
constexpr int kDownMinBlocks = 2;
constexpr int kUpStripCells = 16;        // cell rows a thread of the up kernel walks
constexpr int kDownStripRows = 64;       // output rows a thread of the down kernel walks
constexpr int kDownCols = 4;             // outputs of a row a thread of the down kernel owns

__device__ __forceinline__ int floor_mod(int a, int m) { return ((a % m) + m) % m; }

// One input row of x from the thread's first column ix0: kJ channel vectors,
// each row and column clamped into x so that no branch stands before a
// load (a branch around each would hold the next load back until the last
// returned), and then zeroed where it lies outside x (`valid` marks the
// columns inside it), by a select, so an Inf or NaN there cannot leak.
template <typename T, int kVec, int kJ>
__device__ __forceinline__ void load_row(const T* __restrict__ x, const Geometry& g, int n,
                                         int iy, int ix0, int c0, unsigned valid,
                                         float (&v)[kJ][kVec]) {
  const bool row_in = iy >= 0 && iy < g.h;
  const T* row = x + pixel(g, n, min(max(iy, 0), g.h - 1), 0) + c0;
#pragma unroll
  for (int j = 0; j < kJ; ++j) {
    const int ix = min(max(ix0 + j, 0), g.w - 1);
    load_vec<T, kVec>(row + static_cast<int64_t>(ix) * g.c, v[j]);
    const bool keep = row_in && ((valid >> j) & 1u);
#pragma unroll
    for (int e = 0; e < kVec; ++e) v[j][e] = keep ? v[j][e] : 0.f;
  }
}

// out[d] = sum_j wx[kU j - d] * x[n, iy, ix0 + j, c0..] for d < kU: one
// input row filtered along x for the kU output columns of a cell (zeros
// for a row outside x; `valid` marks the columns j inside it).
template <typename T, int kVec, int kU, int kTaps>
__device__ __forceinline__ void filter_cell_row(const T* __restrict__ x, const Geometry& g,
                                                int n, int iy, int ix0, int c0, unsigned valid,
                                                const float* wx, float (&out)[kU][kVec]) {
  constexpr int kJ = (kTaps + kU - 2) / kU + 1;
  float v[kJ][kVec];
  load_row<T, kVec, kJ>(x, g, n, iy, ix0, c0, valid, v);
#pragma unroll
  for (int d = 0; d < kU; ++d)
#pragma unroll
    for (int e = 0; e < kVec; ++e) out[d][e] = 0.f;
#pragma unroll
  for (int j = 0; j < kJ; ++j) {
#pragma unroll
    for (int d = 0; d < kU; ++d) {
      const int k = kU * j - d;
      if (k < 0 || k >= kTaps) continue;
#pragma unroll
      for (int e = 0; e < kVec; ++e) out[d][e] += wx[k] * v[j][e];
    }
  }
}

// Up kU (2 or 4) and down 1 on both axes, a 1-D filter of at most kTaps taps.
// With pad0 = kU q + r (0 <= r < kU), output kU g + r + d (d < kU) of cell
// g takes input g - q + j at tap kU j - d, on each axis. Cells start at -1
// (r > 0) or 0; a row holds g.cols of them. blockIdx.y picks a strip of
// kUpStripCells cell rows.
template <typename T, int kVec, int kU, int kTaps>
__global__ void __launch_bounds__(kSepThreads, kUpMinBlocks)
upfirdn2d_sep_up_kernel(const T* __restrict__ x, T* __restrict__ y, Geometry g, Filter filt) {
  constexpr int kJ = (kTaps + kU - 2) / kU + 1;      // input rows (columns) a cell reads
  __shared__ float wx[kMaxSepTaps], wy[kMaxSepTaps];
  load_sep_taps(g, filt, wx, wy);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= g.cols * g.vecs) return;
  const int c0 = (i % g.vecs) * kVec;
  const int rx = floor_mod(g.padx0, kU), ry = floor_mod(g.pady0, kU);
  const int gx = i / g.vecs - (rx > 0 ? 1 : 0);
  const int ix0 = gx - (g.padx0 - rx) / kU;
  const int n = blockIdx.z;
  unsigned valid = 0;                                  // the input columns inside x
#pragma unroll
  for (int j = 0; j < kJ; ++j) valid |= (ix0 + j >= 0 && ix0 + j < g.w) ? 1u << j : 0u;
  const int gy_first = blockIdx.y * kUpStripCells - (ry > 0 ? 1 : 0);
  const int gy_end = min(gy_first + kUpStripCells, (g.oh - 1 - ry) / kU + 1);
  const int iy_shift = (g.pady0 - ry) / kU;

  float h[kJ][kU][kVec];                             // x-filtered input rows, oldest first
#pragma unroll
  for (int j = 0; j < kJ - 1; ++j) {
    filter_cell_row<T, kVec, kU, kTaps>(x, g, n, gy_first - iy_shift + j, ix0, c0, valid, wx,
                                        h[j]);
  }
  for (int gy = gy_first; gy < gy_end; ++gy) {
    filter_cell_row<T, kVec, kU, kTaps>(x, g, n, gy - iy_shift + kJ - 1, ix0, c0, valid, wx,
                                        h[kJ - 1]);
#pragma unroll
    for (int dy = 0; dy < kU; ++dy) {
      const int oy = kU * gy + ry + dy;
      if (oy < 0 || oy >= g.oh) continue;
      T* out_row = y + (static_cast<int64_t>(n) * g.oh + oy) * g.ow * g.c + c0;
#pragma unroll
      for (int dx = 0; dx < kU; ++dx) {
        const int ox = kU * gx + rx + dx;
        if (ox < 0 || ox >= g.ow) continue;
        float acc[kVec];
#pragma unroll
        for (int e = 0; e < kVec; ++e) acc[e] = 0.f;
#pragma unroll
        for (int j = 0; j < kJ; ++j) {
          const int k = kU * j - dy;
          if (k < 0 || k >= kTaps) continue;
#pragma unroll
          for (int e = 0; e < kVec; ++e) acc[e] += wy[k] * h[j][dx][e];
        }
        store_vec<T, kVec>(out_row + static_cast<int64_t>(ox) * g.c, acc);
      }
    }
#pragma unroll
    for (int j = 0; j < kJ - 1; ++j)
#pragma unroll
      for (int d = 0; d < kU; ++d)
#pragma unroll
        for (int e = 0; e < kVec; ++e) h[j][d][e] = h[j + 1][d][e];
  }
}

// out[t] = sum_k wx[k] * x[n, iy, ix0 + 2 t + k, c0..] for t < kDownCols: one
// input row filtered along x and decimated for a thread's outputs (zeros
// for a row outside x; `valid` marks the columns inside it).
template <typename T, int kVec, int kTaps>
__device__ __forceinline__ void filter_down_row(const T* __restrict__ x, const Geometry& g,
                                                int n, int iy, int ix0, int c0, unsigned valid,
                                                const float* wx,
                                                float (&out)[kDownCols][kVec]) {
  constexpr int kJ = 2 * (kDownCols - 1) + kTaps;
  float v[kJ][kVec];
  load_row<T, kVec, kJ>(x, g, n, iy, ix0, c0, valid, v);
#pragma unroll
  for (int t = 0; t < kDownCols; ++t)
#pragma unroll
    for (int e = 0; e < kVec; ++e) out[t][e] = 0.f;
#pragma unroll
  for (int j = 0; j < kJ; ++j) {
#pragma unroll
    for (int t = 0; t < kDownCols; ++t) {
      const int k = j - 2 * t;
      if (k < 0 || k >= kTaps) continue;
#pragma unroll
      for (int e = 0; e < kVec; ++e) out[t][e] += wx[k] * v[j][e];
    }
  }
}

// Down 2 and up 1 on both axes, a 1-D filter of at most kTaps taps. A
// thread owns outputs kDownCols c + t (t < kDownCols) of a row, which take
// input columns 2 kDownCols c - padx0 + 2 t + k at tap k, and walks the
// output rows of strip blockIdx.y; output row oy takes input rows
// 2 oy - pady0 + k.
template <typename T, int kVec, int kTaps>
__global__ void __launch_bounds__(kSepThreads, kDownMinBlocks)
upfirdn2d_sep_down_kernel(const T* __restrict__ x, T* __restrict__ y, Geometry g, Filter filt) {
  constexpr int kJ = 2 * (kDownCols - 1) + kTaps;    // input columns a thread reads
  __shared__ float wx[kMaxSepTaps], wy[kMaxSepTaps];
  load_sep_taps(g, filt, wx, wy);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= g.cols * g.vecs) return;
  const int c0 = (i % g.vecs) * kVec;
  const int ox0 = (i / g.vecs) * kDownCols;
  const int ix0 = 2 * ox0 - g.padx0;
  const int n = blockIdx.z;
  unsigned valid = 0;
#pragma unroll
  for (int j = 0; j < kJ; ++j) valid |= (ix0 + j >= 0 && ix0 + j < g.w) ? 1u << j : 0u;
  const int oy_first = blockIdx.y * kDownStripRows;
  const int oy_end = min(oy_first + kDownStripRows, g.oh);

  float h[kTaps][kDownCols][kVec];                   // x-filtered input rows, oldest first
#pragma unroll
  for (int k = 0; k < kTaps - 2; ++k) {
    filter_down_row<T, kVec, kTaps>(x, g, n, 2 * oy_first - g.pady0 + k, ix0, c0, valid, wx,
                                    h[k]);
  }
  for (int oy = oy_first; oy < oy_end; ++oy) {
    filter_down_row<T, kVec, kTaps>(x, g, n, 2 * oy - g.pady0 + kTaps - 2, ix0, c0, valid, wx,
                                    h[kTaps - 2]);
    filter_down_row<T, kVec, kTaps>(x, g, n, 2 * oy - g.pady0 + kTaps - 1, ix0, c0, valid, wx,
                                    h[kTaps - 1]);
    T* out_row = y + (static_cast<int64_t>(n) * g.oh + oy) * g.ow * g.c + c0;
#pragma unroll
    for (int t = 0; t < kDownCols; ++t) {
      if (ox0 + t >= g.ow) continue;
      float acc[kVec];
#pragma unroll
      for (int e = 0; e < kVec; ++e) acc[e] = 0.f;
#pragma unroll
      for (int k = 0; k < kTaps; ++k)
#pragma unroll
        for (int e = 0; e < kVec; ++e) acc[e] += wy[k] * h[k][t][e];
      store_vec<T, kVec>(out_row + static_cast<int64_t>(ox0 + t) * g.c, acc);
    }
#pragma unroll
    for (int k = 0; k < kTaps - 2; ++k)
#pragma unroll
      for (int t = 0; t < kDownCols; ++t)
#pragma unroll
        for (int e = 0; e < kVec; ++e) h[k][t][e] = h[k + 2][t][e];
  }
}

template <typename T, int kVec>
int launch_extended(const void* x, void* y, Geometry g, const Filter& filt, cudaStream_t stream) {
  const T* xp = static_cast<const T*>(x);
  T* yp = static_cast<T*>(y);
  g.vecs = g.c / kVec;
  const bool separable = filt.ndim < 2 && g.upx == g.upy && g.downx == g.downy;
  const bool up = separable && (g.upx == 2 || g.upx == 4) && g.downx == 1;
  const bool down = separable && g.upx == 1 && g.downx == 2;
  int rows = g.oh;
  int threads = kThreadsPerBlock;
  if (up) {
    const int u = g.upx;
    const int rx = ((g.padx0 % u) + u) % u, ry = ((g.pady0 % u) + u) % u;
    // cells from -1 (r > 0) or 0 up to the one that holds the last output
    g.cols = (g.ow - 1 - rx) / u + 1 + (rx > 0 ? 1 : 0);
    const int cell_rows = (g.oh - 1 - ry) / u + 1 + (ry > 0 ? 1 : 0);
    rows = (cell_rows + kUpStripCells - 1) / kUpStripCells;
    threads = kSepThreads;
  } else if (down) {
    g.cols = (g.ow + kDownCols - 1) / kDownCols;
    rows = (g.oh + kDownStripRows - 1) / kDownStripRows;
    threads = kSepThreads;
  } else {
    g.cols = g.ow;
  }
  const int64_t total = static_cast<int64_t>(g.cols) * g.vecs;
  if (rows > kMaxGrid || g.n > kMaxGrid || total > INT32_MAX - threads) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(static_cast<unsigned int>((total + threads - 1) / threads),
                  static_cast<unsigned int>(rows), static_cast<unsigned int>(g.n));
  const int taps = g.fw;                             // fh == fw for a 1-D filter
  if (up && g.upx == 4) {
    upfirdn2d_sep_up_kernel<T, kVec, 4, 24><<<grid, threads, 0, stream>>>(xp, yp, g, filt);
  } else if (up && taps <= 12) {
    upfirdn2d_sep_up_kernel<T, kVec, 2, 12><<<grid, threads, 0, stream>>>(xp, yp, g, filt);
  } else if (up) {
    upfirdn2d_sep_up_kernel<T, kVec, 2, 24><<<grid, threads, 0, stream>>>(xp, yp, g, filt);
  } else if (down && taps <= 12) {
    upfirdn2d_sep_down_kernel<T, kVec, 12><<<grid, threads, 0, stream>>>(xp, yp, g, filt);
  } else if (down) {
    upfirdn2d_sep_down_kernel<T, kVec, 24><<<grid, threads, 0, stream>>>(xp, yp, g, filt);
  } else if (filt.ndim < 2) {
    upfirdn2d_kernel<T, kVec, true><<<grid, threads, 0, stream>>>(xp, yp, g, filt);
  } else {
    upfirdn2d_kernel<T, kVec, false><<<grid, threads, 0, stream>>>(xp, yp, g, filt);
  }
  return static_cast<int>(cudaGetLastError());
}

// Two channels a thread where C is even and x and y are aligned to two
// elements, else one.
template <typename T>
int dispatch_extended(const void* x, void* y, const Geometry& g, const Filter& filt,
                  cudaStream_t stream) {
  constexpr uintptr_t kPair = 2 * sizeof(T);
  const bool pairs = g.c % 2 == 0 && reinterpret_cast<uintptr_t>(x) % kPair == 0 &&
                     reinterpret_cast<uintptr_t>(y) % kPair == 0;
  return pairs ? launch_extended<T, 2>(x, y, g, filt, stream)
               : launch_extended<T, 1>(x, y, g, filt, stream);
}

bool one_two_or_four(int v) { return v == 1 || v == 2 || v == 4; }

}  // namespace

extern "C" {

// x, y: [n, h, w, c] and [n, oh, ow, c] in dtype (0 = float32, 1 = bfloat16).
// f: f32 on the device; f_ndim 0 (null: one tap of 1, fh = fw = 1), 1 (fh =
// fw taps, their outer product) or 2 ([fh, fw], row-major). flip 1 applies
// f as a correlation, 0 as a convolution. up in {1, 2, 4}, down in {1, 2};
// taps <= 8 an axis for a 2-D filter, <= 24 for a 1-D one; oh and ow are
// the caller's: (h*up + pad0 + pad1 - taps) / down + 1. A call with up in
// {1, 2} and at most 8 taps an axis runs upfirdn2d_up2_kernel or
// upfirdn2d_kernel with rounded taps; any other the separable kernels or
// upfirdn2d_kernel with f32 taps.
int pggan_upfirdn2d(const void* x, const void* f, void* y, int n, int c, int h, int w,
                    int oh, int ow, int upx, int upy, int downx, int downy, int padx0,
                    int pady0, int fh, int fw, int f_ndim, int flip, float gain, int dtype,
                    void* stream) {
  const bool filter_ok = (f_ndim == 0 && f == nullptr && fh == 1 && fw == 1) ||
                         (f_ndim == 1 && f != nullptr && fh == fw && fh <= kMaxSepTaps) ||
                         (f_ndim == 2 && f != nullptr && fh <= kMaxTaps && fw <= kMaxTaps);
  if (n <= 0 || c <= 0 || h <= 0 || w <= 0 || oh <= 0 || ow <= 0 || !one_two_or_four(upx) ||
      !one_two_or_four(upy) || !one_or_two(downx) || !one_or_two(downy) ||
      fh < 1 || fw < 1 || !filter_ok) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Geometry g{n, c, h, w, oh, ow, upx, upy, downx, downy, padx0, pady0, fh, fw, 0, 0};
  const Filter filt{static_cast<const float*>(f), f_ndim, flip, gain};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool polyphase = one_or_two(upx) && one_or_two(upy) && fh <= kMaxTaps &&
                         fw <= kMaxTaps;
  if (dtype == 0) {
    return polyphase ? dispatch<float>(x, y, g, filt, s)
                     : dispatch_extended<float>(x, y, g, filt, s);
  }
  if (dtype == 1) {
    return polyphase ? dispatch<__nv_bfloat16>(x, y, g, filt, s)
                     : dispatch_extended<__nv_bfloat16>(x, y, g, filt, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"

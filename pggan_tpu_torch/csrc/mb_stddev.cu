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
// What bounds it on an H100: latency, not bytes. The path calls it on
// [16, 4*4*512] three times a train step: 512 KB in f32 and 256 KB in bf16,
// 128 KB (f32) a group, which device memory moves in a fraction of a
// microsecond at 3.35 TB/s. The time is the launch, the memory latency of
// the loads a thread waits on, and the reductions.
//
// What the design does about it: each group of sg rows is a thread-block
// cluster of kClusterBlocks = 8 blocks on neighbouring SMs (a portable
// cluster size), so the path's 4 groups run on 32 SMs, not 4. Each block
// takes a contiguous eighth of the row's features and reads it once: a
// thread loads, for its 16-byte vector of features (4 f32 or 8 bf16), the sg
// vectors of the group, neighbouring threads on neighbouring vectors; it
// takes the features' means, then their sums of squared deviations from the
// same values, and adds each sqrt(var + eps) to its own sum. At the path's
// sg = 4 the four vectors stay in registers for both passes; another sg
// loads them again in the second (from L1). A block has as many warps as
// its eighth of a row has vectors, up to 8, so every thread has one: at
// [16, 8192] 256 threads in f32, 128 in bf16. The block reduces its
// threads' sums with warp shuffles and one shared-memory step, and writes
// its sum into its slot of rank 0's shared memory through distributed
// shared memory (map_shared_rank); after a cluster barrier rank 0 adds the 8
// slots in order. Distributed shared memory may be touched only once every
// block of the cluster has started: each block arrives on the cluster
// barrier at entry (relaxed, split) and waits on it just before its remote
// store, so the wait is hidden behind the loads. Writing to rank 0 rather
// than having rank 0 read the others keeps the second barrier from having
// to hold every block resident until it has been read (PERF.md has the
// times). One launch, no workspace, no atomics, every sum in a fixed order:
// the same bits on every call. Any sg >= 2 is taken, including sg = n when n is not a
// multiple of 4. Rows that are not a whole number of 16-byte vectors, or a
// pointer that is not 16-byte aligned, take the same kernel with one
// element a load (the generic branch); `pggan_minibatch_stddev_plan`
// reports which.
//
// Plain C interface for ctypes; the entry point returns cudaGetLastError()
// (0 on success) after the launch on the caller's stream. Nothing here
// allocates or synchronises.

#include <cstdint>

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxThreads = 256;
constexpr int kClusterBlocks = 8;
constexpr int kVecBytes = 16;

// One load of a row: a 16-byte vector (kVec) or one element, unpacked to f32.
template <typename T, bool kVec>
struct Unit;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
struct Unit<T, false> {
  using Raw = T;
  static constexpr int kValues = 1;
  __device__ __forceinline__ static void unpack(const T& v, float* f) { f[0] = to_f32(v); }
};

template <>
struct Unit<float, true> {
  using Raw = uint4;
  static constexpr int kValues = 4;
  __device__ __forceinline__ static void unpack(const uint4& v, float* f) {
    f[0] = __uint_as_float(v.x);
    f[1] = __uint_as_float(v.y);
    f[2] = __uint_as_float(v.z);
    f[3] = __uint_as_float(v.w);
  }
};

template <>
struct Unit<__nv_bfloat16, true> {
  using Raw = uint4;
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
};

// The split cluster barrier (PTX barrier.cluster, sm_90): a block arrives
// at entry and waits before it first touches another block's shared memory,
// which is only allowed once every block of the cluster has started.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// The sum over a load's values of sqrt(unbiased var + eps) over the sg
// loads load(s), s < sg: their mean first, then the squared deviations.
template <typename U, typename Load>
__device__ __forceinline__ float stddev_sum(const Load& load, int sg, float inv_sg,
                                            float inv_dof, float eps) {
  float mean[U::kValues] = {};
#pragma unroll 4
  for (int s = 0; s < sg; ++s) {
    float v[U::kValues];
    U::unpack(load(s), v);
#pragma unroll
    for (int i = 0; i < U::kValues; ++i) mean[i] += v[i];
  }
#pragma unroll
  for (int i = 0; i < U::kValues; ++i) mean[i] *= inv_sg;
  float ss[U::kValues] = {};
#pragma unroll 4
  for (int s = 0; s < sg; ++s) {
    float v[U::kValues];
    U::unpack(load(s), v);
#pragma unroll
    for (int i = 0; i < U::kValues; ++i) {
      const float d = v[i] - mean[i];
      ss[i] += d * d;
    }
  }
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < U::kValues; ++i) acc += sqrtf(ss[i] * inv_dof + eps);
  return acc;
}

// x: [groups * sg, units] loads; the grid is groups * kClusterBlocks blocks
// of a whole number of warps (at most kMaxThreads), one cluster a group.
// kSg > 0: sg is kSg, and a thread keeps its kSg loads in registers for
// both passes; kSg = 0: any sg, the second pass loads again (from L1).
template <typename T, bool kVec, int kSg>
__global__ void __cluster_dims__(kClusterBlocks, 1, 1) __launch_bounds__(kMaxThreads)
mb_stddev_kernel(const typename Unit<T, kVec>::Raw* __restrict__ x, float* __restrict__ out,
                 int64_t units, int64_t f, int sg, float eps) {
  using U = Unit<T, kVec>;
  using Raw = typename U::Raw;
  cluster_arrive_relaxed();
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  if (kSg > 0) sg = kSg;
  const int64_t group = blockIdx.x / kClusterBlocks;
  const int64_t per_block = (units + kClusterBlocks - 1) / kClusterBlocks;
  const int64_t begin = rank * per_block;
  const int64_t end = begin + per_block < units ? begin + per_block : units;
  const Raw* xg = x + group * sg * units;
  const float inv_sg = 1.f / static_cast<float>(sg);
  const float inv_dof = 1.f / static_cast<float>(sg - 1);

  float acc = 0.f;
  for (int64_t j = begin + threadIdx.x; j < end; j += blockDim.x) {
    if constexpr (kSg > 0) {
      Raw v[kSg];
#pragma unroll
      for (int s = 0; s < kSg; ++s) v[s] = xg[s * units + j];
      acc += stddev_sum<U>([&](int s) { return v[s]; }, kSg, inv_sg, inv_dof, eps);
    } else {
      acc += stddev_sum<U>([&](int s) { return xg[s * units + j]; }, sg, inv_sg, inv_dof,
                           eps);
    }
  }

  __shared__ float partial[kMaxThreads / 32];
  __shared__ float block_sums[kClusterBlocks];  // read on rank 0 only
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) {
    acc += __shfl_xor_sync(0xffffffffu, acc, offset);
  }
  if (lane == 0) partial[warp] = acc;
  __syncthreads();
  float block_sum = 0.f;
  if (warp == 0) {
    block_sum = lane < static_cast<int>(blockDim.x >> 5) ? partial[lane] : 0.f;
#pragma unroll
    for (int offset = 16; offset > 0; offset >>= 1) {
      block_sum += __shfl_xor_sync(0xffffffffu, block_sum, offset);
    }
  }
  // Every block of the cluster has started (each arrived at entry), so rank
  // 0's shared memory may be written: this block's sum, into slot `rank`.
  cluster_wait();
  if (threadIdx.x == 0) *cluster.map_shared_rank(&block_sums[rank], 0) = block_sum;
  // Every block's sum has reached rank 0, which stays resident until then;
  // no block's own shared memory is read after it.
  cluster.sync();
  if (rank == 0 && threadIdx.x == 0) {
    float total = 0.f;
#pragma unroll
    for (int r = 0; r < kClusterBlocks; ++r) total += block_sums[r];
    out[group] = total / static_cast<float>(f);
  }
}

int elem_bytes(int dtype) { return dtype == 0 ? 4 : dtype == 1 ? 2 : 0; }

// Values a load reads: 16 / bytes (the vector branch) when a row of f
// values is a whole number of 16-byte vectors and x is 16-byte aligned,
// else 1 (the generic branch).
int values_a_load(const void* x, int64_t f, int bytes) {
  const bool vec = (f * bytes) % kVecBytes == 0 &&
                   reinterpret_cast<uintptr_t>(x) % kVecBytes == 0;
  return vec ? kVecBytes / bytes : 1;
}

// Threads a block: the block's share of a row's loads, rounded up to a
// whole warp and at most kMaxThreads, so every thread has a load.
unsigned int block_threads(int64_t units) {
  const int64_t warps = ((units + kClusterBlocks - 1) / kClusterBlocks + 31) / 32;
  return static_cast<unsigned int>(warps < kMaxThreads / 32 ? warps * 32 : kMaxThreads);
}

template <typename T, bool kVec, int kSg>
void launch_one(const void* x, float* out, int64_t groups, int64_t units, int64_t f, int sg,
                float eps, cudaStream_t s) {
  const dim3 grid(static_cast<unsigned int>(groups * kClusterBlocks));
  mb_stddev_kernel<T, kVec, kSg><<<grid, block_threads(units), 0, s>>>(
      static_cast<const typename Unit<T, kVec>::Raw*>(x), out, units, f, sg, eps);
}

template <typename T>
void launch(const void* x, float* out, int64_t groups, int64_t f, int sg, float eps,
            cudaStream_t s) {
  const int per_load = values_a_load(x, f, static_cast<int>(sizeof(T)));
  const int64_t units = f / per_load;
  if (per_load > 1) {
    if (sg == 4) {
      launch_one<T, true, 4>(x, out, groups, units, f, sg, eps, s);
    } else {
      launch_one<T, true, 0>(x, out, groups, units, f, sg, eps, s);
    }
  } else if (sg == 4) {
    launch_one<T, false, 4>(x, out, groups, units, f, sg, eps, s);
  } else {
    launch_one<T, false, 0>(x, out, groups, units, f, sg, eps, s);
  }
}

}  // namespace

extern "C" {

// x: [n, f] of dtype (0 = float32, 1 = bfloat16); out: [n / sg] float32.
int pggan_minibatch_stddev_stat(const void* x, void* out, int64_t n, int64_t f, int sg,
                                int dtype, float eps, void* stream) {
  if (sg < 2 || n <= 0 || f <= 0 || n % sg != 0 || elem_bytes(dtype) == 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t groups = n / sg;
  if (groups > 0x7fffffffLL / kClusterBlocks) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  if (dtype == 0) {
    launch<float>(x, o, groups, f, sg, eps, s);
  } else {
    launch<__nv_bfloat16>(x, o, groups, f, sg, eps, s);
  }
  return static_cast<int>(cudaGetLastError());
}

// The branch the kernel takes for x with f values a sample: *per_load
// values a load, 4 (f32) or 8 (bf16) on the vector branch and 1 on the
// generic one. Touches no memory behind x.
int pggan_minibatch_stddev_plan(const void* x, int64_t f, int dtype, int* per_load) {
  const int bytes = elem_bytes(dtype);
  if (bytes == 0 || f <= 0) return static_cast<int>(cudaErrorInvalidValue);
  *per_load = values_a_load(x, f, bytes);
  return static_cast<int>(cudaSuccess);
}

}  // extern "C"

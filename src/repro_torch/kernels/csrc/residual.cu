// Norms of n rows against one centre: out[r] = ||rows[r] - center||_2.
//
// Replaces no TPU kernel.  The reference's streaming service takes, after
// each commit, the k residual norms ||x_i - estimate|| of its
// estimator-outlier check and the trust clip's step norm ||estimate - w||
// on the host (src/repro/serve/service.py).  On the card, eager PyTorch
// makes each norm from a full-width temporary: vector_norm(x - c) reads
// x and c, writes x - c and reads it back, four times the row's bytes.
// This kernel reads each row once and the centre once per pass; the
// service passes its model as one more row, so the step norm rides along.
//
// What bounds it on this card: bytes.  n rows and the centre of M f32
// elements are (n + 1) * 4 * M bytes: 9 rows of 751,894,528 elements
// (serve-k8's 8 payloads and the model) take at least 8.98 ms at 3.35 TB/s.
//
// Design:
//   * Rows by address: a device table of n row pointers, so the rows are
//     read where they lie and nothing is restaged.
//   * A block owns column tiles in a grid-stride loop over 16-byte vectors
//     of the centre (kUnroll in flight a thread).  It loads the centre's
//     tile once into registers, then streams the same tile of each of its
//     rows and forms d = x - c in f32 -- the subtraction the reference
//     makes -- and accumulates d * d per thread in f64 (a square of an f32
//     is exact in f64).  kUnroll = 2 keeps it at 64 registers, four blocks
//     an SM: on an H100 that read 9 x 751,894,528 rows at 94.5% of 3.35
//     TB/s, where 4 loads (75 registers, three blocks) read 85.6%.
//   * Rows per pass: a block takes up to kMaxRows rows; more rows are
//     split over gridDim.y chunks of equal size, each re-reading the
//     centre (1/16 more bytes at most, much of it from L2).  With n <=
//     kMaxRows, as in serve-k8, the centre is read once.
//   * Alignment: the vectors follow the centre's 16-byte boundaries (its
//     head elements before the first boundary and tail elements after the
//     last whole vector are read one at a time by block x = 0).  A row
//     whose address is not 16-byte aligned the same way as the centre's
//     reads the same elements as four scalar loads.
//   * No float atomics: each block writes its per-row partial sums
//     (a fixed-order tree over its threads) to scratch; a second launch
//     sums each row's partials in a fixed order and writes the f32 norm.
//     The grid depends only on the card, n and M, so the same inputs give
//     the same bits on every run.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 2;
constexpr int kMaxRows = 16;
constexpr int kMaxBlocksX = 1024;
constexpr int kMaxDevices = 64;

__device__ __forceinline__ double add_sq(double acc, float x, float c) {
  const double d = static_cast<double>(x - c);
  return fma(d, d, acc);
}

__device__ __forceinline__ double add_sq4(double acc, float4 x, float4 c) {
  acc = add_sq(acc, x.x, c.x);
  acc = add_sq(acc, x.y, c.y);
  acc = add_sq(acc, x.z, c.z);
  return add_sq(acc, x.w, c.w);
}

// Vector i of a body of 16-byte vectors: one load where the row shares
// the centre's alignment, four scalar loads where it does not.
__device__ __forceinline__ float4 load_vec(const float* body, int64_t i,
                                           bool aligned) {
  if (aligned) return __ldg(reinterpret_cast<const float4*>(body) + i);
  const float* p = body + 4 * i;
  return make_float4(__ldg(p), __ldg(p + 1), __ldg(p + 2), __ldg(p + 3));
}

// Rows r0 .. r0 + nr of the table (r0 = blockIdx.y * rows_per_block) against
// the centre, split as ops.finite_split splits the centre: head elements,
// n_vec 16-byte vectors, tail elements.  partials[r * gridDim.x +
// blockIdx.x]: the block's sum of squared differences of row r.
__global__ void __launch_bounds__(kThreads)
    residual_partials(const float* const* __restrict__ rows, int n,
                      int rows_per_block, const float* __restrict__ center,
                      int64_t head, int64_t n_vec, int64_t tail,
                      double* __restrict__ partials) {
  __shared__ const float* row_body[kMaxRows];
  __shared__ double reduced[kMaxRows][kWarps];
  const int r0 = blockIdx.y * rows_per_block;
  const int nr = min(rows_per_block, n - r0);
  const uintptr_t c_addr = reinterpret_cast<uintptr_t>(center);
  if (threadIdx.x < nr) row_body[threadIdx.x] = rows[r0 + threadIdx.x] + head;
  __syncthreads();
  uint32_t aligned = 0;
  for (int r = 0; r < nr; ++r)
    aligned |= (uint32_t)(((reinterpret_cast<uintptr_t>(row_body[r]) -
                            head * sizeof(float)) ^ c_addr) % 16 == 0) << r;

  double acc[kMaxRows];
#pragma unroll
  for (int r = 0; r < kMaxRows; ++r) acc[r] = 0.0;

  if (blockIdx.x == 0) {
    const int t = threadIdx.x;
    const float* c_body = center + head;
    if (t < head) {
      const float c = __ldg(center + t);
#pragma unroll
      for (int r = 0; r < kMaxRows; ++r)
        if (r < nr) acc[r] = add_sq(acc[r], __ldg(row_body[r] - head + t), c);
    }
    if (t < tail) {
      const int64_t j = 4 * n_vec + t;
      const float c = __ldg(c_body + j);
#pragma unroll
      for (int r = 0; r < kMaxRows; ++r)
        if (r < nr) acc[r] = add_sq(acc[r], __ldg(row_body[r] + j), c);
    }
  }

  const float4* cv = reinterpret_cast<const float4*>(center + head);
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  for (; i + (kUnroll - 1) * stride < n_vec; i += kUnroll * stride) {
    float4 c[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) c[u] = __ldg(cv + i + u * stride);
#pragma unroll
    for (int r = 0; r < kMaxRows; ++r) {
      if (r < nr) {
        const float* body = row_body[r];
        const bool a = (aligned >> r) & 1u;
        float4 x[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) x[u] = load_vec(body, i + u * stride, a);
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) acc[r] = add_sq4(acc[r], x[u], c[u]);
      }
    }
  }
  for (; i < n_vec; i += stride) {
    const float4 c = __ldg(cv + i);
#pragma unroll
    for (int r = 0; r < kMaxRows; ++r)
      if (r < nr)
        acc[r] = add_sq4(acc[r], load_vec(row_body[r], i, (aligned >> r) & 1u),
                         c);
  }

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
#pragma unroll
  for (int r = 0; r < kMaxRows; ++r) {
    if (r < nr) {
      double s = acc[r];
#pragma unroll
      for (int o = 16; o > 0; o /= 2) s += __shfl_down_sync(0xffffffffu, s, o);
      if (lane == 0) reduced[r][warp] = s;
    }
  }
  __syncthreads();
  if (threadIdx.x < nr) {
    double s = 0.0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += reduced[threadIdx.x][w];
    partials[(int64_t)(r0 + threadIdx.x) * gridDim.x + blockIdx.x] = s;
  }
}

// out[blockIdx.x] = sqrt of the sum of the row's `blocks` partials, summed
// in a fixed order.
__global__ void __launch_bounds__(kThreads)
    residual_finish(const double* __restrict__ partials, int blocks,
                    float* __restrict__ out) {
  __shared__ double reduced[kWarps];
  const double* p = partials + (int64_t)blockIdx.x * blocks;
  double s = 0.0;
  for (int j = threadIdx.x; j < blocks; j += kThreads) s += p[j];
#pragma unroll
  for (int o = 16; o > 0; o /= 2) s += __shfl_down_sync(0xffffffffu, s, o);
  if (threadIdx.x % 32 == 0) reduced[threadIdx.x / 32] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    double total = 0.0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) total += reduced[w];
    out[blockIdx.x] = static_cast<float>(sqrt(total));
  }
}

// The blocks of residual_partials that device `dev` holds at once: its SM
// count times the blocks an SM holds, asked once per device.
cudaError_t resident_blocks(int dev, int* blocks) {
  static int cached[kMaxDevices] = {0};
  if (dev < kMaxDevices && cached[dev] > 0) {
    *blocks = cached[dev];
    return cudaSuccess;
  }
  int sms = 0, per_sm = 0;
  cudaError_t err =
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, residual_partials, kThreads, 0);
  if (err != cudaSuccess) return err;
  *blocks = sms * (per_sm > 0 ? per_sm : 1);
  if (dev < kMaxDevices) cached[dev] = *blocks;
  return cudaSuccess;
}

cudaError_t launch(int dev, const float* const* rows, int n,
                   const float* center, int64_t head, int64_t n_vec,
                   int64_t tail, double* partials, int64_t capacity,
                   float* out, cudaStream_t stream) {
  const uintptr_t body = reinterpret_cast<uintptr_t>(center + head);
  if (n_vec > 0 && body % 16 != 0) return cudaErrorMisalignedAddress;
  int resident = 0;
  cudaError_t err = resident_blocks(dev, &resident);
  if (err != cudaSuccess) return err;
  const int chunks = (n + kMaxRows - 1) / kMaxRows;
  const int rows_per_block = (n + chunks - 1) / chunks;
  const int64_t needed = (n_vec + kThreads * kUnroll - 1) / (kThreads * kUnroll);
  int64_t blocks = resident / chunks;
  if (blocks > needed) blocks = needed;
  if (blocks > kMaxBlocksX) blocks = kMaxBlocksX;
  if (blocks < 1) blocks = 1;
  if ((int64_t)n * blocks > capacity) return cudaErrorInvalidValue;
  residual_partials<<<dim3((unsigned)blocks, (unsigned)chunks), kThreads, 0,
                      stream>>>(rows, n, rows_per_block, center, head, n_vec,
                                tail, partials);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  residual_finish<<<(unsigned)n, kThreads, 0, stream>>>(partials, (int)blocks,
                                                        out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The partial sums residual_norms_launch needs room for: n rows times at
// most this many blocks a row.
int residual_max_blocks() { return kMaxBlocksX; }

// rows: a device table of n pointers to contiguous f32 rows of the
// centre's length, on device `device`; center: the centre there, split as
// ops.finite_split splits it (head elements up to its first 16-byte
// boundary, n_vec 16-byte vectors, tail elements).  partials: `capacity`
// device doubles of scratch, at least n * residual_max_blocks().  out: n
// device floats, out[r] = ||rows[r] - center||.  Two launches on `stream`,
// made with `device` current (the caller's current device is put back);
// nothing waits.  Returns a cudaError_t.
int residual_norms_launch(const void* rows, int n, const void* center,
                          int64_t head, int64_t n_vec, int64_t tail,
                          void* partials, int64_t capacity, void* out,
                          void* stream, int device) {
  if (n < 1 || n > 65535 * kMaxRows || head < 0 || n_vec < 0 || tail < 0 ||
      head >= 4 || tail >= 4 || device < 0)
    return (int)cudaErrorInvalidValue;
  int current = 0;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  err = launch(device, static_cast<const float* const*>(rows), n,
               static_cast<const float*>(center), head, n_vec, tail,
               static_cast<double*>(partials), capacity,
               static_cast<float*>(out), static_cast<cudaStream_t>(stream));
  if (current != device) {
    const cudaError_t back = cudaSetDevice(current);
    if (err == cudaSuccess) err = back;
  }
  return (int)err;
}

}  // extern "C"

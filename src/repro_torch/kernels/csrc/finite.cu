// Finiteness check of one tensor: does it hold a NaN, +inf or -inf?
//
// Replaces no TPU kernel.  The reference's streaming service checks each
// payload, each estimate and the initial model with np.isfinite(x).all()
// on the host (src/repro/serve/buffer.py:90, service.py:274 and :669).
// On the card, eager PyTorch does not fuse torch.isfinite(x).all():
// x == x, abs(x), != inf, & and the bool reduction move about 5.5 times
// the tensor's bytes (16.5 GB for a 3.0 GB f32 payload).  This kernel is
// the one read.
//
// What bounds it on this card: bytes.  It reads x once and writes a 4-byte
// flag: a 3.0 GB f32 payload takes at least 0.90 ms at 3.35 TB/s.
//
// Design:
//   * The bits are tested, not the values: an f32 (bf16) element is not
//     finite exactly when its exponent field is all ones, 0x7f800000
//     (0x7f80).  One test covers NaN, +inf and -inf; no float compare.
//   * 16-byte loads (4 f32 or 8 bf16 elements a load), neighbouring
//     threads on neighbouring addresses, in a grid-stride loop over 64-bit
//     offsets with kUnroll loads in flight a thread, on one wave of the
//     blocks the card holds at once (asked of the card once per device).
//     The elements before x's first 16-byte boundary (a view whose offset
//     is not a multiple of 16 bytes) and after its last whole vector are
//     tested one at a time by the first threads of the grid.
//   * Nothing is written but the flag.  Each thread ORs its verdicts, a
//     block combines them with one __syncthreads_or, and its thread 0
//     makes at most one atomicOr on the flag.  The flag comes zeroed, one
//     a check (ops.any_nonfinite hands them out of blocks zeroed ahead),
//     so a check is one launch and the caller's 4-byte read-back.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;
constexpr int kMaxDevices = 64;

// The element's bits (uint32_t for f32, uint16_t for bf16): nonzero where
// an element, or any element of a 32-bit word or a 16-byte vector, is not
// finite.
template <typename E> struct Bits;

template <> struct Bits<uint32_t> {
  static __device__ __forceinline__ uint32_t one(uint32_t e) {
    return (e & 0x7f800000u) == 0x7f800000u;
  }
  static __device__ __forceinline__ uint32_t word(uint32_t w) { return one(w); }
};

template <> struct Bits<uint16_t> {
  static __device__ __forceinline__ uint32_t one(uint16_t e) {
    return (e & 0x7f80u) == 0x7f80u;
  }
  static __device__ __forceinline__ uint32_t word(uint32_t w) {
    return ((w & 0x00007f80u) == 0x00007f80u) |
           ((w & 0x7f800000u) == 0x7f800000u);
  }
};

template <typename E>
__device__ __forceinline__ uint32_t vector_bits(uint4 v) {
  return Bits<E>::word(v.x) | Bits<E>::word(v.y) | Bits<E>::word(v.z) |
         Bits<E>::word(v.w);
}

// x: head elements up to the first 16-byte boundary, then n_vec 16-byte
// vectors, then tail elements; *flag |= 1 where any is not finite.
template <typename E>
__global__ void __launch_bounds__(kThreads)
    finite_scan(const E* __restrict__ x, int64_t head, int64_t n_vec,
                int64_t tail, uint32_t* flag) {
  constexpr int64_t kPerVec = 16 / sizeof(E);
  const int64_t tid = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  const E* body = x + head;
  uint32_t bad = 0;
  if (tid < head) bad |= Bits<E>::one(x[tid]);
  if (tid < tail) bad |= Bits<E>::one(body[n_vec * kPerVec + tid]);
  const uint4* v = reinterpret_cast<const uint4*>(body);
  int64_t i = tid;
  for (; i + (kUnroll - 1) * stride < n_vec; i += kUnroll * stride) {
    uint4 r[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) r[u] = __ldg(v + i + u * stride);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) bad |= vector_bits<E>(r[u]);
  }
  for (; i < n_vec; i += stride) bad |= vector_bits<E>(__ldg(v + i));
  if (__syncthreads_or(bad) && threadIdx.x == 0) atomicOr(flag, 1u);
}

// The blocks of finite_scan<E> that device `dev` holds at once: its SM
// count times the blocks an SM holds, asked once per device.
template <typename E>
cudaError_t resident_blocks(int dev, int64_t* blocks) {
  static int64_t cached[kMaxDevices] = {0};
  if (dev < kMaxDevices && cached[dev] > 0) {
    *blocks = cached[dev];
    return cudaSuccess;
  }
  int sms = 0, per_sm = 0;
  cudaError_t err =
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, finite_scan<E>, kThreads, 0);
  if (err != cudaSuccess) return err;
  *blocks = (int64_t)sms * (per_sm > 0 ? per_sm : 1);
  if (dev < kMaxDevices) cached[dev] = *blocks;
  return cudaSuccess;
}

template <typename E>
cudaError_t launch(int dev, const void* x, int64_t head, int64_t n_vec,
                   int64_t tail, uint32_t* flag, cudaStream_t stream) {
  const uintptr_t body = reinterpret_cast<uintptr_t>(x) + head * sizeof(E);
  if (n_vec > 0 && body % 16 != 0) return cudaErrorMisalignedAddress;
  int64_t blocks = 0;
  cudaError_t err = resident_blocks<E>(dev, &blocks);
  if (err != cudaSuccess) return err;
  const int64_t needed = (n_vec + kThreads - 1) / kThreads;
  if (needed < blocks) blocks = needed > 0 ? needed : 1;
  finite_scan<E><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const E*>(x), head, n_vec, tail, flag);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x: f32 (dtype 0) or bf16 (dtype 1) elements, contiguous, on device
// `device`, split as ops.finite_split splits them: head elements up to the
// first 16-byte boundary, n_vec 16-byte vectors, tail elements (head and
// tail fewer than one vector's).  flag: one zeroed device uint32 there,
// set to 1 where any element is NaN, +inf or -inf.  One launch on
// `stream`, made with `device` current (the caller's current device is
// put back); nothing waits.  Returns a cudaError_t.
int finite_check_launch(const void* x, int dtype, int64_t head, int64_t n_vec,
                        int64_t tail, void* flag, void* stream, int device) {
  if ((dtype != 0 && dtype != 1) || head < 0 || n_vec < 0 || tail < 0 ||
      head >= kThreads || tail >= kThreads || head + n_vec + tail == 0 ||
      device < 0)
    return (int)cudaErrorInvalidValue;
  int current = 0;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  uint32_t* f = static_cast<uint32_t*>(flag);
  err = dtype == 0 ? launch<uint32_t>(device, x, head, n_vec, tail, f, s)
                   : launch<uint16_t>(device, x, head, n_vec, tail, f, s);
  if (current != device) {
    const cudaError_t back = cudaSetDevice(current);
    if (err == cudaSuccess) err = back;
  }
  return (int)err;
}

}  // extern "C"

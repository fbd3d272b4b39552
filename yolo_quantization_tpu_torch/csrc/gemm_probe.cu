// Int8 dot-product probe tiles in the two GEMM orientations, for Hopper.
//
// Replaces scripts/mxu_orientation_probe.py::orientation_a / orientation_b
// (the Pallas kernels that measured the TPU's matrix unit on the stem's two
// GEMM shapes).  Same functions, int8 x int8 -> int32 accumulation, then
// narrowing to int8 that WRAPS modulo 256 as XLA's convert does:
//   orientation_a: x (P, K) . w (K, O) -> (P, O)   rows = pixels
//   orientation_b: w (O, K) . x (K, P) -> (O, P)   pixels contiguous
//
// What bounds it on the H100: bytes for the probe's shapes (K <= 128 and
// O <= 64 give at most 64 int8 operations per byte moved, far below the
// card's int8 ridge), so both kernels stream x once and write the output
// once, with coalesced 16-byte (A) or 4-byte (B) accesses; the small weight
// matrix is staged in shared memory per block.  Products run on __dp4a.
//   - A: one thread per row p and 16 output columns; the row's K codes are
//     already words of 4 along K; w is staged transposed to words along K.
//   - B: one thread per 4 consecutive pixels and 16 output rows; 4x4 byte
//     blocks of x (4 k's x 4 pixels) are transposed in registers with
//     __byte_perm into words along K; w's rows are words along K as stored.
// Shapes are checked by the wrapper: K % 4 == 0, O % 16 == 0, P % 4 == 0 (B).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kOT = 16;      // output columns (A) / rows (B) per block
constexpr int kMaxKW = 64;   // K <= 256

__global__ void __launch_bounds__(kThreads)
orientation_a_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                     uint8_t* __restrict__ out, int p_rows, int k, int o) {
  __shared__ int ws[kOT][kMaxKW + 1];
  const int kw = k / 4;
  const int o0 = blockIdx.y * kOT;
  for (int idx = threadIdx.x; idx < kOT * kw; idx += kThreads) {
    const int ol = idx / kw, q = idx - ol * kw;
    uint32_t v = 0;
#pragma unroll
    for (int b = 0; b < 4; ++b) v |= (uint32_t)(uint8_t)w[(size_t)(4 * q + b) * o + o0 + ol] << (8 * b);
    ws[ol][q] = (int)v;
  }
  __syncthreads();
  const size_t row = (size_t)blockIdx.x * kThreads + threadIdx.x;
  if (row >= (size_t)p_rows) return;
  const int* xr = reinterpret_cast<const int*>(x + row * k);
  int acc[kOT];
#pragma unroll
  for (int j = 0; j < kOT; ++j) acc[j] = 0;
  for (int q = 0; q < kw; ++q) {
    const int a = __ldg(xr + q);
#pragma unroll
    for (int j = 0; j < kOT; ++j) acc[j] = __dp4a(a, ws[j][q], acc[j]);
  }
  uint32_t packed[kOT / 4];
#pragma unroll
  for (int g = 0; g < kOT / 4; ++g) {
    packed[g] = 0;
#pragma unroll
    for (int b = 0; b < 4; ++b) packed[g] |= (uint32_t)(uint8_t)acc[4 * g + b] << (8 * b);
  }
  *reinterpret_cast<uint4*>(out + row * o + o0) =
      make_uint4(packed[0], packed[1], packed[2], packed[3]);
}

__global__ void __launch_bounds__(kThreads)
orientation_b_kernel(const int8_t* __restrict__ w, const int8_t* __restrict__ x,
                     uint8_t* __restrict__ out, int p_cols, int k, int o) {
  __shared__ int ws[kOT][kMaxKW + 1];
  const int kw = k / 4;
  const int o0 = blockIdx.y * kOT;
  for (int idx = threadIdx.x; idx < kOT * kw; idx += kThreads) {
    const int ol = idx / kw, q = idx - ol * kw;
    ws[ol][q] = reinterpret_cast<const int*>(w + (size_t)(o0 + ol) * k)[q];
  }
  __syncthreads();
  const size_t p0 = 4 * ((size_t)blockIdx.x * kThreads + threadIdx.x);
  if (p0 >= (size_t)p_cols) return;
  int acc[kOT][4];
#pragma unroll
  for (int j = 0; j < kOT; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0;
  for (int q = 0; q < kw; ++q) {
    // rows k = 4q .. 4q+3, pixels p0 .. p0+3: transpose the 4x4 byte block
    const uint32_t r0 = __ldg(reinterpret_cast<const unsigned*>(x + (size_t)(4 * q) * p_cols + p0));
    const uint32_t r1 = __ldg(reinterpret_cast<const unsigned*>(x + (size_t)(4 * q + 1) * p_cols + p0));
    const uint32_t r2 = __ldg(reinterpret_cast<const unsigned*>(x + (size_t)(4 * q + 2) * p_cols + p0));
    const uint32_t r3 = __ldg(reinterpret_cast<const unsigned*>(x + (size_t)(4 * q + 3) * p_cols + p0));
    const uint32_t lo01 = __byte_perm(r0, r1, 0x5140), lo23 = __byte_perm(r2, r3, 0x5140);
    const uint32_t hi01 = __byte_perm(r0, r1, 0x7362), hi23 = __byte_perm(r2, r3, 0x7362);
    const int t[4] = {
        (int)__byte_perm(lo01, lo23, 0x5410), (int)__byte_perm(lo01, lo23, 0x7632),
        (int)__byte_perm(hi01, hi23, 0x5410), (int)__byte_perm(hi01, hi23, 0x7632)};
#pragma unroll
    for (int j = 0; j < kOT; ++j) {
      const int b = ws[j][q];
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[j][i] = __dp4a(t[i], b, acc[j][i]);
    }
  }
#pragma unroll
  for (int j = 0; j < kOT; ++j) {
    uint32_t v = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) v |= (uint32_t)(uint8_t)acc[j][i] << (8 * i);
    *reinterpret_cast<uint32_t*>(out + (size_t)(o0 + j) * p_cols + p0) = v;
  }
}

bool bad_shape(int p, int k, int o) {
  return p < 1 || k < 4 || k % 4 || k / 4 > kMaxKW || o < kOT || o % kOT;
}

}  // namespace

// Plain C entries for ctypes; each returns the launch's cudaError_t.
extern "C" int yq_orientation_a(const void* x, const void* w, void* out, int p, int k, int o,
                                void* stream) {
  if (bad_shape(p, k, o)) return (int)cudaErrorInvalidValue;
  const dim3 grid((p + kThreads - 1) / kThreads, o / kOT);
  orientation_a_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
      static_cast<uint8_t*>(out), p, k, o);
  return (int)cudaGetLastError();
}

extern "C" int yq_orientation_b(const void* w, const void* x, void* out, int p, int k, int o,
                                void* stream) {
  if (bad_shape(p, k, o) || p % 4) return (int)cudaErrorInvalidValue;
  const dim3 grid((p / 4 + kThreads - 1) / kThreads, o / kOT);
  orientation_b_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(w), static_cast<const int8_t*>(x),
      static_cast<uint8_t*>(out), p, k, o);
  return (int)cudaGetLastError();
}

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
// once, with coalesced accesses; the small weight matrix is staged in shared
// memory per block.
//   - A (tensor cores): the grid runs over P only, one persistent block per
//     slot the card holds, each walking 128-row tiles of x through a
//     3-stage ring of 16-byte cp.async copies; one block covers all O
//     columns, so x is read once.  w is staged once per block, transposed
//     to the K-contiguous B operand.  Products: mma.sync m16n8k32 s8
//     (common.cuh), operands by ldmatrix; shared rows are K + 16 bytes, so
//     the 8 rows of an ldmatrix phase fall on distinct bank groups.  Each
//     warp narrows its 32 x O accumulators with (uint8_t)acc into shared
//     memory and writes them as contiguous 16-byte stores.
//   - B (__dp4a): one thread per 4 consecutive pixels and 16 output rows;
//     4x4 byte blocks of x (4 k's x 4 pixels) are transposed in registers
//     with __byte_perm into words along K; w's rows are words along K as
//     stored.
// Shapes are checked by the wrapper: A: K % 32 == 0 (<= 256), O % 16 == 0
// (<= 64); B: K % 4 == 0 (<= 256), O % 16 == 0, P % 4 == 0.

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kOT = 16;      // output rows per block (B)
constexpr int kMaxKW = 64;   // K <= 256

constexpr int kATile = 128;     // rows of x per tile (A)
constexpr int kAThreads = 128;  // 4 warps of 32 rows
constexpr int kAStages = 3;
constexpr int kAMaxO = 64;
constexpr int kMaxDevices = 64;  // per-device launch facts in launch_a

// dynamic shared memory of orientation_a at depth k and O = 16 * NT
constexpr int a_smem_bytes(int k, int nt) {
  return (16 * nt + kAStages * kATile) * (k + 16) + kATile * 16 * nt;
}

template <int NT>  // O = 16 * NT output columns
__global__ void __launch_bounds__(kAThreads)
orientation_a_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                     uint8_t* __restrict__ out, int p_rows, int k, int tiles) {
  constexpr int O = 16 * NT, NI = 2 * NT;
  extern __shared__ __align__(128) uint8_t smem[];
  const int rs = k + 16;                   // shared row stride in bytes
  uint8_t* const ws = smem;                // [O][rs]: w transposed, K contiguous
  uint8_t* const xs = smem + O * rs;       // [kAStages][kATile][rs]
  uint8_t* const os = xs + kAStages * kATile * rs;  // [kATile][O]: narrowed outputs
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int chunks = k / 16;               // 16-byte copies per row of x
  const int mine = (tiles - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;

  auto load = [&](int i) {  // this block's i-th tile into ring slot i % kAStages
    const long long row0 = (long long)(blockIdx.x + i * gridDim.x) * kATile;
    uint8_t* dst = xs + (i % kAStages) * kATile * rs;
    for (int idx = t; idx < kATile * chunks; idx += kAThreads) {
      const int r = idx / chunks, c = idx - r * chunks;
      const bool ok = row0 + r < p_rows;
      yq::cp_async16(yq::smem_addr(dst + r * rs + c * 16), ok ? x + (row0 + r) * k + c * 16 : x,
                     ok ? 16 : 0);
    }
  };
#pragma unroll
  for (int s = 0; s < kAStages - 1; ++s) {
    if (s < mine) load(s);
    yq::cp_async_commit();
  }
  for (int idx = t; idx < k * O; idx += kAThreads) {  // w (K, O) -> [O][K]
    const int kk = idx / O, o = idx - kk * O;
    ws[o * rs + kk] = (uint8_t)w[idx];
  }

  const int g = lane >> 2, tq = lane & 3;
  uint8_t* const ow = os + warp * 32 * O;  // this warp's 32 output rows
  for (int i = 0; i < mine; ++i) {
    yq::cp_async_wait<kAStages - 2>();
    __syncthreads();  // tile i is in (and w, at i = 0); every warp is done with tile i - 1
    if (i + kAStages - 1 < mine) load(i + kAStages - 1);
    yq::cp_async_commit();

    const uint8_t* xt = xs + (i % kAStages) * kATile * rs + warp * 32 * rs;
    int acc[2][NI][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) acc[mi][ni][0] = acc[mi][ni][1] = acc[mi][ni][2] = acc[mi][ni][3] = 0;
    for (int k0 = 0; k0 < k; k0 += 32) {
      uint32_t af[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        yq::ldmatrix_x4(af[mi], yq::smem_addr(xt + (mi * 16 + (lane & 15)) * rs + k0 + (lane >> 4) * 16));
      }
#pragma unroll
      for (int nj = 0; nj < NT; ++nj) {
        uint32_t r[4];
        yq::ldmatrix_x4(r, yq::smem_addr(ws + (nj * 16 + (lane & 7) + ((lane >> 4) << 3)) * rs + k0 +
                                         ((lane >> 3) & 1) * 16));
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          yq::mma_s8(acc[mi][2 * nj], af[mi], r[0], r[1]);
          yq::mma_s8(acc[mi][2 * nj + 1], af[mi], r[2], r[3]);
        }
      }
    }
    // narrow modulo 256, as XLA's int32 -> int8 convert does
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < NI; ++ni)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int r = mi * 16 + g + 8 * hh;
          *reinterpret_cast<uint16_t*>(ow + r * O + ni * 8 + 2 * tq) =
              (uint16_t)((uint8_t)acc[mi][ni][2 * hh] | ((uint8_t)acc[mi][ni][2 * hh + 1] << 8));
        }
    __syncwarp();
    const long long row0 = (long long)(blockIdx.x + i * gridDim.x) * kATile + warp * 32;
    for (int idx = lane; idx < 2 * O; idx += 32) {  // 32 rows x O bytes, 16 at a time
      if (row0 + idx / (O / 16) < p_rows) {
        *reinterpret_cast<uint4*>(out + row0 * O + idx * 16) = *reinterpret_cast<const uint4*>(ow + idx * 16);
      }
    }
    __syncwarp();  // the staging rows are read before the next tile writes them
  }
}

template <int NT>
int launch_a(const int8_t* x, const int8_t* w, uint8_t* out, int p, int k, cudaStream_t stream) {
  const auto kernel = orientation_a_kernel<NT>;
  const int smem = a_smem_bytes(k, NT);
  // Set up once per device and depth, outside any graph capture: the smem
  // attribute, the SM count and how many blocks of this size an SM holds.
  static int sms[kMaxDevices] = {0};
  static int per_sm[kMaxDevices][kMaxKW * 4 / 32 + 1] = {{0}};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (sms[dev] == 0) {
    int count = 0;
    err = cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess) {
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 a_smem_bytes(kMaxKW * 4, NT));
    }
    if (err != cudaSuccess) return (int)err;
    sms[dev] = count;
  }
  int& blocks = per_sm[dev][k / 32];
  if (blocks == 0) {
    const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, kAThreads, smem);
    if (err != cudaSuccess) return (int)err;
    if (blocks < 1) return (int)cudaErrorInvalidConfiguration;
  }
  const int tiles = (p + kATile - 1) / kATile;
  const int grid = tiles < sms[dev] * blocks ? tiles : sms[dev] * blocks;
  kernel<<<grid, kAThreads, smem, stream>>>(x, w, out, p, k, tiles);
  return (int)cudaGetLastError();
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
  if (p < 1 || k < 32 || k % 32 || k / 4 > kMaxKW || o < 16 || o % 16 || o > kAMaxO) {
    return (int)cudaErrorInvalidValue;
  }
  const auto xa = static_cast<const int8_t*>(x);
  const auto wa = static_cast<const int8_t*>(w);
  const auto oa = static_cast<uint8_t*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  switch (o / 16) {
    case 1: return launch_a<1>(xa, wa, oa, p, k, s);
    case 2: return launch_a<2>(xa, wa, oa, p, k, s);
    case 3: return launch_a<3>(xa, wa, oa, p, k, s);
    default: return launch_a<4>(xa, wa, oa, p, k, s);
  }
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

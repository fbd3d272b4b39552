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
// once, with 16-byte accesses.  Both run on the int8 tensor cores (mma.sync
// m16n8k32 s8, common.cuh) with the same structure: the grid runs over P
// only, one persistent block per slot the card holds, each walking tiles of
// x through a 3-stage ring of 16-byte cp.async copies; one block covers all
// O, so x is read once; the small w is staged in shared memory once per
// block; each warp narrows its accumulators with (uint8_t)acc into shared
// memory and writes them as contiguous 16-byte stores.  Shared rows are
// 16 bytes longer than their data, so the 8 rows of an ldmatrix phase fall
// on distinct bank groups.
//   - A: 128-row tiles of x (P-major, K contiguous) are the mma's A operand
//     as stored; w is transposed once to the K-contiguous B operand.
//   - B: w (O, K) is the A operand as stored.  x is the B operand, but it is
//     P-contiguous and the s8 mma wants 4 consecutive K-bytes of a column
//     in each register; Hopper has no 8-bit ldmatrix.trans (and wgmma
//     transposes 16-bit types only).  So 128-pixel tiles of x are staged as
//     stored, read with the b16 ldmatrix.trans (a pixel pair is one b16),
//     and one __byte_perm per register splits each pair into an even-pixel
//     and an odd-pixel word of 4 K-bytes.  Those K-bytes are rows
//     2t, 2t+1, 8+2t, 9+2t of a 16-row group, so w's shared copy holds K in
//     that order (b_k_order).  The even and odd words are two n8 tiles, and
//     a thread's columns 2t, 2t+1 of both are pixels 4t .. 4t+3: the store
//     is one word per output row.
// Shapes are checked by the wrapper: A: K % 32 == 0 (<= 256), O % 16 == 0
// (<= 64); B: the same and P % 16 == 0.

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kMaxKW = 64;   // K <= 256
constexpr int kAMaxO = 64;   // O <= 64

constexpr int kATile = 128;     // rows of x per tile (A)
constexpr int kAThreads = 128;  // 4 warps of 32 rows
constexpr int kAStages = 3;

constexpr int kBTile = 128;          // pixels of x per tile (B)
constexpr int kBThreads = 128;       // 4 warps of 32 pixels
constexpr int kBStages = 3;
constexpr int kBRow = kBTile + 16;   // shared row stride of B's x and output tiles

// dynamic shared memory of orientation_a at depth k and O = 16 * NT
constexpr int a_smem_bytes(int k, int nt) {
  return (16 * nt + kAStages * kATile) * (k + 16) + kATile * 16 * nt;
}

// dynamic shared memory of orientation_b at depth k and O = 16 * MI
constexpr int b_smem_bytes(int k, int mi) {
  return 16 * mi * (k + 16) + kBStages * k * kBRow + 16 * mi * kBRow;
}

// The x row of a 16-row group that meets K-byte j of w's shared copy: the
// transposed ldmatrix gives lane t rows 2t, 2t+1 and 8+2t, 9+2t, which the
// mma reads as its K-bytes 4t .. 4t+3.
__host__ __device__ constexpr int b_k_order(int j) {
  return 2 * (j >> 2) + (j & 1) + ((j & 2) << 2);
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

template <int MI>  // O = 16 * MI output rows
__global__ void __launch_bounds__(kBThreads)
orientation_b_kernel(const int8_t* __restrict__ w, const int8_t* __restrict__ x,
                     uint8_t* __restrict__ out, int p_cols, int k, int tiles) {
  constexpr int O = 16 * MI;
  extern __shared__ __align__(128) uint8_t smem[];
  const int rs = k + 16;                          // shared row stride of w in bytes
  uint8_t* const ws = smem;                       // [O][rs]: w, K in b_k_order per 16
  uint8_t* const xs = smem + O * rs;              // [kBStages][k][kBRow]: x tiles as stored
  uint8_t* const os = xs + kBStages * k * kBRow;  // [O][kBRow]: narrowed outputs
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int mine = (tiles - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;

  auto load = [&](int i) {  // this block's i-th tile into ring slot i % kBStages
    const long long p0 = (long long)(blockIdx.x + i * gridDim.x) * kBTile;
    uint8_t* dst = xs + (i % kBStages) * k * kBRow;
    for (int idx = t; idx < k * (kBTile / 16); idx += kBThreads) {
      const int r = idx / (kBTile / 16), c = idx % (kBTile / 16);
      const bool ok = p0 + c * 16 < p_cols;  // P % 16 == 0: a chunk is all in or all out
      yq::cp_async16(yq::smem_addr(dst + r * kBRow + c * 16),
                     ok ? x + (long long)r * p_cols + p0 + c * 16 : x, ok ? 16 : 0);
    }
  };
#pragma unroll
  for (int s = 0; s < kBStages - 1; ++s) {
    if (s < mine) load(s);
    yq::cp_async_commit();
  }
  for (int idx = t; idx < O * k; idx += kBThreads) {  // w (O, K), K reordered within each 16
    const int o = idx / k, kk = idx - o * k;
    ws[o * rs + kk] = (uint8_t)w[o * k + (kk & ~15) + b_k_order(kk & 15)];
  }

  const int g = lane >> 2, tq = lane & 3;
  for (int i = 0; i < mine; ++i) {
    yq::cp_async_wait<kBStages - 2>();
    __syncthreads();  // tile i is in (and w, at i = 0); every warp is done with tile i - 1
    if (i + kBStages - 1 < mine) load(i + kBStages - 1);
    yq::cp_async_commit();

    // this warp's 32 pixels: two groups of 16, each two n8 tiles (even and
    // odd pixels): acc[mi][2 * group + parity]
    const uint8_t* xt = xs + (i % kBStages) * k * kBRow + warp * 32;
    int acc[MI][4][4];
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) acc[mi][ni][0] = acc[mi][ni][1] = acc[mi][ni][2] = acc[mi][ni][3] = 0;
    for (int k0 = 0; k0 < k; k0 += 32) {
      uint32_t af[MI][4];
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) {
        yq::ldmatrix_x4(af[mi], yq::smem_addr(ws + (mi * 16 + (lane & 15)) * rs + k0 + (lane >> 4) * 16));
      }
#pragma unroll
      for (int gi = 0; gi < 2; ++gi) {
        // matrix j is x rows k0 + 8j .. + 7 (lane l addresses row k0 + l) over
        // 16 pixels; lane (g, t) gets rows 2t, 2t+1 of matrix j at pixels 2g,
        // 2g+1.  Bytes 0 and 2 of r[0], r[1] are 4 K-bytes of pixel 2g,
        // bytes 1 and 3 those of pixel 2g+1.
        uint32_t r[4];
        yq::ldmatrix_x4_trans(r, yq::smem_addr(xt + (k0 + lane) * kBRow + gi * 16));
        const uint32_t even0 = __byte_perm(r[0], r[1], 0x6420), odd0 = __byte_perm(r[0], r[1], 0x7531);
        const uint32_t even1 = __byte_perm(r[2], r[3], 0x6420), odd1 = __byte_perm(r[2], r[3], 0x7531);
#pragma unroll
        for (int mi = 0; mi < MI; ++mi) {
          yq::mma_s8(acc[mi][2 * gi], af[mi], even0, even1);
          yq::mma_s8(acc[mi][2 * gi + 1], af[mi], odd0, odd1);
        }
      }
    }
    // narrow modulo 256, as XLA's int32 -> int8 convert does.  Column c of
    // the even tile is pixel 2c of its group, of the odd tile pixel 2c + 1,
    // so columns 2t, 2t+1 of both are pixels 4t .. 4t+3: one word per row.
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int gi = 0; gi < 2; ++gi) {
          *reinterpret_cast<uint32_t*>(os + (mi * 16 + g + 8 * hh) * kBRow + warp * 32 + gi * 16 + 4 * tq) =
              (uint32_t)(uint8_t)acc[mi][2 * gi][2 * hh] | (uint32_t)(uint8_t)acc[mi][2 * gi + 1][2 * hh] << 8 |
              (uint32_t)(uint8_t)acc[mi][2 * gi][2 * hh + 1] << 16 |
              (uint32_t)(uint8_t)acc[mi][2 * gi + 1][2 * hh + 1] << 24;
        }
    __syncwarp();
    const long long p0 = (long long)(blockIdx.x + i * gridDim.x) * kBTile + warp * 32;
    for (int idx = lane; idx < 2 * O; idx += 32) {  // O rows x 32 bytes, 16 at a time
      const int row = idx >> 1, half = idx & 1;
      if (p0 + half * 16 < p_cols) {
        *reinterpret_cast<uint4*>(out + (long long)row * p_cols + p0 + half * 16) =
            *reinterpret_cast<const uint4*>(os + row * kBRow + warp * 32 + half * 16);
      }
    }
    __syncwarp();  // the staging rows are read before the next tile writes them
  }
}

// Launch facts of one persistent kernel, per device: the SM count (0 until
// read) and how many blocks an SM holds at each depth (0 until asked).
struct LaunchFacts {
  int sms[yq::kMaxDevices];
  int per_sm[yq::kMaxDevices][kMaxKW * 4 / 32 + 1];
};

// The persistent grid: once per device, outside any graph capture, the SM
// count and the shared-memory attribute (at the largest depth); once per
// depth, the blocks of this size an SM holds.  That many blocks per SM, or
// fewer where there are fewer tiles.
template <typename Kernel>
cudaError_t persistent_grid(LaunchFacts& f, Kernel kernel, int threads, int max_smem, int k,
                            int smem, int tiles, int& grid) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= yq::kMaxDevices) return cudaErrorInvalidDevice;
  if (f.sms[dev] == 0) {
    int count = 0;
    err = cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess) {
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, max_smem);
    }
    if (err != cudaSuccess) return err;
    f.sms[dev] = count;
  }
  int& blocks = f.per_sm[dev][k / 32];
  if (blocks == 0) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads, smem);
    if (err != cudaSuccess) return err;
    if (blocks < 1) return cudaErrorInvalidConfiguration;
  }
  grid = tiles < f.sms[dev] * blocks ? tiles : f.sms[dev] * blocks;
  return cudaSuccess;
}

template <int NT>
int launch_a(const int8_t* x, const int8_t* w, uint8_t* out, int p, int k, cudaStream_t stream) {
  static LaunchFacts facts;  // one per instantiation
  const int smem = a_smem_bytes(k, NT), tiles = (p + kATile - 1) / kATile;
  int grid = 0;
  const cudaError_t err = persistent_grid(facts, orientation_a_kernel<NT>, kAThreads,
                                          a_smem_bytes(kMaxKW * 4, NT), k, smem, tiles, grid);
  if (err != cudaSuccess) return (int)err;
  orientation_a_kernel<NT><<<grid, kAThreads, smem, stream>>>(x, w, out, p, k, tiles);
  return (int)cudaGetLastError();
}

template <int MI>
int launch_b(const int8_t* w, const int8_t* x, uint8_t* out, int p, int k, cudaStream_t stream) {
  static LaunchFacts facts;  // one per instantiation
  const int smem = b_smem_bytes(k, MI), tiles = (p + kBTile - 1) / kBTile;
  int grid = 0;
  const cudaError_t err = persistent_grid(facts, orientation_b_kernel<MI>, kBThreads,
                                          b_smem_bytes(kMaxKW * 4, MI), k, smem, tiles, grid);
  if (err != cudaSuccess) return (int)err;
  orientation_b_kernel<MI><<<grid, kBThreads, smem, stream>>>(w, x, out, p, k, tiles);
  return (int)cudaGetLastError();
}

bool bad_shape(int p, int k, int o) {
  return p < 1 || k < 32 || k % 32 || k / 4 > kMaxKW || o < 16 || o % 16 || o > kAMaxO;
}

}  // namespace

// Plain C entries for ctypes; each returns the launch's cudaError_t.
extern "C" int yq_orientation_a(const void* x, const void* w, void* out, int p, int k, int o,
                                void* stream) {
  if (bad_shape(p, k, o)) return (int)cudaErrorInvalidValue;
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
  if (bad_shape(p, k, o) || p % 16) return (int)cudaErrorInvalidValue;
  const auto wa = static_cast<const int8_t*>(w);
  const auto xa = static_cast<const int8_t*>(x);
  const auto oa = static_cast<uint8_t*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  switch (o / 16) {
    case 1: return launch_b<1>(wa, xa, oa, p, k, s);
    case 2: return launch_b<2>(wa, xa, oa, p, k, s);
    case 3: return launch_b<3>(wa, xa, oa, p, k, s);
    default: return launch_b<4>(wa, xa, oa, p, k, s);
  }
}

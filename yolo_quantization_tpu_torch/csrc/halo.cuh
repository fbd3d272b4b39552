// The halo design, shared by K1 (qconv.cu, the bytes-bound 3x3 stem convs)
// and K2 (s2d_qconv.cu, the structured s2d stem): each tile's input halo
// fetched once by TMA, A read from it in place, mma.sync s8, the epilogue of
// common.cuh, 16-byte stores.  Also the TMA map encoding and cache that
// qconv.cu's wgmma design uses for its weights.  Each .cu file that
// includes it is its own library, with its own copy of the caches below.
//
// What the two kernels share is the kernel itself (halo_kernel); K2 adds one
// template argument, PHASES.  A structured s2d block kernel (every entry
// outside infer/convert.py::_s2d_weights' pattern zero) is, for output phase
// (py, px), an ordinary 3x3 pad-1 conv at pixel (2 by + py, 2 bx + px) with
// its own 3x3xCi kernel, then the max over the four phases: K1's pooled
// tile with one B slice per phase.  PHASES 1 is K1's (and K2's where the
// four phase kernels are equal, as in every engine program); PHASES 4 gives
// each phase its own slice (ops/cuda_s2d.py::pack_weights), applied per
// fragment, below.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <limits.h>
#include <stdint.h>

#include <mutex>

#include "common.cuh"
#include "hopper.cuh"

namespace yq {

// ---- TMA maps through the driver ----

// cuTensorMapEncodeTiled, a driver entry point, from the driver library
// that the CUDA runtime has already loaded (no -lcuda at build time).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (lib == nullptr) lib = dlopen("libcuda.so.1", RTLD_NOW);
    return lib ? reinterpret_cast<EncodeTiled>(dlsym(lib, "cuTensorMapEncodeTiled")) : nullptr;
  }();
  return fn;
}

// A TMA map (unsigned bytes, no interleave, L2 promotion 128 B, zero fill)
// in a direct-mapped table by (pointer, shape, box, swizzle): an engine's
// tensors keep their maps, so the per-call host cost stays a lookup, and a
// captured CUDA graph replays the map it was captured with (the map is a
// kernel parameter, copied at capture).
struct MapKey {
  const void* ptr;
  int rank;
  cuuint64_t dims[3], strides[2];
  cuuint32_t box[3];
  CUtensorMapSwizzle swizzle;

  bool operator==(const MapKey& o) const {
    bool same = ptr == o.ptr && rank == o.rank && swizzle == o.swizzle;
    for (int i = 0; i < rank; ++i) same = same && dims[i] == o.dims[i] && box[i] == o.box[i];
    for (int i = 0; i + 1 < rank; ++i) same = same && strides[i] == o.strides[i];
    return same;
  }
};

inline cudaError_t cached_map(const MapKey& k, CUtensorMap& map) {
  struct Entry {
    MapKey key;
    CUtensorMap map;
    bool used;
  };
  constexpr int kEntries = 1024;
  static Entry cache[kEntries];
  static std::mutex mu;
  uint64_t hash = ((uint64_t)(uintptr_t)k.ptr >> 4) * 0x9E3779B97F4A7C15ull;
  for (int i = 0; i < k.rank; ++i) hash = (hash ^ (k.dims[i] << 20 ^ (uint64_t)k.box[i] << 8)) * 0x100000001B3ull;
  Entry& e = cache[(hash >> 32) % kEntries];
  std::lock_guard<std::mutex> lock(mu);
  if (e.used && e.key == k) {
    map = e.map;
    return cudaSuccess;
  }
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorSharedObjectSymbolNotFound;
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult res = encode(&map, CU_TENSOR_MAP_DATA_TYPE_UINT8, k.rank, const_cast<void*>(k.ptr), k.dims,
                              k.strides, k.box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, k.swizzle,
                              CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (res != CUDA_SUCCESS) return cudaErrorInvalidValue;
  e = Entry{k, map, true};
  return cudaSuccess;
}

// ---- the halo tile ----

constexpr int kHaloThreads = 128;         // four warps
constexpr int kHaloTW = 32;               // a tile's width in output pixels
constexpr int kStemStride = 48;           // Ci = 3: an A-tile row, 32 K-bytes + 16
constexpr int kHaloMaxSmem = 160 * 1024;

// The tile of a halo instantiation: NT n8 tiles (Co = 8 NT) and MI m16
// tiles a warp, so a thread holds 64 accumulators whatever Co; a tile is TH
// = 2 MI output rows of 32 pixels (the four warps' 64 MI rows), at most 8
// rows at stride 2, where a halo row spans twice the pixels.  Its halo is
// ((TH - 1) S + 3) input rows of ((TW - 1) S + 3) pixels.  Ci = 3 lays a
// halo row out as the pixels' codes end to end (STEM_USED bytes), fetched
// from the 16-byte boundary below the first (the tile's first input byte,
// x0 S 3 - 3, lies STEM_LEAD bytes past one: TMA's box starts on 16
// bytes), the box rounded up to 16 bytes.
template <int S, int NT>
struct HaloTile {
  static constexpr int MI = 16 / NT < (S == 2 ? 4 : 8) ? 16 / NT : (S == 2 ? 4 : 8);
  static constexpr int TH = 2 * MI;
  static constexpr int ROWS = 16 * MI;  // GEMM rows a warp
  static constexpr int HH = (TH - 1) * S + 3;
  static constexpr int HW = (kHaloTW - 1) * S + 3;
  static constexpr int STEM_USED = HW * 3;
  static constexpr int STEM_LEAD = 13;
  static constexpr int STEM_ROW = (STEM_LEAD + STEM_USED + 15) / 16 * 16;
  static_assert(NT == 2 || NT == 4 || NT == 8, "Co 16, 32 or 64");
  static_assert(kHaloTW * S * 3 % 16 == 0, "a tile's first input byte keeps its place past a 16-byte boundary");
};

__host__ __device__ __forceinline__ int round128(int v) { return (v + 127) & ~127; }

// The shared memory of a halo block, from a 128-byte aligned base: two
// halo buffers (TMA's destinations), the weights (PHASES slices of Co
// rows), the A tiles (Ci = 3; else a zero chunk that K padding reads and
// the K chunks' halo offsets, at most 28), the staged output tile, two
// mbarriers.
struct HaloLayout {
  int pitch;         // Ci >= 16: bytes a halo pixel takes (the box's inner extent)
  int box_bytes;     // what TMA writes into a halo buffer
  int halo_bytes;    // a halo buffer
  int b_off, b_stride;
  int a_off;
  int stage_off, stage_stride;
  int bar_off;
  int smem;          // bytes to ask for, alignment slack included
};

template <int S, bool POOL, bool STEM, int NT, int PHASES = 1>
__host__ __device__ __forceinline__ HaloLayout halo_layout(int ci, int k_pad) {
  using T = HaloTile<S, NT>;
  HaloLayout l;
  // an odd number of 16-byte chunks a pixel, so 8 pixels of a row (an
  // ldmatrix phase) fall on 8 distinct bank groups; TMA fills the extra
  // chunk (past Ci in the map) with zeros, which nothing reads
  l.pitch = STEM ? 0 : (ci / 16) % 2 ? ci : ci + 16;
  l.box_bytes = STEM ? T::HH * T::STEM_ROW : T::HH * T::HW * l.pitch;
  l.halo_bytes = round128(l.box_bytes);
  l.b_off = 2 * l.halo_bytes;
  l.b_stride = k_pad + 16;  // an odd number of chunks: K_pad is a multiple of 32
  l.a_off = l.b_off + round128(PHASES * 8 * NT * l.b_stride);
  l.stage_off = l.a_off + (STEM ? 4 * T::ROWS * kStemStride : 128);
  l.stage_stride = NT == 4 ? 48 : 8 * NT + 16;  // an odd number of 16-byte chunks
  l.bar_off = l.stage_off + round128((POOL ? 8 : 32) * T::TH * l.stage_stride);
  l.smem = 128 + l.bar_off + 16;
  return l;
}

// The tile pixel (py, px) of row r of warp `warp` (MI / 2 groups of 32
// rows, two m16 tiles each).  Without the pool, group u is output row
// (MI / 2) warp + u's 32 pixels.  With it, group u holds 8 windows, 4 wide
// and 2 tall (pixels 8 warp .. 8 warp + 7 of rows 4 u .. 4 u + 3): row 8 a
// + j is pixel q = a ^ wy, (dy, dx) = (q / 2, q % 2), of window j = 4 wy +
// wx.  A thread (g = lane / 4) holds rows g, g + 8, 16 + g, 24 + g of a
// group's two m16 tiles, which are window g's four pixels; an 8-row
// ldmatrix phase reads 4 windows of one window row at pixel q and 4 of the
// next at q ^ 1, whose halo pixels lie an odd number of pixels from the
// first four: with an odd pitch, 8 distinct bank groups.  So m16 tile h of
// a group holds its windows' pixels dy = h, and its row g (8 + g) the pixel
// dx = g / 4 (1 - g / 4).
template <bool POOL, int MI>
__device__ __forceinline__ void halo_row_pixel(int warp, int r, int& py, int& px) {
  const int u = r >> 5, rr = r & 31;
  if (POOL) {
    const int a = rr >> 3, j = rr & 7, wy = j >> 2, q = a ^ wy;
    py = 4 * u + 2 * wy + (q >> 1);
    px = 8 * warp + 2 * (j & 3) + (q & 1);
  } else {
    py = (MI / 2) * warp + u;
    px = rr;
  }
}

// A persistent block walks tiles of TH x 32 output pixels (TH/2 x 16
// pooled windows) of one image, blockIdx.x + i gridDim.x.  Two halo
// buffers alternate: thread 0 asks TMA for tile i + 2's halo as soon as
// tile i's buffer is free, so a halo lands while the tiles before it
// multiply and store.  Per tile:
//   - after the buffer's mbarrier, a border tile's threads write the
//     image's zero-point code into the halo pixels outside the map (TMA wrote
//     0 there, or another image's rows: the map folds N and H);
//   - Ci >= 16: each ldmatrix row address points at the (pixel, tap) chunk
//     of the halo itself, the implicit im2col with no copy; K padding (Ci
//     16's last 16 bytes) reads a zero chunk.  Ci = 3: each lane builds its
//     rows' 27 codes (three runs of 9 halo bytes, word loads and byte
//     permutes) into its warp's A tile, K padded to 32 with 0;
//   - mma.sync m16n8k32 over the weights, loaded once per block; the fused
//     pool and ASYM's patchsum as in qconv.cu's qconv_mma_kernel.  With
//     PHASES 4 (pooled, symmetric) m16 tile h is multiplied by slices (h, 0)
//     and (h, 1), each time with the A rows of the other dx zeroed in the
//     lane's fragment (halo_row_pixel: rows g and 8 + g have dx g / 4 and
//     1 - g / 4), into the same accumulators: twice the MMAs of one slice,
//     the same A loads, no bank conflict added;
//   - the codes are staged in shared memory and leave as 16-byte stores of
//     whole rows.
// P is the caller's conv parameters (qconv.cu's Params, s2d_qconv.cu's
// HaloConv).  Held to 128 registers, 4 blocks an SM: 6-12% faster than 3
// blocks (up to 159 registers) on seven of the eight model convs on the H100
// at batch 16; 32 accumulators a thread (6 blocks) or 4 m16 tiles at Co 64
// ran slower (PERF.md §6).
template <int S, bool POOL, bool STEM, int NT, bool ASYM, int PHASES, class P>
__global__ void __launch_bounds__(kHaloThreads, 4)
    halo_kernel(const __grid_constant__ P p, const __grid_constant__ CUtensorMap x_map, int tiles_x, int tiles_y,
                int tiles) {
  using T = HaloTile<S, NT>;
  constexpr int MI = T::MI;
  static_assert(!POOL || S == 1, "the fused pool follows a stride-1 conv");
  static_assert(PHASES == 1 || (PHASES == 4 && POOL && !ASYM), "phase slices: the pooled symmetric tile");
  const HaloLayout L = halo_layout<S, POOL, STEM, NT, PHASES>(p.ci, p.k_pad);
  extern __shared__ __align__(16) uint8_t hsmem[];
  const uint32_t raw = smem_addr(hsmem);
  const uint32_t base = (raw + 127) & ~127u;  // TMA's destinations on 128 bytes
  uint8_t* const sm = hsmem + (base - raw);
  const uint32_t bars = base + L.bar_off;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int g = lane >> 2, tq = lane & 3;

  if (t == 0) {
    mbar_init(bars, 1);
    mbar_init(bars + 8, 1);
    mbar_init_fence();
  }
  const int kc = p.k_pad / 16;  // the weights, once a block: PHASES slices of Co rows of K_pad bytes
  for (int idx = t; idx < PHASES * 8 * NT * kc; idx += kHaloThreads) {
    const int r = idx / kc, c = idx - r * kc;
    *reinterpret_cast<uint4*>(sm + L.b_off + r * L.b_stride + 16 * c) =
        __ldg(reinterpret_cast<const uint4*>(p.w + (size_t)r * p.k_pad) + c);
  }
  // Ci >= 16: a zero chunk (K padding reads it), then per 16-byte K chunk j
  // its halo offset from a row's window origin: tap (dy, dx), channel c
  int* const tap_off = reinterpret_cast<int*>(sm + L.a_off + 16);
  if (!STEM && t < 4) reinterpret_cast<uint32_t*>(sm + L.a_off)[t] = 0;
  if (!STEM && t < p.k_pad / 16) {
    const int tap = 16 * t / p.ci, c = 16 * t - tap * p.ci;
    tap_off[t] = t < 9 * p.ci / 16 ? ((tap / 3) * T::HW + tap % 3) * L.pitch + c : -1;
  }
  __syncthreads();

  auto origin = [&](int tile, int& img, int& y0, int& x0) {
    const int tx = tile % tiles_x, rest = tile / tiles_x, ty = rest % tiles_y;
    img = rest / tiles_y;
    y0 = ty * T::TH;
    x0 = tx * kHaloTW;
  };
  auto fetch = [&](int tile, int buf) {  // thread 0: the tile's halo into buffer buf
    int img, y0, x0;
    origin(tile, img, y0, x0);
    const int row = img * p.h + y0 * S - p.pad, col = x0 * S - p.pad;
    const uint32_t bar = bars + 8 * buf, dst = base + buf * L.halo_bytes;
    mbar_arrive_expect_tx(bar, L.box_bytes);
    if (STEM) {
      tma_load_2d(dst, &x_map, col * 3 - T::STEM_LEAD, row, bar);
    } else {
      tma_load_3d(dst, &x_map, 0, col, row, bar);
    }
  };

  // per lane and m16 tile: the ldmatrix row 16 mi + lane % 16, as the halo
  // offset of the row's window origin (Ci >= 16) or the A-tile row (Ci = 3,
  // at K half lane / 16)
  uint32_t a_row[MI];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi) {
    int py, px;
    halo_row_pixel<POOL, MI>(warp, 16 * mi + (lane & 15), py, px);
    a_row[mi] = STEM ? base + L.a_off + (warp * T::ROWS + 16 * mi + (lane & 15)) * kStemStride + (lane >> 4) * 16
                     : (uint32_t)((py * S * T::HW + px * S) * L.pitch);
  }
  const uint32_t zero_chunk = base + L.a_off;
  const int ksteps = p.k_pad / 32;
  const Clamp cl = clamp_of(p.e);

  if (t == 0) {
    if ((int)blockIdx.x < tiles) fetch(blockIdx.x, 0);
    if ((int)(blockIdx.x + gridDim.x) < tiles) fetch(blockIdx.x + gridDim.x, 1);
  }
  int it = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++it) {
    const int buf = it & 1;
    int img, y0, x0;
    origin(tile, img, y0, x0);
    const uint32_t hb = base + buf * L.halo_bytes;
    uint8_t* const hg = sm + buf * L.halo_bytes;
    mbar_wait(bars + 8 * buf, (it >> 1) & 1);
    const int iy0 = y0 * S - p.pad, ix0 = x0 * S - p.pad;
    const bool border = iy0 < 0 || ix0 < 0 || iy0 + T::HH > p.h || ix0 + T::HW > p.w_in;
    if (border) {  // the zero point where the halo lies outside the map: a warp a halo row
      const int zp = p.x_zp_img ? p.x_zp_img[img] : p.x_zp;
      const bool col_edge = ix0 < 0 || ix0 + T::HW > p.w_in;
      for (int hy = warp; hy < T::HH; hy += kHaloThreads / 32) {
        const bool row_out = (unsigned)(iy0 + hy) >= (unsigned)p.h;
        if (!row_out && !col_edge) continue;
        if (STEM) {  // bytes b of pixel ix0 + b / 3
          uint8_t* const row = hg + hy * T::STEM_ROW + T::STEM_LEAD;
          for (int b = lane; b < T::STEM_USED; b += 32) {
            if (row_out || (unsigned)(ix0 + b / 3) >= (unsigned)p.w_in) row[b] = (uint8_t)zp;
          }
        } else {
          const uint32_t zw = (uint32_t)(uint8_t)zp * 0x01010101u;
          for (int hx = lane; hx < T::HW; hx += 32) {
            if (row_out || (unsigned)(ix0 + hx) >= (unsigned)p.w_in) {
              for (int c = 0; c < p.ci; c += 16) {
                *reinterpret_cast<uint4*>(hg + (hy * T::HW + hx) * L.pitch + c) = make_uint4(zw, zw, zw, zw);
              }
            }
          }
        }
      }
    }
    __syncthreads();  // the halo is whole; the previous tile's codes have left the stage

    if (STEM) {  // K = (dy, dx, c): the 9 codes of halo rows py S + dy end to end, then 5 bytes of 0
#pragma unroll
      for (int u = 0; u < MI / 2; ++u) {
        int py, px;
        halo_row_pixel<POOL, MI>(warp, 32 * u + lane, py, px);
        const int first = T::STEM_LEAD + px * S * 3;  // the window's first code in its halo row
        const int shift = (first & 3) * 8;
        uint32_t r[3][3];
#pragma unroll
        for (int dy = 0; dy < 3; ++dy) {
          const uint32_t* src =
              reinterpret_cast<const uint32_t*>(hg + (py * S + dy) * T::STEM_ROW + (first & ~3));
          const uint32_t w0 = src[0], w1 = src[1], w2 = src[2];
          r[dy][0] = __funnelshift_r(w0, w1, shift);
          r[dy][1] = __funnelshift_r(w1, w2, shift);
          r[dy][2] = w2 >> shift;
        }
        uint8_t* const dst = sm + L.a_off + (warp * T::ROWS + 32 * u + lane) * kStemStride;
        *reinterpret_cast<uint4*>(dst) = make_uint4(r[0][0], r[0][1], __byte_perm(r[0][2], r[1][0], 0x6540),
                                                    __byte_perm(r[1][0], r[1][1], 0x6543));
        *reinterpret_cast<uint4*>(dst + 16) =
            make_uint4(__byte_perm(__byte_perm(r[1][1], r[1][2], 0x0043), r[2][0], 0x5410),
                       __byte_perm(r[2][0], r[2][1], 0x5432), __byte_perm(r[2][1], r[2][2], 0x0432) & 0x00ffffffu,
                       0u);
      }
      __syncwarp();
    }

    int acc[MI][NT][4];
    int ps[MI][2];  // patchsum of rows g, g+8 of each m16 tile (ASYM)
#pragma unroll
    for (int mi = 0; mi < MI; ++mi) {
      ps[mi][0] = ps[mi][1] = 0;
#pragma unroll
      for (int ni = 0; ni < NT; ++ni) acc[mi][ni][0] = acc[mi][ni][1] = acc[mi][ni][2] = acc[mi][ni][3] = 0;
    }
    for (int ks = 0; ks < ksteps; ++ks) {
      uint32_t af[MI][4], bf[NT][2];
      if (STEM) {
#pragma unroll
        for (int mi = 0; mi < MI; ++mi) ldmatrix_x4(af[mi], a_row[mi]);
      } else {
        // lanes 0-15 read K chunk 2 ks, lanes 16-31 chunk 2 ks + 1 of each
        // row's window
        const int off = tap_off[2 * ks + (lane >> 4)];
#pragma unroll
        for (int mi = 0; mi < MI; ++mi) ldmatrix_x4(af[mi], off >= 0 ? hb + off + a_row[mi] : zero_chunk);
      }
      if constexpr (PHASES == 1) {
#pragma unroll
        for (int nj = 0; nj < NT / 2; ++nj) {
          uint32_t r[4];
          ldmatrix_x4(r, base + L.b_off + (nj * 16 + (lane & 7) + ((lane >> 4) << 3)) * L.b_stride + ks * 32 +
                             ((lane >> 3) & 1) * 16);
          bf[2 * nj][0] = r[0];
          bf[2 * nj][1] = r[1];
          bf[2 * nj + 1][0] = r[2];
          bf[2 * nj + 1][1] = r[3];
        }
#pragma unroll
        for (int mi = 0; mi < MI; ++mi) {
#pragma unroll
          for (int ni = 0; ni < NT; ++ni) mma_s8(acc[mi][ni], af[mi], bf[ni][0], bf[ni][1]);
        }
      } else {  // slice ph = (dy, dx) on the rows of m16 tiles dy, dy + 2, .. whose pixel has this dx
        const bool first_rows = (g >> 2) == 0;  // row g has dx 0 (and row 8 + g dx 1)
#pragma unroll
        for (int ph = 0; ph < 4; ++ph) {
#pragma unroll
          for (int nj = 0; nj < NT / 2; ++nj) {
            uint32_t r[4];
            ldmatrix_x4(r, base + L.b_off + (ph * 8 * NT + nj * 16 + (lane & 7) + ((lane >> 4) << 3)) * L.b_stride +
                               ks * 32 + ((lane >> 3) & 1) * 16);
            bf[2 * nj][0] = r[0];
            bf[2 * nj][1] = r[1];
            bf[2 * nj + 1][0] = r[2];
            bf[2 * nj + 1][1] = r[3];
          }
          const bool keep_g = first_rows == ((ph & 1) == 0);  // row g's dx is this slice's
#pragma unroll
          for (int mi = ph >> 1; mi < MI; mi += 2) {
            const uint32_t a[4] = {keep_g ? af[mi][0] : 0u, keep_g ? 0u : af[mi][1], keep_g ? af[mi][2] : 0u,
                                   keep_g ? 0u : af[mi][3]};
#pragma unroll
            for (int ni = 0; ni < NT; ++ni) mma_s8(acc[mi][ni], a, bf[ni][0], bf[ni][1]);
          }
        }
      }
      if (ASYM) {
#pragma unroll
        for (int mi = 0; mi < MI; ++mi) {
          ps[mi][0] = __dp4a((int)af[mi][0], 0x01010101, __dp4a((int)af[mi][2], 0x01010101, ps[mi][0]));
          ps[mi][1] = __dp4a((int)af[mi][1], 0x01010101, __dp4a((int)af[mi][3], 0x01010101, ps[mi][1]));
        }
      }
    }
    if (ASYM) {  // each of a quad's 4 threads summed a quarter of its rows' K bytes
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          ps[mi][hh] += __shfl_xor_sync(0xffffffffu, ps[mi][hh], 1);
          ps[mi][hh] += __shfl_xor_sync(0xffffffffu, ps[mi][hh], 2);
        }
      }
    }

    // the epilogue: per column pair (o, o + 1) of each n8 tile, its bias, m
    // and w_zp read once, for the thread's MI / 2 pooled windows or 2 MI rows
    const size_t bm = (size_t)img * p.e.bm_stride;
    uint8_t* const stage = sm + L.stage_off;
    with_act(p.e, [&](auto mish) {
      constexpr bool MISH = decltype(mish)::value;
#pragma unroll
      for (int ni = 0; ni < NT; ++ni) {
        const int o = 8 * ni + 2 * tq;
        const int b0 = __ldg(p.e.bias + bm + o), b1 = __ldg(p.e.bias + bm + o + 1);
        const float m0 = __ldg(p.e.m + bm + o), m1 = __ldg(p.e.m + bm + o + 1);
        const unsigned z0 = ASYM ? (unsigned)__ldg(p.w_zp + o) : 0u, z1 = ASYM ? (unsigned)__ldg(p.w_zp + o + 1) : 0u;
        // acc - w_zp[o] * patchsum in wrapping int32, as XLA's
        auto corrected = [&](int mi, int hh, int e) {
          return (int)((unsigned)acc[mi][ni][2 * hh + e] - (e ? z1 : z0) * (unsigned)ps[mi][hh]);
        };
        auto pair = [&](int a0, int a1) {
          return (uint16_t)((uint32_t)(uint8_t)requant<MISH>(a0, b0, m0, p.e, cl) |
                            (uint32_t)(uint8_t)requant<MISH>(a1, b1, m1, p.e, cl) << 8);
        };
#pragma unroll
        for (int u = 0; u < MI / 2; ++u) {
          if (POOL) {  // window g of group u: tile window (2 u + g / 4, 4 warp + g % 4) of TH / 2 x 16
            int a0 = INT_MIN, a1 = INT_MIN;
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              a0 = max(a0, corrected(2 * u + (q >> 1), q & 1, 0));
              a1 = max(a1, corrected(2 * u + (q >> 1), q & 1, 1));
            }
            *reinterpret_cast<uint16_t*>(stage + ((2 * u + (g >> 2)) * 16 + 4 * warp + (g & 3)) * L.stage_stride + o) =
                pair(a0, a1);
          } else {  // row 16 h + 8 hh + g of group u: pixel (MI / 2 warp + u, 16 h + 8 hh + g)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
#pragma unroll
              for (int hh = 0; hh < 2; ++hh) {
                const int pl = ((MI / 2) * warp + u) * kHaloTW + 16 * h + 8 * hh + g;
                *reinterpret_cast<uint16_t*>(stage + pl * L.stage_stride + o) =
                    pair(corrected(2 * u + h, hh, 0), corrected(2 * u + h, hh, 1));
              }
            }
          }
        }
      }
    });
    if (border) fence_proxy_async();  // the zero-point writes precede TMA's next writes to the buffer
    __syncthreads();                  // the stage is whole; nothing reads the halo buffer any more
    if (t == 0 && tile + 2 * (int)gridDim.x < tiles) fetch(tile + 2 * gridDim.x, buf);

    constexpr int CPP = NT / 2;  // 16-byte chunks a pixel
    if (POOL) {
      const int ph = p.h_out >> 1, pw = p.w_out >> 1;
#pragma unroll
      for (int idx = t; idx < 8 * T::TH * CPP; idx += kHaloThreads) {
        const int wl = idx / CPP, c = idx - wl * CPP;
        const int y = (y0 >> 1) + (wl >> 4), x = (x0 >> 1) + (wl & 15);
        if (y < ph && x < pw) {
          *reinterpret_cast<uint4*>(p.out + ((size_t)(img * ph + y) * pw + x) * p.co + 16 * c) =
              *reinterpret_cast<const uint4*>(stage + wl * L.stage_stride + 16 * c);
        }
      }
    } else {
#pragma unroll
      for (int idx = t; idx < 32 * T::TH * CPP; idx += kHaloThreads) {
        const int pl = idx / CPP, c = idx - pl * CPP;
        const int y = y0 + (pl >> 5), x = x0 + (pl & 31);
        if (y < p.h_out && x < p.w_out) {
          *reinterpret_cast<uint4*>(p.out + ((size_t)(img * p.h_out + y) * p.w_out + x) * p.co + 16 * c) =
              *reinterpret_cast<const uint4*>(stage + pl * L.stage_stride + 16 * c);
        }
      }
    }
  }
}

// ---- launching a halo kernel ----

// Blocks an SM holds of a halo kernel at `smem` bytes: the occupancy
// calculator's answer, kept per (kernel, device, smem).
template <class P>
cudaError_t halo_blocks_per_sm(void (*kernel)(P, CUtensorMap, int, int, int), int dev, int smem, int& blocks) {
  struct Entry {
    void (*fn)(P, CUtensorMap, int, int, int);
    int dev, smem, blocks;
  };
  constexpr int kEntries = 256;
  static Entry cache[kEntries];
  static int used = 0;
  static std::mutex mu;
  std::lock_guard<std::mutex> lock(mu);
  for (int i = 0; i < used; ++i) {
    if (cache[i].fn == kernel && cache[i].dev == dev && cache[i].smem == smem) {
      blocks = cache[i].blocks;
      return cudaSuccess;
    }
  }
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, kHaloThreads, smem);
  if (err != cudaSuccess) return err;
  if (blocks < 1) return cudaErrorInvalidConfiguration;
  if (used < kEntries) cache[used++] = Entry{kernel, dev, smem, blocks};
  return cudaSuccess;
}

// The TMA map of x for the halo: Ci = 3 as bytes (W * 3 wide, N * H rows),
// boxes of a halo's rows; else (Ci, W, N * H), boxes of (pitch, HW, HH) --
// the pitch past Ci arrives as zeros.  A halo that reaches past the map
// arrives as zeros or as the next image's rows; the kernel overwrites both.
template <int S, bool STEM, int NT, class P>
cudaError_t halo_map(const P& p, int n, const HaloLayout& l, CUtensorMap& map) {
  using T = HaloTile<S, NT>;
  MapKey k{};
  k.ptr = p.x;
  k.swizzle = CU_TENSOR_MAP_SWIZZLE_NONE;
  if (STEM) {
    k.rank = 2;
    k.dims[0] = (cuuint64_t)p.w_in * 3;
    k.dims[1] = (cuuint64_t)n * p.h;
    k.strides[0] = (cuuint64_t)p.w_in * 3;  // TMA: a multiple of 16 (the callers ask W % 16 == 0)
    k.box[0] = T::STEM_ROW;
    k.box[1] = T::HH;
  } else {
    k.rank = 3;
    k.dims[0] = (cuuint64_t)p.ci;
    k.dims[1] = (cuuint64_t)p.w_in;
    k.dims[2] = (cuuint64_t)n * p.h;
    k.strides[0] = (cuuint64_t)p.ci;
    k.strides[1] = (cuuint64_t)p.w_in * p.ci;
    k.box[0] = (cuuint32_t)l.pitch;
    k.box[1] = T::HW;
    k.box[2] = T::HH;
  }
  return cached_map(k, map);
}

// One launch of a halo kernel: as many persistent blocks as the tiles, up
// to what the SMs hold at the layout's shared memory.
template <int S, bool POOL, bool STEM, int NT, bool ASYM, int PHASES, class P>
cudaError_t launch_halo(const P& p, int n, int dev, int sms, cudaStream_t stream) {
  using T = HaloTile<S, NT>;
  const auto kernel = halo_kernel<S, POOL, STEM, NT, ASYM, PHASES, P>;
  static bool smem_set[kMaxDevices] = {false};
  if (!smem_set[dev]) {
    const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kHaloMaxSmem);
    if (err != cudaSuccess) return err;
    smem_set[dev] = true;
  }
  const HaloLayout l = halo_layout<S, POOL, STEM, NT, PHASES>(p.ci, p.k_pad);
  if (l.smem > kHaloMaxSmem) return cudaErrorInvalidValue;
  int per_sm = 0;
  cudaError_t err = halo_blocks_per_sm(kernel, dev, l.smem, per_sm);
  if (err != cudaSuccess) return err;
  CUtensorMap map;
  err = halo_map<S, STEM, NT>(p, n, l, map);
  if (err != cudaSuccess) return err;
  const int tiles_x = (p.w_out + kHaloTW - 1) / kHaloTW, tiles_y = (p.h_out + T::TH - 1) / T::TH;
  const long long tiles = (long long)n * tiles_x * tiles_y;
  const long long grid = tiles < (long long)per_sm * sms ? tiles : (long long)per_sm * sms;
  kernel<<<(unsigned)grid, kHaloThreads, l.smem, stream>>>(p, map, tiles_x, tiles_y, (int)tiles);
  return cudaGetLastError();
}

}  // namespace yq

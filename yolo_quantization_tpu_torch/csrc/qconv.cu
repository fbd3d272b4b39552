// Fused int8 conv + requant epilogue (+ optional 2x2/s2 maxpool) for Hopper.
//
// Replaces yolo_quantization_tpu/ops/pallas_qconv.py::pallas_quantized_conv2d
// (kernel body _qconv_kernel), and covers what the reference engine left to
// XLA beside it.  Same function: a stride-1 or stride-2 KxK conv over
// shifted-int8 NHWC codes padded with the input zero point, int8 x int8 ->
// int32 accumulation, then the epilogue of common.cuh; darknet's output
// geometry, (H + 2 pad - K) / stride + 1.  With fuse_pool (stride 1 only) the
// 2x2/s2 max is taken on the int32 accumulators before the epilogue (exact:
// the epilogue is monotone nondecreasing in the corrected accumulator, since
// m > 0).  The Pallas kernel took stride 1 only; yolov3's five stride-2
// downsampling convs ran on XLA there.
//
// Options: asymmetric weights (ASYM: acc -= w_zp[o] * patchsum, the window
// sum of the codes, padding taps included; yolo_quantization_tpu/ops/
// qconv.py::conv_acc_int32), a per-image input zero point (an (N,) device
// tensor) for the padding, per-image (N, Co) bias and m read by pointer,
// exact_leaky, and the int16 carrier.
//
// The int8 carrier is an implicit GEMM on the int8 tensor cores, in three
// designs (below: halo for the bytes-bound 3x3 stem convs, wgmma for the
// operation-bound ones, mma.sync for the rest).  It replaced a __dp4a
// kernel that ran at about 2% of the card's int8 roofline.  The mma.sync
// design:
//   - GEMM view: M = output pixels, N = Co, K = k*k*Ci in HWIO flatten order
//     (tap-major, channel-minor), padded to 32.  B is the packed weights
//     (Co_pad, K_pad), K contiguous (ops/cuda_qconv.py::pack_weights).
//   - What bounds it on the H100: int8 operations on the 13x13 and 26x26
//     layers (Ci >= 256: K >= 1,152), bytes on the 416^2 / 208^2 stem layers
//     (K = 32 and 160) and on the narrow 1x1 heads.  The tensor cores take
//     the first kind; the second is served by reading each input byte from
//     device memory about once (the k*k window overlap hits L1/L2) and by
//     fusing the pool, which keeps the 4x larger pre-pool tensor out of
//     device memory on exactly those stem layers.
//   - Products: mma.sync m16n8k32 s8 (common.cuh::mma_s8), operands from
//     shared memory through ldmatrix.  Each shared row is 64 K-bytes plus 16
//     bytes of padding, which puts the 8 rows of an ldmatrix phase on 8
//     distinct 16-byte bank groups.
//   - Staging: a ring of up to 4 64-byte K slabs in dynamic shared memory
//     (above 48 KB, hence cudaFuncSetAttribute), filled with 16-byte
//     cp.async copies while the warps multiply an earlier slab.  A layer
//     with fewer slabs (the stem has one) gets fewer slots, so more blocks
//     fit on an SM.
//   - The A tile is an implicit im2col: each row is one output pixel, whose
//     window starts at input pixel (oy * stride - pad, ox * stride - pad).
//     Three loaders (template MODE):
//     kVec (Ci % 16 == 0): a 16-byte chunk of K is one tap's 16 channels,
//       copied straight from NHWC; through L1 (cp.async.ca) when Ci <= 32,
//       where the 3x3 windows of a block's rows overlap 9-fold (2.25-fold
//       at stride 2, where L1 was timed faster than .cg too).
//     kStem (the 3-channel 3x3 stem with its pool fused): each thread loads
//       one pooled window's 4x4x3 input patch once, 48 bytes instead of
//       4 x 27, and builds its four pixels' 27 codes in registers.
//     kByte (any other Ci): byte by byte through registers, a row per thread.
//     A code whose pixel lies outside the map is the input zero-point code
//     (per image), stored explicitly: cp.async's zero-fill writes 0, which
//     is wrong whenever zp != 0.  K padding holds code 0 in A and 0 in B.
//   - Block tile from (M, N): a fixed table (launch_tile) so that the 13x13
//     layers (M = 2,704 at batch 16) still give every SM of the card (132 on
//     an H100 SXM, read per device) a block; 128x128 for the large layers,
//     512x16 for the stem (a window a thread).
//   - fuse_pool: the rows are ordered so that in each 32-row group row 8q + w
//     is pixel q of pooled window w.  In the m16n8 accumulator layout a
//     thread holds rows g and g+8 of two m16 tiles, i.e. all four pixels of
//     window g, and takes the max in registers before the epilogue.
//   - ASYM: the patchsum is the row sum of the staged A tile: a thread's A
//     fragments are 16 of the 32 bytes of rows g and g+8 of each m16 tile,
//     summed with __dp4a(a, 0x01010101, .) and completed across the 4
//     threads of its quad by shuffles.  No product runs on __dp4a.
//   - Integer sums do not depend on their order (int32 wraps alike), so the
//     tile shapes and K order are free; bit-exactness rests on yq::requant.
//
// The three int8 designs share the GEMM view and the epilogue;
// launch_tile picks one per conv (halo_takes, then wgmma_route):
//
// wgmma (Ci % 64 == 0, K = 1 or 3, stride 1 or 2, symmetric or asymmetric,
// with or without the fused pool): the operation-bound convs (Ci >= 64 puts
// K at 64 to 11,520), which mma.sync ran at 9-14% of the int8 ops bound.
//   - Products: wgmma.mma_async m64nNk32 s32.s8.s8 (N = 32, 64, 128), the
//     only route to Hopper's full tensor-core rate.  Both operands come
//     from shared memory, K-major (8-bit wgmma has no transpose), in the
//     64- or 128-byte swizzle (hopper.cuh): a K slab is 64 or 128 channels
//     of one tap, which is why the design needs Ci % 64 == 0.
//   - Warp specialisation: one producer warpgroup keeps a ring of 3-8 slabs
//     in flight (a full and an empty mbarrier per slot); one or two
//     consumer warpgroups issue the wgmmas and hold the int32 sums in
//     registers.  A slot goes back to the producer only after the wgmma
//     group that read it has completed (wait_group 1: one group kept in
//     flight).
//   - B (the packed weights) arrives by TMA: a 2-D tensor map over
//     (Co_pad, K_pad) with (BN, BK) boxes in the slab's swizzle, encoded on
//     the host through the driver's cuTensorMapEncodeTiled and cached per
//     (pointer, shape, box).  Rows past Co_pad arrive as zeros, so
//     pack_weights' layout is unchanged.
//   - A (the implicit im2col) is gathered by the producer with 16-byte
//     cp.async copies straight into the swizzled layout, as the kVec loader
//     does: a row's slab is one pixel's contiguous channels; a pixel
//     outside the map gets the zero-point word (per image), stored by the
//     producer; stride 2 only moves the row origin to (oy s, ox s).  Each
//     producer thread fences its landed copies to the async proxy
//     (fence.proxy.async) before its warp arrives on the full barrier.
//     Taken over TMA's im2col mode, which was built and held bit-exact but
//     ran slower on the H100 in development (its code is not kept), and
//     which fills out-of-map taps with 0, not the zero point, so it needed
//     a per-tap weight-sum correction in the epilogue and another for
//     ASYM's patchsum.  Clusters of two blocks sharing B by TMA multicast
//     ran slower still.
//   - The fused pool: a consumer thread holds rows 16 w + g and 16 w + g + 8
//     of each m64 tile, so the pooled instantiations give a warpgroup two
//     m64 tiles and order rows as pixel (dy, dx) = (tile, half) of window
//     8 w + g (wrow_pixel); the thread maxes its four accumulators.
//   - ASYM: consumers hold no A fragments, so before the wgmmas each thread
//     sums 16-byte chunks of its rows in shared memory (__dp4a with ones),
//     and the quad's shuffles complete the row sums.
//   - Epilogue: the output tile is staged in shared memory and written with
//     16-byte row stores (byte stores where Co is not a multiple of 16).
//   - Block tile (launch_wgmma_tile), from timings on the H100: 64 x 128
//     with two blocks an SM, 128 x 64 or 64 x 64 where that grid would
//     leave SMs idle (the 13x13 layers), N 32 for narrow Co.
//   - What bounds it: the operands come from L2, and a 64 x 128 tile makes
//     43 MACs per byte it reads, far below the tensor cores' rate over
//     L2's; larger tiles left too few blocks in flight (PERF.md).  The 1x1
//     convs with a GEMM depth of at most 128, and the 255-channel heads
//     with one of at most 512, ran slower than on mma.sync and route there
//     (wgmma_route).
//   - No fallback: a failure of this design is returned, never retried on
//     mma.sync.
//
// halo (K = 3, pad 1, stride 1 or 2, with or without the fused pool; Ci 3,
// 16, 32 or 48; Co 16, 32 or 64; symmetric or asymmetric; the kernel is
// halo.cuh's, which K2 shares): the bytes-bound stem convs, where
// mma.sync's loaders read each input byte about 9 times (48 byte loads a
// thread in kStem, 32 in kByte, a cp.async per tap and row in kVec), stored
// a byte at a time and ran one K slab a block, loads, products and stores
// in turn.
//   - A persistent block walks tiles of TH x 32 output pixels of one image
//     (TH 16, 8 or 4 for Co 16, 32, 64: 64 accumulators a thread).
//     Each tile's input halo, ((TH - 1) S + 3) x ((TW - 1) S + 3) pixels,
//     arrives once by TMA into one of two shared buffers, each with an
//     mbarrier; the next tile's halo lands while this one multiplies and
//     stores.  The map folds N and H; Ci = 3 is a 2-D byte map (N H, W 3),
//     which needs W 3 % 16 == 0 (TMA's stride rule: every darknet width).
//   - TMA fills out-of-map cells with 0 (or the next image's rows), not the
//     zero point: after the barrier a border tile's threads write the
//     image's zero-point code there (x_zp_img per image), before any read.
//     So no weight-sum correction is needed, and ASYM's patchsum (the row
//     sum of the A bytes) stays right.
//   - A is read in place: for Ci >= 16 each ldmatrix row address is the
//     (pixel, tap) chunk of the halo (the implicit im2col with no copy).  A
//     halo pixel takes an odd number of 16-byte chunks (TMA's box is wider
//     than Ci, the rest zero-filled) and the pooled rows interleave two
//     window rows, so an ldmatrix phase's 8 rows fall on 8 bank groups at
//     stride 1 (2-way at stride 2, 4-way with the plain pitch).  For Ci = 3
//     each lane builds its row's 27 codes from three word-aligned runs of
//     the halo (funnel shifts and byte permutes) into its warp's A tile.
//   - Products: mma.sync m16n8k32 over the weights, loaded once per block;
//     a warp takes 8 TH rows by all of Co.  The fused pool and ASYM as in
//     the mma.sync design.
//   - Epilogue: codes staged in shared memory, written as 16-byte rows.
//
// mma.sync (every other int8 conv: Ci % 64 != 0 off the halo rule, the 1x1
// convs sent back from wgmma) is described above; it stays the forced
// comparison on the halo design's convs.
//
// The int16 carrier (carrier="int16", the reference's s16 x s16 -> s32 MKL
// cross-check) keeps a scalar kernel: Hopper has no s16 tensor-core mma, and
// its point is arithmetic different from the int8 path.  Codes are staged as
// int16 pairs and multiplied with plain int32 multiply-adds.

#include <cuda.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "common.cuh"
#include "halo.cuh"
#include "hopper.cuh"

namespace {

using yq::Epilogue;

constexpr int kMaxK = 3;
constexpr int kBK = 64;              // K bytes per stage: two m16n8k32 steps
constexpr int kRowBytes = kBK + 16;  // shared row stride; +16 spreads ldmatrix rows over banks
constexpr int kStages = 4;
constexpr int kFar = INT_MIN / 4;    // a row past the end: every tap lies outside the map
constexpr int kVec = 0, kStem = 1, kByte = 2;  // A loaders

struct Params {
  const int8_t* x;          // (N, H, W, Ci) shifted int8 codes
  const int8_t* w;          // (Co_pad, K_pad) packed int8 weights, K = (ky, kx, ci)
  const int32_t* w_zp;      // (Co,) shifted weight zero points (ASYM only)
  const int32_t* x_zp_img;  // (N,) per-image input zero point, or null
  Epilogue e;
  uint8_t* out;             // (N, Ho, Wo, Co), or pooled (N, Ho/2, Wo/2, Co)
  int h, w_in, ci, co, k, pad, stride;
  int h_out, w_out;         // (h + 2 pad - k) / stride + 1, and the same along W
  int k_real, k_pad, co_pad;  // GEMM depth k*k*Ci, padded to 32; Co padded to 16
  int x_zp, pool;
  int outs;                 // output pixels: N*Ho*Wo, or pooled windows
  int rows;                 // GEMM rows: outs, or 32 per 8 windows with pool
  int tiles_x;              // int16 kernel: spatial tiles along W
};

// The output pixel of GEMM row r; false past the end.  With pool, row 8q + w
// of each 32-row group is pixel q (dy = q / 2, dx = q % 2) of window w.
__device__ __forceinline__ bool row_pixel(const Params& p, int r, int& img, int& oy, int& ox) {
  if (p.pool) {
    const int win = (r >> 5) * 8 + (r & 7), q = (r >> 3) & 3;
    const int pw = p.w_out >> 1, phw = (p.h_out >> 1) * pw;
    if (win >= p.outs) return false;
    img = win / phw;
    const int rem = win - img * phw, py = rem / pw;
    oy = 2 * py + (q >> 1);
    ox = 2 * (rem - py * pw) + (q & 1);
    return true;
  }
  if (r >= p.outs) return false;
  const int hw = p.h_out * p.w_out;
  img = r / hw;
  const int rem = r - img * hw;
  oy = rem / p.w_out;
  ox = rem - oy * p.w_out;
  return true;
}

// The ring slots a layer uses: one per K slab, at most kStages.
__host__ __device__ __forceinline__ int ring_slots(int k_pad) {
  const int slabs = (k_pad + kBK - 1) / kBK;
  return slabs < kStages ? slabs : kStages;
}

// BM x BN block tile, WM x WN warps, each warp a (BM/WM) x (BN/WN) tile of
// m16n8 accumulators; MODE the A loader.  The symmetric stem is held to 128
// registers (4 blocks an SM); the asymmetric one would spill there.
template <int BM, int BN, int WM, int WN, bool ASYM, int MODE>
__global__ void __launch_bounds__(WM * WN * 32, MODE == kStem && !ASYM ? 4 : 1)
    qconv_mma_kernel(const Params p) {
  constexpr int kThreads = WM * WN * 32;
  constexpr int TM = BM / WM, TN = BN / WN;
  constexpr int MI = TM / 16, NI = TN / 8;
  constexpr bool VEC = MODE == kVec;
  constexpr int A_ROWS = VEC ? kThreads / 4 : kThreads;  // rows one pass of the A loader covers
  constexpr int A_ITERS = MODE == kStem ? 1 : BM / A_ROWS;
  static_assert(TM % 32 == 0 && NI % 2 == 0 && BM % A_ROWS == 0, "unsupported tile");
  static_assert(MODE != kByte || A_ITERS == 1, "the byte gather takes one row per thread");
  static_assert(MODE != kStem || BM == 4 * kThreads, "the stem loader takes one window per thread");

  const int nk = (p.k_pad + kBK - 1) / kBK;
  extern __shared__ __align__(128) uint8_t smem[];
  uint8_t* const a_smem = smem;                                      // [slots][BM][kRowBytes]
  uint8_t* const b_smem = smem + ring_slots(p.k_pad) * BM * kRowBytes;  // [slots][BN][kRowBytes]

  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int wm0 = (warp / WN) * TM, wn0 = (warp % WN) * TN;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;

  // The A loader's rows: kVec, thread t fills 16-byte column a_col of rows
  // t/4 + i*A_ROWS (4 threads read a pixel's 64 contiguous bytes); kByte,
  // thread t fills row t; kStem finds its own (load_stage).
  const int a_col = t & 3;
  const int8_t* a_src[A_ITERS];  // the row's window origin in x: pixel (oy * stride, ox * stride)
  int a_iy[A_ITERS], a_ix[A_ITERS];  // that pixel's coordinates (kFar past the end)
  uint32_t a_zp[A_ITERS];        // the row's image's zero-point code, 4 lanes
#pragma unroll
  for (int i = 0; i < A_ITERS && MODE != kStem; ++i) {
    int img = 0, oy = 0, ox = 0;
    const bool valid = row_pixel(p, m0 + (VEC ? t / 4 : t) + i * A_ROWS, img, oy, ox);
    const int zp = p.x_zp_img ? p.x_zp_img[img] : p.x_zp;
    a_zp[i] = (uint32_t)(uint8_t)(int8_t)zp * 0x01010101u;
    a_src[i] = p.x + ((size_t)(img * p.h + oy * p.stride) * p.w_in + ox * p.stride) * p.ci;
    a_iy[i] = valid ? oy * p.stride : kFar;
    a_ix[i] = ox * p.stride;
  }

  // Stage the K slab [k0, k0 + 64) (or the last 32) into ring slot `slot`.
  auto load_stage = [&](int slot, int k0) {
    uint8_t* as = a_smem + slot * BM * kRowBytes;
    uint8_t* bs = b_smem + slot * BN * kRowBytes;
    const int kc = min(kBK, p.k_pad - k0);
    for (int idx = t; idx < BN * 4; idx += kThreads) {
      const int nr = idx >> 2, c = idx & 3;
      if (c * 16 >= kc) continue;
      const int n = n0 + nr;
      const bool ok = n < p.co_pad;
      yq::cp_async16(yq::smem_addr(bs + nr * kRowBytes + c * 16),
                     ok ? p.w + (size_t)n * p.k_pad + k0 + c * 16 : p.w, ok ? 16 : 0);
    }
    if constexpr (MODE == kStem) {  // k0 == 0 and K = 27: one slab, one k32 step
      // thread t: pooled window t of the block, i.e. rows 8q + (t % 8) of
      // 32-row group t / 8; patch rows 2py-1 .. 2py+2, columns 2px-1 .. 2px+2
      const int win = (m0 >> 2) + t;
      const int pw = p.w_out >> 1, phw = (p.h_out >> 1) * pw;
      const bool valid = win < p.outs;
      const int img = valid ? win / phw : 0, rem = win - img * phw;
      const int py = rem / pw, px = rem - py * pw;
      const uint32_t zp = (uint8_t)(p.x_zp_img ? p.x_zp_img[img] : p.x_zp);
      uint32_t patch[4][12];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int iy = 2 * py - 1 + r;
        const bool row_in = valid && (unsigned)iy < (unsigned)p.h;
        const int8_t* rp = p.x + ((size_t)(img * p.h + iy) * p.w_in + 2 * px - 1) * 3;
#pragma unroll
        for (int j = 0; j < 12; ++j) {  // every load issued, so all 48 are in flight together
          const bool take = row_in && (unsigned)(2 * px - 1 + j / 3) < (unsigned)p.w_in;
          const uint32_t code = (uint8_t)__ldg(take ? rp + j : p.x);
          patch[r][j] = take ? code : zp;
        }
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {  // pixel (dy, dx) = (q / 2, q % 2); K index j = tap * 3 + c
        uint32_t v[8];
#pragma unroll
        for (int wd = 0; wd < 8; ++wd) {
          v[wd] = 0;
#pragma unroll
          for (int b = 0; b < 4; ++b) {
            const int j = 4 * wd + b;
            if (j < 27) v[wd] |= patch[q / 2 + j / 9][(q % 2 + j / 3 % 3) * 3 + j % 3] << (8 * b);
          }
        }
        uint8_t* dst = as + ((t >> 3) * 32 + 8 * q + (t & 7)) * kRowBytes;
        *reinterpret_cast<uint4*>(dst) = make_uint4(v[0], v[1], v[2], v[3]);
        *reinterpret_cast<uint4*>(dst + 16) = make_uint4(v[4], v[5], v[6], v[7]);
      }
      return;
    }
    if constexpr (MODE == kByte) {  // 32 K-bytes at a time: k walks (tap, channel) across taps
#pragma unroll
      for (int half = 0; half < kBK / 32; ++half) {
        if (half * 32 >= kc) break;
        const int kb = k0 + half * 32;
        int tap = kb / p.ci, c = kb - tap * p.ci;
        int dy = tap / p.k, dx = tap - dy * p.k;
        uint32_t v[8];
#pragma unroll
        for (int b = 0; b < 32; ++b) {
          // every load is issued (from x itself where the code is not read),
          // so all 32 are in flight together; the select comes after
          const int iy = a_iy[0] + dy - p.pad, ix = a_ix[0] + dx - p.pad;
          const bool real = kb + b < p.k_real;  // past it: K padding, code 0
          const bool take = real && (unsigned)iy < (unsigned)p.h && (unsigned)ix < (unsigned)p.w_in;
          const int off = ((dy - p.pad) * p.w_in + dx - p.pad) * p.ci + c;
          const uint32_t code = (uint8_t)__ldg(take ? a_src[0] + off : p.x);
          const uint32_t byte = take ? code : real ? (a_zp[0] & 0xffu) : 0u;
          v[b / 4] = (b % 4 ? v[b / 4] : 0u) | byte << (8 * (b % 4));
          c = c + 1 == p.ci ? 0 : c + 1;
          dx = c ? dx : dx + 1 == p.k ? 0 : dx + 1;
          dy = c || dx ? dy : dy + 1;
        }
        uint8_t* dst = as + t * kRowBytes + half * 32;
        *reinterpret_cast<uint4*>(dst) = make_uint4(v[0], v[1], v[2], v[3]);
        *reinterpret_cast<uint4*>(dst + 16) = make_uint4(v[4], v[5], v[6], v[7]);
      }
      return;
    }
    if (a_col * 16 >= kc) return;
    const int kk = k0 + a_col * 16;
    uint8_t* const arow = as + (t / 4) * kRowBytes + a_col * 16;
    if (kk >= p.k_real) {  // K padding: code 0 (B is 0 there too)
#pragma unroll
      for (int i = 0; i < A_ITERS; ++i) {
        *reinterpret_cast<uint4*>(arow + i * A_ROWS * kRowBytes) = make_uint4(0, 0, 0, 0);
      }
      return;
    }
    // one tap, 16 channels: a 16-byte copy per row
    const int tap = kk / p.ci, c = kk - tap * p.ci;
    const int dy = tap / p.k, dx = tap - dy * p.k;
    const int off = ((dy - p.pad) * p.w_in + dx - p.pad) * p.ci + c;
#pragma unroll
    for (int i = 0; i < A_ITERS; ++i) {
      uint8_t* dst = arow + i * A_ROWS * kRowBytes;
      const int iy = a_iy[i] + dy - p.pad, ix = a_ix[i] + dx - p.pad;
      if ((unsigned)iy < (unsigned)p.h && (unsigned)ix < (unsigned)p.w_in) {
        if (p.ci <= 32) {
          yq::cp_async16_l1(yq::smem_addr(dst), a_src[i] + off);
        } else {
          yq::cp_async16(yq::smem_addr(dst), a_src[i] + off, 16);
        }
      } else {
        *reinterpret_cast<uint4*>(dst) = make_uint4(a_zp[i], a_zp[i], a_zp[i], a_zp[i]);
      }
    }
  };

  int acc[MI][NI][4];
  int ps[MI][2];  // patchsum of rows g, g+8 of each m16 tile (ASYM)
#pragma unroll
  for (int mi = 0; mi < MI; ++mi) {
    ps[mi][0] = ps[mi][1] = 0;
#pragma unroll
    for (int ni = 0; ni < NI; ++ni) acc[mi][ni][0] = acc[mi][ni][1] = acc[mi][ni][2] = acc[mi][ni][3] = 0;
  }

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) load_stage(s, s * kBK);
    yq::cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    yq::cp_async_wait<kStages - 2>();
    __syncthreads();  // slab kt is in; every warp is done with slab kt - 1
    const int nxt = kt + kStages - 1;  // past nk whenever the ring has fewer slots
    if (nxt < nk) load_stage(nxt % kStages, nxt * kBK);
    yq::cp_async_commit();

    const uint8_t* as = a_smem + (kt % kStages) * BM * kRowBytes;
    const uint8_t* bs = b_smem + (kt % kStages) * BN * kRowBytes;
    const int ksteps = p.k_pad - kt * kBK >= kBK ? 2 : 1;
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      if (ks < ksteps) {
        uint32_t af[MI][4], bf[NI][2];
#pragma unroll
        for (int mi = 0; mi < MI; ++mi) {
          yq::ldmatrix_x4(af[mi], yq::smem_addr(as + (wm0 + mi * 16 + (lane & 15)) * kRowBytes +
                                                ks * 32 + (lane >> 4) * 16));
        }
#pragma unroll
        for (int nj = 0; nj < NI / 2; ++nj) {
          uint32_t r[4];
          yq::ldmatrix_x4(r, yq::smem_addr(bs + (wn0 + nj * 16 + (lane & 7) + ((lane >> 4) << 3)) *
                                                    kRowBytes +
                                           ks * 32 + ((lane >> 3) & 1) * 16));
          bf[2 * nj][0] = r[0];
          bf[2 * nj][1] = r[1];
          bf[2 * nj + 1][0] = r[2];
          bf[2 * nj + 1][1] = r[3];
        }
#pragma unroll
        for (int mi = 0; mi < MI; ++mi) {
#pragma unroll
          for (int ni = 0; ni < NI; ++ni) yq::mma_s8(acc[mi][ni], af[mi], bf[ni][0], bf[ni][1]);
        }
        if (ASYM) {
#pragma unroll
          for (int mi = 0; mi < MI; ++mi) {
            ps[mi][0] = __dp4a((int)af[mi][0], 0x01010101, __dp4a((int)af[mi][2], 0x01010101, ps[mi][0]));
            ps[mi][1] = __dp4a((int)af[mi][1], 0x01010101, __dp4a((int)af[mi][3], 0x01010101, ps[mi][1]));
          }
        }
      }
    }
  }
  yq::cp_async_wait<0>();

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

  const int g = lane >> 2, tq = lane & 3;
  const yq::Clamp cl = yq::clamp_of(p.e);
  // acc - w_zp[o] * patchsum in wrapping int32, as XLA's
  auto correct = [&](int a, int o, int patchsum) {
    return ASYM ? (int)((unsigned)a - (unsigned)p.w_zp[o] * (unsigned)patchsum) : a;
  };
  if (p.pool) {
    const int phw = (p.h_out >> 1) * (p.w_out >> 1);
#pragma unroll
    for (int jg = 0; jg < MI / 2; ++jg) {
      const int win = ((m0 + wm0) >> 2) + jg * 8 + g;
      if (win >= p.outs) continue;
      const size_t bm = (size_t)(win / phw) * p.e.bm_stride;
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int o = n0 + wn0 + ni * 8 + 2 * tq + j;
          if (o >= p.co) continue;
          const int q0 = correct(acc[2 * jg][ni][j], o, ps[2 * jg][0]);
          const int q1 = correct(acc[2 * jg][ni][2 + j], o, ps[2 * jg][1]);
          const int q2 = correct(acc[2 * jg + 1][ni][j], o, ps[2 * jg + 1][0]);
          const int q3 = correct(acc[2 * jg + 1][ni][2 + j], o, ps[2 * jg + 1][1]);
          const int a = max(max(q0, q1), max(q2, q3));
          p.out[(size_t)win * p.co + o] = (uint8_t)yq::requant(a, p.e.bias[bm + o], p.e.m[bm + o], p.e, cl);
        }
      }
    }
  } else {
    const int hw = p.h_out * p.w_out;
#pragma unroll
    for (int mi = 0; mi < MI; ++mi) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = m0 + wm0 + mi * 16 + g + 8 * hh;
        if (r >= p.outs) continue;
        const size_t bm = (size_t)(r / hw) * p.e.bm_stride;
#pragma unroll
        for (int ni = 0; ni < NI; ++ni) {
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int o = n0 + wn0 + ni * 8 + 2 * tq + j;
            if (o >= p.co) continue;
            const int a = correct(acc[mi][ni][2 * hh + j], o, ps[mi][hh]);
            p.out[(size_t)r * p.co + o] = (uint8_t)yq::requant(a, p.e.bias[bm + o], p.e.m[bm + o], p.e, cl);
          }
        }
      }
    }
  }
}

template <int BM, int BN, int WM, int WN, bool ASYM, int MODE = kVec>
cudaError_t launch_mma(const Params& p, int dev, cudaStream_t stream) {
  constexpr int kMaxSmem = kStages * (BM + BN) * kRowBytes;
  const auto kernel = qconv_mma_kernel<BM, BN, WM, WN, ASYM, MODE>;
  // the attribute holds for the current device only; a benign race: every
  // caller sets the same value
  static bool smem_set[yq::kMaxDevices] = {false};
  if (!smem_set[dev]) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err != cudaSuccess) return err;
    smem_set[dev] = true;
  }
  const dim3 grid((p.rows + BM - 1) / BM, (p.co + BN - 1) / BN);
  kernel<<<grid, WM * WN * 32, ring_slots(p.k_pad) * (BM + BN) * kRowBytes, stream>>>(p);
  return cudaGetLastError();
}

// ---- the wgmma design: the operation-bound int8 convs (Ci % 64 == 0) ----

constexpr int kRouteMma = 1, kRouteWgmma = 2, kRouteInt16 = 3;  // reported to the caller
constexpr int kProducerThreads = 128;  // one producer warpgroup

// The shared layout of a K slab of BK bytes a row (one tap's BK channels):
// rows of BK bytes, the 16-byte chunk c of row r at chunk c ^ swizzle(r)
// (hopper.cuh: the 64-byte swizzle for BK 64, the 128-byte one for 128).
template <int BK>
struct Slab {
  static_assert(BK == 64 || BK == 128, "K slabs of 64 or 128 bytes");
  static constexpr int CHUNKS = BK / 16;
  __host__ __device__ static constexpr int swizzle(int r) { return BK == 128 ? r & 7 : (r >> 1) & 3; }
  __device__ static uint64_t desc(uint32_t addr) {
    return BK == 128 ? yq::desc_sw128(addr) : yq::desc_sw64(addr);
  }
};

// The tile of a wgmma instantiation: WGS consumer warpgroups, each MT m64
// tiles of BN columns (MT = 2 with the fused pool: the four pixels of a
// window sit in one thread's rows), K slabs of BK bytes, and the ring's
// depth.
template <int WGS, int MT, int BN, int BK>
struct WTile {
  static constexpr int BM = 64 * MT * WGS;
  static constexpr int A_BYTES = BM * BK, B_BYTES = BN * BK;
  // the ring: up to 200 KB where registers leave one block an SM (256
  // accumulator columns a block), else 112 KB, so two fit; 3 to 8 slabs
  static constexpr int BUDGET = (WGS * MT * BN >= 256 ? 200 : 112) * 1024;
  static constexpr int FIT = BUDGET / (A_BYTES + B_BYTES);
  static constexpr int STAGES = FIT < 8 ? FIT : 8;
  // A slabs a producer thread keeps in flight before it waits for the
  // oldest: at most STAGES - 2, or it would wait for a slot whose release
  // needs its own arrival
  static constexpr int LAG = STAGES - 2;
  // 1 KB of alignment slack, the ring, and a full and an empty barrier a stage
  static constexpr int SMEM = 1024 + STAGES * (A_BYTES + B_BYTES) + 16 * STAGES;
  static_assert(STAGES >= 3, "ring");
  static_assert(BN == 32 || BN == 64 || BN == 128, "wgmma_s8 is instantiated for N 32, 64, 128");
  static_assert(MT * BN / 2 <= 128, "accumulator registers");
};

// The output pixel of GEMM row r under the wgmma design; false past the end.
// With pool, row 64 mt + 16 w + 8 h + g of each 128-row group is pixel
// (dy, dx) = (mt, h) of window 32 * group + 8 w + g, so a consumer thread,
// which holds rows 16 w + g and 16 w + g + 8 of both m64 tiles, holds the
// window's four pixels.
__device__ __forceinline__ bool wrow_pixel(const Params& p, int r, int& img, int& oy, int& ox) {
  if (p.pool) {
    const int rr = r & 127;
    const int win = (r >> 7) * 32 + ((rr >> 4) & 3) * 8 + (rr & 7);
    if (win >= p.outs) return false;
    const int pw = p.w_out >> 1, phw = (p.h_out >> 1) * pw;
    img = win / phw;
    const int rem = win - img * phw, py = rem / pw;
    oy = 2 * py + (rr >> 6);
    ox = 2 * (rem - py * pw) + ((rr >> 3) & 1);
    return true;
  }
  return row_pixel(p, r, img, oy, ox);
}

// Warp-specialised implicit GEMM on wgmma.  Warpgroups 0 .. WGS-1 consume,
// warpgroup WGS produces.  Per K slab kt (BK channels of one tap), ring
// slot kt % S:
//   producer: waits until the consumers have released the slot; thread 0
//     asks TMA for B's (BN x BK) tile; every thread copies one 16-byte
//     chunk of BM / (128 / CHUNKS) rows of A with cp.async (the zero-point
//     word for a pixel outside the map) at its swizzled place; LAG slabs
//     later it waits for those copies, fences them to the async proxy, and
//     its warp arrives on the slot's full barrier.
//   consumers: wait on the full barrier, issue MT * BK / 32 wgmma
//     m64nBNk32 from the slot's descriptors, commit, wait until one group
//     is pending, and release the previous slot on its empty barrier (a
//     warp's lane 0, once the warp's wgmmas are done).  ASYM: each thread
//     first sums CHUNKS / 4 16-byte chunks of each of its rows (the quad's
//     four threads cover a row), completed by shuffles at the end.
template <int WGS, int MT, int BN, int BK, bool ASYM>
__global__ void __launch_bounds__((WGS + 1) * 128, 1)
    qconv_wgmma_kernel(const __grid_constant__ Params p, const __grid_constant__ CUtensorMap w_map) {
  using T = WTile<WGS, MT, BN, BK>;
  using L = Slab<BK>;
  constexpr int BM = T::BM, S = T::STAGES, LAG = T::LAG;
  extern __shared__ __align__(16) uint8_t wsmem[];
  const uint32_t raw = yq::smem_addr(wsmem);
  const uint32_t a_ring = (raw + 1023) & ~1023u;  // swizzled stages start on the pattern's 1 KB
  const uint32_t b_ring = a_ring + S * T::A_BYTES;
  const uint32_t bars = b_ring + S * T::B_BYTES;  // full[S], then empty[S]
  const int t = threadIdx.x;
  if (t == 0) {
    for (int s = 0; s < S; ++s) {
      yq::mbar_init(bars + 8 * s, kProducerThreads / 32 + 1);  // a producer warp's lane 0 each, + TMA
      yq::mbar_init(bars + 8 * (S + s), WGS * 4);              // a consumer warp's lane 0 each
    }
    yq::mbar_init_fence();
  }
  __syncthreads();

  const int nk = p.k_pad / BK;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;

  if (t >= WGS * 128) {  // ---- producer warpgroup ----
    constexpr int RPP = kProducerThreads / L::CHUNKS;  // rows one pass covers
    constexpr int ROWS = BM / RPP;  // rows a thread fills: pt / CHUNKS + RPP i, chunk pt % CHUNKS
    const int pt = t - WGS * 128;
    const int chunk = pt % L::CHUNKS, r0 = pt / L::CHUNKS;
    const uint32_t dst0 = r0 * BK + ((chunk ^ L::swizzle(r0)) << 4);  // RPP keeps the swizzle
    int a_img[ROWS], a_iy[ROWS], a_ix[ROWS];
    uint32_t a_zp[ROWS];
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      int img = 0, oy = 0, ox = 0;
      const bool valid = wrow_pixel(p, m0 + r0 + RPP * i, img, oy, ox);
      const int zp = p.x_zp_img ? p.x_zp_img[img] : p.x_zp;
      a_zp[i] = (uint32_t)(uint8_t)(int8_t)zp * 0x01010101u;
      a_img[i] = img * p.h;
      a_iy[i] = valid ? oy * p.stride - p.pad : kFar;
      a_ix[i] = ox * p.stride - p.pad;
    }
    int dy = 0, dx = 0, c0 = 0;  // slab kt: tap (dy, dx), channels c0 .. c0 + BK - 1
    for (int kt = 0; kt < nk; ++kt) {
      const int slot = kt % S;
      if (kt >= S) yq::mbar_wait(bars + 8 * (S + slot), ((kt / S) - 1) & 1);
      if (pt == 0) {
        yq::mbar_arrive_expect_tx(bars + 8 * slot, T::B_BYTES);
        yq::tma_load_2d(b_ring + slot * T::B_BYTES, &w_map, (dy * p.k + dx) * p.ci + c0, n0, bars + 8 * slot);
      }
      const uint32_t as = a_ring + slot * T::A_BYTES + dst0;
#pragma unroll
      for (int i = 0; i < ROWS; ++i) {
        const int iy = a_iy[i] + dy, ix = a_ix[i] + dx;
        if ((unsigned)iy < (unsigned)p.h && (unsigned)ix < (unsigned)p.w_in) {
          yq::cp_async16(as + i * RPP * BK,
                         p.x + ((size_t)(a_img[i] + iy) * p.w_in + ix) * p.ci + c0 + chunk * 16, 16);
        } else {
          yq::st_shared_v4(as + i * RPP * BK, a_zp[i]);
        }
      }
      yq::cp_async_commit();
      if (kt >= LAG) {  // the thread's copies of slab kt - LAG have landed: one arrival for the warp
        yq::cp_async_wait<LAG>();
        yq::fence_proxy_async();
        __syncwarp();
        if ((pt & 31) == 0) yq::mbar_arrive(bars + 8 * ((kt - LAG) % S));
      }
      c0 += BK;
      if (c0 == p.ci) {
        c0 = 0;
        if (++dx == p.k) {
          dx = 0;
          ++dy;
        }
      }
    }
    yq::cp_async_wait<0>();
    yq::fence_proxy_async();
    __syncwarp();
    if ((pt & 31) == 0) {
      for (int kt = nk > LAG ? nk - LAG : 0; kt < nk; ++kt) yq::mbar_arrive(bars + 8 * (kt % S));
    }
  } else {  // ---- consumer warpgroups ----
    const int wg = t >> 7, warp = (t >> 5) & 3, lane = t & 31;
    const int g = lane >> 2, tq = lane & 3;
    const int row0 = wg * MT * 64;  // the warpgroup's first row in the block tile
    int acc[MT][BN / 2];
    int ps[MT][2];  // patchsum of rows 16 w + g and 16 w + g + 8 of each m64 tile (ASYM)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      ps[mt][0] = ps[mt][1] = 0;
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) {
        acc[mt][i] = 0;
        yq::fence_operand(acc[mt][i]);
      }
    }
    for (int kt = 0; kt < nk; ++kt) {
      const int slot = kt % S;
      yq::mbar_wait(bars + 8 * slot, (kt / S) & 1);
      const uint32_t as = a_ring + slot * T::A_BYTES + row0 * BK;
      const uint32_t bs = b_ring + slot * T::B_BYTES;
      if (ASYM) {  // physical chunks tq, tq + 4 of each row: the quad covers the row, in any order
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
#pragma unroll
            for (int c = tq; c < L::CHUNKS; c += 4) {
              const uint4 v = yq::ld_shared_v4(as + (mt * 64 + 16 * warp + 8 * hh + g) * BK + c * 16);
              ps[mt][hh] = __dp4a((int)v.x, 0x01010101, __dp4a((int)v.y, 0x01010101, ps[mt][hh]));
              ps[mt][hh] = __dp4a((int)v.z, 0x01010101, __dp4a((int)v.w, 0x01010101, ps[mt][hh]));
            }
          }
        }
      }
      yq::wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < BK / 32; ++ks) {
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          yq::wgmma_s8<BN>(acc[mt], L::desc(as + mt * 64 * BK + ks * 32), L::desc(bs + ks * 32));
        }
      }
      yq::wgmma_commit();
      yq::wgmma_wait<1>();  // the warp's wgmmas of slab kt - 1 are done: its lane 0 releases the slot
      if (kt > 0 && lane == 0) yq::mbar_arrive(bars + 8 * (S + (kt - 1) % S));
    }
    yq::wgmma_wait<0>();
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) yq::fence_operand(acc[mt][i]);
    }
    if (ASYM) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          ps[mt][hh] += __shfl_xor_sync(0xffffffffu, ps[mt][hh], 1);
          ps[mt][hh] += __shfl_xor_sync(0xffffffffu, ps[mt][hh], 2);
        }
      }
    }
    // The epilogue stages the tile's output codes in shared memory (the
    // A ring: every consumer warpgroup is past its last wgmma, every copy
    // into it has landed), then writes whole rows with 16-byte stores: a
    // thread's accumulators are two bytes of each of 8 rows, which stored
    // directly would cost a partial write each.
    yq::named_barrier_sync(1, WGS * 128);
    constexpr int SST = BN + 16;  // staged row stride: a warp's 8 rows on distinct banks, 16-byte rows
    static_assert(BM * SST <= S * T::A_BYTES, "the staged tile fits the A ring");
    uint8_t* const stage = wsmem + (a_ring - raw);
    const yq::Clamp cl = yq::clamp_of(p.e);
    auto code = [&](int a, int o, int patchsum, size_t bm) {
      if (ASYM) a = (int)((unsigned)a - (unsigned)__ldg(p.w_zp + o) * (unsigned)patchsum);
      return (uint8_t)yq::requant(a, __ldg(p.e.bias + bm + o), __ldg(p.e.m + bm + o), p.e, cl);
    };
    if constexpr (MT == 2) {  // the fused pool (the only use of two m64 tiles a warpgroup)
      const int wl = wg * 32 + 8 * warp + g;  // the window within the tile
      const int win = (m0 >> 2) + wl;
      if (win < p.outs) {
        const int phw = (p.h_out >> 1) * (p.w_out >> 1);
        const size_t bm = (size_t)(win / phw) * p.e.bm_stride;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int o = n0 + 8 * j + 2 * tq + e;
            if (o >= p.co) continue;
            int a = INT_MIN;  // the max over the window's pixels (dy, dx) = (q / 2, q % 2)
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              const int v = acc[q >> 1][4 * j + 2 * (q & 1) + e];
              a = max(a, ASYM ? (int)((unsigned)v - (unsigned)__ldg(p.w_zp + o) * (unsigned)ps[q >> 1][q & 1])
                              : v);
            }
            stage[wl * SST + 8 * j + 2 * tq + e] =
                (uint8_t)yq::requant(a, __ldg(p.e.bias + bm + o), __ldg(p.e.m + bm + o), p.e, cl);
          }
        }
      }
    } else {
      const int hw = p.h_out * p.w_out;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int rl = row0 + 16 * warp + 8 * hh + g;
        const int r = m0 + rl;
        if (r >= p.outs) continue;
        const size_t bm = (size_t)(r / hw) * p.e.bm_stride;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int o = n0 + 8 * j + 2 * tq + e;
            if (o < p.co) stage[rl * SST + 8 * j + 2 * tq + e] = code(acc[0][4 * j + 2 * hh + e], o, ps[0][hh], bm);
          }
        }
      }
    }
    yq::named_barrier_sync(1, WGS * 128);
    // the tile's rows (windows with the pool), BN codes each, to out
    constexpr int TROWS = MT == 2 ? WGS * 32 : BM;
    const int first = MT == 2 ? m0 >> 2 : m0;
    if (n0 + BN <= p.co && p.co % 16 == 0) {
      for (int idx = t; idx < TROWS * (BN / 16); idx += WGS * 128) {
        const int rl = idx / (BN / 16), c = idx % (BN / 16);
        if (first + rl >= p.outs) break;  // rows in order: the rest lie past the end too
        *reinterpret_cast<uint4*>(p.out + (size_t)(first + rl) * p.co + n0 + 16 * c) =
            *reinterpret_cast<const uint4*>(stage + rl * SST + 16 * c);
      }
    } else {
      const int cols = min(BN, p.co - n0);
      for (int idx = t; idx < TROWS * BN; idx += WGS * 128) {
        const int rl = idx / BN, c = idx % BN;
        if (first + rl >= p.outs) break;
        if (c < cols) p.out[(size_t)(first + rl) * p.co + n0 + c] = stage[rl * SST + c];
      }
    }
  }
}

// The TMA map of the packed weights (Co_pad rows of K_pad bytes) in boxes
// of (bn rows, bk bytes) under the bk-byte swizzle.
cudaError_t weight_map(const Params& p, int bn, int bk, CUtensorMap& map) {
  yq::MapKey k{};
  k.ptr = p.w;
  k.rank = 2;
  k.dims[0] = (cuuint64_t)p.k_pad;
  k.dims[1] = (cuuint64_t)p.co_pad;
  k.strides[0] = (cuuint64_t)p.k_pad;
  k.box[0] = (cuuint32_t)bk;
  k.box[1] = (cuuint32_t)bn;
  k.swizzle = bk == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B;
  return yq::cached_map(k, map);
}

template <int WGS, int MT, int BN, int BK, bool ASYM>
cudaError_t launch_wgmma(const Params& p, int dev, cudaStream_t stream) {
  using T = WTile<WGS, MT, BN, BK>;
  const auto kernel = qconv_wgmma_kernel<WGS, MT, BN, BK, ASYM>;
  static bool smem_set[yq::kMaxDevices] = {false};
  if (!smem_set[dev]) {
    const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
    if (err != cudaSuccess) return err;
    smem_set[dev] = true;
  }
  CUtensorMap map;
  const cudaError_t err = weight_map(p, BN, BK, map);
  if (err != cudaSuccess) return err;
  const long long rows = p.pool ? 4LL * p.outs : p.outs;
  const dim3 grid((unsigned)((rows + T::BM - 1) / T::BM), (p.co + BN - 1) / BN);
  kernel<<<grid, (WGS + 1) * 128, T::SMEM, stream>>>(p, map);
  return cudaGetLastError();
}

// The convs the wgmma design takes: the int8 carrier (the caller's), Ci a
// multiple of 64 (a slab is one tap's 64 or 128 channels), K = 1 or 3 --
// but not the 1x1 convs it ran slower than mma.sync on the H100 (PERF.md):
// a GEMM depth of at most 128 (yolov3's 1x1 convs at 208^2 and 104^2), and
// a Co past 128 off the 16-byte store (the 255-channel heads) with a depth
// of at most 512.  Mirrored by ops/cuda_qconv.py::design.
__host__ __forceinline__ bool wgmma_takes(const Params& p) { return p.ci % 64 == 0 && (p.k == 1 || p.k == 3); }

__host__ __forceinline__ bool wgmma_route(const Params& p) {
  return wgmma_takes(p) && !(p.k == 1 && (p.ci <= 128 || (p.co > 128 && p.co % 16 && p.ci <= 512)));
}

// 128-byte slabs where Ci allows (the pooled tiles keep 64)
template <int WGS, int MT, int BN, bool ASYM>
cudaError_t launch_wgmma_bk(const Params& p, int dev, cudaStream_t s) {
  if constexpr (MT == 1) {
    if (p.ci % 128 == 0) return launch_wgmma<WGS, MT, BN, 128, ASYM>(p, dev, s);
  }
  return launch_wgmma<WGS, MT, BN, 64, ASYM>(p, dev, s);
}

// The wgmma block tile, from the H100's timings (PERF.md): 64 x 128, two
// blocks an SM, where that grid gives every SM a block; else 128 x 64 for
// a GEMM depth from 512 (or a grid that fills the card), else 64 x 64;
// N 32 for Co up to 32 (128 x 32 where it fills the card); with the fused
// pool, 128-row tiles of one warpgroup (MT = 2).
template <bool ASYM>
cudaError_t launch_wgmma_tile(const Params& p, int dev, int sms, cudaStream_t s) {
  const long long rows = p.pool ? 4LL * p.outs : p.outs;
  const auto blocks = [&](int bm, int bn) { return ((rows + bm - 1) / bm) * ((p.co + bn - 1) / bn); };
  if (p.pool) {
    if (p.co <= 32) return launch_wgmma_bk<1, 2, 32, ASYM>(p, dev, s);
    if (p.co <= 64) return launch_wgmma_bk<1, 2, 64, ASYM>(p, dev, s);
    return launch_wgmma_bk<1, 2, 128, ASYM>(p, dev, s);
  }
  if (p.co <= 32) {
    return blocks(128, 32) >= sms ? launch_wgmma_bk<2, 1, 32, ASYM>(p, dev, s)
                                  : launch_wgmma_bk<1, 1, 32, ASYM>(p, dev, s);
  }
  if (p.co > 64 && blocks(64, 128) >= sms) return launch_wgmma_bk<1, 1, 128, ASYM>(p, dev, s);
  if (p.k_pad >= 512 || blocks(128, 64) >= sms) return launch_wgmma_bk<2, 1, 64, ASYM>(p, dev, s);
  return launch_wgmma_bk<1, 1, 64, ASYM>(p, dev, s);
}

// ---- the halo design: the bytes-bound 3x3 convs (Ci 3, 16, 32, 48; Co 16, 32, 64) ----

constexpr int kRouteHalo = 4;             // reported to the caller, beside kRouteMma .. kRouteInt16

// The convs the halo design takes: the int8 carrier (the caller's), 3x3 with
// pad 1 at stride 1 or 2, Co 16, 32 or 64 (a whole N tile a warp, 16-byte
// stores), Ci 16, 32 or 48 (chunks of one tap's channels read in place), or
// Ci 3 where a row of W * 3 bytes meets TMA's 16-byte stride (every darknet
// width, a multiple of 32).  Mirrored by ops/cuda_qconv.py::halo_capable;
// it takes no conv that wgmma_takes.
__host__ __forceinline__ bool halo_takes(const Params& p) {
  return p.k == 3 && p.pad == 1 && (p.co == 16 || p.co == 32 || p.co == 64) &&
         (p.ci == 3 ? p.w_in % 16 == 0 : p.ci % 16 == 0 && p.ci <= 48);
}

template <int S, bool POOL, bool STEM, bool ASYM>
cudaError_t launch_halo_nt(const Params& p, int n, int dev, int sms, cudaStream_t s) {
  if (p.co == 16) return yq::launch_halo<S, POOL, STEM, 2, ASYM, 1>(p, n, dev, sms, s);
  if (p.co == 32) return yq::launch_halo<S, POOL, STEM, 4, ASYM, 1>(p, n, dev, sms, s);
  return yq::launch_halo<S, POOL, STEM, 8, ASYM, 1>(p, n, dev, sms, s);
}

template <bool ASYM>
cudaError_t launch_halo_tile(const Params& p, int n, int dev, int sms, cudaStream_t s) {
  const bool stem = p.ci == 3;
  if (p.stride == 2) {
    return stem ? launch_halo_nt<2, false, true, ASYM>(p, n, dev, sms, s)
                : launch_halo_nt<2, false, false, ASYM>(p, n, dev, sms, s);
  }
  if (p.pool) {
    return stem ? launch_halo_nt<1, true, true, ASYM>(p, n, dev, sms, s)
                : launch_halo_nt<1, true, false, ASYM>(p, n, dev, sms, s);
  }
  return stem ? launch_halo_nt<1, false, true, ASYM>(p, n, dev, sms, s)
              : launch_halo_nt<1, false, false, ASYM>(p, n, dev, sms, s);
}

// The design, then the block tile.  halo takes what halo_takes admits,
// wgmma what wgmma_route admits (the two are disjoint), unless the caller
// forces a design on a conv that design takes, to compare it with
// mma.sync; mma.sync the rest: its tile by N = Co, and by M where the large
// tile would leave SMs without a block (the 13x13 layers: M = 2,704 at
// batch 16).  The pooled 3-channel stem and other Ci % 16 != 0 take their
// own loaders.
template <bool ASYM>
cudaError_t launch_tile(const Params& p, int n, int force, int& route, cudaStream_t s) {
  int dev = 0, sms = 0;
  const cudaError_t err = yq::device_sms(dev, sms);
  if (err != cudaSuccess) return err;
  if ((force == kRouteWgmma && !wgmma_takes(p)) || (force == kRouteHalo && !halo_takes(p))) {
    return cudaErrorInvalidValue;
  }
  if (force == kRouteHalo || (force == 0 && halo_takes(p))) {
    route = kRouteHalo;
    return launch_halo_tile<ASYM>(p, n, dev, sms, s);
  }
  if (force == kRouteWgmma || (force == 0 && wgmma_route(p))) {
    route = kRouteWgmma;
    return launch_wgmma_tile<ASYM>(p, dev, sms, s);
  }
  route = kRouteMma;
  const auto blocks = [&](int bm, int bn) {
    return (long long)((p.rows + bm - 1) / bm) * ((p.co + bn - 1) / bn);
  };
  if (p.ci == 3 && p.k == 3 && p.pad == 1 && p.pool && p.co <= 16) {
    return launch_mma<512, 16, 4, 1, ASYM, kStem>(p, dev, s);
  }
  if (p.ci % 16) {
    return p.co <= 16 ? launch_mma<128, 16, 4, 1, ASYM, kByte>(p, dev, s)
                      : launch_mma<128, 32, 4, 1, ASYM, kByte>(p, dev, s);
  }
  if (p.co <= 16) return launch_mma<128, 16, 4, 1, ASYM>(p, dev, s);
  if (p.co <= 32) {
    return blocks(128, 32) >= sms ? launch_mma<128, 32, 4, 1, ASYM>(p, dev, s)
                                  : launch_mma<64, 32, 2, 1, ASYM>(p, dev, s);
  }
  if (p.co <= 64) {
    return blocks(128, 64) >= sms ? launch_mma<128, 64, 4, 2, ASYM>(p, dev, s)
                                  : launch_mma<64, 64, 2, 2, ASYM>(p, dev, s);
  }
  return blocks(128, 128) >= sms ? launch_mma<128, 128, 2, 4, ASYM>(p, dev, s)
                                 : launch_mma<64, 64, 2, 2, ASYM>(p, dev, s);
}

// ---- the int16 carrier: a scalar kernel ----

constexpr int kI16Threads = 256;

// One 32-bit shared word of the int16 carrier: 2 int16 lanes.
struct I16Word {
  static constexpr int kLanes = 2;

  // a lane's code placed in its slot of the word
  __device__ static __forceinline__ uint32_t lane(int8_t code, int b) {
    return (uint32_t)(uint16_t)(int16_t)code << (16 * b);
  }

  // acc + the word dot product: s16 x s16 -> s32 multiply-adds
  __device__ static __forceinline__ int mac(int a, int b, int acc) {
    return acc + (int)(int16_t)a * (int)(int16_t)b + (a >> 16) * (b >> 16);
  }

  // acc + the sum of the word's lanes (the patchsum of asymmetric weights)
  __device__ static __forceinline__ int lane_sum(int a, int acc) { return acc + (int)(int16_t)a + (a >> 16); }
};

// CG threads share one 2x2 window of output pixels, each with 4 channels:
// TC = 4*CG output channels per block, 256/CG windows arranged WY x WX, an
// output tile of TH x TW pixels whose input patch at stride S is
// ((TH-1)*S + K) x ((TW-1)*S + K).  CHUNK shared words (int16 pairs) of
// channels per position and stage; stride 2 halves it, so its 4x larger
// patch still fits the 48 KB of static shared memory.
template <int CG, int S>
struct I16Tile {
  static constexpr int TC = 4 * CG;
  static constexpr int WINDOWS = kI16Threads / CG;
  static constexpr int WX = CG == 16 ? 4 : 8;
  static constexpr int WY = WINDOWS / WX;
  static constexpr int TH = 2 * WY;
  static constexpr int TW = 2 * WX;
  static constexpr int CHUNK = S == 1 ? 16 : 8;
  // odd word strides (+1) keep the per-thread shared loads conflict-free
  static constexpr int IN_WORDS = ((TH - 1) * S + kMaxK) * ((TW - 1) * S + kMaxK) * (CHUNK + 1);
  static constexpr int W_WORDS = TC * (kMaxK * kMaxK * CHUNK + 1);
  static_assert((IN_WORDS + W_WORDS) * 4 <= 48 * 1024, "static shared memory");
};

// Each thread owns one 2x2 output window and 4 output channels; input
// channels are walked in chunks of 2 * CHUNK, each chunk staging the
// zero-point-padded input patch and the chunk's weights in shared memory.
template <int CG, int S, bool ASYM>
__global__ void __launch_bounds__(kI16Threads) qconv_i16_kernel(const Params p) {
  using T = I16Tile<CG, S>;
  using Wd = I16Word;
  constexpr int L = Wd::kLanes;  // channels per shared word
  __shared__ int xs[T::IN_WORDS];
  __shared__ int ws[T::W_WORDS];

  const int t = threadIdx.x;
  const int cg = t % CG;
  const int win = t / CG;
  const int wy = win / T::WX, wx = win % T::WX;
  const int y0 = (blockIdx.x / p.tiles_x) * T::TH;
  const int x0 = (blockIdx.x % p.tiles_x) * T::TW;
  const int o0 = blockIdx.y * T::TC;
  const int img = blockIdx.z;
  const int K = p.k, KK = K * K;
  const int IW = (T::TW - 1) * S + K;
  const int npos = ((T::TH - 1) * S + K) * IW;
  const int8_t zp_code = (int8_t)(p.x_zp_img ? p.x_zp_img[img] : p.x_zp);
  const int nwords = (p.ci + L - 1) / L;  // shared words per pixel
  const size_t img_base = (size_t)img * p.h * p.w_in;

  int acc[4][4];  // [channel j][pixel (dy*2+dx) of the 2x2 window]
  int ps[4];      // patchsum per pixel (ASYM)
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    ps[q] = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[j][q] = 0;
  }

  for (int c0 = 0; c0 < nwords; c0 += T::CHUNK) {
    const int cw = min(T::CHUNK, nwords - c0);
    const int ips = cw | 1;         // input word stride per position
    const int wrs = (KK * cw) | 1;  // weight word stride per channel
    __syncthreads();                // the previous chunk's reads are done

    for (int idx = t; idx < npos * cw; idx += kI16Threads) {
      const int pos = idx / cw, q = idx - pos * cw;
      const int py = pos / IW, px = pos - py * IW;
      const int iy = y0 * S - p.pad + py, ix = x0 * S - p.pad + px;
      const bool inside = iy >= 0 && iy < p.h && ix >= 0 && ix < p.w_in;
      const size_t pix = img_base + (size_t)iy * p.w_in + ix;
      uint32_t v = 0;  // channels past Ci stay 0, as do their weights
      const int c = L * (c0 + q);
#pragma unroll
      for (int b = 0; b < L; ++b) {
        if (c + b < p.ci) v |= Wd::lane(inside ? p.x[pix * p.ci + c + b] : zp_code, b);
      }
      xs[pos * ips + q] = (int)v;
    }
    for (int idx = t; idx < T::TC * KK * cw; idx += kI16Threads) {
      const int ol = idx / (KK * cw), r = idx - ol * (KK * cw);
      const int tap = r / cw, q = r - tap * cw;
      const int o = o0 + ol;
      uint32_t v = 0;
      if (o < p.co) {
        const int8_t* wp = p.w + (size_t)o * p.k_pad + tap * p.ci;  // the packed B row
        const int c = L * (c0 + q);
#pragma unroll
        for (int b = 0; b < L; ++b) {
          if (c + b < p.ci) v |= Wd::lane(wp[c + b], b);
        }
      }
      ws[ol * wrs + r] = (int)v;
    }
    __syncthreads();

    for (int tap = 0; tap < KK; ++tap) {
      const int dy = tap / K, dx = tap - dy * K;
      const int* xp = xs + ((2 * wy * S + dy) * IW + 2 * wx * S + dx) * ips;
      const int* wp = ws + cg * wrs + tap * cw;
      for (int q = 0; q < cw; ++q) {  // the window's pixels are S patch positions apart
        const int a0 = xp[q];
        const int a1 = xp[S * ips + q];
        const int a2 = xp[S * IW * ips + q];
        const int a3 = xp[S * (IW + 1) * ips + q];
        if (ASYM) {
          ps[0] = Wd::lane_sum(a0, ps[0]);
          ps[1] = Wd::lane_sum(a1, ps[1]);
          ps[2] = Wd::lane_sum(a2, ps[2]);
          ps[3] = Wd::lane_sum(a3, ps[3]);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int b = wp[j * CG * wrs + q];
          acc[j][0] = Wd::mac(a0, b, acc[j][0]);
          acc[j][1] = Wd::mac(a1, b, acc[j][1]);
          acc[j][2] = Wd::mac(a2, b, acc[j][2]);
          acc[j][3] = Wd::mac(a3, b, acc[j][3]);
        }
      }
    }
  }

  const yq::Clamp cl = yq::clamp_of(p.e);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int o = o0 + cg + CG * j;
    if (o >= p.co) continue;
    if (ASYM) {
      const unsigned zw = (unsigned)p.w_zp[o];
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[j][q] = (int)((unsigned)acc[j][q] - zw * (unsigned)ps[q]);
    }
    const int bias = p.e.bias[(size_t)img * p.e.bm_stride + o];
    const float m = p.e.m[(size_t)img * p.e.bm_stride + o];
    if (p.pool) {
      const int ph = p.h_out / 2, pw = p.w_out / 2;
      const int oy = y0 / 2 + wy, ox = x0 / 2 + wx;
      if (oy < ph && ox < pw) {
        const int a = max(max(acc[j][0], acc[j][1]), max(acc[j][2], acc[j][3]));
        p.out[(((size_t)img * ph + oy) * pw + ox) * p.co + o] =
            (uint8_t)yq::requant(a, bias, m, p.e, cl);
      }
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int oy = y0 + 2 * wy + (q >> 1), ox = x0 + 2 * wx + (q & 1);
        if (oy < p.h_out && ox < p.w_out) {
          p.out[(((size_t)img * p.h_out + oy) * p.w_out + ox) * p.co + o] =
              (uint8_t)yq::requant(acc[j][q], bias, m, p.e, cl);
        }
      }
    }
  }
}

template <int CG, int S, bool ASYM>
cudaError_t launch_i16(Params p, int n, cudaStream_t stream) {
  using T = I16Tile<CG, S>;
  p.tiles_x = (p.w_out + T::TW - 1) / T::TW;
  const int tiles_y = (p.h_out + T::TH - 1) / T::TH;
  const dim3 grid(p.tiles_x * tiles_y, (p.co + T::TC - 1) / T::TC, n);
  qconv_i16_kernel<CG, S, ASYM><<<grid, kI16Threads, 0, stream>>>(p);
  return cudaGetLastError();
}

template <int S, bool ASYM>
cudaError_t launch_i16_cg(const Params& p, int n, cudaStream_t s) {
  if (p.co <= 16) return launch_i16<4, S, ASYM>(p, n, s);
  if (p.co <= 32) return launch_i16<8, S, ASYM>(p, n, s);
  return launch_i16<16, S, ASYM>(p, n, s);
}

template <bool ASYM>
cudaError_t launch_i16_tile(const Params& p, int n, cudaStream_t s) {
  return p.stride == 1 ? launch_i16_cg<1, ASYM>(p, n, s) : launch_i16_cg<2, ASYM>(p, n, s);
}

}  // namespace

// Plain C entry for ctypes.  Shapes are validated by the Python wrapper;
// returns the launch's cudaError_t (0 on success).  w is pack_weights'
// (Co_pad, K_pad) layout; w_zp null means symmetric weights, x_zp_img null
// the static x_zp; stride 1 or 2 (fuse_pool with stride 1 only);
// bm_per_image selects (N, Co) bias/m; carrier16 the int16 carrier;
// design 0 routes (halo_takes, then wgmma_route), 1 forces mma.sync, 2
// wgmma and 4 halo on a conv that design takes (for comparing designs; the
// engine passes 0).  *route (if not null) receives the design launched: 1
// mma.sync, 2 wgmma, 3 the int16 kernel, 4 halo.
extern "C" int yq_qconv(const void* x, const void* w, const void* w_zp, const void* x_zp_img,
                        const void* bias, const void* m, void* out, int n, int h, int w_in,
                        int ci, int co, int k, int pad, int stride, int x_zp, int out_zp,
                        int act, int exact_leaky, int out_i8, int fuse_pool, int bm_per_image,
                        int carrier16, int design, int* route, void* stream) {
  if (n < 1 || n > 65535 || k < 1 || k > kMaxK || ci < 1 || co < 1 || pad < 0 ||
      (stride != 1 && stride != 2) || (fuse_pool && stride != 1) || h + 2 * pad < k ||
      w_in + 2 * pad < k) {
    return (int)cudaErrorInvalidValue;
  }
  Params p;
  p.x = static_cast<const int8_t*>(x);
  p.w = static_cast<const int8_t*>(w);
  p.w_zp = static_cast<const int32_t*>(w_zp);
  p.x_zp_img = static_cast<const int32_t*>(x_zp_img);
  p.e.bias = static_cast<const int32_t*>(bias);
  p.e.m = static_cast<const float*>(m);
  p.e.bm_stride = bm_per_image ? co : 0;
  p.e.act = act;
  p.e.exact_leaky = exact_leaky;
  p.e.out_i8 = out_i8;
  p.e.out_zp = out_zp;
  p.out = static_cast<uint8_t*>(out);
  p.h = h;
  p.w_in = w_in;
  p.ci = ci;
  p.co = co;
  p.k = k;
  p.pad = pad;
  p.stride = stride;
  p.h_out = (h + 2 * pad - k) / stride + 1;
  p.w_out = (w_in + 2 * pad - k) / stride + 1;
  p.k_real = k * k * ci;
  p.k_pad = (p.k_real + 31) / 32 * 32;
  p.co_pad = (co + 15) / 16 * 16;
  p.x_zp = x_zp;
  p.pool = fuse_pool;
  p.tiles_x = 1;
  if (p.h_out < 1 || p.w_out < 1) return (int)cudaErrorInvalidValue;
  if (fuse_pool && (p.h_out % 2 || p.w_out % 2)) return (int)cudaErrorInvalidValue;
  const long long outs = fuse_pool ? (long long)n * (p.h_out / 2) * (p.w_out / 2)
                                   : (long long)n * p.h_out * p.w_out;
  const long long rows = fuse_pool ? 32 * ((outs + 7) / 8) : outs;
  if (rows > INT_MAX - 256 || (long long)n * h * w_in * ci > INT_MAX) {
    return (int)cudaErrorInvalidValue;
  }
  p.outs = (int)outs;
  p.rows = (int)rows;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool asym = w_zp != nullptr;
  cudaError_t err;
  int launched = 0;
  if (carrier16) {
    launched = kRouteInt16;
    err = asym ? launch_i16_tile<true>(p, n, s) : launch_i16_tile<false>(p, n, s);
  } else {
    err = asym ? launch_tile<true>(p, n, design, launched, s) : launch_tile<false>(p, n, design, launched, s);
  }
  if (route) *route = launched;
  return (int)err;
}

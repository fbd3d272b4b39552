// Space-to-depth stem conv + 4-phase max + requant epilogue for Hopper.
//
// Replaces yolo_quantization_tpu/ops/pallas_qconv.py::pallas_s2d_conv_phase_max
// (kernel body _s2d_phase_kernel).  Same function: a 3x3/s1 conv over the
// 2x2 space-to-depth input xs (N, H/2, W/2, 4C), slot (qy*2+qx)*C + c
// holding pixel (2i+qy, 2j+qx, c), whose blocks are padded by 1 with the
// input zero point; the block kernel w_s2d (3, 3, 4C, 4O) (any one: the
// mma.sync design does not assume infer/convert.py::_s2d_weights'
// structural zeros, the halo design takes the kernels that have them),
// output slot (py*2+px)*O + o; then the max over the 4 output-phase groups
// on the int32 accumulators (the following 2x2/s2 maxpool of the original
// graph, exact because the epilogue is monotone); then the epilogue of
// common.cuh, emitting shifted int8.
//
// Two designs, chosen by the block kernel (ops/cuda_s2d.py::pack_weights
// decides on the host, once per weight tensor, and ::design mirrors the
// rule below):
//
// halo (a structured w_s2d: every entry outside _s2d_weights' pattern zero;
// C 3 with W % 16 == 0, or C 16, 32, 48; O 16, 32, 64): phase (py, px) of
// block (by, bx) is then an ordinary 3x3 pad-1 conv at pixel (2 by + py,
// 2 bx + px) with that phase's own 3x3xC kernel, 36 C O MACs a block where
// the dense GEMM below does 144 C O (its structural zeros, 4x the work, made
// layers 2 and 4 operation-bound).  That is K1's pooled halo tile
// (halo.cuh::halo_kernel) with one B slice per phase: each tile's input halo
// arrives once by TMA (Ci 3 in the stem row layout), the image's zero-point
// code is written where TMA filled 0, A is read from the halo in place, the
// phase max is taken on the int32 accumulators in registers, then the
// epilogue and 16-byte stores.  Where the four phase kernels are equal (every
// engine program: _s2d_weights of one 3x3 kernel) the tile shares one slice
// (PHASES 1), which is K1's pooled kernel itself.  Four distinct slices
// (PHASES 4): K1's pooled tile mixes phases inside an m16 fragment (rows g
// and 8 + g of one tile are pixels dx = g / 4 and 1 - g / 4), so each tile
// is multiplied by its two slices with the other dx's rows zeroed in the A
// fragment (twice the MMAs, the same loads).  The alternative, rows
// regrouped so that each m16 tile is one phase, does the MACs once but puts
// the 8 rows of an ldmatrix phase on pixels an even number apart, 2-way bank
// conflicts on every A read for any pitch, and needs four m16 tiles a warp
// (Co 64 has two).  Measured on an H100 (700 W, tools/kernel_timings.py,
// the flagship's layers 0 / 2 / 4 at batch 16, PERF.md §6): the shared
// slice, the time the regrouped rows could at best reach, takes 0.0364 /
// 0.0225 / 0.0195 ms, the same kernel as four per-fragment slices 0.0394 /
// 0.0311 / 0.0399 ms (1.08 / 1.38 / 2.05x).  The per-fragment slices stay:
// four distinct phase kernels come from no program the engine converts,
// and the regrouped tile was not built.
//
// mma.sync (any other w_s2d, or a shape the halo design does not take): an
// implicit GEMM on the int8 tensor cores, built like qconv.cu's K1:
//   - GEMM view: M = output blocks (N*H/2*W/2), N = 4*O phase columns, K = 9
//     taps x 4C slots in w_s2d's flatten order (tap-major, slot-minor),
//     padded to 32.  In the original image a row's K is the 6x6xC input
//     window at (2by-2, 2bx-2), so the s2d index map is applied on load from
//     NHWC and no space-to-depth copy exists in device memory.
//   - What bounds it on the H100: int8 operations (the block kernel's 4x
//     MACs, its zeros multiplied: 25.5 G ops on layers 2 and 4 at batch 16)
//     and, on the 3-channel layer 0, bytes.  Hence the tensor cores
//     (mma.sync m16n8k32 s8, operands by ldmatrix, common.cuh) and a ring of
//     K slabs in dynamic shared memory filled by cp.async while the warps
//     multiply an earlier slab; shared rows are slab + 16 bytes, so the 8
//     rows of an ldmatrix phase fall on distinct bank groups.
//   - B column order (ops/cuda_s2d.py::pack_weights): column
//     16*(o/4) + 8*(ph/2) + 2*(o%4) + ph%2.  In the m16n8 accumulator a
//     thread holds columns 2t and 2t+1 of each n8 tile, so the two n8 tiles
//     of a 16-column group give it phases 0..3 of channel 4*group + t and
//     the phase max stays in registers, as K1's fused pool does.
//   - A loaders (template MODE):
//     kVec (C % 16 == 0): a 16-byte chunk of K is 16 channels of one pixel,
//       copied straight from NHWC (through L1 when C <= 32: neighbouring
//       blocks' 6x6 windows overlap 9-fold);
//     kStem (C == 3): a row is its block's 6x6x3 patch (108 codes), read
//       once as 54 16-bit loads (a block column is 6 aligned bytes) and
//       permuted in registers into one 128-byte slab;
//     kByte (any other C): byte by byte, a row per thread.
//     A code whose pixel lies outside the map is the input zero point (per
//     image), stored explicitly: cp.async's zero-fill writes 0.  K padding
//     holds 0 in A and in B.
//   - Block tile from (M, N): a fixed table (launch_tile), 128x128 where
//     N > 64, 128x64 where N <= 64 and for the stem and the byte gather,
//     64x64 where the larger tile would leave SMs (read per device) without
//     a block.
// Options: a per-image input zero point ((N,) device tensor), per-image
// (N, O) bias and m, and exact_leaky, as in qconv.cu.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "common.cuh"
#include "halo.cuh"

namespace {

using yq::Epilogue;

constexpr int kRouteMma = 1, kRouteHalo = 4;  // reported to the caller, as qconv.cu's codes

constexpr int kStages = 4;
constexpr int kFar = INT_MIN / 4;  // a row past the end: every tap lies outside the map
constexpr int kVec = 0, kStem = 1, kByte = 2;  // A loaders

struct Params {
  const int8_t* x;          // (N, H, W, C) shifted int8 codes, NHWC
  const int8_t* w;          // (n_pad, k_pad) packed B, phase-interleaved columns
  const int32_t* x_zp_img;  // (N,) per-image input zero point, or null
  Epilogue e;
  int8_t* out;              // (N, H/2, W/2, O) shifted int8
  int h, w_in, c, o, h2, w2;
  int k_real, k_pad, n_pad;  // 36C, padded to 32; 4 * O padded to 4
  int x_zp, rows;            // rows = N * H/2 * W/2
};

// K bytes per ring slot: the stem's whole 128-byte row, else 64
__host__ __device__ constexpr int slab_bytes(int mode) { return mode == kStem ? 128 : 64; }

// The ring slots a layer uses: one per K slab, at most kStages.
__host__ __device__ __forceinline__ int ring_slots(int k_pad, int bk) {
  const int slabs = (k_pad + bk - 1) / bk;
  return slabs < kStages ? slabs : kStages;
}

// BM x BN block tile, WM x WN warps, each warp a (BM/WM) x (BN/WN) tile of
// m16n8 accumulators; MODE the A loader.  The stem is held to 170 registers
// (3 blocks an SM) so that loads of other blocks cover its one-slab stall:
// at 4 blocks it spills its patch, at 2 it runs a third slower.
template <int BM, int BN, int WM, int WN, int MODE>
__global__ void __launch_bounds__(WM * WN * 32, MODE == kStem ? 3 : 1)
    s2d_mma_kernel(const Params p) {
  constexpr int kThreads = WM * WN * 32;
  constexpr int BK = slab_bytes(MODE), RB = BK + 16;  // slab bytes, shared row stride
  constexpr int CPR = BK / 16;                        // 16-byte chunks per row and slab
  constexpr int TM = BM / WM, TN = BN / WN;
  constexpr int MI = TM / 16, NI = TN / 8;
  constexpr bool VEC = MODE == kVec;
  constexpr int A_ROWS = VEC ? kThreads / CPR : kThreads;  // rows one pass of the A loader covers
  constexpr int A_ITERS = BM / A_ROWS;
  static_assert(TM % 16 == 0 && TN % 16 == 0 && BM % A_ROWS == 0, "unsupported tile");
  static_assert(VEC || A_ITERS == 1, "the stem and byte loaders take one row per thread");

  const int nk = (p.k_pad + BK - 1) / BK;
  extern __shared__ __align__(128) uint8_t smem[];
  uint8_t* const a_smem = smem;                                     // [slots][BM][RB]
  uint8_t* const b_smem = smem + ring_slots(p.k_pad, BK) * BM * RB;  // [slots][BN][RB]

  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int wm0 = (warp / WN) * TM, wn0 = (warp % WN) * TN;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int hw2 = p.h2 * p.w2;

  // The A loader's rows: kVec, thread t fills 16-byte column a_col of rows
  // t / CPR + i * A_ROWS; otherwise thread t fills row t.  Each row's block
  // (by, bx) has its input pixel (2by, 2bx) at a_src; its window starts 2
  // pixels up and left.
  const int a_col = VEC ? t % CPR : 0;
  const int8_t* a_src[A_ITERS];
  int a_iy[A_ITERS], a_ix[A_ITERS];
  uint32_t a_zp[A_ITERS];  // the row's image's zero-point code, 4 lanes
#pragma unroll
  for (int i = 0; i < A_ITERS; ++i) {
    const int r = m0 + (VEC ? t / CPR : t) + i * A_ROWS;
    const bool valid = r < p.rows;
    const int img = valid ? r / hw2 : 0, rem = valid ? r - img * hw2 : 0;
    const int by = rem / p.w2, bx = rem - by * p.w2;
    const int zp = p.x_zp_img ? p.x_zp_img[img] : p.x_zp;
    a_zp[i] = (uint32_t)(uint8_t)(int8_t)zp * 0x01010101u;
    a_src[i] = p.x + ((size_t)(img * p.h + 2 * by) * p.w_in + 2 * bx) * p.c;
    a_iy[i] = valid ? 2 * by : kFar;
    a_ix[i] = 2 * bx;
  }

  // Stage the K slab [k0, k0 + BK) (or its last 32) into ring slot `slot`.
  auto load_stage = [&](int slot, int k0) {
    uint8_t* as = a_smem + slot * BM * RB;
    uint8_t* bs = b_smem + slot * BN * RB;
    const int kc = min(BK, p.k_pad - k0);
    for (int idx = t; idx < BN * CPR; idx += kThreads) {
      const int nr = idx / CPR, c = idx % CPR;
      if (c * 16 >= kc) continue;
      const int n = n0 + nr;
      const bool ok = n < p.n_pad;
      yq::cp_async16(yq::smem_addr(bs + nr * RB + c * 16),
                     ok ? p.w + (size_t)n * p.k_pad + k0 + c * 16 : p.w, ok ? 16 : 0);
    }
    if constexpr (MODE == kStem) {  // k0 == 0, K = 108 -> 128: the whole row at once
      // patch row pr (input row 2by-2+pr), bytes 0..17 = pixels 2bx-2 .. 2bx+3
      // x 3 channels, as 9 16-bit words; block column dx holds words 3dx..3dx+2
      const uint32_t zp16 = a_zp[0] & 0xffffu;
      const int bx = a_ix[0] / 2;
      uint32_t u[6][9];
#pragma unroll
      for (int pr = 0; pr < 6; ++pr) {
        const int iy = a_iy[0] - 2 + pr;
        const bool row_in = (unsigned)iy < (unsigned)p.h;
        const uint16_t* rp = reinterpret_cast<const uint16_t*>(a_src[0] + ((pr - 2) * p.w_in - 2) * 3);
#pragma unroll
        for (int j = 0; j < 9; ++j) {  // every load issued, so all 54 are in flight together
          const bool take = row_in && (unsigned)(bx + j / 3 - 1) < (unsigned)p.w2;
          const uint32_t pair = __ldg(take ? rp + j : reinterpret_cast<const uint16_t*>(p.x));
          u[pr][j] = take ? pair : zp16;
        }
      }
      // K index k = tap*12 + q*3 + c, tap = dy*3 + dx, q = qy*2 + qx: patch
      // row 2dy+qy, byte (2dx+qx)*3 + c
      uint32_t v[32];
#pragma unroll
      for (int wd = 0; wd < 32; ++wd) {
        v[wd] = 0;
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int k = 4 * wd + b;
          if (k < 108) {
            const int tap = k / 12, q = k % 12 / 3, c = k % 3;
            const int pr = 2 * (tap / 3) + q / 2, bb = (2 * (tap % 3) + q % 2) * 3 + c;
            v[wd] |= (u[pr][bb / 2] >> (8 * (bb % 2)) & 0xffu) << (8 * b);
          }
        }
      }
      uint8_t* dst = as + t * RB;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        *reinterpret_cast<uint4*>(dst + 16 * j) = make_uint4(v[4 * j], v[4 * j + 1], v[4 * j + 2], v[4 * j + 3]);
      }
      return;
    }
    const int c4 = 4 * p.c;
    if constexpr (MODE == kByte) {  // 32 K-bytes at a time: k walks (tap, slot, channel)
#pragma unroll
      for (int half = 0; half < BK / 32; ++half) {
        if (half * 32 >= kc) break;
        const int kb = k0 + half * 32;
        const int tap = kb / c4, s = kb - tap * c4;
        int q = s / p.c, c = s - q * p.c;
        int dy = tap / 3, dx = tap - dy * 3;
        uint32_t v[8];
#pragma unroll
        for (int b = 0; b < 32; ++b) {
          // every load is issued (from x itself where the code is not read),
          // so all 32 are in flight together; the select comes after
          const int ry = 2 * dy + (q >> 1) - 2, rx = 2 * dx + (q & 1) - 2;
          const int iy = a_iy[0] + ry, ix = a_ix[0] + rx;
          const bool real = kb + b < p.k_real;  // past it: K padding, code 0
          const bool take = real && (unsigned)iy < (unsigned)p.h && (unsigned)ix < (unsigned)p.w_in;
          const uint32_t code = (uint8_t)__ldg(take ? a_src[0] + (ry * p.w_in + rx) * p.c + c : p.x);
          const uint32_t byte = take ? code : real ? (a_zp[0] & 0xffu) : 0u;
          v[b / 4] = (b % 4 ? v[b / 4] : 0u) | byte << (8 * (b % 4));
          c = c + 1 == p.c ? 0 : c + 1;
          q = c ? q : q == 3 ? 0 : q + 1;
          dx = c || q ? dx : dx == 2 ? 0 : dx + 1;
          dy = c || q || dx ? dy : dy + 1;
        }
        uint8_t* dst = as + t * RB + half * 32;
        *reinterpret_cast<uint4*>(dst) = make_uint4(v[0], v[1], v[2], v[3]);
        *reinterpret_cast<uint4*>(dst + 16) = make_uint4(v[4], v[5], v[6], v[7]);
      }
      return;
    }
    if (a_col * 16 >= kc) return;
    const int kk = k0 + a_col * 16;
    uint8_t* const arow = as + (t / CPR) * RB + a_col * 16;
    if (kk >= p.k_real) {  // K padding: code 0 (B is 0 there too)
#pragma unroll
      for (int i = 0; i < A_ITERS; ++i) {
        *reinterpret_cast<uint4*>(arow + i * A_ROWS * RB) = make_uint4(0, 0, 0, 0);
      }
      return;
    }
    // 16 channels of one pixel: (tap, slot q) -> window offset (ry, rx)
    const int tap = kk / c4, s = kk - tap * c4, q = s / p.c, c = s - q * p.c;
    const int ry = 2 * (tap / 3) + (q >> 1) - 2, rx = 2 * (tap % 3) + (q & 1) - 2;
    const int off = (ry * p.w_in + rx) * p.c + c;
#pragma unroll
    for (int i = 0; i < A_ITERS; ++i) {
      uint8_t* dst = arow + i * A_ROWS * RB;
      const int iy = a_iy[i] + ry, ix = a_ix[i] + rx;
      if ((unsigned)iy < (unsigned)p.h && (unsigned)ix < (unsigned)p.w_in) {
        if (p.c <= 32) {
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
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni) acc[mi][ni][0] = acc[mi][ni][1] = acc[mi][ni][2] = acc[mi][ni][3] = 0;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) load_stage(s, s * BK);
    yq::cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    yq::cp_async_wait<kStages - 2>();
    __syncthreads();  // slab kt is in; every warp is done with slab kt - 1
    const int nxt = kt + kStages - 1;  // past nk whenever the ring has fewer slots
    if (nxt < nk) load_stage(nxt % kStages, nxt * BK);
    yq::cp_async_commit();

    const uint8_t* as = a_smem + (kt % kStages) * BM * RB;
    const uint8_t* bs = b_smem + (kt % kStages) * BN * RB;
    const int ksteps = min(BK, p.k_pad - kt * BK) / 32;
#pragma unroll
    for (int ks = 0; ks < BK / 32; ++ks) {
      if (ks < ksteps) {
        uint32_t af[MI][4], bf[NI][2];
#pragma unroll
        for (int mi = 0; mi < MI; ++mi) {
          yq::ldmatrix_x4(af[mi], yq::smem_addr(as + (wm0 + mi * 16 + (lane & 15)) * RB + ks * 32 +
                                                (lane >> 4) * 16));
        }
#pragma unroll
        for (int nj = 0; nj < NI / 2; ++nj) {
          uint32_t r[4];
          yq::ldmatrix_x4(r, yq::smem_addr(bs + (wn0 + nj * 16 + (lane & 7) + ((lane >> 4) << 3)) * RB +
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
      }
    }
  }
  yq::cp_async_wait<0>();

  // n8 tiles 2jj and 2jj+1 hold phases (0, 1) and (2, 3) of channel
  // (n0 + wn0) / 4 + 4jj + t in this thread's columns 2t, 2t+1
  const int g = lane >> 2, tq = lane & 3;
  const yq::Clamp cl = yq::clamp_of(p.e);
#pragma unroll
  for (int mi = 0; mi < MI; ++mi) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = m0 + wm0 + mi * 16 + g + 8 * hh;
      if (r >= p.rows) continue;
      const size_t bm = (size_t)(r / hw2) * p.e.bm_stride;
#pragma unroll
      for (int jj = 0; jj < NI / 2; ++jj) {
        const int o = (n0 + wn0) / 4 + 4 * jj + tq;
        if (o >= p.o) continue;
        const int a = max(max(acc[mi][2 * jj][2 * hh], acc[mi][2 * jj][2 * hh + 1]),
                          max(acc[mi][2 * jj + 1][2 * hh], acc[mi][2 * jj + 1][2 * hh + 1]));
        p.out[(size_t)r * p.o + o] = (int8_t)yq::requant(a, p.e.bias[bm + o], p.e.m[bm + o], p.e, cl);
      }
    }
  }
}

template <int BM, int BN, int WM, int WN, int MODE>
cudaError_t launch_mma(const Params& p, int dev, cudaStream_t stream) {
  constexpr int RB = slab_bytes(MODE) + 16;
  constexpr int kMaxSmem = kStages * (BM + BN) * RB;
  const auto kernel = s2d_mma_kernel<BM, BN, WM, WN, MODE>;
  // the attribute holds for the current device only; a benign race: every
  // caller sets the same value
  static bool smem_set[yq::kMaxDevices] = {false};
  if (!smem_set[dev]) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err != cudaSuccess) return err;
    smem_set[dev] = true;
  }
  const dim3 grid((p.rows + BM - 1) / BM, (p.n_pad + BN - 1) / BN);
  kernel<<<grid, WM * WN * 32, ring_slots(p.k_pad, slab_bytes(MODE)) * (BM + BN) * RB, stream>>>(p);
  return cudaGetLastError();
}

// The block tile by loader, by N = 4*O, and by M where the large tile would
// leave SMs without a block.
cudaError_t launch_tile(const Params& p, cudaStream_t s) {
  int dev = 0, sms = 0;
  const cudaError_t err = yq::device_sms(dev, sms);
  if (err != cudaSuccess) return err;
  const auto blocks = [&](int bm, int bn) {
    return (long long)((p.rows + bm - 1) / bm) * ((p.n_pad + bn - 1) / bn);
  };
  if (p.c == 3) return launch_mma<128, 64, 4, 1, kStem>(p, dev, s);
  if (p.c % 16) return launch_mma<128, 64, 4, 1, kByte>(p, dev, s);
  if (p.n_pad <= 64) {
    return blocks(128, 64) >= sms ? launch_mma<128, 64, 4, 2, kVec>(p, dev, s)
                                  : launch_mma<64, 64, 2, 2, kVec>(p, dev, s);
  }
  return blocks(128, 128) >= sms ? launch_mma<128, 128, 2, 4, kVec>(p, dev, s)
                                 : launch_mma<64, 64, 2, 2, kVec>(p, dev, s);
}

// ---- the halo design: structured block kernels ----

// What halo.cuh::halo_kernel reads of a conv: here the stem's 3x3 pad-1
// conv at every output phase, pooled over the four, symmetric, with one or
// four B slices (the kernel's PHASES).
struct HaloConv {
  const int8_t* x;          // (N, H, W, C) shifted int8 codes, NHWC
  const int8_t* w;          // (PHASES, O, K_pad) phase slices, K = (u, v, c) of the phase's 3x3 kernel
  const int32_t* w_zp;      // null: the stem's weights are symmetric
  const int32_t* x_zp_img;  // (N,) per-image input zero point, or null
  Epilogue e;
  uint8_t* out;             // (N, H/2, W/2, O) shifted int8 codes
  int h, w_in, ci, co, pad;
  int h_out, w_out;         // the conv's map before the pool: H, W
  int k_pad;                // 9 C padded to 32
  int x_zp;
};

// The structured convs the halo design takes, as qconv.cu::halo_takes for
// K1's pooled 3x3: O 16, 32 or 64; C 16, 32 or 48, or C 3 where a row of W
// * 3 bytes meets TMA's 16-byte stride.  Mirrored by
// ops/cuda_s2d.py::halo_capable.
__host__ __forceinline__ bool halo_takes(int c, int o, int w_in) {
  return (o == 16 || o == 32 || o == 64) && (c == 3 ? w_in % 16 == 0 : c % 16 == 0 && c <= 48);
}

template <bool STEM, int PHASES>
cudaError_t launch_halo_nt(const HaloConv& p, int n, int dev, int sms, cudaStream_t s) {
  if (p.co == 16) return yq::launch_halo<1, true, STEM, 2, false, PHASES>(p, n, dev, sms, s);
  if (p.co == 32) return yq::launch_halo<1, true, STEM, 4, false, PHASES>(p, n, dev, sms, s);
  return yq::launch_halo<1, true, STEM, 8, false, PHASES>(p, n, dev, sms, s);
}

cudaError_t launch_halo_tile(const HaloConv& p, int n, int phases, cudaStream_t s) {
  int dev = 0, sms = 0;
  const cudaError_t err = yq::device_sms(dev, sms);
  if (err != cudaSuccess) return err;
  const bool stem = p.ci == 3;
  if (phases == 1) {
    return stem ? launch_halo_nt<true, 1>(p, n, dev, sms, s) : launch_halo_nt<false, 1>(p, n, dev, sms, s);
  }
  return stem ? launch_halo_nt<true, 4>(p, n, dev, sms, s) : launch_halo_nt<false, 4>(p, n, dev, sms, s);
}

}  // namespace

// Plain C entry for ctypes.  Shapes are validated by the Python wrapper;
// returns the launch's cudaError_t (0 on success).  phases 0: w is
// pack_weights' dense layout (4 * O padded to 16, 36 * C padded to 32) and
// the mma.sync design runs; phases 1 or 4: w is the structured layout
// (phases, O, 9 * C padded to 32) and the halo design runs, on a conv that
// halo_takes (else cudaErrorInvalidValue).  *route (if not null) receives
// the design launched: 1 mma.sync, 4 halo.
extern "C" int yq_s2d_qconv(const void* x, const void* w, const void* x_zp_img,
                            const void* bias, const void* m, void* out, int n, int h,
                            int w_in, int c, int o, int x_zp, int out_zp, int act,
                            int exact_leaky, int bm_per_image, int phases, int* route, void* stream) {
  if (n < 1 || n > 65535 || c < 1 || o < 1 || h < 2 || w_in < 2 || (h & 1) || (w_in & 1) ||
      (phases != 0 && phases != 1 && phases != 4)) {
    return (int)cudaErrorInvalidValue;
  }
  const long long rows = (long long)n * (h / 2) * (w_in / 2);
  if (rows > INT_MAX - 256 || (long long)n * h * w_in * c > INT_MAX || 36LL * c > INT_MAX / 2 ||
      16LL * o > INT_MAX / 2) {
    return (int)cudaErrorInvalidValue;
  }
  Epilogue e;
  e.bias = static_cast<const int32_t*>(bias);
  e.m = static_cast<const float*>(m);
  e.bm_stride = bm_per_image ? o : 0;
  e.act = act;
  e.exact_leaky = exact_leaky;
  e.out_i8 = 1;
  e.out_zp = out_zp;
  if (phases) {
    if (route) *route = kRouteHalo;
    if (!halo_takes(c, o, w_in)) return (int)cudaErrorInvalidValue;
    HaloConv hp;
    hp.x = static_cast<const int8_t*>(x);
    hp.w = static_cast<const int8_t*>(w);
    hp.w_zp = nullptr;
    hp.x_zp_img = static_cast<const int32_t*>(x_zp_img);
    hp.e = e;
    hp.out = static_cast<uint8_t*>(out);
    hp.h = h;
    hp.w_in = w_in;
    hp.ci = c;
    hp.co = o;
    hp.pad = 1;
    hp.h_out = h;
    hp.w_out = w_in;
    hp.k_pad = (9 * c + 31) / 32 * 32;
    hp.x_zp = x_zp;
    return (int)launch_halo_tile(hp, n, phases, static_cast<cudaStream_t>(stream));
  }
  if (route) *route = kRouteMma;
  Params p;
  p.x = static_cast<const int8_t*>(x);
  p.w = static_cast<const int8_t*>(w);
  p.x_zp_img = static_cast<const int32_t*>(x_zp_img);
  p.e = e;
  p.out = static_cast<int8_t*>(out);
  p.h = h;
  p.w_in = w_in;
  p.c = c;
  p.o = o;
  p.h2 = h / 2;
  p.w2 = w_in / 2;
  p.k_real = 36 * c;
  p.k_pad = (p.k_real + 31) / 32 * 32;
  p.n_pad = (4 * o + 15) / 16 * 16;
  p.x_zp = x_zp;
  p.rows = (int)rows;
  return (int)launch_tile(p, static_cast<cudaStream_t>(stream));
}

// Fused int8 conv + requant epilogue (+ optional 2x2/s2 maxpool) for Hopper.
//
// Replaces yolo_quantization_tpu/ops/pallas_qconv.py::pallas_quantized_conv2d
// (kernel body _qconv_kernel), and covers what the reference engine left to
// XLA beside it.  Same function: a stride-1 KxK conv over shifted-int8 NHWC
// codes padded with the input zero point, int8 x int8 -> int32 accumulation,
// then the epilogue of common.cuh; with fuse_pool the 2x2/s2 max is taken on
// the int32 accumulators before the epilogue (exact: the epilogue is monotone
// nondecreasing in the corrected accumulator, since m > 0).
//
// Options, all of one kernel (template or runtime parameters):
//   - asymmetric weights (ASYM): acc -= w_zp[o] * patchsum, the window sum
//     of the staged codes, padding taps included (yolo_quantization_tpu/ops/
//     qconv.py::conv_acc_int32); __dp4a(a, 0x01010101, ps) sums a word;
//   - a per-image input zero point (an (N,) device tensor) for the padding;
//   - per-image (N, Co) bias and m, read by pointer (no host sync);
//   - exact_leaky, darknet's double-rounded leaky;
//   - the int16 carrier (I16): codes staged as int16 pairs and multiplied
//     with plain int32 multiply-adds, a cross-check of the __dp4a path that
//     must give the same bits.
//
// What bounds it on the H100: int8 multiply-accumulates on the large 3x3
// layers (13x13 and 26x26 maps, up to 512->1024 channels), bytes on the
// 416^2 / 208^2 stem layers, whose few channels do little work per byte
// moved.  fuse_pool therefore keeps the pre-pool tensor (4x the pooled
// bytes) out of device memory on exactly those stem layers.
//
// Design (a simple first version; mma/wgmma s8, TMA and tuning come later):
//   - one block of 256 threads per (output spatial tile, tile of TC output
//     channels, image);
//   - input channels are walked in chunks of 16 shared-memory words (64
//     int8 channels, or 32 with I16); each chunk stages the zero-point-padded
//     input window (padding done on load, no padded copy in device memory)
//     and the chunk's weights in shared memory;
//   - each thread owns one 2x2 output window and 4 output channels (16 int32
//     accumulators) and accumulates word by word;
//     Cin % 4 != 0 (the 3-channel stem) is staged byte-wise with zero
//     channel padding, matching the zero-padded packed weights;
//   - weights arrive repacked as (Co, K, K, Cin_pad4) int8, i.e. int32
//     words of 4 input channels (see ops/cuda_qconv.py::pack_weights).

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using yq::Epilogue;
using yq::Word;

constexpr int kThreads = 256;
constexpr int kChunkWords = 16;  // shared-memory words per position and stage
constexpr int kMaxK = 3;

// CG threads share one 2x2 window, each with 4 channels: TC = 4*CG output
// channels per block, 256/CG windows arranged WY x WX.
template <int CG>
struct Tile {
  static constexpr int TC = 4 * CG;
  static constexpr int WINDOWS = kThreads / CG;
  static constexpr int WX = CG == 16 ? 4 : 8;
  static constexpr int WY = WINDOWS / WX;
  static constexpr int TH = 2 * WY;
  static constexpr int TW = 2 * WX;
  // odd word strides (+1) keep the per-thread shared loads conflict-free
  static constexpr int IN_WORDS = (TH + kMaxK - 1) * (TW + kMaxK - 1) * (kChunkWords + 1);
  static constexpr int W_WORDS = TC * (kMaxK * kMaxK * kChunkWords + 1);
};

struct Params {
  const int8_t* x;          // (N, H, W, Ci) shifted int8 codes
  const int8_t* w;          // (Co, K, K, Ci4 * 4) packed int8 weights
  const int32_t* w_zp;      // (Co,) shifted weight zero points (ASYM only)
  const int32_t* x_zp_img;  // (N,) per-image input zero point, or null
  Epilogue e;
  uint8_t* out;             // (N, Ho, Wo, Co), or pooled (N, Ho/2, Wo/2, Co)
  int h, w_in, ci, ci4, co, k, pad, h_out, w_out;
  int x_zp, pool, tiles_x;
};

template <int CG, bool ASYM, bool I16>
__global__ void __launch_bounds__(kThreads) qconv_kernel(const Params p) {
  using T = Tile<CG>;
  using Wd = Word<I16>;
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
  const int IW = T::TW + K - 1;
  const int npos = (T::TH + K - 1) * IW;
  const int x_zp = p.x_zp_img ? p.x_zp_img[img] : p.x_zp;
  const int8_t zp_code = (int8_t)x_zp;
  const uint32_t zp_word = (uint32_t)(uint8_t)zp_code * 0x01010101u;
  const bool word_aligned = !I16 && (p.ci & 3) == 0;
  const int nwords = (p.ci + L - 1) / L;  // shared words per pixel
  const size_t img_base = (size_t)img * p.h * p.w_in;
  const size_t w_row = (size_t)p.ci4 * 4;  // packed weight bytes per (o, tap)

  int acc[4][4];  // [channel j][pixel (dy*2+dx) of the 2x2 window]
  int ps[4];      // patchsum per pixel (ASYM)
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    ps[q] = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[j][q] = 0;
  }

  for (int c0 = 0; c0 < nwords; c0 += kChunkWords) {
    const int cw = min(kChunkWords, nwords - c0);
    const int ips = cw | 1;            // input word stride per position
    const int wrs = (KK * cw) | 1;     // weight word stride per channel
    __syncthreads();  // the previous chunk's reads are done

    for (int idx = t; idx < npos * cw; idx += kThreads) {
      const int pos = idx / cw, q = idx - pos * cw;
      const int py = pos / IW, px = pos - py * IW;
      const int iy = y0 - p.pad + py, ix = x0 - p.pad + px;
      const bool inside = iy >= 0 && iy < p.h && ix >= 0 && ix < p.w_in;
      const size_t pix = img_base + (size_t)iy * p.w_in + ix;
      uint32_t v;
      if (word_aligned) {
        v = inside ? reinterpret_cast<const uint32_t*>(p.x)[pix * p.ci4 + c0 + q] : zp_word;
      } else {
        v = 0;  // channels past Ci stay 0; their packed weights are 0 too
        const int c = L * (c0 + q);
#pragma unroll
        for (int b = 0; b < L; ++b) {
          if (c + b < p.ci) v |= Wd::lane(inside ? p.x[pix * p.ci + c + b] : zp_code, b);
        }
      }
      xs[pos * ips + q] = (int)v;
    }
    for (int idx = t; idx < T::TC * KK * cw; idx += kThreads) {
      const int ol = idx / (KK * cw), r = idx - ol * (KK * cw);
      const int tap = r / cw, q = r - tap * cw;
      const int o = o0 + ol;
      uint32_t v = 0;
      if (o < p.co) {
        const int8_t* wp = p.w + ((size_t)o * KK + tap) * w_row;
        if (I16) {
#pragma unroll
          for (int b = 0; b < L; ++b) v |= Wd::lane(wp[L * (c0 + q) + b], b);
        } else {
          v = reinterpret_cast<const uint32_t*>(wp)[c0 + q];
        }
      }
      ws[ol * wrs + r] = (int)v;
    }
    __syncthreads();

    for (int tap = 0; tap < KK; ++tap) {
      const int dy = tap / K, dx = tap - dy * K;
      const int* xp = xs + ((2 * wy + dy) * IW + 2 * wx + dx) * ips;
      const int* wp = ws + cg * wrs + tap * cw;
      for (int q = 0; q < cw; ++q) {
        const int a0 = xp[q];
        const int a1 = xp[ips + q];
        const int a2 = xp[IW * ips + q];
        const int a3 = xp[(IW + 1) * ips + q];
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
      // acc - w_zp[o] * patchsum in wrapping int32, as XLA's
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

template <int CG, bool ASYM, bool I16>
void launch(Params p, int n, cudaStream_t stream) {
  using T = Tile<CG>;
  p.tiles_x = (p.w_out + T::TW - 1) / T::TW;
  const int tiles_y = (p.h_out + T::TH - 1) / T::TH;
  const dim3 grid(p.tiles_x * tiles_y, (p.co + T::TC - 1) / T::TC, n);
  qconv_kernel<CG, ASYM, I16><<<grid, kThreads, 0, stream>>>(p);
}

template <bool ASYM, bool I16>
void launch_tile(const Params& p, int n, cudaStream_t s) {
  if (p.co <= 16) {
    launch<4, ASYM, I16>(p, n, s);
  } else if (p.co <= 32) {
    launch<8, ASYM, I16>(p, n, s);
  } else {
    launch<16, ASYM, I16>(p, n, s);
  }
}

}  // namespace

// Plain C entry for ctypes.  Shapes are validated by the Python wrapper;
// returns the launch's cudaError_t (0 on success).  w_zp null means
// symmetric weights, x_zp_img null the static x_zp; bm_per_image selects
// (N, Co) bias/m; carrier16 the int16 carrier.
extern "C" int yq_qconv(const void* x, const void* w, const void* w_zp, const void* x_zp_img,
                        const void* bias, const void* m, void* out, int n, int h, int w_in,
                        int ci, int co, int k, int pad, int x_zp, int out_zp, int act,
                        int exact_leaky, int out_i8, int fuse_pool, int bm_per_image,
                        int carrier16, void* stream) {
  if (n < 1 || n > 65535 || k < 1 || k > kMaxK || ci < 1 || co < 1 || pad < 0) {
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
  p.ci4 = (ci + 3) / 4;
  p.co = co;
  p.k = k;
  p.pad = pad;
  p.h_out = h + 2 * pad - k + 1;
  p.w_out = w_in + 2 * pad - k + 1;
  p.x_zp = x_zp;
  p.pool = fuse_pool;
  p.tiles_x = 1;
  if (p.h_out < 1 || p.w_out < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool asym = w_zp != nullptr;
  if (asym && carrier16) {
    launch_tile<true, true>(p, n, s);
  } else if (asym) {
    launch_tile<true, false>(p, n, s);
  } else if (carrier16) {
    launch_tile<false, true>(p, n, s);
  } else {
    launch_tile<false, false>(p, n, s);
  }
  return (int)cudaGetLastError();
}

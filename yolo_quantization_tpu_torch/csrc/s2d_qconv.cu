// Space-to-depth stem conv + 4-phase max + requant epilogue for Hopper.
//
// Replaces yolo_quantization_tpu/ops/pallas_qconv.py::pallas_s2d_conv_phase_max
// (kernel body _s2d_phase_kernel).  Same function: a 3x3/s1 conv over the
// 2x2 space-to-depth input xs (N, H/2, W/2, 4C), slot (qy*2+qx)*C + c
// holding pixel (2i+qy, 2j+qx, c), whose blocks are padded by 1 with the
// input zero point; the block kernel w_s2d (3, 3, 4C, 4O) from
// infer/convert.py::_s2d_weights, output slot (py*2+px)*O + o; then the max
// over the 4 output-phase groups on the int32 accumulators (the following
// 2x2/s2 maxpool of the original graph, exact because the epilogue is
// monotone); then the epilogue of common.cuh, emitting shifted int8.  Every
// tap of the block kernel is multiplied, its structural zeros included:
// 144*C*O multiply-accumulates per 2x2 block against a plain conv's 36*C*O.
//
// What bounds it on the H100: int8 multiply-accumulates on __dp4a (4x the
// stem conv's, for the zeros), then the bytes of the stem input (416^2 x 3
// codes per image on layer 0).  The design keeps both passes of the TPU
// kernel's HBM traffic away: x is read in NHWC with the s2d index map applied
// on load (no transposed or padded copy in device memory), and the 4x-channel
// accumulator never leaves registers.
//
// Design (simple first; mma s8 and tuning come later):
//   - one block of 256 threads per (8x8 tile of output blocks, 16 output
//     channels, image); 16 threads share a 2x2 window of output blocks, each
//     with one channel and its 4 phases (16 int32 accumulators);
//   - the 4C slots are walked in chunks of 16 words (64 slots); each chunk
//     stages the zero-point-padded input window and the chunk's weights in
//     shared memory.  For even C a slot word is 4 contiguous bytes of one
//     pixel row pair, loaded as one word; odd C (the 3-channel stem) loads
//     byte by byte;
//   - weights arrive repacked once as (4 phases, O, 3, 3, 4C) int8, i.e. int32
//     words of 4 slots (see ops/cuda_s2d.py::pack_weights).
// Options: a per-image input zero point ((N,) device tensor), per-image
// (N, O) bias and m, and exact_leaky, as in qconv.cu.

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using yq::Epilogue;
using Wd = yq::Word<false>;

constexpr int kThreads = 256;
constexpr int kChunkWords = 16;
constexpr int TC = 16;              // output channels per block (one per thread)
constexpr int WX = 4, WY = 4;       // 2x2 windows per block
constexpr int TH = 2 * WY, TW = 2 * WX;
constexpr int IH = TH + 2, IW = TW + 2;  // with the 1-block halo
constexpr int IN_WORDS = IH * IW * (kChunkWords + 1);
constexpr int W_WORDS = 4 * TC * (9 * kChunkWords + 1);

struct Params {
  const int8_t* x;          // (N, H, W, C) shifted int8 codes, NHWC
  const int32_t* w;         // (4, O, 3, 3, C) words of 4 slots
  const int32_t* x_zp_img;  // (N,) per-image input zero point, or null
  Epilogue e;
  int8_t* out;              // (N, H/2, W/2, O) shifted int8
  int h, w_in, c, o, h2, w2, x_zp, tiles_x;
};

__global__ void __launch_bounds__(kThreads) s2d_kernel(const Params p) {
  __shared__ int xs[IN_WORDS];
  __shared__ int ws[W_WORDS];

  const int t = threadIdx.x;
  const int cg = t % TC;
  const int win = t / TC;
  const int wy = win / WX, wx = win % WX;
  const int y0 = (blockIdx.x / p.tiles_x) * TH;
  const int x0 = (blockIdx.x % p.tiles_x) * TW;
  const int o0 = blockIdx.y * TC;
  const int img = blockIdx.z;
  const int C = p.c;
  const int nwords = C;  // 4C slots
  const int x_zp = p.x_zp_img ? p.x_zp_img[img] : p.x_zp;
  const int8_t zp_code = (int8_t)x_zp;
  const uint32_t zp_word = (uint32_t)(uint8_t)zp_code * 0x01010101u;
  const bool word_aligned = (C & 1) == 0;
  const size_t img_base = (size_t)img * p.h * p.w_in;

  int acc[4][4];  // [phase][block (dy*2+dx) of the 2x2 window]
#pragma unroll
  for (int ph = 0; ph < 4; ++ph)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[ph][q] = 0;

  for (int c0 = 0; c0 < nwords; c0 += kChunkWords) {
    const int cw = min(kChunkWords, nwords - c0);
    const int ips = cw | 1;
    const int wrs = (9 * cw) | 1;
    __syncthreads();

    for (int idx = t; idx < IH * IW * cw; idx += kThreads) {
      const int pos = idx / cw, q = idx - pos * cw;
      const int py = pos / IW, px = pos - py * IW;
      const int by = y0 - 1 + py, bx = x0 - 1 + px;
      const bool inside = by >= 0 && by < p.h2 && bx >= 0 && bx < p.w2;
      const int s = 4 * (c0 + q);  // first slot of the word
      uint32_t v;
      if (!inside) {
        v = zp_word;
      } else if (word_aligned) {
        // 2C slots per qy: pixels (2by+qy, 2bx) and (2bx+1) are adjacent
        const int qy = s / (2 * C), r = s - qy * 2 * C;
        const size_t off = (img_base + (size_t)(2 * by + qy) * p.w_in + 2 * bx) * C + r;
        v = reinterpret_cast<const uint32_t*>(p.x)[off >> 2];
      } else {
        v = 0;
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int sl = s + b;
          const int qy = sl / (2 * C), qx = (sl / C) & 1, c = sl % C;
          const size_t pix = img_base + (size_t)(2 * by + qy) * p.w_in + 2 * bx + qx;
          v |= Wd::lane(p.x[pix * C + c], b);
        }
      }
      xs[pos * ips + q] = (int)v;
    }
    // weights: ws[(phase * TC + ol) * wrs + tap * cw + q]
    for (int idx = t; idx < 4 * TC * 9 * cw; idx += kThreads) {
      const int col = idx / (9 * cw), r = idx - col * (9 * cw);
      const int ph = col / TC, ol = col - ph * TC;
      const int tap = r / cw, q = r - tap * cw;
      const int o = o0 + ol;
      ws[col * wrs + r] = o < p.o ? p.w[(((size_t)ph * p.o + o) * 9 + tap) * nwords + c0 + q] : 0;
    }
    __syncthreads();

    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3, dx = tap - dy * 3;
      const int* xp = xs + ((2 * wy + dy) * IW + 2 * wx + dx) * ips;
      const int* wp = ws + cg * wrs + tap * cw;
      for (int q = 0; q < cw; ++q) {
        const int a0 = xp[q];
        const int a1 = xp[ips + q];
        const int a2 = xp[IW * ips + q];
        const int a3 = xp[(IW + 1) * ips + q];
#pragma unroll
        for (int ph = 0; ph < 4; ++ph) {
          const int b = wp[ph * TC * wrs + q];
          acc[ph][0] = Wd::mac(a0, b, acc[ph][0]);
          acc[ph][1] = Wd::mac(a1, b, acc[ph][1]);
          acc[ph][2] = Wd::mac(a2, b, acc[ph][2]);
          acc[ph][3] = Wd::mac(a3, b, acc[ph][3]);
        }
      }
    }
  }

  const int o = o0 + cg;
  if (o >= p.o) return;
  const yq::Clamp cl = yq::clamp_of(p.e);
  const int bias = p.e.bias[(size_t)img * p.e.bm_stride + o];
  const float m = p.e.m[(size_t)img * p.e.bm_stride + o];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int oy = y0 + 2 * wy + (q >> 1), ox = x0 + 2 * wx + (q & 1);
    if (oy < p.h2 && ox < p.w2) {
      const int a = max(max(acc[0][q], acc[1][q]), max(acc[2][q], acc[3][q]));
      p.out[(((size_t)img * p.h2 + oy) * p.w2 + ox) * p.o + o] =
          (int8_t)yq::requant(a, bias, m, p.e, cl);
    }
  }
}

}  // namespace

// Plain C entry for ctypes.  Shapes are validated by the Python wrapper;
// returns the launch's cudaError_t (0 on success).
extern "C" int yq_s2d_qconv(const void* x, const void* w, const void* x_zp_img,
                            const void* bias, const void* m, void* out, int n, int h,
                            int w_in, int c, int o, int x_zp, int out_zp, int act,
                            int exact_leaky, int bm_per_image, void* stream) {
  if (n < 1 || n > 65535 || c < 1 || o < 1 || h < 2 || w_in < 2 || (h & 1) || (w_in & 1)) {
    return (int)cudaErrorInvalidValue;
  }
  Params p;
  p.x = static_cast<const int8_t*>(x);
  p.w = static_cast<const int32_t*>(w);
  p.x_zp_img = static_cast<const int32_t*>(x_zp_img);
  p.e.bias = static_cast<const int32_t*>(bias);
  p.e.m = static_cast<const float*>(m);
  p.e.bm_stride = bm_per_image ? o : 0;
  p.e.act = act;
  p.e.exact_leaky = exact_leaky;
  p.e.out_i8 = 1;
  p.e.out_zp = out_zp;
  p.out = static_cast<int8_t*>(out);
  p.h = h;
  p.w_in = w_in;
  p.c = c;
  p.o = o;
  p.h2 = h / 2;
  p.w2 = w_in / 2;
  p.x_zp = x_zp;
  p.tiles_x = (p.w2 + TW - 1) / TW;
  const int tiles_y = (p.h2 + TH - 1) / TH;
  const dim3 grid(p.tiles_x * tiles_y, (o + TC - 1) / TC, n);
  s2d_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

// The SPP block (YOLOv4's spatial pyramid pooling) on codes, one launch.
//
// Replaces, for the engine's block of the form "stride-1 pools of odd size
// over one input, single-layer routes back to it between them, a route
// concatenating them" (infer/engine.py::spp_plan; YOLOv4's layers 108-113:
// maxpools of 5, 9 and 13 over layer 107, then route -1,-3,-5,-6), the
// plain path's nn/layers.py::maxpool_u8 per pool (a torch.maximum a tap:
// 25 + 81 + 169 launches, each reading and writing the whole map) and the
// route's requant and concat.  Same function, bit for bit:
//   - each pool is darknet's stride-1 maxpool of size k = 2r + 1 with its
//     default padding k - 1, r cells on each side, padded with the domain
//     minimum (-128 in shifted int8 codes), as maxpool_u8 pads: a window's
//     max is the max over its cells inside the map;
//   - the max is separable, W then H, and a k-wide max is the 2r + 1 cells
//     about the centre, so one running max outwards from the centre gives
//     every pool's row max at its radius;
//   - the route's requant of a branch, round((q - z_in) ratio) + z_out
//     clamped (float32, rintf, each step rounded: infer/engine.py's route),
//     is monotone nondecreasing in q (ratio > 0), so it commutes with the
//     max and runs once an output code.
//
// A block takes one image, 16 channels (one 16-byte word a pixel) and a
// tile of TH x TW output pixels (the whole map where it fits 48 KB of
// shared memory: 19 x 19 at 608, 13 x 13 at 416).  It reads the tile's
// input codes and their halo of R = the largest radius once into shared
// memory (out-of-map cells set to -128), takes each pool's max along W
// for every halo row, then along H, and writes the output pixel's branches
// in route order, 16 bytes a branch.  Byte maxima are __vmaxs4 on words.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kMaxBranches = 8;
constexpr int kThreads = 256;
constexpr int kChunk = 16;  // channels a block takes: one uint4 a pixel
constexpr int kSmemLimit = 48 * 1024;
constexpr unsigned kDomainMin = 0x80808080u;  // -128 in each byte

struct Branch {
  int pool;     // index into SppParams::radius, or -1: the input itself
  int identity; // the route copies the codes
  float ratio;  // else round((q - zin) ratio) + zout, clamped
  int zin;      // shifted-int8 zero point of the branch
};

struct SppParams {
  const int8_t* x;  // (N, H, W, C) shifted int8 codes
  int8_t* out;      // (N, H, W, branches C), branch b at channels [b C, (b + 1) C)
  int h, w, c, branches, pools;
  int radius[kMaxBranches];  // each pool's radius, ascending and distinct
  int th, tw, tiles_x;       // the output tile, and tiles along W
  float zout;                // shifted-int8 zero point of the route
  Branch br[kMaxBranches];
};

__device__ __forceinline__ uint4 vmax(uint4 a, uint4 b) {
  return make_uint4(__vmaxs4(a.x, b.x), __vmaxs4(a.y, b.y), __vmaxs4(a.z, b.z), __vmaxs4(a.w, b.w));
}

// the route's requant of four shifted int8 codes
__device__ __forceinline__ unsigned requant4(unsigned w, const Branch& b, float zout) {
  unsigned r = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int q = (int)(int8_t)(uint8_t)(w >> (8 * k));
    float f = rintf(__fmul_rn(__int2float_rn(q - b.zin), b.ratio));
    f = fminf(fmaxf(__fadd_rn(f, zout), -128.f), 127.f);
    r |= (unsigned)(uint8_t)(int8_t)(int)f << (8 * k);
  }
  return r;
}

__global__ void __launch_bounds__(kThreads) spp_kernel(const SppParams p) {
  extern __shared__ uint4 sm[];
  const int R = p.radius[p.pools - 1];
  const int hh = p.th + 2 * R, hw = p.tw + 2 * R;
  uint4* const in = sm;             // [hh][hw] input codes and halo
  uint4* const rows = sm + hh * hw; // [pools][hh][tw] each pool's max along W
  const int c0 = blockIdx.y * kChunk, img = blockIdx.z;
  const int y0 = (blockIdx.x / p.tiles_x) * p.th, x0 = (blockIdx.x % p.tiles_x) * p.tw;

  for (int i = threadIdx.x; i < hh * hw; i += kThreads) {
    const int y = y0 - R + i / hw, x = x0 - R + i % hw;
    uint4 v = make_uint4(kDomainMin, kDomainMin, kDomainMin, kDomainMin);
    if (y >= 0 && y < p.h && x >= 0 && x < p.w) {
      v = __ldg(reinterpret_cast<const uint4*>(p.x + (((size_t)img * p.h + y) * p.w + x) * p.c + c0));
    }
    in[i] = v;
  }
  __syncthreads();

  for (int i = threadIdx.x; i < hh * p.tw; i += kThreads) {
    const int iy = i / p.tw, ox = i % p.tw;
    const uint4* const r = in + iy * hw + ox + R;
    uint4 m = r[0];
    int k = 0;
    for (int d = 1; d <= R; ++d) {
      m = vmax(m, vmax(r[-d], r[d]));
      if (d == p.radius[k]) rows[(k++ * hh + iy) * p.tw + ox] = m;
    }
  }
  __syncthreads();

  const int cs = p.c * p.branches;
  for (int i = threadIdx.x; i < p.th * p.tw; i += kThreads) {
    const int oy = i / p.tw, ox = i % p.tw, y = y0 + oy, x = x0 + ox;
    if (y >= p.h || x >= p.w) continue;
    int8_t* const o = p.out + (((size_t)img * p.h + y) * p.w + x) * cs + c0;
    for (int b = 0; b < p.branches; ++b) {
      const Branch& br = p.br[b];
      uint4 v;
      if (br.pool < 0) {
        v = in[(oy + R) * hw + ox + R];
      } else {
        const uint4* const col = rows + (br.pool * hh + oy + R) * p.tw + ox;
        v = col[0];
        for (int d = 1; d <= p.radius[br.pool]; ++d) v = vmax(v, vmax(col[-d * p.tw], col[d * p.tw]));
      }
      if (!br.identity) {
        v = make_uint4(requant4(v.x, br, p.zout), requant4(v.y, br, p.zout),
                       requant4(v.z, br, p.zout), requant4(v.w, br, p.zout));
      }
      *reinterpret_cast<uint4*>(o + b * p.c) = v;
    }
  }
}

__host__ int smem_bytes(int th, int tw, int r, int pools) {
  return ((th + 2 * r) * (tw + 2 * r) + pools * (th + 2 * r) * tw) * (int)sizeof(uint4);
}

}  // namespace

// Plain C entry for ctypes.  x (N, H, W, C) and out (N, H, W, branches C)
// shifted int8, 16-byte aligned, C a multiple of 16.  Branch b is the input
// itself where size[b] is 1, else its stride-1 pool of odd size size[b];
// identity[b] copies it, else it is requantized by (ratio[b], zin[b]) onto
// zout (shifted-int8 zero points).  Returns the launch's cudaError_t.
extern "C" int yq_spp(const void* x, void* out, int n, int h, int w, int c, int branches,
                      const int* size, const int* identity, const float* ratio, const int* zin,
                      int zout, void* stream) {
  if (n < 1 || n > 65535 || h < 1 || w < 1 || c < kChunk || c % kChunk || branches < 1 ||
      branches > kMaxBranches || (long long)n * h * w * c * branches > LLONG_MAX / 2) {
    return (int)cudaErrorInvalidValue;
  }
  SppParams p;
  p.x = static_cast<const int8_t*>(x);
  p.out = static_cast<int8_t*>(out);
  p.h = h;
  p.w = w;
  p.c = c;
  p.branches = branches;
  p.zout = (float)zout;
  // the distinct pool radii, ascending
  p.pools = 0;
  for (int r = 1; r <= 64; ++r) {
    for (int b = 0; b < branches; ++b) {
      if (size[b] == 2 * r + 1) {
        p.radius[p.pools++] = r;
        break;
      }
    }
  }
  for (int b = 0; b < branches; ++b) {
    if (size[b] != 1 && (size[b] < 3 || size[b] % 2 == 0 || size[b] > 129)) return (int)cudaErrorInvalidValue;
    p.br[b].pool = -1;
    for (int k = 0; k < p.pools; ++k) {
      if (size[b] == 2 * p.radius[k] + 1) p.br[b].pool = k;
    }
    p.br[b].identity = identity[b];
    p.br[b].ratio = ratio[b];
    p.br[b].zin = zin[b];
  }
  if (p.pools == 0) return (int)cudaErrorInvalidValue;
  const int R = p.radius[p.pools - 1];
  int t = 32;
  while (t > 1 && smem_bytes(h < t ? h : t, w < t ? w : t, R, p.pools) > kSmemLimit) --t;
  p.th = h < t ? h : t;
  p.tw = w < t ? w : t;
  const int smem = smem_bytes(p.th, p.tw, R, p.pools);
  if (smem > kSmemLimit) return (int)cudaErrorInvalidValue;
  p.tiles_x = (w + p.tw - 1) / p.tw;
  const int tiles = p.tiles_x * ((h + p.th - 1) / p.th);
  const dim3 grid(tiles, c / kChunk, n);
  spp_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

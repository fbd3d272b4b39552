// Device helpers shared by the port's int8 kernels (qconv.cu, s2d_qconv.cu,
// gemm_probe.cu): the requant epilogue, the per-device SM count, and
// inline-PTX wrappers of the int8 tensor-core pieces (mma.sync s8, ldmatrix,
// cp.async).
//
// The epilogue is bit-exact with the reference's XLA path
// (yolo_quantization_tpu/ops/qconv.py::requant_activate): (float) is a
// round-to-nearest conversion of the wrapping int32 sum acc + bias, one
// multiply by m[o], the leaky slope as a separate multiply, rintf (half to
// even, never roundf; rint_clamped), then the zero point and a clamp in
// float before the narrowing cast.  The _rn intrinsics keep nvcc from
// contracting any multiply and add into an FMA.
//
// Mish (YOLOv4) is a table on the rounded pre-activation r = rint(v), built
// in float64 at conversion (ops/qconv.py::mish_table): T[r - lo] inside it,
// the zero point below it, clamp(r + zp) above it.  It is requant<true>; a
// kernel chooses between requant<true> and requant<false> once, for its
// whole epilogue, by a runtime branch (with_act), so every design takes mish
// and every other activation's epilogue is the straight-line code it was (a
// mish branch in each element's requant cost yolov3 at 416, batch 64, 9% of
// its images/s on an H100).  K2 refuses mish: its phase max runs before the
// epilogue, and the table is not monotone.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace yq {

constexpr int ACT_LEAKY = 1;
constexpr int ACT_RELU = 2;
constexpr int ACT_RELU6 = 3;
constexpr int ACT_MISH = 4;

// What the epilogue reads: bias/m are (Co,) (bm_stride 0) or per image
// (N, Co) (bm_stride Co), read on the device by pointer.
struct Epilogue {
  const int32_t* bias;
  const float* m;
  int bm_stride;
  int act;
  int exact_leaky;  // darknet's double-rounded leaky, round(0.1 * round(v))
  int out_i8;       // shifted int8 codes, else uint8
  int out_zp;       // uint8-domain output zero point
  // ACT_MISH: the uint8 codes T[r - t_lo] for t_lo <= r < t_lo + t_len
  const uint8_t* table = nullptr;
  int t_lo = 0, t_len = 0;
};

// 1.5 * 2^23 (bits 0x4B400000): adding it to a float of magnitude below
// 2^22 rounds it to an integer k (half to even, the rounding mode) held as
// 0x4B400000 + k in the sum's bits
constexpr float kRoundMagic = 12582912.0f;
constexpr int kRoundMagicBits = 0x4B400000;

// The clamp in that representation: the zero point, and the bounds plus
// kRoundMagic (exact: small integers)
struct Clamp {
  float zps, lo_m, hi_m;
};

__device__ __forceinline__ Clamp clamp_of(const Epilogue& e) {
  const bool relu_like = e.act == ACT_RELU || e.act == ACT_RELU6;
  Clamp c;
  c.zps = (float)(e.out_i8 ? e.out_zp - 128 : e.out_zp);
  const float dom_lo = e.out_i8 ? -128.f : 0.f;
  c.lo_m = (relu_like ? fmaxf(c.zps, dom_lo) : dom_lo) + kRoundMagic;
  c.hi_m = (e.out_i8 ? 127.f : 255.f) + kRoundMagic;
  return c;
}

// rintf for the values the clamp keeps: exact below 2^22 in magnitude;
// beyond, the result stays past 2^21 on the same side, so it clamps alike.
// Two adds instead of a conversion (FRND), a slower pipe on the card.
__device__ __forceinline__ float rint_clamped(float v) {
  return __fsub_rn(__fadd_rn(v, kRoundMagic), kRoundMagic);
}

// The epilogue, computed in the kRoundMagic representation: rint(v) is v +
// kRoundMagic, the zero point an exact add, the clamp on the shifted
// bounds, and the code the sum's bits less kRoundMagicBits (its low byte is
// the code's).  Equal to rintf, a float add and a clamp and a truncating
// cast for every input: past 2^22 both sides clamp to the same bound.  The
// leaky slope as max(v, 0.1 v) (the larger for v < 0, v itself for v >= 0).
template <bool MISH = false>
__device__ __forceinline__ int requant(int acc, int bias, float m, const Epilogue& e,
                                       const Clamp& c) {
  // int32 add (wrapping, as XLA's), then f32, then the multiply
  const int a = (int)((unsigned)acc + (unsigned)bias);
  const float vf = __fmul_rn(__int2float_rn(a), m);
  float t;
  if constexpr (MISH) {
    // j exact: r is an integer below 2^22 in magnitude, or past 2^21 on
    // vf's side, below or above the table alike
    const float r = rint_clamped(vf);
    const float j = __fsub_rn(r, (float)e.t_lo);
    if (j < 0.f) return (int)c.zps;  // the zero point, as a code of the domain
    if (j < (float)e.t_len) {
      const int code = __ldg(e.table + (int)j);
      return e.out_i8 ? code - 128 : code;
    }
    t = __fadd_rn(r, kRoundMagic);
  } else if (e.act == ACT_LEAKY && e.exact_leaky) {  // round(0.1 * round(v)) below 0
    const float v = rint_clamped(vf);
    t = __fadd_rn(v < 0.f ? __fmul_rn(v, 0.1f) : v, kRoundMagic);
  } else {
    t = __fadd_rn(e.act == ACT_LEAKY ? fmaxf(vf, __fmul_rn(vf, 0.1f)) : vf, kRoundMagic);
  }
  return __float_as_int(fminf(fmaxf(__fadd_rn(t, c.zps), c.lo_m), c.hi_m)) - kRoundMagicBits;
}

// The epilogue's one choice of a kernel: f(Mish<true>{}) where it is mish,
// else f(Mish<false>{}); f's code calls requant<decltype(tag)::value>.
template <bool B>
struct Mish {
  static constexpr bool value = B;
};

template <class F>
__device__ __forceinline__ void with_act(const Epilogue& e, F&& f) {
  if (e.act == ACT_MISH) {
    f(Mish<true>{});
  } else {
    f(Mish<false>{});
  }
}

constexpr int kMaxDevices = 64;  // per-device launch facts

// The current device and its SM count, read once per device (per library:
// each .cu file has its own copy).
inline cudaError_t device_sms(int& dev, int& sms) {
  static int count[kMaxDevices] = {0};
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (count[dev] == 0) {
    err = cudaDeviceGetAttribute(&count[dev], cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
  }
  sms = count[dev];
  return cudaSuccess;
}

// ---- int8 tensor cores (sm_80+ warp-level PTX; CUTLASS's headers would
// lengthen every build) ----

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// d += a . b on one warp: a is 16x32 s8 (row-major fragment, 4 words), b is
// 32x8 s8 (column-major fragment, 2 words), d 16x8 s32.  Fragment layout,
// with g = lane / 4 and t = lane % 4: a[0] = row g, k 4t..4t+3; a[1] = row
// g+8, same k; a[2], a[3] = the same rows at k 16+4t..; b[0] = column g,
// k 4t..4t+3; b[1] = column g, k 16+4t..; d[0..1] = row g, columns 2t, 2t+1;
// d[2..3] = row g+8.  Without .satfinite the int32 sums wrap.
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8x8 b16 matrices (8 rows of 16 bytes each) from shared memory; lane l
// gives the row address of matrix l / 8, row l % 8 (16-byte aligned), and
// receives word l % 4 of row l / 4 of each matrix.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// The same with .trans: lane l receives column l / 4 of each matrix, rows
// 2 (l % 4) and 2 (l % 4) + 1 (b16 elements).  On bytes stored k-major (8
// rows of k, 16 bytes along n) a lane's word is (k 2t, n 2g), (k 2t, n 2g+1),
// (k 2t+1, n 2g), (k 2t+1, n 2g+1): Hopper has no 8-bit transpose, so a
// __byte_perm of two such words gives 4 k-bytes of one column.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// 16 bytes global -> shared without registers; src_bytes 0 writes zeros
// (and reads nothing).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes));
}

// the same through L1 (.ca), for data that neighbouring rows read again
__device__ __forceinline__ void cp_async16_l1(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

}  // namespace yq

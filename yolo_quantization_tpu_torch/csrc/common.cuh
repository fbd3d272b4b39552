// Device helpers shared by the port's int8 conv kernels (qconv.cu, s2d_qconv.cu).
//
// The epilogue is bit-exact with the reference's XLA path
// (yolo_quantization_tpu/ops/qconv.py::requant_activate): (float) is a
// round-to-nearest conversion of the wrapping int32 sum acc + bias, one
// multiply by m[o], the leaky slope as a separate multiply, rintf (half to
// even, never roundf), then the zero point and a clamp in float before the
// narrowing cast.  The _rn intrinsics keep nvcc from contracting any
// multiply and add into an FMA.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace yq {

constexpr int ACT_LEAKY = 1;
constexpr int ACT_RELU = 2;
constexpr int ACT_RELU6 = 3;

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
};

struct Clamp {
  float zps, lo, hi;
};

__device__ __forceinline__ Clamp clamp_of(const Epilogue& e) {
  const bool relu_like = e.act == ACT_RELU || e.act == ACT_RELU6;
  Clamp c;
  c.zps = (float)(e.out_i8 ? e.out_zp - 128 : e.out_zp);
  const float dom_lo = e.out_i8 ? -128.f : 0.f;
  c.lo = relu_like ? fmaxf(c.zps, dom_lo) : dom_lo;
  c.hi = e.out_i8 ? 127.f : 255.f;
  return c;
}

__device__ __forceinline__ int requant(int acc, int bias, float m, const Epilogue& e,
                                       const Clamp& c) {
  // int32 add (wrapping, as XLA's), then f32, then the multiply
  const int a = (int)((unsigned)acc + (unsigned)bias);
  float vf = __fmul_rn(__int2float_rn(a), m);
  float v;
  if (e.act == ACT_LEAKY && e.exact_leaky) {
    v = rintf(vf);
    if (v < 0.f) v = rintf(__fmul_rn(v, 0.1f));
  } else {
    if (e.act == ACT_LEAKY && vf < 0.f) vf = __fmul_rn(vf, 0.1f);
    v = rintf(vf);
  }
  return (int)fminf(fmaxf(__fadd_rn(v, c.zps), c.lo), c.hi);
}

// One 32-bit word of codes: 4 int8 lanes, or 2 int16 lanes with I16.
template <bool I16>
struct Word {
  static constexpr int kLanes = I16 ? 2 : 4;

  // a lane's code placed in its slot of the word
  __device__ static __forceinline__ uint32_t lane(int8_t code, int b) {
    return I16 ? (uint32_t)(uint16_t)(int16_t)code << (16 * b)
               : (uint32_t)(uint8_t)code << (8 * b);
  }

  // acc + the word dot product: __dp4a on int8 lanes; plain int32
  // multiply-adds on int16 lanes (the s16 x s16 -> s32 carrier)
  __device__ static __forceinline__ int mac(int a, int b, int acc) {
    if (I16) {
      return acc + (int)(int16_t)a * (int)(int16_t)b + (a >> 16) * (b >> 16);
    }
    return __dp4a(a, b, acc);
  }

  // acc + the sum of the word's lanes (the patchsum of asymmetric weights)
  __device__ static __forceinline__ int lane_sum(int a, int acc) {
    if (I16) return acc + (int)(int16_t)a + (a >> 16);
    return __dp4a(a, 0x01010101, acc);
  }
};

}  // namespace yq

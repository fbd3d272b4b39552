// Integer shortcut (residual add) for Hopper: one pass over two int8 tensors.
//
// Replaces the integer branch of the shortcut in
// yolo_quantization_tpu/infer/engine.py::build_forward, which XLA runs as one
// loop fusion (it is not a pallas_call).  Same function, code by code, on
// shifted int8 codes:
//   t = ((x * ra) + (skip * rb)) + cst
//   leaky: t < 0 ? t * 0.1f : t;  relu: max(t, 0);  relu6: min(max(t, 0), cap)
//   out = clamp(rintf(t) + (out_zp - 128), -128, 127)
// ra, rb, cst and cap are the host's float64 values cast to float32
// (ops/shortcut.py::shortcut_params).  Every float operation rounds on its own:
// the _rn intrinsics keep nvcc from contracting a multiply and an add into an
// FMA, which would move values near .5 ties by one code against the
// reference's un-jitted engine.  rintf rounds half to even, as jnp.round.
//
// What bounds it on the H100: bytes.  Each code reads 2 bytes and writes 1,
// against a handful of float operations, far below the card's ratio of
// operations to bytes.  So the design is one pass at full width: a thread
// moves 16 codes of each operand with one 16-byte load each and one 16-byte
// store, in a grid-stride loop over a few blocks per SM; a scalar tail takes
// the last n % 16 codes.  The operands must start on 16-byte boundaries (the
// wrapper checks).

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;

struct ShortcutArgs {
  float ra, rb, cst, cap, zps;  // zps: the shifted output zero point, out_zp - 128
  int act;
};

__device__ __forceinline__ uint32_t shortcut_code(int8_t x, int8_t k, const ShortcutArgs& a) {
  float t = __fadd_rn(__fadd_rn(__fmul_rn((float)x, a.ra), __fmul_rn((float)k, a.rb)), a.cst);
  if (a.act == yq::ACT_LEAKY) {
    if (t < 0.f) t = __fmul_rn(t, 0.1f);
  } else if (a.act == yq::ACT_RELU) {
    t = fmaxf(t, 0.f);
  } else if (a.act == yq::ACT_RELU6) {
    t = fminf(fmaxf(t, 0.f), a.cap);
  }
  return (uint32_t)(uint8_t)(int8_t)(int)fminf(fmaxf(__fadd_rn(rintf(t), a.zps), -128.f), 127.f);
}

// four codes of each operand, packed in a word
__device__ __forceinline__ uint32_t shortcut_word(uint32_t xw, uint32_t kw, const ShortcutArgs& a) {
  uint32_t o = 0;
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    o |= shortcut_code((int8_t)(xw >> (8 * b)), (int8_t)(kw >> (8 * b)), a) << (8 * b);
  }
  return o;
}

__global__ void __launch_bounds__(kThreads)
    shortcut_kernel(const uint4* __restrict__ x, const uint4* __restrict__ k, uint4* __restrict__ out,
                    long long n, ShortcutArgs a) {
  const long long nvec = n / 16;
  const long long first = (long long)blockIdx.x * kThreads + threadIdx.x;
  for (long long i = first; i < nvec; i += (long long)gridDim.x * kThreads) {
    const uint4 xv = __ldg(x + i), kv = __ldg(k + i);
    out[i] = make_uint4(shortcut_word(xv.x, kv.x, a), shortcut_word(xv.y, kv.y, a),
                        shortcut_word(xv.z, kv.z, a), shortcut_word(xv.w, kv.w, a));
  }
  if (first < n - nvec * 16) {  // the scalar tail: thread `first` takes code nvec * 16 + first
    const long long e = nvec * 16 + first;
    const int8_t* xb = reinterpret_cast<const int8_t*>(x);
    const int8_t* kb = reinterpret_cast<const int8_t*>(k);
    reinterpret_cast<uint8_t*>(out)[e] = (uint8_t)shortcut_code(xb[e], kb[e], a);
  }
}

}  // namespace

// Plain C entry for ctypes.  x, skip and out hold n shifted int8 codes each,
// 16-byte aligned (validated by the Python wrapper); act is the ACT_* code.
// Returns the launch's cudaError_t (0 on success).
extern "C" int yq_shortcut(const void* x, const void* skip, void* out, long long n, float ra,
                           float rb, float cst, float cap, int act, int out_zp, void* stream) {
  if (n < 1 || act < 0 || act > yq::ACT_RELU6 || out_zp < 0 || out_zp > 255) {
    return (int)cudaErrorInvalidValue;
  }
  int dev = 0, sms = 0;
  const cudaError_t err = yq::device_sms(dev, sms);
  if (err != cudaSuccess) return err;
  const ShortcutArgs a{ra, rb, cst, cap, (float)(out_zp - 128), act};
  const long long chunks = n / 16 > 16 ? n / 16 : 16;  // at least the tail's threads
  const long long want = (chunks + kThreads - 1) / kThreads;
  const int blocks = (int)(want < (long long)sms * kBlocksPerSm ? want : (long long)sms * kBlocksPerSm);
  shortcut_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(x), static_cast<const uint4*>(skip), static_cast<uint4*>(out), n, a);
  return (int)cudaGetLastError();
}

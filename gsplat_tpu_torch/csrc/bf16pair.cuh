// bf16-pair carriers: two float32 values rounded to bfloat16 and held in one
// float32-typed word, (bf16(hi) << 16) | bf16(lo), the layout of
// gsplat_tpu/ops/mxu.py:pack_bf16_pair (:264-285) and of the port's
// ops/bf16pair.py.  Each half rounds to nearest, ties to even
// (__float2bfloat16_rn: denormals and -0 kept, overflow to inf), as
// PyTorch's float32 -> bfloat16 conversion does, so a kernel's carriers equal
// its plain version's bit for bit.  Zero bits unpack to exact zeros.
//
// Used by the packed emission (expand.cu, K4), the packed composite
// (rasterize_fwd.cu, K1) and its backward (rasterize_bwd.cu, K2).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace gs {

__device__ __forceinline__ float pack_bf16_pair(float hi, float lo) {
  const unsigned h = __bfloat16_as_ushort(__float2bfloat16_rn(hi));
  const unsigned l = __bfloat16_as_ushort(__float2bfloat16_rn(lo));
  return __uint_as_float((h << 16) | l);
}

__device__ __forceinline__ float bf16_hi(float carrier) {
  return __uint_as_float(__float_as_uint(carrier) & 0xffff0000u);
}

__device__ __forceinline__ float bf16_lo(float carrier) {
  return __uint_as_float(__float_as_uint(carrier) << 16);
}

}  // namespace gs

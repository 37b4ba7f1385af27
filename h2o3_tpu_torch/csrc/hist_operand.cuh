// The histogram kernels' operand modes. The TPU kernels take their values
// (g, h and the count weight, each masked by the row's node) as float32 or
// as bf16 operands with float32 accumulation (h2o3_tpu/ops/pallas_histogram.py
// `_resolve_hist_dtype` :438; the casts feeding `_nm_kernel` :194,
// `_fact_kernel` :319 and `_hist_kernel` in `_prep_padded` :424). Here a
// kernel instantiated with kBf16 rounds each value to bf16 (round to nearest
// even) where it reads it and sums the rounded values in float exactly as
// the float32 instantiation sums the values themselves. A count without a
// weight stays 1, which bf16 holds exactly. The float32 instantiation reads
// the value untouched: the same code, and the same bits, as before the mode.
#pragma once

#include <cuda_bf16.h>

template <bool kBf16>
__device__ __forceinline__ float hist_operand(float v) {
  if constexpr (kBf16) {
    return __bfloat162float(__float2bfloat16_rn(v));
  } else {
    return v;
  }
}

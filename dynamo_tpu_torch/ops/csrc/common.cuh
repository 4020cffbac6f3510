// Helpers shared by the attention kernels of dynamo_tpu_torch/ops/csrc.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace dtt {

// Finite "minus infinity" of the online softmax, as in the JAX kernels: a
// fully masked row keeps m = NEG_INF, so exp(m_old - m_new) stays finite, and
// masked slots get p = 0 explicitly instead of exp(NEG_INF - m).
constexpr float NEG_INF = -1e30f;

// 8 bf16 values (one 16-byte load) -> 8 floats.
__device__ __forceinline__ void unpack8(const uint4& u, float* dst) {
    const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const float2 f = __bfloat1622float2(p[i]);
        dst[2 * i] = f.x;
        dst[2 * i + 1] = f.y;
    }
}

__device__ __forceinline__ void zero8(float* dst) {
#pragma unroll
    for (int i = 0; i < 8; ++i) dst[i] = 0.f;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
        v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
    return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
        v += __shfl_xor_sync(0xffffffffu, v, o);
    return v;
}

// Gemma2 score softcap, applied before masking; softcap <= 0 means off.
__device__ __forceinline__ float cap_score(float s, float softcap) {
    return softcap > 0.f ? tanhf(s / softcap) * softcap : s;
}

}  // namespace dtt

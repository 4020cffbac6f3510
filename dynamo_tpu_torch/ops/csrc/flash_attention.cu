// Flash attention for prefill chunks, hand-written for Hopper (sm_90a).
//
// Replaces: dynamo_tpu/ops/attention.py:flash_attention (Pallas kernel
// _flash_kernel). Same contract: q [B,T,Hq,Dh], gathered GQA context k/v
// [B,S,Hkv,Dh] (bf16), explicit positions q_pos [B,T] / k_pos [B,S] (int32)
// and validity k_valid [B,S] (bool). A query at position p attends to keys
// with k_pos <= p and k_valid, and on sliding layers also k_pos > p - window.
// The softcap tanh(s/c)*c comes before masking; a fully masked row gives 0.
// Output [B,T,Hq,Dh] bf16; m, l and the accumulator stay in f32.
//
// Bound on the H100: for a first 512-token chunk of Llama-3-8B (Hq=32,
// Dh=128) one layer moves about 10 MB of q/k/v/out (about 3 us at
// 3.35 TB/s) and does 2*512*512*32*128 = 2.1 GFLOP of causal products
// (about 2.2 us at 989 TFLOP/s in bf16): the two are close, and a long
// context makes it bound by operations.
//
// Design: one block of 256 threads per (tile of 64 query rows, q head, b);
// four threads share a query row, each holding a quarter of the head dim
// (d = part + 4*i, so neighbouring threads read neighbouring shared-memory
// words). The Pallas grid's sequential key axis becomes a loop inside the
// block: each key tile is staged once in shared memory as f32, and the
// online softmax is updated every 16 keys. The [T,S] score matrix never
// reaches device memory. A key tile that no query of the block can see
// (causally in the future, invalid, or wholly below every query's window) is
// skipped before its K/V are loaded. This first version multiplies with
// f32 FMAs on the CUDA cores; tensor cores (wgmma), TMA loads and
// warp-specialised pipelining are the next step toward the bound.

#include <climits>

#include "common.cuh"

namespace {

constexpr int BQ = 64;           // query rows per block
constexpr int PARTS = 4;         // threads per query row
constexpr int NT = BQ * PARTS;   // threads per block
constexpr int KC = 16;           // keys per online-softmax update

template <int DH, int BK>
__global__ void __launch_bounds__(NT)
flash_kernel(const __nv_bfloat16* __restrict__ q,
             const __nv_bfloat16* __restrict__ k,
             const __nv_bfloat16* __restrict__ v,
             const int* __restrict__ q_pos,
             const int* __restrict__ k_pos,
             const unsigned char* __restrict__ k_valid,
             __nv_bfloat16* __restrict__ out,
             int T, int S, int Hq, int G,
             long long q_sb, long long q_st, long long q_sh,
             long long k_sb, long long k_ss, long long k_sh,
             long long v_sb, long long v_ss, long long v_sh,
             float scale, float softcap, int window) {
    constexpr int DP = DH / PARTS;   // head-dim elements per thread
    constexpr int C8 = DH / 8;       // 16-byte chunks per K/V row
    extern __shared__ float smem[];
    float* Ks = smem;                                  // [BK][DH]
    float* Vs = Ks + BK * DH;                          // [BK][DH]
    int* Kp = reinterpret_cast<int*>(Vs + BK * DH);    // [BK] key positions
    int* Kv = Kp + BK;                                 // [BK] key validity
    __shared__ int q_lo, q_hi;                         // block's query range

    const int tid = threadIdx.x;
    const int row = tid / PARTS;
    const int part = tid % PARTS;
    const int h = blockIdx.y;
    const int b = blockIdx.z;
    const int hk = h / G;
    const int t = blockIdx.x * BQ + row;
    const bool row_ok = t < T;

    float qr[DP];
    const __nv_bfloat16* qp = q + b * q_sb + (long long)(row_ok ? t : 0) * q_st
                              + h * q_sh + part;
#pragma unroll
    for (int i = 0; i < DP; ++i)
        qr[i] = row_ok ? __bfloat162float(qp[PARTS * i]) : 0.f;
    const int my_pos = row_ok ? q_pos[(long long)b * T + t] : 0;

    if (tid == 0) {
        q_lo = INT_MAX;
        q_hi = INT_MIN;
    }
    __syncthreads();
    if (row_ok && part == 0) {
        atomicMin(&q_lo, my_pos);
        atomicMax(&q_hi, my_pos);
    }
    __syncthreads();
    const int lo = q_lo, hi = q_hi;

    float m = dtt::NEG_INF, l = 0.f;
    float acc[DP];
#pragma unroll
    for (int i = 0; i < DP; ++i) acc[i] = 0.f;

    for (int k0 = 0; k0 < S; k0 += BK) {
        int seen = 0;
        if (tid < BK) {
            const int kk = k0 + tid;
            int kp = 0, kv = 0;
            if (kk < S) {
                kp = k_pos[(long long)b * S + kk];
                kv = k_valid[(long long)b * S + kk] ? 1 : 0;
            }
            Kp[tid] = kp;
            Kv[tid] = kv;
            seen = kv && kp <= hi && (window <= 0 || kp > lo - window);
        }
        // barrier + vote: skip the tile when no query of the block sees it
        if (!__syncthreads_or(seen)) continue;

        for (int idx = tid; idx < BK * C8; idx += NT) {
            const int r = idx / C8;
            const int c = (idx % C8) * 8;
            const int kk = k0 + r;
            float* kd = Ks + r * DH + c;
            float* vd = Vs + r * DH + c;
            if (kk < S) {
                dtt::unpack8(*reinterpret_cast<const uint4*>(
                                 k + b * k_sb + kk * k_ss + hk * k_sh + c), kd);
                dtt::unpack8(*reinterpret_cast<const uint4*>(
                                 v + b * v_sb + kk * v_ss + hk * v_sh + c), vd);
            } else {
                dtt::zero8(kd);
                dtt::zero8(vd);
            }
        }
        __syncthreads();

        for (int kc = 0; kc < BK; kc += KC) {
            float s[KC];
            unsigned live = 0u;
#pragma unroll
            for (int j = 0; j < KC; ++j) {
                const float* kr = Ks + (kc + j) * DH + part;
                float a = 0.f;
#pragma unroll
                for (int i = 0; i < DP; ++i) a = fmaf(qr[i], kr[PARTS * i], a);
                a += __shfl_xor_sync(0xffffffffu, a, 1);
                a += __shfl_xor_sync(0xffffffffu, a, 2);
                a = dtt::cap_score(a * scale, softcap);
                const int kp = Kp[kc + j];
                const bool ok = Kv[kc + j] && kp <= my_pos
                                && (window <= 0 || kp > my_pos - window);
                s[j] = ok ? a : dtt::NEG_INF;
                live |= (ok ? 1u : 0u) << j;
            }
            if (live == 0u) continue;   // nothing visible: state unchanged
            float mc = dtt::NEG_INF;
#pragma unroll
            for (int j = 0; j < KC; ++j) mc = fmaxf(mc, s[j]);
            const float m_new = fmaxf(m, mc);
            const float alpha = expf(m - m_new);
            float ps = 0.f;
#pragma unroll
            for (int j = 0; j < KC; ++j) {
                s[j] = ((live >> j) & 1u) ? expf(s[j] - m_new) : 0.f;
                ps += s[j];
            }
            l = l * alpha + ps;
#pragma unroll
            for (int i = 0; i < DP; ++i) {
                const float* vc = Vs + kc * DH + part + PARTS * i;
                float a = acc[i] * alpha;
#pragma unroll
                for (int j = 0; j < KC; ++j) a = fmaf(s[j], vc[j * DH], a);
                acc[i] = a;
            }
            m = m_new;
        }
        __syncthreads();
    }

    if (row_ok) {
        const float den = l == 0.f ? 1.f : l;
        __nv_bfloat16* op = out + (((long long)b * T + t) * Hq + h) * DH + part;
#pragma unroll
        for (int i = 0; i < DP; ++i) op[PARTS * i] = __float2bfloat16(acc[i] / den);
    }
}

template <int DH, int BK>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* q_pos, const int* k_pos,
                   const unsigned char* k_valid, void* out,
                   int B, int T, int S, int Hq, int Hkv,
                   long long q_sb, long long q_st, long long q_sh,
                   long long k_sb, long long k_ss, long long k_sh,
                   long long v_sb, long long v_ss, long long v_sh,
                   float scale, float softcap, int window,
                   cudaStream_t stream) {
    const size_t smem = 2 * sizeof(float) * BK * DH + 2 * sizeof(int) * BK;
    cudaError_t e = cudaFuncSetAttribute(
        flash_kernel<DH, BK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
    const dim3 grid((T + BQ - 1) / BQ, Hq, B);
    flash_kernel<DH, BK><<<grid, NT, smem, stream>>>(
        static_cast<const __nv_bfloat16*>(q),
        static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), q_pos, k_pos, k_valid,
        static_cast<__nv_bfloat16*>(out), T, S, Hq, Hq / Hkv,
        q_sb, q_st, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
        scale, softcap, window);
    return cudaGetLastError();
}

}  // namespace

// Returns the cudaError_t of the launch (0 = success). Strides are in
// elements; the head dim must be contiguous and 16-byte aligned.
extern "C" int dtt_flash_attention(
    const void* q, const void* k, const void* v, const void* q_pos,
    const void* k_pos, const void* k_valid, void* out,
    int B, int T, int S, int Hq, int Hkv, int Dh,
    long long q_sb, long long q_st, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    float scale, float softcap, int window, void* stream) {
    const int* qp = static_cast<const int*>(q_pos);
    const int* kp = static_cast<const int*>(k_pos);
    const unsigned char* kv = static_cast<const unsigned char*>(k_valid);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
#define DTT_FLASH(DH, BK)                                                    \
    launch<DH, BK>(q, k, v, qp, kp, kv, out, B, T, S, Hq, Hkv, q_sb, q_st,   \
                   q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, scale, softcap, \
                   window, st)
    switch (Dh) {
        case 64: return (int)DTT_FLASH(64, 64);
        case 128: return (int)DTT_FLASH(128, 64);
        case 256: return (int)DTT_FLASH(256, 32);
        default: return (int)cudaErrorInvalidValue;
    }
#undef DTT_FLASH
}

// Paged decode attention, hand-written for Hopper (sm_90a).
//
// Replaces: dynamo_tpu/ops/attention.py:_paged_attention_tpu (Pallas kernel
// _paged_dma_kernel, the TPU serving variant) and
// dynamo_tpu/ops/attention.py:paged_attention (Pallas kernel _paged_kernel,
// the one-page-per-step variant); both compute the same function. One query
// token per sequence, q [B,Hq,Dh], reads K/V straight from one layer of the
// page pool [Hkv,n_pages,page,Dh] (bf16) through page_tables [B,P] (int32,
// padded with page 0) and lengths [B] (int32, clamped to >= 1). Sequence b
// attends to tokens [0, len), or [max(0, len - window), len) on sliding
// layers; the softcap comes before masking; scale defaults to rsqrt(Dh).
//
// Bound on the H100: bytes. For Llama-3-8B at B=8 and 1024 tokens of context
// one layer must read 8*1024*8*128*2*2 B = 33.5 MB of K/V, about 10 us at
// 3.35 TB/s, against only 4 FLOP per byte of compute.
//
// Design: one block of 256 threads per (kv head, sequence), so every page is
// read once for the whole GQA group of G query heads. The block reads its own
// page-table row and length. The Pallas grid's sequential page axis becomes a
// loop inside the block over tiles of TK tokens starting at the window's
// first token, so only the pages of [start, len) are ever touched: a sliding
// layer reads O(window) bytes. Each tile of K and V is staged in shared memory
// as f32 with 16-byte loads (the K rows padded by one word so the per-token
// dot products read without bank conflicts); scores, the per-head online
// softmax (one warp per head) and the accumulator live in shared memory. This
// first version keeps a single block per (kv head, sequence) and loads
// synchronously; spreading long contexts over more blocks (split-K), cp.async
// or TMA double buffering are the next steps toward the byte bound.

#include "common.cuh"

namespace {

constexpr int NT = 256;          // threads per block
constexpr int NW = NT / 32;      // warps per block

template <int DH, int TK>
__global__ void __launch_bounds__(NT)
paged_kernel(const __nv_bfloat16* __restrict__ q,
             const __nv_bfloat16* __restrict__ k_pages,
             const __nv_bfloat16* __restrict__ v_pages,
             const int* __restrict__ page_tables,
             const int* __restrict__ lengths,
             __nv_bfloat16* __restrict__ out,
             int Hq, int n_pages, int page, int P, int G,
             float scale, float softcap, int window) {
    constexpr int KS = DH + 1;   // padded K row stride
    constexpr int C8 = DH / 8;   // 16-byte chunks per K/V row
    extern __shared__ float smem[];
    float* Ks = smem;                 // [TK][KS]
    float* Vs = Ks + TK * KS;         // [TK][DH]
    float* Qs = Vs + TK * DH;         // [G][DH]
    float* Ps = Qs + G * DH;          // [G][TK] scores, then probabilities
    float* Acc = Ps + G * TK;         // [G][DH]
    float* Ms = Acc + G * DH;         // [G] running max
    float* Ls = Ms + G;               // [G] running sum
    float* As = Ls + G;               // [G] this tile's rescale factor

    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const int hk = blockIdx.x;
    const int b = blockIdx.y;
    const int len = min(max(lengths[b], 1), P * page);
    const int start = window > 0 ? max(len - window, 0) : 0;

    const __nv_bfloat16* qb = q + ((long long)b * Hq + (long long)hk * G) * DH;
    for (int i = tid; i < G * DH; i += NT) {
        Qs[i] = __bfloat162float(qb[i]);
        Acc[i] = 0.f;
    }
    for (int g = tid; g < G; g += NT) {
        Ms[g] = dtt::NEG_INF;
        Ls[g] = 0.f;
    }
    __syncthreads();

    const int* pt = page_tables + (long long)b * P;
    const long long head_rows = (long long)hk * n_pages * page;
    for (int t0 = start; t0 < len; t0 += TK) {
        const int jn = min(TK, len - t0);   // live tokens in this tile

        for (int idx = tid; idx < TK * C8; idx += NT) {
            const int r = idx / C8;
            const int c = (idx % C8) * 8;
            float* kd = Ks + r * KS + c;
            float* vd = Vs + r * DH + c;
            if (r < jn) {
                const int tt = t0 + r;
                const long long off =
                    (head_rows + (long long)pt[tt / page] * page + tt % page)
                    * DH + c;
                dtt::unpack8(*reinterpret_cast<const uint4*>(k_pages + off), kd);
                dtt::unpack8(*reinterpret_cast<const uint4*>(v_pages + off), vd);
            } else {
                dtt::zero8(kd);
                dtt::zero8(vd);
            }
        }
        __syncthreads();

        for (int i = tid; i < G * TK; i += NT) {
            const int g = i / TK;
            const int j = i % TK;
            const float* qg = Qs + g * DH;
            const float* kr = Ks + j * KS;
            float a = 0.f;
#pragma unroll 8
            for (int d = 0; d < DH; ++d) a = fmaf(qg[d], kr[d], a);
            Ps[i] = j < jn ? dtt::cap_score(a * scale, softcap) : dtt::NEG_INF;
        }
        __syncthreads();

        for (int g = warp; g < G; g += NW) {
            float* pg = Ps + g * TK;
            float mc = dtt::NEG_INF;
            for (int j = lane; j < TK; j += 32) mc = fmaxf(mc, pg[j]);
            mc = dtt::warp_max(mc);
            const float m_old = Ms[g];
            const float m_new = fmaxf(m_old, mc);
            const float alpha = expf(m_old - m_new);
            float ps = 0.f;
            for (int j = lane; j < TK; j += 32) {
                const float p = j < jn ? expf(pg[j] - m_new) : 0.f;
                pg[j] = p;
                ps += p;
            }
            ps = dtt::warp_sum(ps);
            __syncwarp();
            if (lane == 0) {
                Ms[g] = m_new;
                Ls[g] = Ls[g] * alpha + ps;
                As[g] = alpha;
            }
        }
        __syncthreads();

        for (int i = tid; i < G * DH; i += NT) {
            const int g = i / DH;
            const int d = i % DH;
            const float* pg = Ps + g * TK;
            float a = Acc[i] * As[g];
            for (int j = 0; j < jn; ++j) a = fmaf(pg[j], Vs[j * DH + d], a);
            Acc[i] = a;
        }
        __syncthreads();
    }

    __nv_bfloat16* ob = out + ((long long)b * Hq + (long long)hk * G) * DH;
    for (int i = tid; i < G * DH; i += NT) {
        const float l = Ls[i / DH];
        ob[i] = __float2bfloat16(Acc[i] / (l == 0.f ? 1.f : l));
    }
}

template <int DH, int TK>
cudaError_t launch(const void* q, const void* k_pages, const void* v_pages,
                   const int* page_tables, const int* lengths, void* out,
                   int B, int Hq, int Hkv, int n_pages, int page, int P,
                   float scale, float softcap, int window,
                   cudaStream_t stream) {
    const int G = Hq / Hkv;
    const size_t smem = sizeof(float) * (TK * (DH + 1) + TK * DH
                                         + 2 * G * DH + G * TK + 3 * G);
    cudaError_t e = cudaFuncSetAttribute(
        paged_kernel<DH, TK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
    const dim3 grid(Hkv, B);
    paged_kernel<DH, TK><<<grid, NT, smem, stream>>>(
        static_cast<const __nv_bfloat16*>(q),
        static_cast<const __nv_bfloat16*>(k_pages),
        static_cast<const __nv_bfloat16*>(v_pages), page_tables, lengths,
        static_cast<__nv_bfloat16*>(out), Hq, n_pages, page, P, G,
        scale, softcap, window);
    return cudaGetLastError();
}

}  // namespace

// Returns the cudaError_t of the launch (0 = success). q [B,Hq,Dh] and the
// pools [Hkv,n_pages,page,Dh] are contiguous and 16-byte aligned.
extern "C" int dtt_paged_attention(
    const void* q, const void* k_pages, const void* v_pages,
    const void* page_tables, const void* lengths, void* out,
    int B, int Hq, int Hkv, int Dh, int n_pages, int page, int P,
    float scale, float softcap, int window, void* stream) {
    const int* pt = static_cast<const int*>(page_tables);
    const int* ln = static_cast<const int*>(lengths);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
#define DTT_PAGED(DH, TK)                                                    \
    launch<DH, TK>(q, k_pages, v_pages, pt, ln, out, B, Hq, Hkv, n_pages,    \
                   page, P, scale, softcap, window, st)
    switch (Dh) {
        case 64: return (int)DTT_PAGED(64, 64);
        case 128: return (int)DTT_PAGED(128, 64);
        case 256: return (int)DTT_PAGED(256, 32);
        default: return (int)cudaErrorInvalidValue;
    }
#undef DTT_PAGED
}

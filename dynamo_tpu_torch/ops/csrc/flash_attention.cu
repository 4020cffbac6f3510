// Flash attention for prefill chunks, hand-written for Hopper (sm_90a).
//
// Replaces: dynamo_tpu/ops/attention.py:_flash_kernel (the pallas_call at
// :166). Same contract: q [B,T,Hq,Dh], gathered GQA context k/v
// [B,S,Hkv,Dh] (bf16), explicit positions q_pos [B,T] / k_pos [B,S] (int32)
// and validity k_valid [B,S] (bool). A query at position p attends to keys
// with k_pos <= p and k_valid, and on sliding layers also k_pos > p - window.
// The softcap tanh(s/c)*c comes before masking; a fully masked row gives 0.
// Output [B,T,Hq,Dh] bf16; m, l and the accumulator stay in f32.
//
// Bound on the H100: a 512-token chunk of Llama-3-8B (Hq=32, Hkv=8, Dh=128)
// over a 1024-token context does 4*Dh*Hq flops per visible (query, key)
// pair, 9.8 GFLOP for two lanes: 9.9 us at 989 TFLOP/s (bf16 tensor cores),
// against 3.8 us for its 12.6 MB of q/k/v/out at 3.35 TB/s. Long contexts
// are bound by operations; a first chunk (T = S = 512, causal) sits near the
// line of the two. mma.sync reaches only about two thirds of that bf16 rate
// on this card (ops/flash_probe.py measures it).
//
// Design (what it does about that bound):
// - Both products run on the tensor cores: mma.sync.m16n8k16 bf16 -> f32.
//   S = Q.K^T takes K through ldmatrix.x4; O += P.V takes V through
//   ldmatrix.x4.trans, all of a k-step's V fragments before its MMAs; P is
//   re-packed from the S accumulators into bf16 A fragments in registers
//   (the Pallas kernel casts p to bf16 before P.V in the same way), so
//   scores never touch shared memory.
// - One block of 4 warps per (64 rows, kv head, sequence). The rows are the
//   flattened (position, query head of the group) pairs of that kv head, as
//   the Pallas block [G, BT, Dh] holds the whole GQA group: each K/V tile
//   reaches shared memory once per group, not once per query head. Each
//   warp owns 16 rows (the m16 of the MMA); masks depend only on a row's
//   position, which each thread keeps in registers.
// - K/V tiles are staged as bf16 in a two-stage ring filled by 16-byte
//   cp.async copies, so tile j+1 loads while tile j computes. Rows are
//   padded by 16 bytes, which makes every ldmatrix conflict-free for any
//   global row stride that is a multiple of 8 elements (the serve path
//   passes a permuted view of a pool gather).
// - Q fragments stay in registers for the whole key loop (Dh <= 128); at
//   Dh = 256 they are re-read from shared memory each tile instead, so the
//   f32 accumulator (128 registers a thread) fits without spilling.
// - Online softmax per row in registers: the row max is reduced across the
//   four threads of a quad once per key tile, the row sum once at the end.
//   The finite -1e30 sentinel and explicit p = 0 for masked slots keep a
//   fully masked row at exactly 0. A tile whose every key every row of the
//   block sees (a vote at the tile's barrier) skips the mask and folds the
//   scale into one FMA before each exp.
// - The block computes its live key tiles up front (a key is live if some
//   row of the block can see it: valid, not in the causal future, not below
//   every row's window) and loads and multiplies only the tiles between the
//   first and the last live one.
// Next step toward the bound: wgmma with TMA loads into an mbarrier ring
// and warp specialisation (a producer warp, two consumer warpgroups).

#include <cfloat>
#include <climits>

#include "common.cuh"

namespace {

constexpr int NW = 4;             // warps per block, 16 rows (one m16) each
constexpr int NT = NW * 32;       // threads per block
constexpr int BM = NW * 16;       // rows (position x group head) per block

using bf16 = __nv_bfloat16;

// a key's position, or INT_MAX (never visible) when it is invalid or past
// S; the two loads are independent, so they share one round trip
__device__ __forceinline__ int key_code(const int* k_pos,
                                        const unsigned char* k_valid,
                                        long long base, int key, int S) {
    if (key >= S) return INT_MAX;
    const int p = k_pos[base + key];
    return k_valid[base + key] ? p : INT_MAX;
}

// shared memory: Q [BM][DH+8], the two-slot K and V rings [2][BK][DH+8]
// each, and the ring's key codes [2][BK]
template <int DH, int BK>
constexpr size_t smem_bytes() {
    return sizeof(bf16) * (BM + 4 * BK) * (DH + 8) + sizeof(int) * 2 * BK;
}

// DH head dim, BK keys per tile; QREG: Q fragments stay in registers for
// the whole key loop (else they are re-read from shared memory each tile,
// which keeps the Dh=256 accumulator within the register file)
template <int DH, int BK, bool QREG>
__global__ void __launch_bounds__(NT)
flash_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
             const bf16* __restrict__ v, const int* __restrict__ q_pos,
             const int* __restrict__ k_pos,
             const unsigned char* __restrict__ k_valid,
             bf16* __restrict__ out, int T, int S, int Hq, int G,
             long long q_sb, long long q_st, long long q_sh,
             long long k_sb, long long k_ss, long long k_sh,
             long long v_sb, long long v_ss, long long v_sh,
             float scale, float softcap, int window) {
    constexpr int LD = DH + 8;          // padded shared row (elements)
    constexpr int C8 = DH / 8;          // 16-byte chunks per row
    constexpr int KSTEPS = DH / 16;     // k-steps of Q.K^T
    constexpr int NS = BK / 8;          // score n-tiles per warp
    constexpr int NO = DH / 8;          // output n-tiles per warp
    static_assert(BK % 16 == 0 && BK <= NT, "key tile");

    extern __shared__ __align__(16) unsigned char smem_raw[];
    bf16* sQ = reinterpret_cast<bf16*>(smem_raw);       // [BM][LD]
    bf16* sK = sQ + BM * LD;                            // [2][BK][LD]
    bf16* sV = sK + 2 * BK * LD;                        // [2][BK][LD]
    int* sKp = reinterpret_cast<int*>(sV + 2 * BK * LD);  // [2][BK]
    __shared__ int s_lo, s_hi, s_first, s_last;

    const int tid = threadIdx.x;
    const int warp = tid / 32, lane = tid % 32;
    const int gid = lane >> 2, tig = lane & 3;
    const int b = blockIdx.z, hk = blockIdx.y;
    // the rows with the most keys (latest positions) start first
    const int R0 = (gridDim.x - 1 - blockIdx.x) * BM;
    const int rows = T * G;
    const long long kb = (long long)b * S;              // k_pos/k_valid row
    const bf16* kbase = k + b * k_sb + hk * k_sh;
    const bf16* vbase = v + b * v_sb + hk * v_sh;

    // 1. Q tile -> shared (padded rows past T*G become zeros)
    for (int c = tid; c < BM * C8; c += NT) {
        const int r = c / C8, d = (c % C8) * 8;
        const int R = R0 + r;
        const bool ok = R < rows;
        const int t = ok ? R / G : 0, g = ok ? R % G : 0;
        dtt::cp_async16(
            sQ + r * LD + d,
            q + b * q_sb + t * q_st + (hk * G + g) * q_sh + d, ok);
    }
    dtt::cp_async_commit();

    // K/V rows of one tile into a ring slot (keys past S become 0)
    auto load_kv = [&](int tile, int slot) {
        bf16* dk = sK + slot * BK * LD;
        bf16* dv = sV + slot * BK * LD;
        for (int c = tid; c < BK * C8; c += NT) {
            const int r = c / C8, d = (c % C8) * 8;
            const int key = tile * BK + r;
            const bool ok = key < S;
            const long long kr = ok ? key : 0;
            dtt::cp_async16(dk + r * LD + d, kbase + kr * k_ss + d, ok);
            dtt::cp_async16(dv + r * LD + d, vbase + kr * v_ss + d, ok);
        }
    };

    // 2. the block's query positions and the live key tiles, with the
    // positions and the scan's first keys loaded in one round trip
    if (tid == 0) {
        s_lo = INT_MAX;
        s_hi = INT_MIN;
        s_first = INT_MAX;
        s_last = -1;
    }
    constexpr int SCAN = 8;             // keys a thread loads per round
    int kp[SCAN];
    bool kv[SCAN];
    auto scan_load = [&](int s0) {
#pragma unroll
        for (int u = 0; u < SCAN; ++u) {
            const int s = s0 + u * NT;
            kp[u] = s < S ? k_pos[kb + s] : 0;
            kv[u] = s < S && k_valid[kb + s];
        }
    };
    scan_load(tid);
    const int qp = tid < BM && R0 + tid < rows
                   ? q_pos[(long long)b * T + (R0 + tid) / G] : INT_MIN;
    __syncthreads();
    if (qp != INT_MIN) {
        atomicMin(&s_lo, qp);
        atomicMax(&s_hi, qp);
    }
    __syncthreads();
    const int lo = s_lo, hi = s_hi;
    int first = INT_MAX, last = -1;
    if (lo <= hi) {
        for (int s0 = tid; s0 < S; s0 += SCAN * NT) {
            if (s0 != tid) scan_load(s0);
#pragma unroll
            for (int u = 0; u < SCAN; ++u) {
                const int s = s0 + u * NT;
                if (kv[u] && kp[u] <= hi
                        && (window <= 0 || kp[u] > lo - window)) {
                    first = min(first, s / BK);
                    last = max(last, s / BK);
                }
            }
        }
    }
    first = __reduce_min_sync(0xffffffffu, first);
    last = __reduce_max_sync(0xffffffffu, last);
    if (lane == 0) {
        atomicMin(&s_first, first);
        atomicMax(&s_last, last);
    }
    __syncthreads();
    first = s_first;
    last = s_last;

    // this thread's two rows: warp*16 + gid and + 8
    int qhi[2], qlo[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        const int R = R0 + warp * 16 + gid + 8 * i;
        if (R < rows) {
            const int p = q_pos[(long long)b * T + R / G];
            qhi[i] = p;
            qlo[i] = window > 0 ? p - window : INT_MIN;
        } else {                        // padding row: sees nothing
            qhi[i] = INT_MIN;
            qlo[i] = INT_MAX;
        }
    }
    // scores in log2 units: exp2(x - m) == exp(s - m') for x = s * log2(e)
    const bool capped = softcap > 0.f;
    const float sc = capped ? scale / softcap : scale * dtt::LOG2E;
    const float cap2 = softcap * dtt::LOG2E;

    float o[NO][4];
#pragma unroll
    for (int n = 0; n < NO; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
    float m[2] = {dtt::NEG_INF, dtt::NEG_INF}, l[2] = {0.f, 0.f};

    // per-lane ldmatrix offsets (elements) inside the warp's 16-row Q
    // slice, a 16-key x 16-d block of K (non-transposed) and of V
    // (transposed)
    const int q_off = (lane & 15) * LD + (lane >> 4) * 8;
    const int k_off = ((lane & 7) + ((lane >> 4) << 3)) * LD
                      + ((lane >> 3) & 1) * 8;
    const int v_off = ((lane & 7) + (((lane >> 3) & 1) << 3)) * LD
                      + (lane >> 4) * 8;
    const bf16* sQw = sQ + warp * 16 * LD + q_off;

    // a key every row of the block can see (a tile of such keys needs no
    // mask); INT_MAX codes (invalid or past S) never qualify
    auto sees_all = [&](int code) {
        return code <= lo && (window <= 0 || code > hi - window);
    };
    unsigned full_bits = 0u;            // this thread's key, per ring slot

    if (first <= last) {
        load_kv(first, 0);
        dtt::cp_async_commit();
        const int code0 = tid < BK
            ? key_code(k_pos, k_valid, kb, first * BK + tid, S) : INT_MAX;
        uint32_t qf[QREG ? KSTEPS : 1][4];
        if constexpr (QREG) {           // while tile `first` lands
            dtt::cp_async_wait<1>();         // the Q tile has landed
            __syncthreads();
#pragma unroll
            for (int kk = 0; kk < KSTEPS; ++kk)
                dtt::ldsm_x4(qf[kk], sQw + kk * 16);
        }
        if (tid < BK) {
            sKp[tid] = code0;
            full_bits = (unsigned)sees_all(code0);
        }

        for (int j = first, slot = 0; j <= last; ++j, slot ^= 1) {
            dtt::cp_async_wait<0>();         // tile j has landed for every
            // thread, tile j - 1's slot is free, and the vote says whether
            // every row sees every key of tile j
            const bool full = __syncthreads_and(
                tid >= BK || ((full_bits >> slot) & 1u));
            int code_next = INT_MAX;
            if (j < last) {
                load_kv(j + 1, slot ^ 1);
                if (tid < BK)           // lands while this tile computes
                    code_next = key_code(k_pos, k_valid, kb,
                                         (j + 1) * BK + tid, S);
            }
            dtt::cp_async_commit();

            const bf16* Ks = sK + slot * BK * LD + k_off;
            const bf16* Vs = sV + slot * BK * LD + v_off;
            const int* kps = sKp + slot * BK + tig * 2;

            // S = Q.K^T for this warp's 16 rows x BK keys
            float s[NS][4];
#pragma unroll
            for (int n = 0; n < NS; ++n)
                s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
            for (int kk = 0; kk < KSTEPS; ++kk) {
                uint32_t a[4];
                if constexpr (QREG) {
#pragma unroll
                    for (int i = 0; i < 4; ++i) a[i] = qf[kk][i];
                } else {
                    dtt::ldsm_x4(a, sQw + kk * 16);
                }
#pragma unroll
                for (int n = 0; n < NS / 2; ++n) {
                    uint32_t bk[4];
                    dtt::ldsm_x4(bk, Ks + n * 16 * LD + kk * 16);
                    dtt::mma_bf16(s[2 * n], a, bk[0], bk[1]);
                    dtt::mma_bf16(s[2 * n + 1], a, bk[2], bk[3]);
                }
            }

            // online softmax; the row max and alpha need the quad's values
            float alpha[2], ls[2] = {0.f, 0.f};
            if (full && !capped) {
                // nothing masked: the max of the raw scores, then the scale
                // folded into one FMA before each exp
                float mx[2] = {-FLT_MAX, -FLT_MAX};
#pragma unroll
                for (int n = 0; n < NS; ++n) {
                    mx[0] = fmaxf(mx[0], fmaxf(s[n][0], s[n][1]));
                    mx[1] = fmaxf(mx[1], fmaxf(s[n][2], s[n][3]));
                }
#pragma unroll
                for (int i = 0; i < 2; ++i) {
                    const float m_new = fmaxf(m[i], dtt::quad_max(mx[i]) * sc);
                    alpha[i] = dtt::fast_exp2(m[i] - m_new);
                    m[i] = m_new;
                }
#pragma unroll
                for (int n = 0; n < NS; ++n) {
#pragma unroll
                    for (int e = 0; e < 4; ++e) {
                        const int i = e >> 1;
                        const float p =
                            dtt::fast_exp2(fmaf(s[n][e], sc, -m[i]));
                        s[n][e] = p;
                        ls[i] += p;
                    }
                }
            } else {
                // scale, softcap, mask (NEG_INF); the row max over the tile
                float mx[2] = {dtt::NEG_INF, dtt::NEG_INF};
#pragma unroll
                for (int n = 0; n < NS; ++n) {
                    const int2 kp2 =
                        *reinterpret_cast<const int2*>(kps + n * 8);
#pragma unroll
                    for (int e = 0; e < 4; ++e) {
                        const int i = e >> 1;
                        const int key = (e & 1) ? kp2.y : kp2.x;
                        float x = s[n][e] * sc;
                        if (capped) x = tanhf(x) * cap2;
                        x = (key <= qhi[i] && key > qlo[i]) ? x
                                                            : dtt::NEG_INF;
                        s[n][e] = x;
                        mx[i] = fmaxf(mx[i], x);
                    }
                }
#pragma unroll
                for (int i = 0; i < 2; ++i) {
                    const float m_new = fmaxf(m[i], dtt::quad_max(mx[i]));
                    alpha[i] = dtt::fast_exp2(m[i] - m_new);
                    m[i] = m_new;
                }
#pragma unroll
                for (int n = 0; n < NS; ++n) {
#pragma unroll
                    for (int e = 0; e < 4; ++e) {
                        const int i = e >> 1;   // masked slots: p = 0
                        const float p = s[n][e] == dtt::NEG_INF
                                        ? 0.f : dtt::fast_exp2(s[n][e] - m[i]);
                        s[n][e] = p;
                        ls[i] += p;
                    }
                }
            }
#pragma unroll
            for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + ls[i];
#pragma unroll
            for (int n = 0; n < NO; ++n) {
                o[n][0] *= alpha[0];
                o[n][1] *= alpha[0];
                o[n][2] *= alpha[1];
                o[n][3] *= alpha[1];
            }

            // O += P.V, P re-packed from the score accumulators
#pragma unroll
            for (int kk = 0; kk < BK / 16; ++kk) {
                uint32_t a[4];
                a[0] = dtt::pack_bf16(s[2 * kk][0], s[2 * kk][1]);
                a[1] = dtt::pack_bf16(s[2 * kk][2], s[2 * kk][3]);
                a[2] = dtt::pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
                a[3] = dtt::pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
                // all of this k-step's V fragments first, then the MMAs
                // (8% faster at Dh=128 than loading each beside its MMA)
                uint32_t bv[NO / 2][4];
#pragma unroll
                for (int n = 0; n < NO / 2; ++n)
                    dtt::ldsm_x4_trans(bv[n], Vs + kk * 16 * LD + n * 16);
#pragma unroll
                for (int n = 0; n < NO / 2; ++n) {
                    dtt::mma_bf16(o[2 * n], a, bv[n][0], bv[n][1]);
                    dtt::mma_bf16(o[2 * n + 1], a, bv[n][2], bv[n][3]);
                }
            }

            // tile j + 1's slot was tile j - 1's: every thread is past it
            if (j < last && tid < BK) {
                sKp[(slot ^ 1) * BK + tid] = code_next;
                full_bits = (full_bits & (1u << slot))
                            | ((unsigned)sees_all(code_next) << (slot ^ 1));
            }
        }
    }
    dtt::cp_async_wait<0>();
    __syncthreads();                    // sQ is free for the output

    // normalise (l == 0: the row saw nothing and stays 0) and stage the
    // bf16 rows in sQ, then write them out in 16-byte pieces
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        const float li = dtt::quad_sum(l[i]);
        const float inv = li == 0.f ? 1.f : 1.f / li;
        bf16* row = sQ + (warp * 16 + gid + 8 * i) * LD + tig * 2;
#pragma unroll
        for (int n = 0; n < NO; ++n)
            *reinterpret_cast<uint32_t*>(row + n * 8) =
                dtt::pack_bf16(o[n][2 * i] * inv, o[n][2 * i + 1] * inv);
    }
    __syncthreads();
    for (int c = tid; c < BM * C8; c += NT) {
        const int r = c / C8, d = (c % C8) * 8;
        const int R = R0 + r;
        if (R < rows) {
            const int t = R / G, g = R % G;
            *reinterpret_cast<uint4*>(
                out + (((long long)b * T + t) * Hq + hk * G + g) * DH + d) =
                *reinterpret_cast<const uint4*>(sQ + r * LD + d);
        }
    }
}

template <int DH, int BK, bool QREG>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* q_pos, const int* k_pos,
                   const unsigned char* k_valid, void* out,
                   int B, int T, int S, int Hq, int Hkv,
                   long long q_sb, long long q_st, long long q_sh,
                   long long k_sb, long long k_ss, long long k_sh,
                   long long v_sb, long long v_ss, long long v_sh,
                   float scale, float softcap, int window,
                   cudaStream_t stream) {
    constexpr size_t smem = smem_bytes<DH, BK>();
    auto* kernel = flash_kernel<DH, BK, QREG>;
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    const int G = Hq / Hkv;
    const dim3 grid((unsigned)(((long long)T * G + BM - 1) / BM), Hkv, B);
    kernel<<<grid, NT, smem, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), q_pos, k_pos, k_valid,
        static_cast<bf16*>(out), T, S, Hq, G,
        q_sb, q_st, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
        scale, softcap, window);
    return cudaGetLastError();
}

}  // namespace

// Returns the cudaError_t of the launch (0 = success). Strides are in
// elements; the head dim must be contiguous and every other stride a
// multiple of 8 elements, with 16-byte aligned bases. Positions must be
// below INT_MAX (the kernel's code for an invalid key).
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
#define DTT_FLASH(DH, BK, QREG)                                              \
    launch<DH, BK, QREG>(q, k, v, qp, kp, kv, out, B, T, S, Hq, Hkv, q_sb,    \
                         q_st, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,      \
                         scale, softcap, window, st)
    switch (Dh) {
        case 64: return (int)DTT_FLASH(64, 64, true);
        case 128: return (int)DTT_FLASH(128, 64, true);
        case 256: return (int)DTT_FLASH(256, 32, false);
        default: return (int)cudaErrorInvalidValue;
    }
#undef DTT_FLASH
}

// Paged decode attention, hand-written for Hopper (sm_90a): split-K over the
// context (flash-decoding), a bf16 cp.async page ring per warp, products on
// the tensor cores, and a merge of the splits in a fixed order.
//
// Replaces: dynamo_tpu/ops/attention.py:_paged_attention_tpu (Pallas kernel
// _paged_dma_kernel, the TPU serving variant) and
// dynamo_tpu/ops/attention.py:paged_attention (Pallas kernel _paged_kernel,
// the one-page-per-step variant); both compute the same function. One query
// token per sequence, q [B,Hq,Dh], reads K/V straight from one layer of the
// page pool [Hkv,n_pages,page,Dh] (bf16) through page_tables [B,P] (int32,
// padded with page 0) and lengths [B] (int32, clamped to [1, P*page]).
// Sequence b attends to tokens [0, len), or [max(0, len - window), len) on
// sliding layers; the softcap comes before masking; scale defaults to
// rsqrt(Dh) (the wrapper passes it).
//
// Bound on the H100: bytes. Each K/V row serves only the G query heads of
// its group, 4*G FLOP per 4 bytes: for Llama-3-8B at B=8 and 1024 tokens
// one layer reads 33.5 MB, 10 us at 3.35 TB/s, against 0.13 GFLOP. What the
// design does about it:
// - Split-K. The grid is (split, kv head x block of 16 query heads,
//   sequence). Each split owns `split` consecutive tokens, a whole number of
//   the block's rounds of warp tiles. The host picks `split` from B, Hkv, P,
//   page and Dh alone (ops/attention.py:paged_split_plan), aiming at four
//   blocks an SM, so the grid never depends on the lengths on the device: no
//   host sync, and the launch can be captured in a CUDA graph. A block whose
//   tokens lie wholly outside [start, len) exits at once (lanes shorter than
//   the table, splits below a window), so about half of the grid does work.
// - The block keeps the GQA group together: up to 16 query heads are the M
//   rows of its MMAs, so each K/V row reaches shared memory once per kv head.
// - A cp.async ring per warp. Warp w takes every NW-th tile of TK tokens of
//   its split and keeps STAGES such tiles of bf16 K and V in flight in its
//   own slice of shared memory, 16 bytes a lane: the next tiles' pages load
//   while this one computes, with only __syncwarp between stages. Every row
//   resolves its page through the table, so any page size works, smaller or
//   larger than a tile. Rows are padded by 16 bytes for ldmatrix.
// - Products on the tensor cores (mma.sync.m16n8k16 bf16 -> f32, the
//   fragment code of flash_attention.cu): S = Q.K^T with the query heads in
//   the M rows, O += P.V with P re-packed in registers. At G=4 twelve of the
//   16 rows idle, which costs nothing in a kernel bound by bytes; what it
//   buys is about 12 instructions a token a warp against about 90 for
//   CUDA-core dot products with shuffle reductions, which measured 1.2x to
//   2.2x slower (PERF.md). Q fragments stay in registers (Dh <= 128)
//   or are re-read from shared memory (Dh = 256). The online softmax is in
//   f32 in base 2 with the finite NEG_INF sentinel.
// - The merge. The warps of a block merge through shared memory in a fixed
//   order. With one split the block writes the bf16 output; otherwise it
//   writes its partial (m, l, acc[Dh]) in f32 to a workspace the wrapper
//   allocates, and paged_merge_kernel (same stream, same C entry, launched
//   as a programmatic dependent so that its launch overlaps the split
//   kernel) combines each (sequence, q head)'s live splits in split order.
//   No atomics: the output is bitwise the same from run to run. A dead
//   split writes nothing and the merge skips it by the same test of
//   [start, len).

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int NW = 4;             // warps per block
constexpr int NT = NW * 32;       // threads per block
constexpr int TK = 16;            // tokens per warp tile (one MMA k-step)
constexpr int STAGES = 3;         // warp tiles in a warp's cp.async ring
constexpr int GR = 16;            // query heads a block holds (MMA rows)

// a split is a whole number of block rounds (NW warp tiles)
constexpr int GRANULE = NW * TK;

// shared memory: Q [GR][DH+8], then each warp's ring [STAGES][K,V][TK][DH+8]
template <int DH>
__host__ __device__ constexpr int ring_elems() {
    return STAGES * 2 * TK * (DH + 8);
}

template <int DH>
constexpr size_t smem_bytes() {
    return sizeof(bf16) * (GR * (DH + 8) + NW * ring_elems<DH>());
}

// Tokens [start, len) of sequence b: the same test in both kernels decides
// which splits are live.
__device__ __forceinline__ void token_range(const int* lengths, int b, int P,
                                            int page, int window, int& start,
                                            int& len) {
    len = min(max(lengths[b], 1), P * page);
    start = window > 0 ? max(len - window, 0) : 0;
}

// DH head dim; QREG: Q fragments stay in registers for the whole token loop
// (else they are re-read from shared memory each tile, which keeps the
// Dh=256 accumulator within the register file)
template <int DH, bool QREG>
__global__ void __launch_bounds__(NT)
paged_split_kernel(const bf16* __restrict__ q,
                   const bf16* __restrict__ k_pages,
                   const bf16* __restrict__ v_pages,
                   const int* __restrict__ page_tables,
                   const int* __restrict__ lengths,
                   bf16* __restrict__ out, float* __restrict__ ws,
                   int Hq, int n_pages, int page, int P, int G, int chunks,
                   int split, int nsplit, float scale, float softcap,
                   int window) {
    constexpr int LD = DH + 8;            // padded shared row (elements)
    constexpr int C8 = DH / 8;            // 16-byte chunks per row
    constexpr int RPP = 32 / C8;          // rows a warp copies per pass
    constexpr int KSTEPS = DH / 16;       // k-steps of Q.K^T
    constexpr int NS = TK / 8;            // score n-tiles per warp tile
    constexpr int NO = DH / 8;            // output n-tiles
    constexpr int VB = DH == 256 ? 4 : NO / 2;   // V fragments per batch
    extern __shared__ __align__(16) unsigned char smem_raw[];
    bf16* sQ = reinterpret_cast<bf16*>(smem_raw);           // [GR][LD]

    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const int gid = lane >> 2, tig = lane & 3;
    const int sp = blockIdx.x;
    const int hk = blockIdx.y / chunks;
    const int g0 = (blockIdx.y % chunks) * GR;
    const int gn = min(GR, G - g0);       // query heads of this block
    const int b = blockIdx.z;
    int start, len;
    token_range(lengths, b, P, page, window, start, len);
    const int s0 = sp * split;
    const int lo = max(start, s0);
    const int hi = min(len, s0 + split);
    if (lo >= hi) return;                 // dead split: nothing to read
    // the merge kernel may launch now; it waits for this grid to finish
    asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");

    // 1. the group's query heads -> shared (rows past gn become zeros)
    const int hq0 = hk * G + g0;
    for (int c = tid; c < GR * C8; c += NT) {
        const int r = c / C8, d = (c % C8) * 8;
        dtt::cp_async16(
            sQ + r * LD + d,
            q + ((long long)b * Hq + hq0 + min(r, gn - 1)) * DH + d, r < gn);
    }
    dtt::cp_async_commit();

    // this warp's tiles: every NW-th live tile of the split, from tile k0
    const int k0 = (lo - s0) / TK;
    const int k1 = (hi - 1 - s0) / TK;
    const int first = k0 + warp;
    const int n_mine = first > k1 ? 0 : (k1 - first) / NW + 1;

    bf16* ring = sQ + GR * LD + warp * ring_elems<DH>();
    const int* pt = page_tables + (long long)b * P;
    const long long head_rows = (long long)hk * n_pages * page;
    const int crow = lane / C8;           // this lane's row of a pass
    const int cd = (lane % C8) * 8;       // and its 16-byte piece

    // queue tile i of this warp into stage st (an empty group past the end,
    // so the waits below always count the same groups)
    auto load_tile = [&](int i, int st) {
        if (i < n_mine) {
            bf16* ks = ring + st * 2 * TK * LD + crow * LD + cd;
            bf16* vs = ks + TK * LD;
            const int t0 = s0 + (first + i * NW) * TK + crow;
            int pg = t0 / page;
            int off = t0 - pg * page;
#pragma unroll
            for (int r = 0; r < TK; r += RPP) {
                const int t = t0 + r;
                const bool ok = t >= lo && t < hi;
                long long src = 0;
                if (ok) src = (head_rows + (long long)pt[pg] * page + off)
                              * DH + cd;
                dtt::cp_async16(ks + r * LD, k_pages + src, ok);
                dtt::cp_async16(vs + r * LD, v_pages + src, ok);
                off += RPP;
                while (off >= page) {
                    off -= page;
                    ++pg;
                }
            }
        }
        dtt::cp_async_commit();
    };

#pragma unroll
    for (int i = 0; i < STAGES - 1; ++i) load_tile(i, i);

    // scores in log2 units: exp2(x - m) == exp(s - m') for x = s * log2(e)
    const bool capped = softcap > 0.f;
    const float sc = capped ? scale / softcap : scale * dtt::LOG2E;
    const float cap2 = softcap * dtt::LOG2E;

    // per-lane ldmatrix offsets (elements): the 16 Q rows, a 16-token x
    // 16-d block of K (non-transposed) and of V (transposed)
    const int q_off = (lane & 15) * LD + (lane >> 4) * 8;
    const int k_off = ((lane & 7) + ((lane >> 4) << 3)) * LD
                      + ((lane >> 3) & 1) * 8;
    const int v_off = ((lane & 7) + (((lane >> 3) & 1) << 3)) * LD
                      + (lane >> 4) * 8;

    dtt::cp_async_wait<STAGES - 1>();          // the Q rows have landed
    __syncthreads();
    uint32_t qf[QREG ? KSTEPS : 1][4];
    if constexpr (QREG) {
#pragma unroll
        for (int kk = 0; kk < KSTEPS; ++kk)
            dtt::ldsm_x4(qf[kk], sQ + q_off + kk * 16);
    }

    // rows gid and gid + 8 of O (query heads); only rows < gn are kept
    float o[NO][4];
#pragma unroll
    for (int n = 0; n < NO; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
    float m[2] = {dtt::NEG_INF, dtt::NEG_INF}, l[2] = {0.f, 0.f};

    for (int i = 0; i < n_mine; ++i) {
        // tile i has landed for this lane, and after the __syncwarp for the
        // warp; every lane is then done with tile i - 1's stage, which is
        // refilled now
        dtt::cp_async_wait<STAGES - 2>();
        __syncwarp();
        load_tile(i + STAGES - 1, (i + STAGES - 1) % STAGES);
        const bf16* Ks = ring + (i % STAGES) * 2 * TK * LD;
        const bf16* Vs = Ks + TK * LD;
        const int t0 = s0 + (first + i * NW) * TK;

        // S = Q.K^T: 16 head rows x TK tokens
        float s[NS][4];
#pragma unroll
        for (int n = 0; n < NS; ++n)
            s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
        for (int kk = 0; kk < KSTEPS; ++kk) {
            uint32_t a[4];
            if constexpr (QREG) {
#pragma unroll
                for (int e = 0; e < 4; ++e) a[e] = qf[kk][e];
            } else {
                dtt::ldsm_x4(a, sQ + q_off + kk * 16);
            }
#pragma unroll
            for (int n = 0; n < NS / 2; ++n) {
                uint32_t bk[4];
                dtt::ldsm_x4(bk, Ks + k_off + n * 16 * LD + kk * 16);
                dtt::mma_bf16(s[2 * n], a, bk[0], bk[1]);
                dtt::mma_bf16(s[2 * n + 1], a, bk[2], bk[3]);
            }
        }

        // scale, softcap, mask (NEG_INF) by token; the row max over the tile
        float mx[2] = {dtt::NEG_INF, dtt::NEG_INF};
#pragma unroll
        for (int n = 0; n < NS; ++n) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int t = t0 + n * 8 + 2 * tig + (e & 1);
                float x = s[n][e] * sc;
                if (capped) x = tanhf(x) * cap2;
                x = (t >= lo && t < hi) ? x : dtt::NEG_INF;
                s[n][e] = x;
                mx[e >> 1] = fmaxf(mx[e >> 1], x);
            }
        }
        float alpha[2], ls[2] = {0.f, 0.f};
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            const float m_new = fmaxf(m[r], dtt::quad_max(mx[r]));
            alpha[r] = dtt::fast_exp2(m[r] - m_new);
            m[r] = m_new;
        }
#pragma unroll
        for (int n = 0; n < NS; ++n) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int r = e >> 1;         // masked slots: p = 0
                const float p = s[n][e] == dtt::NEG_INF
                                ? 0.f : dtt::fast_exp2(s[n][e] - m[r]);
                s[n][e] = p;
                ls[r] += p;
            }
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + ls[r];
#pragma unroll
        for (int n = 0; n < NO; ++n) {
            o[n][0] *= alpha[0];
            o[n][1] *= alpha[0];
            o[n][2] *= alpha[1];
            o[n][3] *= alpha[1];
        }

        // O += P.V, P re-packed from the score accumulators
#pragma unroll
        for (int kk = 0; kk < TK / 16; ++kk) {
            uint32_t a[4];
            a[0] = dtt::pack_bf16(s[2 * kk][0], s[2 * kk][1]);
            a[1] = dtt::pack_bf16(s[2 * kk][2], s[2 * kk][3]);
            a[2] = dtt::pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
            a[3] = dtt::pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
            for (int n0 = 0; n0 < NO / 2; n0 += VB) {
                uint32_t bv[VB][4];
#pragma unroll
                for (int n = 0; n < VB; ++n)
                    dtt::ldsm_x4_trans(bv[n], Vs + v_off + kk * 16 * LD
                                              + (n0 + n) * 16);
#pragma unroll
                for (int n = 0; n < VB; ++n) {
                    dtt::mma_bf16(o[2 * (n0 + n)], a, bv[n][0], bv[n][1]);
                    dtt::mma_bf16(o[2 * (n0 + n) + 1], a, bv[n][2], bv[n][3]);
                }
            }
        }
    }
    dtt::cp_async_wait<0>();

    // merge the warps in order 0..NW-1 through shared memory (the rings are
    // free once every warp is past its loop)
    float* red_o = reinterpret_cast<float*>(smem_raw);      // [NW][GR][DH]
    float* red_m = red_o + NW * GR * DH;                     // [NW][GR]
    float* red_l = red_m + NW * GR;                          // [NW][GR]
    __syncthreads();
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        const int row = gid + 8 * r;
        const float lr = dtt::quad_sum(l[r]);
        if (row < gn) {
            float* dst = red_o + (warp * GR + row) * DH + 2 * tig;
#pragma unroll
            for (int n = 0; n < NO; ++n)
                *reinterpret_cast<float2*>(dst + n * 8) =
                    make_float2(o[n][2 * r], o[n][2 * r + 1]);
            if (tig == 0) {
                red_m[warp * GR + row] = m[r];
                red_l[warp * GR + row] = lr;
            }
        }
    }
    __syncthreads();
    const long long ws_rows = (long long)gridDim.z * Hq * nsplit;
    for (int i = tid; i < gn * DH; i += NT) {
        const int g = i / DH;
        const int d = i % DH;
        float mxw = dtt::NEG_INF;
#pragma unroll
        for (int w = 0; w < NW; ++w) mxw = fmaxf(mxw, red_m[w * GR + g]);
        float a = 0.f, sum = 0.f;
#pragma unroll
        for (int w = 0; w < NW; ++w) {
            const float e = dtt::fast_exp2(red_m[w * GR + g] - mxw);
            a += red_o[(w * GR + g) * DH + d] * e;
            sum += red_l[w * GR + g] * e;
        }
        const long long row = (long long)b * Hq + hq0 + g;
        if (nsplit == 1) {
            out[row * DH + d] = __float2bfloat16(a / (sum == 0.f ? 1.f : sum));
        } else {
            const long long r = row * nsplit + sp;
            ws[r * DH + d] = a;
            if (d == 0) {
                ws[ws_rows * DH + 2 * r] = mxw;
                ws[ws_rows * DH + 2 * r + 1] = sum;
            }
        }
    }
}

// One block per (q head, sequence), one thread per dimension: the live
// splits' partials combined in split order. The loops are unrolled so that
// a batch of splits' loads is in flight at once.
template <int DH>
__global__ void __launch_bounds__(DH)
paged_merge_kernel(const float* __restrict__ ws,
                   const int* __restrict__ lengths, bf16* __restrict__ out,
                   int Hq, int P, int page, int split, int nsplit,
                   int window) {
    const int d = threadIdx.x;
    const int b = blockIdx.y;
    int start, len;
    token_range(lengths, b, P, page, window, start, len);
    // launched as a programmatic dependent of the split kernel: wait here
    // until that grid has finished and its workspace writes are visible
    asm volatile("griddepcontrol.wait;\n" ::: "memory");
    const long long row = (long long)b * Hq + blockIdx.x;
    const float* ml = ws + (long long)gridDim.y * Hq * nsplit * DH;
    // splits holding tokens of [start, len)
    const int s_lo = start / split;
    const int s_hi = (len - 1) / split;
    float mx = dtt::NEG_INF;
#pragma unroll 8
    for (int s = s_lo; s <= s_hi; ++s)
        mx = fmaxf(mx, ml[2 * (row * nsplit + s)]);
    float a = 0.f, sum = 0.f;
#pragma unroll 8
    for (int s = s_lo; s <= s_hi; ++s) {
        const long long r = row * nsplit + s;
        const float e = dtt::fast_exp2(ml[2 * r] - mx);
        a += ws[r * DH + d] * e;
        sum += ml[2 * r + 1] * e;
    }
    out[row * DH + d] = __float2bfloat16(a / (sum == 0.f ? 1.f : sum));
}

template <int DH>
cudaError_t launch(const void* q, const void* k_pages, const void* v_pages,
                   const int* page_tables, const int* lengths, void* out,
                   float* ws, int B, int Hq, int Hkv, int n_pages, int page,
                   int P, int split, int nsplit, float scale, float softcap,
                   int window, cudaStream_t stream) {
    constexpr size_t smem = smem_bytes<DH>();
    static_assert(smem >= sizeof(float) * NW * GR * (DH + 2),
                  "the warps' merge reuses the rings");
    auto* kernel = paged_split_kernel<DH, (DH <= 128)>;
    const int G = Hq / Hkv;
    const int chunks = (G + GR - 1) / GR;
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    kernel<<<dim3(nsplit, Hkv * chunks, B), NT, smem, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k_pages),
        static_cast<const bf16*>(v_pages), page_tables, lengths,
        static_cast<bf16*>(out), ws, Hq, n_pages, page, P, G, chunks, split,
        nsplit, scale, softcap, window);
    e = cudaGetLastError();
    if (e != cudaSuccess || nsplit == 1) return e;
    // programmatic dependent launch: the merge grid is set up while the
    // split kernel runs, instead of after it
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[0].val.programmaticStreamSerializationAllowed = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(Hq, B);
    cfg.blockDim = dim3(DH);
    cfg.stream = stream;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    return cudaLaunchKernelEx(&cfg, paged_merge_kernel<DH>,
                              static_cast<const float*>(ws), lengths,
                              static_cast<bf16*>(out), Hq, P, page, split,
                              nsplit, window);
}

}  // namespace

// Tokens in one round of a block's warp tiles (0 for a head dim without a
// kernel): a split must be a multiple of it.
extern "C" int dtt_paged_granule(int Dh) {
    return Dh == 64 || Dh == 128 || Dh == 256 ? GRANULE : 0;
}

// Returns the cudaError_t of the launches (0 = success). q [B,Hq,Dh] and the
// pools [Hkv,n_pages,page,Dh] are contiguous and 16-byte aligned; `split`
// is a multiple of dtt_paged_granule(Dh) with nsplit * split >= P * page,
// and with nsplit > 1, ws holds B*Hq*nsplit*(Dh+2) floats (unused, may be
// null, with one split).
extern "C" int dtt_paged_attention(
    const void* q, const void* k_pages, const void* v_pages,
    const void* page_tables, const void* lengths, void* out, void* ws,
    int B, int Hq, int Hkv, int Dh, int n_pages, int page, int P, int split,
    int nsplit, float scale, float softcap, int window, void* stream) {
    const int gran = dtt_paged_granule(Dh);
    if (gran == 0 || split <= 0 || split % gran || nsplit < 1
        || (long long)nsplit * split < (long long)P * page
        || (nsplit > 1 && ws == nullptr) || Hq % Hkv)
        return (int)cudaErrorInvalidValue;
    const int* pt = static_cast<const int*>(page_tables);
    const int* ln = static_cast<const int*>(lengths);
    float* w = static_cast<float*>(ws);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
#define DTT_PAGED(DH)                                                        \
    launch<DH>(q, k_pages, v_pages, pt, ln, out, w, B, Hq, Hkv, n_pages,     \
               page, P, split, nsplit, scale, softcap, window, st)
    switch (Dh) {
        case 64: return (int)DTT_PAGED(64);
        case 128: return (int)DTT_PAGED(128);
        default: return (int)DTT_PAGED(256);
    }
#undef DTT_PAGED
}

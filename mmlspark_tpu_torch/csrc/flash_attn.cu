// Flash-attention forward with the per-row logsumexp (K2), for Hopper.
//
// Replaces mmlspark_tpu/nn/attention.py::_flash_fwd_lse, the Pallas TPU
// kernel (body `_flash_kernel`) that kept a (block_q, block_k) score tile
// and the online-softmax state in VMEM across a sequential key-block grid
// axis. Here one block owns one (batch, head, 64-row query tile); a loop
// inside the block walks the key tiles, staged through shared memory, and
// the online-softmax state (running max m, denominator l, the f32
// accumulator) lives in registers. Nothing carries between blocks, so the
// blocks run in any order.
//
// What it computes, as the TPU kernel does (attention.py:139-189):
//   s = (q . k) * d**-0.5 in f32 (inputs widened, never pre-scaled);
//   keys at or past Tk, and keys after the query when causal, are masked
//   with -1e30 and their p is zeroed explicitly; corr = exp(m_prev - m_new);
//   in bf16, p is rounded to bf16 before the p.v product (f32 accumulate),
//   while l sums the unrounded p; a row with l == 0 gives output 0 and
//   lse +inf; out is written in the input dtype, lse in f32.
// Layout: q (B, Tq, H, D), k and v (B, Tk, H, D), read through their
// strides (the last dim contiguous), so no transposes or pads precede the
// launch; out is (B, Tq, H, D) contiguous and lse (B, H, Tq).
//
// Bound: at short T (the serving shape B 64, T 512, H 8, D 64) the bytes
// (q, k, v read once, out and lse written once) and the tensor-core
// operations (4 * B * H * Tq * Tk * D) take about the same time; at long
// T the operations bound it. What the design does about it:
//   - bf16 with D >= 16 (the serving path) runs both products on the
//     tensor cores with mma.sync m16n8k16 (bf16 in, f32 accumulate), four
//     warps of 16 query rows each; see flash_fwd_mma_kernel;
//   - f32 keeps the reference's f32 products (TF32 would break its
//     2e-5 gate), so it and bf16 with D = 8 take the FFMA kernel below:
//     one thread per query row (two for D = 128, joined by a shuffle),
//     keys 8 at a time as independent chains;
//   - every key tile is read once per query tile and shared by its 64
//     rows through shared memory; causal tiles wholly after the query
//     tile are skipped (their p would be zero, so the outputs do not
//     change) and the heaviest causal tiles launch first.
// Not yet: wgmma, TMA-fed multi-stage tiles, overlap of loads and math.
//
// The kernel allocates nothing: the caller passes out and lse. Built with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and called through the C interface at the bottom (ctypes).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kBlockQ = 64;        // query rows per block
constexpr int kKeyStep = 8;        // keys per online-softmax update
constexpr float kNegInf = -1e30f;  // the TPU kernel's mask value

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) { return __bfloat162float(x); }

// p as the PV product of the TPU kernel sees it: cast to v's dtype
template <typename T>
__device__ __forceinline__ float like_v(float p) {
    if constexpr (std::is_same<T, __nv_bfloat16>::value) {
        return __bfloat162float(__float2bfloat16(p));
    } else {
        return p;
    }
}

__device__ __forceinline__ void narrow(float* dst, float x) { *dst = x; }
__device__ __forceinline__ void narrow(__nv_bfloat16* dst, float x) { *dst = __float2bfloat16(x); }

template <typename T, int D>
struct Tiling {
    static constexpr int kThreadsPerRow = D > 64 ? D / 64 : 1;
    static constexpr int kDims = D / kThreadsPerRow;      // dims per thread
    static constexpr int kBlockK = D > 64 ? 32 : 64;      // keys per smem tile
    static constexpr int kThreads = kBlockQ * kThreadsPerRow;
};

template <typename T, int D>
__global__ void __launch_bounds__(Tiling<T, D>::kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out,
                 float* __restrict__ lse, int64_t num_bh, int heads,
                 int64_t tq, int64_t tk, int64_t num_q_tiles, int causal,
                 float scale, int64_t qsb, int64_t qst, int64_t qsh,
                 int64_t ksb, int64_t kst, int64_t ksh, int64_t vsb,
                 int64_t vst, int64_t vsh) {
    using Tl = Tiling<T, D>;
    constexpr int TPR = Tl::kThreadsPerRow;
    constexpr int DPT = Tl::kDims;
    constexpr int BK = Tl::kBlockK;
    __shared__ __align__(16) float ks[BK][D];
    __shared__ __align__(16) float vs[BK][D];

    // later query tiles first: under a causal mask they hold the most keys
    const int64_t bh = blockIdx.x % num_bh;
    const int64_t qt = num_q_tiles - 1 - blockIdx.x / num_bh;
    const int64_t b = bh / heads;
    const int64_t h = bh % heads;
    const int row = threadIdx.x / TPR;
    const int part = threadIdx.x % TPR;
    const int64_t qpos = qt * kBlockQ + row;
    const bool valid = qpos < tq;

    float qr[DPT];
    float acc[DPT];
    const T* qp = q + b * qsb + qpos * qst + h * qsh + part * DPT;
#pragma unroll
    for (int i = 0; i < DPT; ++i) {
        qr[i] = valid ? widen(qp[i]) : 0.0f;
        acc[i] = 0.0f;
    }
    float m = kNegInf;
    float l = 0.0f;

    // keys after the tile's last query are masked for every row of the
    // tile under a causal mask: skip them
    int64_t kend = tk;
    if (causal && (qt + 1) * kBlockQ < kend) kend = (qt + 1) * kBlockQ;

    for (int64_t k0 = 0; k0 < kend; k0 += BK) {
        __syncthreads();   // the previous tile is consumed
        for (int e = threadIdx.x; e < BK * D; e += Tl::kThreads) {
            const int j = e / D;
            const int d = e % D;
            const int64_t kp = k0 + j;
            float kv = 0.0f, vv = 0.0f;
            if (kp < tk) {
                kv = widen(k[b * ksb + kp * kst + h * ksh + d]);
                vv = widen(v[b * vsb + kp * vst + h * vsh + d]);
            }
            ks[j][d] = kv;
            vs[j][d] = vv;
        }
        __syncthreads();
        const int nkeys = kend - k0 < BK ? static_cast<int>(kend - k0) : BK;
        for (int j0 = 0; j0 < nkeys; j0 += kKeyStep) {
            float s[kKeyStep];
#pragma unroll
            for (int c = 0; c < kKeyStep; ++c) s[c] = 0.0f;
#pragma unroll
            for (int i = 0; i < DPT; i += 4) {
#pragma unroll
                for (int c = 0; c < kKeyStep; ++c) {
                    const float4 k4 =
                        *reinterpret_cast<const float4*>(&ks[j0 + c][part * DPT + i]);
                    s[c] = fmaf(qr[i], k4.x, s[c]);
                    s[c] = fmaf(qr[i + 1], k4.y, s[c]);
                    s[c] = fmaf(qr[i + 2], k4.z, s[c]);
                    s[c] = fmaf(qr[i + 3], k4.w, s[c]);
                }
            }
            float m_new = m;
            bool ok[kKeyStep];
#pragma unroll
            for (int c = 0; c < kKeyStep; ++c) {
                if (TPR > 1) s[c] += __shfl_xor_sync(0xffffffffu, s[c], 1);
                const int64_t kp = k0 + j0 + c;
                ok[c] = kp < tk && (!causal || qpos >= kp);
                s[c] = ok[c] ? s[c] * scale : kNegInf;
                m_new = fmaxf(m_new, s[c]);
            }
            const float corr = expf(m - m_new);
            float psum = 0.0f;
#pragma unroll
            for (int c = 0; c < kKeyStep; ++c) {
                s[c] = ok[c] ? expf(s[c] - m_new) : 0.0f;   // s now holds p
                psum += s[c];
            }
            l = l * corr + psum;
#pragma unroll
            for (int i = 0; i < DPT; ++i) acc[i] *= corr;
#pragma unroll
            for (int c = 0; c < kKeyStep; ++c) {
                const float p = like_v<T>(s[c]);
#pragma unroll
                for (int i = 0; i < DPT; i += 4) {
                    const float4 v4 =
                        *reinterpret_cast<const float4*>(&vs[j0 + c][part * DPT + i]);
                    acc[i] = fmaf(p, v4.x, acc[i]);
                    acc[i + 1] = fmaf(p, v4.y, acc[i + 1]);
                    acc[i + 2] = fmaf(p, v4.z, acc[i + 2]);
                    acc[i + 3] = fmaf(p, v4.w, acc[i + 3]);
                }
            }
            m = m_new;
        }
    }

    if (!valid) return;
    T* op = out + ((b * tq + qpos) * heads + h) * D + part * DPT;
    const float denom = fmaxf(l, 1e-30f);
#pragma unroll
    for (int i = 0; i < DPT; ++i) narrow(op + i, l > 0.0f ? acc[i] / denom : 0.0f);
    if (part == 0) lse[bh * tq + qpos] = l > 0.0f ? m + logf(denom) : INFINITY;
}

// ---------------------------------------------------------------------
// bf16 with D >= 16: both products on the tensor cores (mma.sync
// m16n8k16, bf16 in, f32 accumulate). Four warps own 16 query rows each.
// Fragment layouts (PTX ISA, "mma.m16n8k16"), with g = lane / 4 and
// t = lane % 4: A (16x16, row-major) a0 = (g, 2t..2t+1), a1 = (g+8, 2t..),
// a2 = (g, 2t+8..), a3 = (g+8, 2t+8..); B (16x8) b0 = (2t..2t+1, g),
// b1 = (2t+8.., g); C (16x8) c0, c1 = (g, 2t..2t+1), c2, c3 = (g+8, 2t..).
// The S accumulator of two neighbouring 8-key tiles is therefore the A
// fragment of the PV product once rounded to bf16: p goes to the PV
// product in bf16, as the TPU kernel casts p to v's dtype, while l sums
// the f32 p. q, k and v are copied to shared memory in 16-byte chunks
// (the wrapper checks that rows are 16-byte aligned) with rows padded by
// 8 elements, so the 8 rows a fragment load touches fall in distinct
// banks; v's B fragments (pairs of neighbouring keys) come transposed by
// ldmatrix.trans.
// ---------------------------------------------------------------------

constexpr int kPad = 8;

template <int D>
struct MmaTiling {
    static constexpr int kBlockK = D > 64 ? 32 : 64;     // keys per tile
    static constexpr int kThreads = 128;                  // 4 warps x 16 rows
    static constexpr int kLd = D + kPad;                  // smem row pitch
    static constexpr int kChunks = D / 8;                 // 16-byte chunks a row
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld_pair(const __nv_bfloat16* p) {
    return *reinterpret_cast<const uint32_t*>(p);
}

// rows [row, row + 8) of `tile` (pitch kLd) from global memory, 16 bytes
// a thread; rows at or past `valid` are zeros
template <int D, int ROWS>
__device__ __forceinline__ void stage_rows(__nv_bfloat16 (*tile)[MmaTiling<D>::kLd],
                                           const __nv_bfloat16* base, int64_t row0,
                                           int64_t valid, int64_t row_stride) {
    constexpr int C = MmaTiling<D>::kChunks;
    for (int c = threadIdx.x; c < ROWS * C; c += MmaTiling<D>::kThreads) {
        const int i = c / C;
        const int d = (c % C) * 8;
        uint4 val = make_uint4(0u, 0u, 0u, 0u);
        if (row0 + i < valid)
            val = *reinterpret_cast<const uint4*>(base + (row0 + i) * row_stride + d);
        *reinterpret_cast<uint4*>(&tile[i][d]) = val;
    }
}

// the B fragment (b0, b1) of keys [k, k + 16) x columns [n, n + 8) of a
// row-major (keys, D) tile, transposed on the way by ldmatrix
__device__ __forceinline__ void ldsm_x2_trans(uint32_t& b0, uint32_t& b1,
                                              const __nv_bfloat16* row) {
    const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(row));
    asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
                 : "=r"(b0), "=r"(b1)
                 : "r"(addr));
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, uint32_t b0,
                                         uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int D>
__global__ void __launch_bounds__(MmaTiling<D>::kThreads)
flash_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                     int64_t num_bh, int heads, int64_t tq, int64_t tk,
                     int64_t num_q_tiles, int causal, float scale, int64_t qsb,
                     int64_t qst, int64_t qsh, int64_t ksb, int64_t kst,
                     int64_t ksh, int64_t vsb, int64_t vst, int64_t vsh) {
    using Tl = MmaTiling<D>;
    constexpr int BK = Tl::kBlockK;
    constexpr int NT = BK / 8;        // 8-key tiles of S
    constexpr int DT = D / 8;         // 8-wide column tiles of the output
    constexpr int KS = D / 16;        // k-steps of the score product
    __shared__ __align__(16) __nv_bfloat16 qs[kBlockQ][Tl::kLd];
    __shared__ __align__(16) __nv_bfloat16 ks[BK][Tl::kLd];
    __shared__ __align__(16) __nv_bfloat16 vs[BK][Tl::kLd];

    const int64_t bh = blockIdx.x % num_bh;
    const int64_t qt = num_q_tiles - 1 - blockIdx.x / num_bh;
    const int64_t b = bh / heads;
    const int64_t h = bh % heads;
    const int warp = threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    const int g = lane / 4;
    const int t = lane % 4;
    const int64_t q0 = qt * kBlockQ;

    stage_rows<D, kBlockQ>(qs, q + b * qsb + h * qsh, q0, tq, qst);
    __syncthreads();
    uint32_t qa[KS][4];
    const int r0 = warp * 16 + g;                     // this thread's rows r0, r0 + 8
#pragma unroll
    for (int s = 0; s < KS; ++s) {
        qa[s][0] = ld_pair(&qs[r0][s * 16 + 2 * t]);
        qa[s][1] = ld_pair(&qs[r0 + 8][s * 16 + 2 * t]);
        qa[s][2] = ld_pair(&qs[r0][s * 16 + 2 * t + 8]);
        qa[s][3] = ld_pair(&qs[r0 + 8][s * 16 + 2 * t + 8]);
    }
    const int64_t qpos[2] = {q0 + r0, q0 + r0 + 8};

    float o[DT][4];
#pragma unroll
    for (int n = 0; n < DT; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.0f;
    float m[2] = {kNegInf, kNegInf};
    float l[2] = {0.0f, 0.0f};

    int64_t kend = tk;
    if (causal && (qt + 1) * kBlockQ < kend) kend = (qt + 1) * kBlockQ;

    for (int64_t k0 = 0; k0 < kend; k0 += BK) {
        __syncthreads();   // the previous tile is consumed
        stage_rows<D, BK>(ks, k + b * ksb + h * ksh, k0, tk, kst);
        stage_rows<D, BK>(vs, v + b * vsb + h * vsh, k0, tk, vst);
        __syncthreads();

        float s[NT][4];
#pragma unroll
        for (int n = 0; n < NT; ++n) {
            s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.0f;
#pragma unroll
            for (int st = 0; st < KS; ++st)
                mma_bf16(s[n], qa[st], ld_pair(&ks[n * 8 + g][st * 16 + 2 * t]),
                         ld_pair(&ks[n * 8 + g][st * 16 + 2 * t + 8]));
        }
        // scale, mask, running max of this thread's two rows over the tile;
        // a tile inside the sequence and wholly before the query tile
        // under a causal mask has nothing to mask
        const bool whole = k0 + BK <= tk && (!causal || k0 + BK <= q0 + 1);
        float m_new[2] = {m[0], m[1]};
#pragma unroll
        for (int n = 0; n < NT; ++n) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int64_t kp = k0 + n * 8 + 2 * t + (e & 1);
                const int r = e / 2;
                const bool ok = whole || (kp < tk && (!causal || qpos[r] >= kp));
                s[n][e] = ok ? s[n][e] * scale : kNegInf;
                m_new[r] = fmaxf(m_new[r], s[n][e]);
            }
        }
        float corr[2], psum[2] = {0.0f, 0.0f};
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            // the four threads of a quad hold one row
            m_new[r] = fmaxf(m_new[r], __shfl_xor_sync(0xffffffffu, m_new[r], 1));
            m_new[r] = fmaxf(m_new[r], __shfl_xor_sync(0xffffffffu, m_new[r], 2));
            corr[r] = expf(m[r] - m_new[r]);
        }
#pragma unroll
        for (int n = 0; n < NT; ++n) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int r = e / 2;
                // masked entries are exactly kNegInf; their p is zero even
                // when the whole row is masked (then exp(s - m_new) == 1)
                s[n][e] = s[n][e] == kNegInf ? 0.0f : expf(s[n][e] - m_new[r]);
                psum[r] += s[n][e];
            }
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            psum[r] += __shfl_xor_sync(0xffffffffu, psum[r], 1);
            psum[r] += __shfl_xor_sync(0xffffffffu, psum[r], 2);
            l[r] = l[r] * corr[r] + psum[r];
            m[r] = m_new[r];
        }
#pragma unroll
        for (int n = 0; n < DT; ++n) {
            o[n][0] *= corr[0];
            o[n][1] *= corr[0];
            o[n][2] *= corr[1];
            o[n][3] *= corr[1];
        }
#pragma unroll
        for (int kt = 0; kt < BK / 16; ++kt) {
            const uint32_t pa[4] = {pack_bf16(s[2 * kt][0], s[2 * kt][1]),
                                    pack_bf16(s[2 * kt][2], s[2 * kt][3]),
                                    pack_bf16(s[2 * kt + 1][0], s[2 * kt + 1][1]),
                                    pack_bf16(s[2 * kt + 1][2], s[2 * kt + 1][3])};
#pragma unroll
            for (int n = 0; n < DT; ++n) {
                uint32_t b0, b1;
                ldsm_x2_trans(b0, b1, &vs[kt * 16 + (lane & 15)][n * 8]);
                mma_bf16(o[n], pa, b0, b1);
            }
        }
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
        if (qpos[r] >= tq) continue;
        const float denom = fmaxf(l[r], 1e-30f);
        __nv_bfloat16* op = out + ((b * tq + qpos[r]) * heads + h) * D;
#pragma unroll
        for (int n = 0; n < DT; ++n) {
            const float x0 = l[r] > 0.0f ? o[n][2 * r] / denom : 0.0f;
            const float x1 = l[r] > 0.0f ? o[n][2 * r + 1] / denom : 0.0f;
            *reinterpret_cast<__nv_bfloat162*>(op + n * 8 + 2 * t) = __floats2bfloat162_rn(x0, x1);
        }
        if (t == 0) lse[bh * tq + qpos[r]] = l[r] > 0.0f ? m[r] + logf(denom) : INFINITY;
    }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   float* lse, int64_t batch, int heads, int64_t tq,
                   int64_t tk, int causal, float scale, const int64_t* st,
                   cudaStream_t stream) {
    const int64_t num_bh = batch * heads;
    const int64_t num_q_tiles = (tq + kBlockQ - 1) / kBlockQ;
    const int64_t blocks = num_bh * num_q_tiles;
    if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
    if constexpr (std::is_same<T, __nv_bfloat16>::value && D >= 16) {
        flash_fwd_mma_kernel<D><<<static_cast<unsigned>(blocks), MmaTiling<D>::kThreads, 0,
                                  stream>>>(
            static_cast<const T*>(q), static_cast<const T*>(k),
            static_cast<const T*>(v), static_cast<T*>(out), lse, num_bh, heads,
            tq, tk, num_q_tiles, causal, scale, st[0], st[1], st[2], st[3],
            st[4], st[5], st[6], st[7], st[8]);
    } else {
        flash_fwd_kernel<T, D><<<static_cast<unsigned>(blocks), Tiling<T, D>::kThreads, 0,
                                 stream>>>(
            static_cast<const T*>(q), static_cast<const T*>(k),
            static_cast<const T*>(v), static_cast<T*>(out), lse, num_bh, heads,
            tq, tk, num_q_tiles, causal, scale, st[0], st[1], st[2], st[3],
            st[4], st[5], st[6], st[7], st[8]);
    }
    return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dim(int head_dim, const void* q, const void* k,
                       const void* v, void* out, float* lse, int64_t batch,
                       int heads, int64_t tq, int64_t tk, int causal,
                       float scale, const int64_t* st, cudaStream_t stream) {
    switch (head_dim) {
        case 8: return launch<T, 8>(q, k, v, out, lse, batch, heads, tq, tk, causal, scale, st, stream);
        case 16: return launch<T, 16>(q, k, v, out, lse, batch, heads, tq, tk, causal, scale, st, stream);
        case 32: return launch<T, 32>(q, k, v, out, lse, batch, heads, tq, tk, causal, scale, st, stream);
        case 64: return launch<T, 64>(q, k, v, out, lse, batch, heads, tq, tk, causal, scale, st, stream);
        case 128: return launch<T, 128>(q, k, v, out, lse, batch, heads, tq, tk, causal, scale, st, stream);
        default: return cudaErrorInvalidValue;
    }
}

}  // namespace

extern "C" {

// Attention forward of q (B, Tq, H, D) against k, v (B, Tk, H, D), all of
// `dtype` 0 (f32) or 1 (bf16). `strides` holds the (batch, time, head)
// element strides of q, k and v in that order; the head dim is
// contiguous. Writes out (B, Tq, H, D) contiguous in the input dtype and
// lse (B, H, Tq) f32. Returns a cudaError_t code, 0 on success.
int mmlspark_flash_fwd(const void* q, const void* k, const void* v,
                       void* out, float* lse, int dtype, int64_t batch,
                       int heads, int64_t tq, int64_t tk, int head_dim,
                       int causal, float scale, const int64_t* strides,
                       int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return err;
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dtype == 0)
        return launch_dim<float>(head_dim, q, k, v, out, lse, batch, heads,
                                 tq, tk, causal, scale, strides, s);
    if (dtype == 1)
        return launch_dim<__nv_bfloat16>(head_dim, q, k, v, out, lse, batch,
                                         heads, tq, tk, causal, scale,
                                         strides, s);
    return cudaErrorInvalidValue;
}

const char* mmlspark_flash_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

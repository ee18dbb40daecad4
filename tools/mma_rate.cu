// Issue-rate microbenchmark of mma.sync and ex2 on Hopper, for the
// questions K2 (mmlspark_tpu_torch/csrc/flash_attn.cu) raises: how fast
// does mma.sync m16n8k8 run TF32 when nothing else is in the way, and how
// much do the 3xTF32 pattern around it (three products into one
// accumulator, the hi/lo split of the operands, the operand loads from
// shared memory) take off that rate ("tf32x3" path)? And how many
// ex2.approx.f32 a second does the card issue, the floor of the bf16
// paths at small head dims, where every score costs one exponential?
//
// Every warp runs `iters` iterations; each iteration issues, for each of
// ACC independent accumulators:
//   mode 0 "tf32":        one m16n8k8 tf32 mma, operands in registers;
//   mode 1 "chain3":      three m16n8k8 tf32 mma into the accumulator
//                         (lo.hi, hi.lo, hi.hi), operands split beforehand;
//   mode 2 "split3":      as chain3, with the B operand (two f32 values a
//                         thread) moved and split every time, and the A
//                         operand (four values) moved and split once an
//                         iteration: the instruction mix of the kernel's
//                         S product, without the loads;
//   mode 3 "split3_lds":  as split3, B loaded from shared memory (one
//                         8-byte load a thread, conflict-free) instead of
//                         moved in registers;
//   mode 4 "bf16":        one m16n8k16 bf16 mma (f32 accumulate), for scale;
//   mode 5 "ex2":         no mma: one ex2.approx.ftz.f32 on each of ACC
//                         independent chains x = 2^-x (which stay finite,
//                         near 0.64), as K2's softmax issues them.
// The accumulators are summed into `sink` at the end so nothing is dead.
//
// Built with the port's flags and called through the C interface at the
// bottom (ctypes) by tools/torch_flash_turns.py mma_rate.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t tf32_rna(float x) {
    uint32_t r;
    asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
    return r;
}

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
    hi = tf32_rna(x);
    lo = tf32_rna(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
    asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int ACC>
__global__ void ex2_rate_kernel(float* __restrict__ sink, int iters, float seed) {
    float x[ACC];
#pragma unroll
    for (int j = 0; j < ACC; ++j) x[j] = seed + 0.01f * (threadIdx.x % 32 + 7 * j);
    for (int it = 0; it < iters; ++it) {
#pragma unroll
        for (int j = 0; j < ACC; ++j) asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(x[j]) : "f"(-x[j]));
    }
    float sum = 0.0f;
#pragma unroll
    for (int j = 0; j < ACC; ++j) sum += x[j];
    sink[blockIdx.x * blockDim.x + threadIdx.x] = sum;
}

template <int MODE, int ACC>
__global__ void mma_rate_kernel(float* __restrict__ sink, int iters, float seed, float step) {
    __shared__ float2 bsm[8 * 32];
    const int lane = threadIdx.x % 32;
    for (int i = threadIdx.x; i < 8 * 32; i += blockDim.x)
        bsm[i] = make_float2(seed + 0.001f * i, seed - 0.002f * i);
    __syncthreads();

    float af[4], bf[2];
    for (int i = 0; i < 4; ++i) af[i] = seed + 0.01f * (lane + 7 * i);
    for (int i = 0; i < 2; ++i) bf[i] = seed - 0.03f * (lane + 5 * i);
    uint32_t ah[4], al[4], bh[2], bl[2];
    for (int i = 0; i < 4; ++i) split(af[i], ah[i], al[i]);
    for (int i = 0; i < 2; ++i) split(bf[i], bh[i], bl[i]);

    float c[ACC][4];
#pragma unroll
    for (int j = 0; j < ACC; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) c[j][e] = 0.0f;

    for (int it = 0; it < iters; ++it) {
        if (MODE >= 2) {
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                af[i] += step;
                split(af[i], ah[i], al[i]);
            }
        }
#pragma unroll
        for (int j = 0; j < ACC; ++j) {
            if (MODE == 0) {
                mma_tf32(c[j], ah, bh[0], bh[1]);
            } else if (MODE == 4) {
                mma_bf16(c[j], ah, bh[0], bh[1]);
            } else {
                uint32_t h0 = bh[0], h1 = bh[1], l0 = bl[0], l1 = bl[1];
                if (MODE == 2) {
                    bf[0] += step;
                    bf[1] -= step;
                    split(bf[0], h0, l0);
                    split(bf[1], h1, l1);
                } else if (MODE == 3) {
                    const float2 b = bsm[32 * ((it + j) & 7) + lane];
                    split(b.x, h0, l0);
                    split(b.y, h1, l1);
                }
                mma_tf32(c[j], al, h0, h1);
                mma_tf32(c[j], ah, l0, l1);
                mma_tf32(c[j], ah, h0, h1);
            }
        }
    }
    float sum = 0.0f;
#pragma unroll
    for (int j = 0; j < ACC; ++j) sum += c[j][0] + c[j][1] + c[j][2] + c[j][3];
    sink[blockIdx.x * blockDim.x + threadIdx.x] = sum;
}

template <int MODE>
cudaError_t launch_mode(int acc, int blocks, int threads, int iters, float* sink,
                        cudaStream_t stream) {
    const float seed = 0.75f, step = 1e-6f;
    if constexpr (MODE == 5) {
        switch (acc) {
            case 1: ex2_rate_kernel<1><<<blocks, threads, 0, stream>>>(sink, iters, seed); break;
            case 4: ex2_rate_kernel<4><<<blocks, threads, 0, stream>>>(sink, iters, seed); break;
            case 8: ex2_rate_kernel<8><<<blocks, threads, 0, stream>>>(sink, iters, seed); break;
            default: return cudaErrorInvalidValue;
        }
        return cudaGetLastError();
    }
    switch (acc) {
        case 1: mma_rate_kernel<MODE, 1><<<blocks, threads, 0, stream>>>(sink, iters, seed, step); break;
        case 4: mma_rate_kernel<MODE, 4><<<blocks, threads, 0, stream>>>(sink, iters, seed, step); break;
        case 8: mma_rate_kernel<MODE, 8><<<blocks, threads, 0, stream>>>(sink, iters, seed, step); break;
        default: return cudaErrorInvalidValue;
    }
    return cudaGetLastError();
}

}  // namespace

// One launch of `blocks` x `threads` threads; `sink` holds blocks * threads
// floats. acc is 1, 4 or 8. Returns 0, else a cudaError_t.
extern "C" int mma_rate(int mode, int acc, int blocks, int threads, int iters, float* sink,
                        void* stream) {
    auto s = static_cast<cudaStream_t>(stream);
    cudaError_t err;
    switch (mode) {
        case 0: err = launch_mode<0>(acc, blocks, threads, iters, sink, s); break;
        case 1: err = launch_mode<1>(acc, blocks, threads, iters, sink, s); break;
        case 2: err = launch_mode<2>(acc, blocks, threads, iters, sink, s); break;
        case 3: err = launch_mode<3>(acc, blocks, threads, iters, sink, s); break;
        case 4: err = launch_mode<4>(acc, blocks, threads, iters, sink, s); break;
        case 5: err = launch_mode<5>(acc, blocks, threads, iters, sink, s); break;
        default: err = cudaErrorInvalidValue;
    }
    return static_cast<int>(err);
}

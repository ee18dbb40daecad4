// Gradient/hessian/count histogram of the GBDT split search, for Hopper.
//
// Replaces mmlspark_tpu/gbdt/hist_kernel.py::_histogram_pallas, the Pallas
// TPU kernel that built H[f, b, c] = sum_{i : bins[i, f] == b} stats[i, c]
// as a one-hot compare plus a matmul per row chunk, because the TPU has no
// fast scatter. Hopper has one (shared-memory read-modify-write), so this
// kernel scatters directly.
//
// Bound: bytes. One launch reads n*F bin bytes (uint8 or int32) plus n*12
// stat bytes and does three adds per (row, feature); at the H100's
// 3.35 TB/s the reads, not the adds, set the floor. What the design does
// about it:
//   - bins are read in their storage dtype (a template parameter) and
//     widened in registers, so uint8 storage reads 4x fewer bytes;
//   - every warp owns one feature and a private (B, 3) f32 sub-histogram
//     in shared memory, so the scatter never touches device memory;
//   - rows with all-zero stats (masked out of the node) add nothing.
// Reading the bins of one feature per warp is strided; the eight warps of
// a block read neighbouring bytes of the same rows, which L1 serves.
//
// Deterministic: a warp takes its chunk's rows 32 at a time, lanes stage
// their stats in shared memory, __match_any_sync groups the lanes holding
// the same bin, and the lowest lane of each group sums the group's stats in
// ascending lane order and does a plain read-add-write. Distinct groups
// write distinct addresses, so there are no races and no float atomics. A
// second kernel sums the per-chunk partials in chunk order. The same inputs
// give the same bits on every launch, as the TPU kernel's sequential grid
// did.
//
// The kernels allocate nothing: the caller passes the (chunks, F, B, 3)
// partials and the (F, B, 3) output. Built with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and called through the C interface at the bottom (ctypes).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kChannels = 3;
constexpr unsigned kFullMask = 0xffffffffu;

// Shared floats one warp needs: its (B, 3) sub-histogram plus the
// (32, 3) staging area for one step of rows.
__host__ __device__ inline int warp_smem_floats(int num_bins) {
    return num_bins * kChannels + kWarp * kChannels;
}

template <typename BinT>
__global__ void hist_partials_kernel(const BinT* __restrict__ bins,
                                     const float* __restrict__ stats,
                                     int64_t n, int num_features,
                                     int num_bins, int64_t rows_per_chunk,
                                     float* __restrict__ partials) {
    extern __shared__ float smem[];
    const int warps = blockDim.x / kWarp;
    const int warp = threadIdx.x / kWarp;
    const int lane = threadIdx.x % kWarp;
    const int f = blockIdx.y * warps + warp;
    // a warp past the last feature has nothing to do; no block-wide
    // barrier follows, so it may leave
    if (f >= num_features) return;

    const int hist_floats = num_bins * kChannels;
    float* hist = smem + warp * warp_smem_floats(num_bins);
    float* stage = hist + hist_floats;
    for (int i = lane; i < hist_floats; i += kWarp) hist[i] = 0.0f;
    __syncwarp();

    const int64_t chunk = blockIdx.x;
    const int64_t row0 = chunk * rows_per_chunk;
    const int64_t row_end = row0 + rows_per_chunk < n ? row0 + rows_per_chunk : n;
    for (int64_t base = row0; base < row_end; base += kWarp) {
        const int64_t r = base + lane;
        bool valid = r < row_end;
        int b = 0;
        float s0 = 0.0f, s1 = 0.0f, s2 = 0.0f;
        if (valid) {
            b = static_cast<int>(bins[r * num_features + f]);
            s0 = stats[r * kChannels + 0];
            s1 = stats[r * kChannels + 1];
            s2 = stats[r * kChannels + 2];
            // out-of-range bins are dropped (the wrapper documents it);
            // rows with all-zero stats would add zeros
            valid = b >= 0 && b < num_bins &&
                    (s0 != 0.0f || s1 != 0.0f || s2 != 0.0f);
        }
        stage[lane * kChannels + 0] = s0;
        stage[lane * kChannels + 1] = s1;
        stage[lane * kChannels + 2] = s2;
        __syncwarp();
        const unsigned active = __ballot_sync(kFullMask, valid);
        if (valid) {
            const unsigned peers = __match_any_sync(active, b);
            if (lane == __ffs(peers) - 1) {
                float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f;
                for (unsigned m = peers; m != 0u; m &= m - 1u) {
                    const int j = __ffs(m) - 1;      // ascending lane order
                    a0 += stage[j * kChannels + 0];
                    a1 += stage[j * kChannels + 1];
                    a2 += stage[j * kChannels + 2];
                }
                float* h = hist + b * kChannels;
                h[0] += a0;
                h[1] += a1;
                h[2] += a2;
            }
        }
        // the next step overwrites the staging area and may pick another
        // leader for a bin this step wrote
        __syncwarp();
    }

    float* out = partials + (chunk * num_features + f) * hist_floats;
    for (int i = lane; i < hist_floats; i += kWarp) out[i] = hist[i];
}

// out[i] = sum over chunks of partials[chunk, i], in chunk order.
__global__ void hist_reduce_kernel(const float* __restrict__ partials,
                                   int num_chunks, int64_t size,
                                   float* __restrict__ out) {
    const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (i >= size) return;
    float acc = 0.0f;
    for (int c = 0; c < num_chunks; ++c) acc += partials[c * size + i];
    out[i] = acc;
}

template <typename BinT>
cudaError_t launch_partials(const void* bins, const float* stats, int64_t n,
                            int num_features, int num_bins,
                            int64_t rows_per_chunk, int num_chunks,
                            int warps, float* partials, cudaStream_t stream) {
    const int groups = (num_features + warps - 1) / warps;
    const size_t smem = static_cast<size_t>(warps) *
                        warp_smem_floats(num_bins) * sizeof(float);
    if (smem > 48 * 1024) {
        const cudaError_t err = cudaFuncSetAttribute(
            hist_partials_kernel<BinT>,
            cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(smem));
        if (err != cudaSuccess) return err;
    }
    hist_partials_kernel<BinT><<<dim3(num_chunks, groups), warps * kWarp,
                                 smem, stream>>>(
        static_cast<const BinT*>(bins), stats, n, num_features, num_bins,
        rows_per_chunk, partials);
    return cudaGetLastError();
}

}  // namespace

extern "C" {

// Histogram of `n` rows: bins (n, F) row-major with `bin_bytes` 1 (uint8)
// or 4 (int32), stats (n, 3) f32, partials (num_chunks, F, B, 3) scratch,
// out (F, B, 3). Rows [c * rows_per_chunk, (c + 1) * rows_per_chunk) form
// chunk c; `warps` features share a block. Returns a cudaError_t code, 0 on
// success, checked after each of the two launches.
int mmlspark_hist_build(const void* bins, int bin_bytes, const float* stats,
                        int64_t n, int num_features, int num_bins,
                        int64_t rows_per_chunk, int num_chunks, int warps,
                        float* partials, float* out, int device,
                        void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return err;
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (bin_bytes == 1) {
        err = launch_partials<uint8_t>(bins, stats, n, num_features, num_bins,
                                       rows_per_chunk, num_chunks, warps,
                                       partials, s);
    } else if (bin_bytes == 4) {
        err = launch_partials<int32_t>(bins, stats, n, num_features, num_bins,
                                       rows_per_chunk, num_chunks, warps,
                                       partials, s);
    } else {
        return cudaErrorInvalidValue;
    }
    if (err != cudaSuccess) return err;
    const int64_t size = static_cast<int64_t>(num_features) * num_bins * kChannels;
    const int threads = 256;
    const int blocks = static_cast<int>((size + threads - 1) / threads);
    hist_reduce_kernel<<<blocks, threads, 0, s>>>(partials, num_chunks, size, out);
    return cudaGetLastError();
}

const char* mmlspark_cuda_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

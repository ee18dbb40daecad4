// Gradient/hessian/count histogram of the GBDT split search, for Hopper.
//
// Replaces mmlspark_tpu/gbdt/hist_kernel.py::_histogram_pallas, the Pallas
// TPU kernel that built H[f, b, c] = sum_{i : bins[i, f] == b} stats[i, c]
// as a one-hot compare plus a matmul per row chunk over a sequential grid,
// because the TPU has no fast scatter. Hopper scatters into shared memory.
//
// Bound: bytes. A call must read every row's 12 stat bytes (to see which
// rows are in the node), the bins of the rows that are, and write the
// (F, B, 3) output once; at 3.35 TB/s that is 0.7 us at the Adult shape and
// 12.5 us at Higgs. The engine calls it once per tree node with all n rows
// and the node's mask folded into the stats, so most rows of a deep node
// are zero rows.
//
// Design: one launch.
//   - A block walks a contiguous range of rows in tiles of R rows and keeps
//     the histogram of all its features (or of one feature group,
//     blockIdx.y, where they do not fit in shared memory) there. The grid
//     spreads the tiles over as many blocks as the SMs take (one tile a
//     block at the Adult shape, 128 blocks; 32 at Higgs).
//   - Node rows only: a tile's stats come first (coalesced, prefetched into
//     registers a tile ahead); rows with all-zero stats are dropped and the
//     kept rows compacted in row order. Only then are bins read: the whole
//     tile's span with 16-byte cp.async when at least a quarter of its rows
//     are kept, else each kept row's own 4-byte words. The copies of tile
//     t + 1 are in flight while tile t is added up.
//   - Adding up: warp w owns copy c = w / W of the histogram and features
//     w % W, w % W + W, ...; copy c takes every C-th step of 32 kept rows.
//     In a step the lanes holding one bin find each other through a mask
//     word per bin (an integer atomic OR, so the word does not depend on
//     the order), and the lowest of them adds their stats in lane (row)
//     order and does one read-add-write. Each (copy, feature, bin) has one
//     writer at a time and is summed in row order: no float atomics.
//     __match_any_sync gives the same groups but costs ~44 SM cycles a
//     call (with it: 371 against 192 us at Higgs). What bounds adding up
//     is the read-add-write itself: lanes of a step hit random bins, ~3.4
//     to a bank.
//   - The cross-block sum, in the same launch: each block writes its
//     partial (its C copies summed in copy order) to a scratch buffer the
//     wrapper keeps, the grid waits at a cooperative-groups grid barrier
//     (a cooperative launch, so every block is resident), and block L sums
//     its slice of the output over the partials in block order: the slices
//     staged in shared memory by 16-byte cp.async, all in flight at once,
//     summed in runs of consecutive partials, the runs in order. Why this
//     sum: a reduce kernel of its own measured 4.2 us at the Adult shape
//     (beside 8.8 us of partials kernel, torch.profiler), a latency-bound
//     chain of one load per chunk, and costs a second launch; a cluster
//     sum would still need a grid-level step at the Higgs shape, where
//     every SM adds up, and a last-arriving block would sum every partial
//     on one SM. Its
//     cost, from %globaltimer stamps at the Adult shape: 1.0 us to write
//     the partials, 1.8 us of barrier, 3.6 us to stage and sum.
//     With one block along the rows it writes the output directly and
//     launches plainly, without the barrier.
//   - Any B whose histogram fits: above 256 bins a block holds one copy of
//     its group's features (F warps, fewer threads than 1.5 R rows' stats,
//     which the block then reads in two parts), and where one copy of all
//     features does not fit, feature groups along grid_y. The wrapper's
//     `launch_plan` raises where not even one feature fits (about 14,000
//     bins).
// The same inputs and launch plan give the same bits on every launch.
//
// The kernel allocates nothing: the caller passes the (grid_x, F, B, 3)
// partials and the (F, B, 3) output, and the launch plan (the wrapper's
// `launch_plan`). Built with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and called through the C interface at the bottom (ctypes). ptxas (nvcc
// -Xptxas -v, tools/torch_hist_turns.py ptxas): 64 registers (the cap of
// 1,024-thread blocks) in both instantiations, spilling 4 bytes each.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kWarp = 32;
constexpr int kChannels = 3;
constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kMaxThreads = 1024;
constexpr int kMaxTileWarps = 8;      // R <= 256: warps whose rows a tile holds
constexpr int kMiscInts = 64;         // [0, 8) kept rows of each warp, [32, 34) kept rows of a buffer
constexpr int kMaxSmem = 232448;      // shared memory a block may use on sm_90

struct Params {
    const uint8_t* bins;       // (n, F), rows of F * sizeof(BinT) bytes
    const float* stats;        // (n, 3)
    int64_t n;
    int num_features;          // F
    int num_bins;              // B
    int feats_per_group;       // features of one blockIdx.y (the last group may have fewer)
    int warps_per_copy;        // W
    int copies;                // C
    int tile_rows;             // R, a multiple of 32, at most 256 and at most the threads
    int tiles_per_block;       // tiles of one blockIdx.x
    int bins_buf_bytes;        // one of the two bin staging buffers
    int gather_pitch;          // bytes of one gathered row in a buffer
    int smem_bytes;
    float* partials;           // (gridDim.x, F, B, 3), read when gridDim.x > 1
    float* out;                // (F, B, 3)
};

__host__ __device__ inline int round_up(int x, int m) { return (x + m - 1) / m * m; }

// The dynamic shared memory one block carves: the C histogram copies, each
// warp's B lane masks, the stats of one tile, two buffers of compacted
// entries and two of bins, and the counters. The wrapper's `launch_plan`
// computes the same total.
__host__ __device__ inline int smem_bytes_of(int copies, int feats_per_group, int num_bins,
                                             int warps, int tile_rows, int bins_buf_bytes) {
    return 4 * round_up(copies * feats_per_group * num_bins * kChannels, 4) +
           4 * round_up(warps * num_bins, 4) + 12 * tile_rows + 2 * 16 * tile_rows +
           2 * bins_buf_bytes + 4 * kMiscInts;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_one() {
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
}

struct Smem {
    float* hist;
    unsigned* masks;       // warp w's at [w * B, (w + 1) * B): the lanes holding each bin
    float* stage;
    float4* ent;
    uint8_t* bins;
    int* misc;
};

__device__ __forceinline__ Smem carve(uint8_t* base, const Params& p) {
    Smem s;
    s.hist = reinterpret_cast<float*>(base);
    s.masks = reinterpret_cast<unsigned*>(
        s.hist + round_up(p.copies * p.feats_per_group * p.num_bins * kChannels, 4));
    s.stage = reinterpret_cast<float*>(
        s.masks + round_up(p.copies * p.warps_per_copy * p.num_bins, 4));
    s.ent = reinterpret_cast<float4*>(s.stage + 3 * p.tile_rows);
    s.bins = reinterpret_cast<uint8_t*>(s.ent + 2 * p.tile_rows);
    s.misc = reinterpret_cast<int*>(s.bins + 2 * p.bins_buf_bytes);
    return s;
}

// The stats of rows [r0, r0 + rows) into registers, zeros past the end:
// each thread holds floats tid and tid + blockDim.x of the tile's 3R.
__device__ __forceinline__ void prefetch_stats(const Params& p, int64_t r0, int64_t rows,
                                               float (&pre)[2]) {
    const int64_t lim = rows * kChannels;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
        const int i = threadIdx.x + j * blockDim.x;
        pre[j] = i < lim ? __ldg(p.stats + r0 * kChannels + i) : 0.0f;
    }
}

// The stats of the tile of `rows` rows at r0 into s.stage: the two floats
// each thread prefetched, then, in a block of fewer than 1.5R threads (one
// copy of a few warps, at wide bins), the floats past them, read here.
__device__ __forceinline__ void store_stats(const Params& p, const Smem& s, const float (&pre)[2],
                                            int64_t r0, int64_t rows) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
        const int i = threadIdx.x + j * blockDim.x;
        if (i < 3 * p.tile_rows) s.stage[i] = pre[j];
    }
    const int64_t lim = rows * kChannels;
    for (int i = threadIdx.x + 2 * blockDim.x; i < 3 * p.tile_rows; i += blockDim.x)
        s.stage[i] = i < lim ? __ldg(p.stats + r0 * kChannels + i) : 0.0f;
}

// Compacts the kept rows of the tile at r0 (stats already in s.stage) into
// entry buffer `buf` in row order, {g, h, count, byte offset of the row's
// bins in bin buffer `buf`}, and starts the copies of their bins.
template <typename BinT>
__device__ __forceinline__ void compact(const Params& p, const Smem& s, int64_t r0, int rows,
                                        int buf, int f0, int fg) {
    const int tid = threadIdx.x, lane = tid % kWarp, warp = tid / kWarp;
    const int R = p.tile_rows;
    float s0 = 0.0f, s1 = 0.0f, s2 = 0.0f;
    bool keep = false;
    if (tid < R) {
        s0 = s.stage[3 * tid];
        s1 = s.stage[3 * tid + 1];
        s2 = s.stage[3 * tid + 2];
        keep = tid < rows && (s0 != 0.0f || s1 != 0.0f || s2 != 0.0f);
    }
    const unsigned kept = __ballot_sync(kFullMask, keep);
    if (lane == 0 && warp < R / kWarp) s.misc[warp] = __popc(kept);
    __syncthreads();
    int total = 0, before = 0;
    for (int w = 0; w < R / kWarp; ++w) {
        const int c = s.misc[w];
        before += w < warp ? c : 0;
        total += c;
    }
    const int64_t row_bytes = static_cast<int64_t>(p.num_features) * sizeof(BinT);
    uint8_t* dst = s.bins + buf * p.bins_buf_bytes;
    // the tile's span of bins, from the 16-byte boundary below it: every
    // 16-byte chunk that holds a byte of the tensor lies in its page
    const uintptr_t span = reinterpret_cast<uintptr_t>(p.bins) + r0 * row_bytes;
    const bool dense = gridDim.y == 1 && 4 * total >= R;
    if (keep) {
        const int k = before + __popc(kept & ((1u << lane) - 1u));
        int offset;
        if (dense) {
            offset = static_cast<int>(span & 15u) + tid * static_cast<int>(row_bytes);
        } else {
            // the 4-byte words that hold the row's bins of this feature group
            const uintptr_t from = span + tid * row_bytes + f0 * sizeof(BinT);
            const uintptr_t w0 = from & ~static_cast<uintptr_t>(3);
            const int words = static_cast<int>((from + fg * sizeof(BinT) - 1 - w0) / 4) + 1;
            uint8_t* row_dst = dst + k * p.gather_pitch;
            for (int j = 0; j < words; ++j)
                cp_async4(row_dst + 4 * j, reinterpret_cast<const void*>(w0 + 4 * j));
            offset = k * p.gather_pitch + static_cast<int>(from & 3u);
        }
        s.ent[buf * R + k] = make_float4(s0, s1, s2, __int_as_float(offset));
    }
    if (tid == 0) s.misc[32 + buf] = total;
    if (dense) {
        const uintptr_t a0 = span & ~static_cast<uintptr_t>(15);
        const int chunks = static_cast<int>((span + rows * row_bytes - a0 + 15) / 16);
        for (int c = tid; c < chunks; c += blockDim.x)
            cp_async16(dst + 16 * c, reinterpret_cast<const void*>(a0 + 16 * c));
    }
    cp_async_commit();
}

// Adds the kept rows of entry and bin buffer `buf` into the histogram
// copies: one writer per (copy, feature, bin) at a time, row order within.
// The lanes holding one bin find each other through the warp's masks: each
// ORs its bit into its bin's word (an integer atomic, so the word does not
// depend on the order), reads the word back, and the lowest lane of it
// clears it, sums the group in lane order and does the read-add-write.
// (__match_any_sync gives the same groups, at several times the cost.)
template <typename BinT>
__device__ __forceinline__ void accumulate(const Params& p, const Smem& s, int buf, int fg) {
    const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
    const int W = p.warps_per_copy, C = p.copies, B = p.num_bins, R = p.tile_rows;
    const int copy = warp / W, first = warp % W;
    const int kept = s.misc[32 + buf];
    const float4* ent = s.ent + buf * R;
    const uint8_t* bins = s.bins + buf * p.bins_buf_bytes;
    float* hist = s.hist + copy * p.feats_per_group * B * kChannels;
    unsigned* masks = s.masks + warp * B;
    for (int step = copy; step * kWarp < kept; step += C) {
        const int k = step * kWarp + lane;
        const bool valid = k < kept;
        const float4 e = valid ? ent[k] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        const int offset = __float_as_int(e.w);
        for (int f = first; f < fg; f += W) {
            const int b = valid ? static_cast<int>(
                                      *reinterpret_cast<const BinT*>(bins + offset + f * sizeof(BinT)))
                                : -1;
            // out-of-range bins are dropped (the wrapper documents it)
            const bool ok = valid && static_cast<unsigned>(b) < static_cast<unsigned>(B);
            if (ok) atomicOr(masks + b, 1u << lane);
            __syncwarp();
            const unsigned peers = ok ? masks[b] : 0u;
            __syncwarp();
            if (ok) {
                if (lane == __ffs(peers) - 1) {
                    masks[b] = 0u;
                    float a0 = e.x, a1 = e.y, a2 = e.z;
                    for (unsigned m = peers & (peers - 1u); m != 0u; m &= m - 1u) {
                        const float4 o = ent[step * kWarp + __ffs(m) - 1];   // ascending lanes
                        a0 += o.x;
                        a1 += o.y;
                        a2 += o.z;
                    }
                    float* h = hist + (f * B + b) * kChannels;
                    h[0] += a0;
                    h[1] += a1;
                    h[2] += a2;
                }
            }
            // the masks are clear, and this copy's next step may give a bin
            // another leader lane
            __syncwarp();
        }
    }
}

// Rows of tile t of a block's range [row_begin, row_end).
__device__ __forceinline__ int rows_of_tile(int64_t row_begin, int64_t row_end, int R, int t) {
    const int64_t left = row_end - row_begin - static_cast<int64_t>(t) * R;
    return static_cast<int>(left < R ? left : R);
}

template <typename BinT>
__global__ void __launch_bounds__(kMaxThreads, 1) hist_kernel(const Params p) {
    extern __shared__ __align__(16) uint8_t smem_raw[];
    const Smem s = carve(smem_raw, p);
    const int tid = threadIdx.x, threads = blockDim.x;
    const int R = p.tile_rows, B = p.num_bins;
    const int f0 = blockIdx.y * p.feats_per_group;
    const int fg = min(p.feats_per_group, p.num_features - f0);

    // the histograms and masks are contiguous and 16-byte aligned
    const int zero_words = static_cast<int>(s.stage - s.hist);
    for (int i = tid; i < zero_words / 4; i += threads)
        reinterpret_cast<float4*>(s.hist)[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);

    const int64_t row_begin = static_cast<int64_t>(blockIdx.x) * p.tiles_per_block * R;
    const int64_t block_end = row_begin + static_cast<int64_t>(p.tiles_per_block) * R;
    const int64_t row_end = block_end < p.n ? block_end : p.n;
    const int tiles = static_cast<int>((row_end - row_begin + R - 1) / R);

    float pre[2];
    prefetch_stats(p, row_begin, rows_of_tile(row_begin, row_end, R, 0), pre);
    store_stats(p, s, pre, row_begin, rows_of_tile(row_begin, row_end, R, 0));
    __syncthreads();
    compact<BinT>(p, s, row_begin, rows_of_tile(row_begin, row_end, R, 0), 0, f0, fg);
    if (tiles > 1)
        prefetch_stats(p, row_begin + R, rows_of_tile(row_begin, row_end, R, 1), pre);
    for (int t = 0; t < tiles; ++t) {
        const int buf = t & 1;
        if (t + 1 < tiles) {
            const int64_t next = row_begin + static_cast<int64_t>(t + 1) * R;
            store_stats(p, s, pre, next, rows_of_tile(row_begin, row_end, R, t + 1));
            __syncthreads();
            compact<BinT>(p, s, next, rows_of_tile(row_begin, row_end, R, t + 1), buf ^ 1, f0, fg);
            if (t + 2 < tiles)
                prefetch_stats(p, row_begin + static_cast<int64_t>(t + 2) * R,
                               rows_of_tile(row_begin, row_end, R, t + 2), pre);
        } else {
            cp_async_commit();       // an empty group keeps the count of groups
        }
        cp_async_wait_one();         // this thread's copies of tile t have landed
        __syncthreads();             // everyone's have
        accumulate<BinT>(p, s, buf, fg);
        __syncthreads();
    }

    // the block's partial: its copies summed in copy order
    const int size = p.num_features * B * kChannels;
    const int group_floats = fg * B * kChannels;
    const int copy_floats = p.feats_per_group * B * kChannels;
    float* dst = (gridDim.x == 1 ? p.out : p.partials + static_cast<int64_t>(blockIdx.x) * size) +
                 f0 * B * kChannels;
    if ((size | group_floats | copy_floats | (f0 * B * kChannels)) % 4 == 0) {
        // four floats at a time where every offset is a whole float4 (F x B
        // a multiple of 4, as at B = 256, 512, 1024), added as the scalars are
        const float4* h4 = reinterpret_cast<const float4*>(s.hist);
        for (int i = tid; i < group_floats / 4; i += threads) {
            float4 acc = h4[i];
            for (int c = 1; c < p.copies; ++c) {
                const float4 v = h4[c * copy_floats / 4 + i];
                acc.x += v.x;
                acc.y += v.y;
                acc.z += v.z;
                acc.w += v.w;
            }
            reinterpret_cast<float4*>(dst)[i] = acc;
        }
    } else {
        for (int i = tid; i < group_floats; i += threads) {
            float acc = s.hist[i];
            for (int c = 1; c < p.copies; ++c) acc += s.hist[c * copy_floats + i];
            dst[i] = acc;
        }
    }
    if (gridDim.x == 1) return;

    cg::this_grid().sync();

    // block L sums output slice [L * per, L * per + len) over the partials
    // in block order: the partials' slices are staged in shared memory by
    // asynchronous copies, all in flight at once; slot (run, j) adds up run
    // `run` of consecutive partials at output j; then the runs' sums are
    // added in run order. (len * 2 fits at any B: with gridDim.x > 1 a
    // block's slice is at most half of one feature group's histogram plus
    // a float4, and the block's shared memory holds that histogram and a
    // warp's B lane masks.) Slices are copied 16 bytes at a time where the
    // output is whole float4s (F x B x 3 a multiple of 4), else 4.
    const int blocks = gridDim.x * gridDim.y;
    const int L = blockIdx.y * gridDim.x + blockIdx.x;
    const int width = size % 4 == 0 ? 4 : 1;
    const int per = round_up((size + blocks - 1) / blocks, width);
    const int lo = L * per;
    const int len = min(size - lo, per);
    if (len <= 0) return;
    const int parts = gridDim.x;
    const int smem_floats = p.smem_bytes / 4;
    const int runs = max(1, min(threads / len, parts));
    const int run_len = (parts + runs - 1) / runs;
    const int slots = runs * len;
    float* run_sums = reinterpret_cast<float*>(smem_raw);       // [slots]
    float* stage = run_sums + slots;                              // [chunk * len]
    const int chunk = max(1, min(parts, (smem_floats - slots) / len));
    for (int i = tid; i < slots; i += threads) run_sums[i] = 0.0f;
    // copy i of a staged chunk is (partial i / units, width floats at
    // output width * (i % units)): kept as a pair stepped by (threads /
    // units, threads % units), with no division in the loops
    const int units = len / width;
    const int first_q = tid / units, first_u = tid % units;
    const int step_q = threads / units, step_u = threads % units;
    for (int c0 = 0; c0 < parts; c0 += chunk) {
        const int count = min(chunk, parts - c0);
        int q = first_q, u = first_u;
        for (int i = tid; i < count * units; i += threads) {
            const float* src = p.partials + static_cast<int64_t>(c0 + q) * size + lo + u * width;
            if (width == 4)
                cp_async16(stage + 4 * i, src);
            else
                cp_async4(stage + i, src);
            q += step_q;
            u += step_u;
            if (u >= units) {
                u -= units;
                ++q;
            }
        }
        cp_async_commit();
        cp_async_wait_all();
        __syncthreads();
        // slot i is (run i / len, output i % len), stepped the same way
        int run = tid / len, j = tid % len;
        const int run_step = threads / len, j_step = threads % len;
        for (int i = tid; i < slots; i += threads) {
            const int q_end = min((run + 1) * run_len, c0 + count);
            float acc = run_sums[i];
            for (int q2 = max(run * run_len, c0); q2 < q_end; ++q2)
                acc += stage[(q2 - c0) * len + j];
            run_sums[i] = acc;
            run += run_step;
            j += j_step;
            if (j >= len) {
                j -= len;
                ++run;
            }
        }
        __syncthreads();
    }
    for (int k = tid; k < len; k += threads) {
        float sum = run_sums[k];
        for (int r = 1; r < runs; ++r) sum += run_sums[r * len + k];
        p.out[lo + k] = sum;
    }
}

__global__ void hist_empty_kernel() {}

template <typename BinT>
cudaError_t launch(const Params& p, int grid_x, int grid_y, int threads, cudaStream_t stream) {
    // raised once to the most a block may have; the launch asks for its own
    static bool raised = false;
    if (!raised) {
        const cudaError_t err = cudaFuncSetAttribute(
            hist_kernel<BinT>, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
        if (err != cudaSuccess) return err;
        raised = true;
    }
    const dim3 grid(grid_x, grid_y), block(threads);
    if (grid_x == 1) {
        hist_kernel<BinT><<<grid, block, p.smem_bytes, stream>>>(p);
        return cudaGetLastError();
    }
    void* args[] = {const_cast<Params*>(&p)};
    const cudaError_t err = cudaLaunchCooperativeKernel(
        reinterpret_cast<const void*>(hist_kernel<BinT>), grid, block, args, p.smem_bytes, stream);
    return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace

extern "C" {

// Histogram of `n` rows: bins (n, F) row-major with `bin_bytes` 1 (uint8)
// or 4 (int32), stats (n, 3) f32, out (F, B, 3), partials (grid_x, F, B, 3)
// scratch (unused when grid_x is 1), and the launch plan of the wrapper's
// `launch_plan`. Returns a cudaError_t code, 0 on success.
int mmlspark_hist_build(const void* bins, int bin_bytes, const float* stats, int64_t n,
                        int num_features, int num_bins, int grid_x, int grid_y,
                        int feats_per_group, int warps_per_copy, int copies, int tile_rows,
                        int tiles_per_block, int bins_buf_bytes, int gather_pitch,
                        int smem_bytes, float* partials, float* out, int device, void* stream) {
    const int threads = kWarp * warps_per_copy * copies;
    if (threads > kMaxThreads || tile_rows % kWarp || tile_rows > kMaxTileWarps * kWarp ||
        tile_rows > threads || warps_per_copy < 1 || copies < 1 ||
        smem_bytes != smem_bytes_of(copies, feats_per_group, num_bins, warps_per_copy * copies,
                                    tile_rows, bins_buf_bytes) ||
        smem_bytes > kMaxSmem || bins_buf_bytes % 16 || gather_pitch % 4)
        return cudaErrorInvalidValue;
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return err;
    Params p{static_cast<const uint8_t*>(bins), stats, n, num_features, num_bins,
             feats_per_group, warps_per_copy, copies, tile_rows, tiles_per_block,
             bins_buf_bytes, gather_pitch, smem_bytes, partials, out};
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (bin_bytes == 1) return launch<uint8_t>(p, grid_x, grid_y, threads, s);
    if (bin_bytes == 4) return launch<int32_t>(p, grid_x, grid_y, threads, s);
    return cudaErrorInvalidValue;
}

// An empty kernel launched as mmlspark_hist_build would launch a plan of
// this grid (cooperatively when grid_x > 1): the floor of one call's device
// time, for the measurements beside the kernel's.
int mmlspark_hist_empty(int grid_x, int grid_y, int threads, int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return err;
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (grid_x == 1) {
        hist_empty_kernel<<<dim3(grid_x, grid_y), threads, 0, s>>>();
        return cudaGetLastError();
    }
    err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(hist_empty_kernel),
                                      dim3(grid_x, grid_y), dim3(threads), nullptr, 0, s);
    return err != cudaSuccess ? err : cudaGetLastError();
}

const char* mmlspark_cuda_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

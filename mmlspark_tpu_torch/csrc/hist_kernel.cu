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
//   - Above 256 bins a block owns a range of bins of its feature group:
//     grid_y runs over (group, range), and each warp owns one feature and a
//     part of the block's bins, so the block holds one histogram of fg
//     features x Br bins and each warp the lane masks of its part only (16
//     bytes a bin of the block, whatever the warps). A warp scans the
//     tile's kept rows for its feature (a bin, a compare and a ballot a
//     step of 32 rows, four steps' bins read at once), appends the rows
//     whose bin falls in its part to a ring in shared memory in row order
//     ({g, h, count, local bin}), and adds the ring 32 entries at a time
//     through the same lane groups and one read-add-write a bin. So a
//     range costs one more scan of the rows' bins, not one more add of each
//     row, and the ranges lift the limit of a whole feature a block (~14,000
//     bins): any B the output takes. A tile may take a row a thread (stats
//     three floats a thread, prefetched). Along the rows the blocks of one
//     (group, range) are one block (a plain launch) or a cooperative grid
//     with partials as above; several blocks may share an SM, as many as
//     the runtime's occupancy says (`mmlspark_hist_resident_blocks`). The
//     wrapper's `launch_plan` picks among them by a cost model fitted to
//     timed plans (the partials' grid_x x F x B x 12 bytes, each block's
//     tiles and scans).
// The same inputs and launch plan give the same bits on every launch.
//
// The kernel allocates nothing: the caller passes the (grid_x, F, B, 3)
// partials and the (F, B, 3) output, and the launch plan (the wrapper's
// `launch_plan`). Built with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and called through the C interface at the bottom (ctypes). Registers and
// spills (tools/torch_hist_turns.py ptxas): up to 256 bins 64, the cap of
// 1,024-thread blocks, no spill; the ranged variant 82-84, no spill, under
// its 512-thread bound.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kWarp = 32;
constexpr int kChannels = 3;
constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kMaxThreads = 1024;
constexpr int kMaxTileWarps = 8;      // R <= 256 up to 256 bins (above, R <= the threads)
constexpr int kMiscInts = 64;         // [0, 16) kept rows of each warp, [32, 34) kept rows of a buffer
constexpr int kMaxSmem = 232448;      // shared memory a block may use on sm_90
constexpr int kNarrowBins = 256;      // above it, the ranged kernel (kWide)
constexpr int kRing = 64;             // entries of a warp's ring (kWide)
constexpr int kMaxGridY = 65535;
// Above 256 bins a block has at most 16 warps: 128 registers a thread, where
// 1,024 threads cap them at 64 and the ranged kernel spilled (its stats
// prefetch then waited on its loads: 8-15% of its time, PERF.md).
constexpr int kMaxWideThreads = 512;

struct Params {
    const uint8_t* bins;       // (n, F), rows of F * sizeof(BinT) bytes
    const float* stats;        // (n, 3)
    int64_t n;
    int num_features;          // F
    int num_bins;              // B
    int feats_per_group;       // features of one group (the last group may have fewer)
    int warps_per_copy;        // W; above 256 bins a multiple of feats_per_group
    int copies;                // C; 1 above 256 bins
    int bins_per_range;        // Br: bins of a block; B up to 256 bins
    int ranges;                // bin ranges of a feature: grid_y = groups x ranges
    int grid_y;                // blocks along y (gridDim.y x gridDim.z may hold idle ones)
    int tile_rows;             // R, a multiple of 32, at most 256 and at most the threads
    int tiles_per_block;       // tiles of one blockIdx.x
    int bins_buf_bytes;        // one of the two bin staging buffers
    int gather_pitch;          // bytes of one gathered row in a buffer
    int smem_bytes;
    float* partials;           // (gridDim.x, F, B, 3), read when gridDim.x > 1
    float* out;                // (F, B, 3)
};

__host__ __device__ inline int round_up(int x, int m) { return (x + m - 1) / m * m; }

// Bins of a warp's sub-range above 256 bins: the block's Br bins cut in
// warps / feats_per_group parts.
__host__ __device__ inline int sub_range_bins(int bins_per_range, int warps, int feats_per_group) {
    const int parts = warps / feats_per_group;
    return (bins_per_range + parts - 1) / parts;
}

// The dynamic shared memory one block carves: the C histogram copies of
// its Br bins, each warp's lane masks (of the Br bins, or above 256 bins
// of its sub-range, beside its ring of kRing entries), the stats of one
// tile, two buffers of compacted entries (above 256 bins with their bins'
// offsets beside them) and two of bins, and the counters. The wrapper's
// `launch_plan` computes the same total.
__host__ __device__ inline int smem_bytes_of(bool wide, int copies, int feats_per_group,
                                             int bins_per_range, int warps, int tile_rows,
                                             int bins_buf_bytes) {
    const int mask_words =
        wide ? warps * sub_range_bins(bins_per_range, warps, feats_per_group)
             : warps * bins_per_range;
    return 4 * round_up(copies * feats_per_group * bins_per_range * kChannels, 4) +
           4 * round_up(mask_words, 4) + (wide ? 16 * kRing * warps + 2 * 4 * tile_rows : 0) +
           12 * tile_rows + 2 * 16 * tile_rows + 2 * bins_buf_bytes + 4 * kMiscInts;
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
    unsigned* masks;       // warp w's at [w * M, (w + 1) * M): the lanes holding each of its M bins
    float4* ring;          // kWide: warp w's at [w * kRing, (w + 1) * kRing)
    float* stage;
    float4* ent;
    int* off;              // kWide: the entries' byte offsets, 4 bytes apart
    uint8_t* bins;
    int* misc;
    int mask_bins;         // M: Br, or above 256 bins a warp's sub-range
};

template <bool kWide>
__device__ __forceinline__ Smem carve(uint8_t* base, const Params& p) {
    Smem s;
    const int warps = p.copies * p.warps_per_copy;
    s.mask_bins = kWide ? sub_range_bins(p.bins_per_range, warps, p.feats_per_group)
                        : p.bins_per_range;
    s.hist = reinterpret_cast<float*>(base);
    s.masks = reinterpret_cast<unsigned*>(
        s.hist + round_up(p.copies * p.feats_per_group * p.bins_per_range * kChannels, 4));
    s.ring = reinterpret_cast<float4*>(s.masks + round_up(warps * s.mask_bins, 4));
    s.stage = reinterpret_cast<float*>(s.ring + (kWide ? kRing * warps : 0));
    s.ent = reinterpret_cast<float4*>(s.stage + 3 * p.tile_rows);
    s.off = reinterpret_cast<int*>(s.ent + 2 * p.tile_rows);
    s.bins = reinterpret_cast<uint8_t*>(s.off + (kWide ? 2 * p.tile_rows : 0));
    s.misc = reinterpret_cast<int*>(s.bins + 2 * p.bins_buf_bytes);
    return s;
}

// The stats of rows [r0, r0 + rows) into registers, zeros past the end:
// each thread holds floats tid, tid + blockDim.x, ... of the tile's 3R
// (two a thread up to 256 bins; three above, where a tile may take a row
// a thread).
template <int P>
__device__ __forceinline__ void prefetch_stats(const Params& p, int64_t r0, int64_t rows,
                                               float (&pre)[P]) {
    const int64_t lim = rows * kChannels;
#pragma unroll
    for (int j = 0; j < P; ++j) {
        const int i = threadIdx.x + j * blockDim.x;
        pre[j] = i < lim ? __ldg(p.stats + r0 * kChannels + i) : 0.0f;
    }
}

// The stats of the tile of `rows` rows at r0 into s.stage: the floats each
// thread prefetched, then any past them (a block of fewer than 3R / P
// threads), read here.
template <int P>
__device__ __forceinline__ void store_stats(const Params& p, const Smem& s, const float (&pre)[P],
                                            int64_t r0, int64_t rows) {
#pragma unroll
    for (int j = 0; j < P; ++j) {
        const int i = threadIdx.x + j * blockDim.x;
        if (i < 3 * p.tile_rows) s.stage[i] = pre[j];
    }
    const int64_t lim = rows * kChannels;
    for (int i = threadIdx.x + P * blockDim.x; i < 3 * p.tile_rows; i += blockDim.x)
        s.stage[i] = i < lim ? __ldg(p.stats + r0 * kChannels + i) : 0.0f;
}

// Compacts the kept rows of the tile at r0 (stats already in s.stage) into
// entry buffer `buf` in row order, {g, h, count, byte offset of the row's
// bins in bin buffer `buf`}, and starts the copies of their bins.
template <typename BinT, bool kWide>
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
    if constexpr (kWide) {
        // up to 32 warps' counts: a shuffle scan in each warp
        int c = lane < R / kWarp ? s.misc[lane] : 0;
        for (int d = 1; d < kWarp; d *= 2) {
            const int up = __shfl_up_sync(kFullMask, c, d);
            c += lane >= d ? up : 0;
        }
        total = __shfl_sync(kFullMask, c, kWarp - 1);
        before = warp > 0 ? __shfl_sync(kFullMask, c, (warp - 1) % kWarp) : 0;
    } else {
        for (int w = 0; w < R / kWarp; ++w) {
            const int c = s.misc[w];
            before += w < warp ? c : 0;
            total += c;
        }
    }
    const int64_t row_bytes = static_cast<int64_t>(p.num_features) * sizeof(BinT);
    uint8_t* dst = s.bins + buf * p.bins_buf_bytes;
    // the tile's span of bins, from the 16-byte boundary below it: every
    // 16-byte chunk that holds a byte of the tensor lies in its page
    const uintptr_t span = reinterpret_cast<uintptr_t>(p.bins) + r0 * row_bytes;
    const bool dense = p.feats_per_group >= p.num_features && 4 * total >= R;
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
        if constexpr (kWide) s.off[buf * R + k] = offset;
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
    unsigned* masks = s.masks + warp * s.mask_bins;
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

// Above 256 bins: the lanes of warp w hold entries `head` to `head` +
// `count` (at most 32) of its ring, {g, h, count, bin of its sub-range};
// they are added into the sub-range's histogram `hist` as `accumulate`
// adds a step, one writer per bin and in ring (row) order.
__device__ __forceinline__ void add_ring(const float4* ring, unsigned* masks, float* hist,
                                         int head, int count) {
    const int lane = threadIdx.x % kWarp;
    const bool ok = lane < count;
    const float4 e = ok ? ring[(head + lane) & (kRing - 1)] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    const int b = __float_as_int(e.w);
    if (ok) atomicOr(masks + b, 1u << lane);
    __syncwarp();
    const unsigned peers = ok ? masks[b] : 0u;
    __syncwarp();
    if (ok && lane == __ffs(peers) - 1) {
        masks[b] = 0u;
        float a0 = e.x, a1 = e.y, a2 = e.z;
        for (unsigned m = peers & (peers - 1u); m != 0u; m &= m - 1u) {
            const float4 o = ring[(head + __ffs(m) - 1) & (kRing - 1)];   // ascending lanes
            a0 += o.x;
            a1 += o.y;
            a2 += o.z;
        }
        float* h = hist + b * kChannels;
        h[0] += a0;
        h[1] += a1;
        h[2] += a2;
    }
    // the leaders have read their entries before the ring takes new ones
    __syncwarp();
}

// Above 256 bins, what warp w owns: feature w % feats_per_group of the
// block's group and part w / feats_per_group of the block's bins [lo,
// lo + nb), `width` bins from `first` (none where the last group or range
// is short); its ring, masks and histogram; the ring's entries added
// (`head`) and appended (`tail`), counted across the tiles.
struct WideWarp {
    int bin_col;               // the feature's byte offset in a staged row
    float4* ring;
    unsigned* masks;
    float* hist;
    int base;                  // the global bin of the sub-range's first
    int width;
    int head, tail;
};

template <typename BinT>
__device__ __forceinline__ WideWarp wide_warp(const Params& p, const Smem& s, int fg, int lo,
                                              int nb) {
    const int warp = threadIdx.x / kWarp;
    const int f = warp % p.feats_per_group;
    const int first = (warp / p.feats_per_group) * s.mask_bins;
    WideWarp w;
    w.bin_col = f * static_cast<int>(sizeof(BinT));
    w.ring = s.ring + warp * kRing;
    w.masks = s.masks + warp * s.mask_bins;
    w.hist = s.hist + (f * p.bins_per_range + first) * kChannels;
    w.base = lo + first;
    w.width = f < fg ? max(0, min(s.mask_bins, nb - first)) : 0;
    w.head = w.tail = 0;
    return w;
}

// Above 256 bins: warp w scans the kept rows of entry and bin buffer `buf`
// for its feature, appends those whose bin falls in its sub-range to its
// ring in row order, and adds the ring each time it holds 32 entries. The
// bins of kScanSteps steps are read before the first is used, so their
// reads overlap.
constexpr int kScanSteps = 4;

template <typename BinT>
__device__ __forceinline__ void scan_wide(const Params& p, const Smem& s, int buf, WideWarp& w) {
    if (w.width == 0) return;                 // the same for the whole warp
    const int lane = threadIdx.x % kWarp;
    const int kept = s.misc[32 + buf];
    const float4* ent = s.ent + buf * p.tile_rows;
    const int* off = s.off + buf * p.tile_rows;
    const uint8_t* bins = s.bins + buf * p.bins_buf_bytes + w.bin_col;
    const unsigned below = (1u << lane) - 1u;
    for (int k0 = 0; k0 < kept; k0 += kScanSteps * kWarp) {
        unsigned b[kScanSteps];
#pragma unroll
        for (int u = 0; u < kScanSteps; ++u) {
            const int k = k0 + u * kWarp + lane;
            b[u] = k < kept ? static_cast<unsigned>(static_cast<int>(
                                  *reinterpret_cast<const BinT*>(bins + off[k]))) -
                                  static_cast<unsigned>(w.base)
                            : ~0u;
        }
#pragma unroll
        for (int u = 0; u < kScanSteps; ++u) {
            // bins outside [0, B) fall in no sub-range and are dropped
            const bool ok = b[u] < static_cast<unsigned>(w.width);
            const unsigned in = __ballot_sync(kFullMask, ok);
            if (ok) {
                float4 e = ent[k0 + u * kWarp + lane];
                e.w = __int_as_float(static_cast<int>(b[u]));
                w.ring[(w.tail + __popc(in & below)) & (kRing - 1)] = e;
            }
            w.tail += __popc(in);
            if (w.tail - w.head >= kWarp) {
                __syncwarp();
                add_ring(w.ring, w.masks, w.hist, w.head, kWarp);
                w.head += kWarp;
            }
        }
    }
}

// Rows of tile t of a block's range [row_begin, row_end).
__device__ __forceinline__ int rows_of_tile(int64_t row_begin, int64_t row_end, int R, int t) {
    const int64_t left = row_end - row_begin - static_cast<int64_t>(t) * R;
    return static_cast<int>(left < R ? left : R);
}

template <typename BinT, bool kWide>
__global__ void __launch_bounds__(kWide ? kMaxWideThreads : kMaxThreads, 1)
    hist_kernel(const Params p) {
    extern __shared__ __align__(16) uint8_t smem_raw[];
    const Smem s = carve<kWide>(smem_raw, p);
    const int tid = threadIdx.x, threads = blockDim.x;
    const int R = p.tile_rows, B = p.num_bins;
    int group = blockIdx.y, lo = 0, nb = B;      // the block's bins [lo, lo + nb)
    if constexpr (kWide) {
        const int y = blockIdx.z * gridDim.y + blockIdx.y;
        if (y >= p.grid_y) return;   // a plain launch's blocks past grid_y (never a cooperative one's)
        group = y / p.ranges;
        lo = (y % p.ranges) * p.bins_per_range;
        nb = min(p.bins_per_range, B - lo);
    }
    const int f0 = group * p.feats_per_group;
    const int fg = min(p.feats_per_group, p.num_features - f0);

    // the histograms and masks are contiguous and 16-byte aligned
    const int zero_words = static_cast<int>(reinterpret_cast<float*>(s.ring) - s.hist);
    for (int i = tid; i < zero_words / 4; i += threads)
        reinterpret_cast<float4*>(s.hist)[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    WideWarp ww;
    if constexpr (kWide) ww = wide_warp<BinT>(p, s, fg, lo, nb);

    const int64_t row_begin = static_cast<int64_t>(blockIdx.x) * p.tiles_per_block * R;
    const int64_t block_end = row_begin + static_cast<int64_t>(p.tiles_per_block) * R;
    const int64_t row_end = block_end < p.n ? block_end : p.n;
    const int tiles = static_cast<int>((row_end - row_begin + R - 1) / R);

    float pre[kWide ? 3 : 2];
    prefetch_stats(p, row_begin, rows_of_tile(row_begin, row_end, R, 0), pre);
    store_stats(p, s, pre, row_begin, rows_of_tile(row_begin, row_end, R, 0));
    __syncthreads();
    compact<BinT, kWide>(p, s, row_begin, rows_of_tile(row_begin, row_end, R, 0), 0, f0, fg);
    if (tiles > 1)
        prefetch_stats(p, row_begin + R, rows_of_tile(row_begin, row_end, R, 1), pre);
    for (int t = 0; t < tiles; ++t) {
        const int buf = t & 1;
        if (t + 1 < tiles) {
            const int64_t next = row_begin + static_cast<int64_t>(t + 1) * R;
            store_stats(p, s, pre, next, rows_of_tile(row_begin, row_end, R, t + 1));
            __syncthreads();
            compact<BinT, kWide>(p, s, next, rows_of_tile(row_begin, row_end, R, t + 1), buf ^ 1,
                                 f0, fg);
            if (t + 2 < tiles)
                prefetch_stats(p, row_begin + static_cast<int64_t>(t + 2) * R,
                               rows_of_tile(row_begin, row_end, R, t + 2), pre);
        } else {
            cp_async_commit();       // an empty group keeps the count of groups
        }
        cp_async_wait_one();         // this thread's copies of tile t have landed
        __syncthreads();             // everyone's have
        if constexpr (kWide) {
            // the next tile's compaction, which overwrites these buffers,
            // comes after the barrier that follows its stats
            scan_wide<BinT>(p, s, buf, ww);
        } else {
            accumulate<BinT>(p, s, buf, fg);
            __syncthreads();
        }
    }

    const int64_t size = static_cast<int64_t>(p.num_features) * B * kChannels;
    float* part = gridDim.x == 1 ? p.out : p.partials + static_cast<int64_t>(blockIdx.x) * size;
    if constexpr (kWide) {
        // what is left in the rings
        if (ww.tail > ww.head) {
            __syncwarp();
            add_ring(ww.ring, ww.masks, ww.hist, ww.head, ww.tail - ww.head);
        }
        __syncthreads();
        // each feature's nb bins, whole in the output (or partial) from bin lo
        for (int f = 0; f < fg; ++f) {
            float* dst = part + (static_cast<int64_t>(f0 + f) * B + lo) * kChannels;
            const float* src = s.hist + f * p.bins_per_range * kChannels;
            for (int i = tid; i < nb * kChannels; i += threads) dst[i] = src[i];
        }
    } else {
        // the block's partial: its copies summed in copy order
        const int group_floats = fg * B * kChannels;
        const int copy_floats = p.feats_per_group * B * kChannels;
        const int64_t at = static_cast<int64_t>(f0) * B * kChannels;
        float* dst = part + at;
        if ((size | group_floats | copy_floats | at) % 4 == 0) {
            // four floats at a time where every offset is a whole float4 (F x B
            // a multiple of 4, as at B = 256), added as the scalars are
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
    }
    if (gridDim.x == 1) return;

    cg::this_grid().sync();

    // block L sums output slice [L * per, L * per + len) over the partials
    // in block order: the partials' slices are staged in shared memory by
    // asynchronous copies, all in flight at once; slot (run, j) adds up run
    // `run` of consecutive partials at output j; then the runs' sums are
    // added in run order. (len * 2 fits at any B: with gridDim.x > 1 a
    // block's slice is at most half of the histogram a block holds, fg
    // features of Br bins, plus a float4, and the block's shared memory
    // holds that histogram and the lane masks.) Slices are copied 16 bytes
    // at a time where the output is whole float4s (F x B x 3 a multiple of
    // 4), else 4.
    const int blocks = gridDim.x * gridDim.y;
    const int L = blockIdx.y * gridDim.x + blockIdx.x;
    const int width = size % 4 == 0 ? 4 : 1;
    const int64_t share = (size + blocks - 1) / blocks;
    const int64_t per = (share + width - 1) / width * width;
    const int64_t at = L * per;
    if (at >= size) return;
    const int len = static_cast<int>(size - at < per ? size - at : per);
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
            const float* src = p.partials + static_cast<int64_t>(c0 + q) * size + at + u * width;
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
        p.out[at + k] = sum;
    }
}

__global__ void hist_empty_kernel() {}

// The kernel's attributes, set once: shared memory raised to the most a
// block may have (the launch asks for its own), and above 256 bins, where a
// plan may put several blocks on an SM, all of its shared memory for them
// and none for L1.
template <typename BinT, bool kWide>
cudaError_t prepare() {
    static bool done = false;
    if (done) return cudaSuccess;
    cudaError_t err = cudaFuncSetAttribute(
        hist_kernel<BinT, kWide>, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err == cudaSuccess && kWide)
        err = cudaFuncSetAttribute(hist_kernel<BinT, kWide>,
                                   cudaFuncAttributePreferredSharedMemoryCarveout,
                                   cudaSharedmemCarveoutMaxShared);
    done = err == cudaSuccess;
    return err;
}

template <typename BinT, bool kWide>
cudaError_t launch(const Params& p, int grid_x, int threads, cudaStream_t stream) {
    const cudaError_t prepared = prepare<BinT, kWide>();
    if (prepared != cudaSuccess) return prepared;
    // above 256 bins more than 65,535 (group, range) blocks go along z too
    const dim3 plain = kWide ? dim3(grid_x, min(p.grid_y, kMaxGridY),
                                    (p.grid_y + kMaxGridY - 1) / kMaxGridY)
                             : dim3(grid_x, p.grid_y);
    if (grid_x == 1) {
        hist_kernel<BinT, kWide><<<plain, threads, p.smem_bytes, stream>>>(p);
        return cudaGetLastError();
    }
    void* args[] = {const_cast<Params*>(&p)};
    const cudaError_t err = cudaLaunchCooperativeKernel(
        reinterpret_cast<const void*>(hist_kernel<BinT, kWide>), dim3(grid_x, p.grid_y),
        dim3(threads), args, p.smem_bytes, stream);
    return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace

extern "C" {

// Histogram of `n` rows: bins (n, F) row-major with `bin_bytes` 1 (uint8)
// or 4 (int32), stats (n, 3) f32, out (F, B, 3), partials (grid_x, F, B, 3)
// scratch (unused when grid_x is 1), and the launch plan of the wrapper's
// `launch_plan` (grid_y = groups x ranges). Returns a cudaError_t code, 0 on
// success.
int mmlspark_hist_build(const void* bins, int bin_bytes, const float* stats, int64_t n,
                        int num_features, int num_bins, int grid_x, int grid_y,
                        int feats_per_group, int warps_per_copy, int copies, int tile_rows,
                        int tiles_per_block, int bins_buf_bytes, int gather_pitch,
                        int smem_bytes, int bins_per_range, int ranges, float* partials, float* out, int device, void* stream) {
    const bool wide = num_bins > kNarrowBins;
    const int threads = kWarp * warps_per_copy * copies;
    if (threads > (wide ? kMaxWideThreads : kMaxThreads) || tile_rows % kWarp ||
        tile_rows > (wide ? kMaxThreads : kMaxTileWarps * kWarp) ||
        tile_rows > threads || warps_per_copy < 1 || copies < 1 || feats_per_group < 1 ||
        ranges < 1 || bins_per_range < 1 || grid_y % ranges ||
        static_cast<int64_t>(ranges) * bins_per_range < num_bins ||
        static_cast<int64_t>(ranges - 1) * bins_per_range >= num_bins ||
        (wide ? copies != 1 || warps_per_copy % feats_per_group != 0
              : ranges != 1 || bins_per_range != num_bins) ||
        smem_bytes != smem_bytes_of(wide, copies, feats_per_group, bins_per_range,
                                    warps_per_copy * copies, tile_rows, bins_buf_bytes) ||
        smem_bytes > kMaxSmem || bins_buf_bytes % 16 || gather_pitch % 4 ||
        (grid_x > 1 && grid_y > kMaxGridY))
        return cudaErrorInvalidValue;
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return err;
    Params p{static_cast<const uint8_t*>(bins), stats, n, num_features, num_bins,
             feats_per_group, warps_per_copy, copies, bins_per_range, ranges, grid_y,
             tile_rows, tiles_per_block, bins_buf_bytes, gather_pitch, smem_bytes, partials, out};
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (bin_bytes == 1)
        return wide ? launch<uint8_t, true>(p, grid_x, threads, s)
                    : launch<uint8_t, false>(p, grid_x, threads, s);
    if (bin_bytes == 4)
        return wide ? launch<int32_t, true>(p, grid_x, threads, s)
                    : launch<int32_t, false>(p, grid_x, threads, s);
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

// Blocks of `threads` threads and `smem_bytes` of dynamic shared memory
// that one SM of `device` holds at once of the kernel for `bin_bytes` bins
// up to 256 bins (`wide` 0) or above (1), from the runtime's occupancy
// (its registers, shared memory and threads), into *blocks: how large a
// cooperative grid may be. Returns a cudaError_t code, 0 on success.
int mmlspark_hist_resident_blocks(int bin_bytes, int wide, int threads, int smem_bytes,
                                  int device, int* blocks) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return err;
    if (bin_bytes != 1 && bin_bytes != 4) return cudaErrorInvalidValue;
    if (bin_bytes == 1)
        err = wide ? prepare<uint8_t, true>() : prepare<uint8_t, false>();
    else
        err = wide ? prepare<int32_t, true>() : prepare<int32_t, false>();
    if (err != cudaSuccess) return err;
    const void* fn =
        bin_bytes == 1 ? (wide ? reinterpret_cast<const void*>(hist_kernel<uint8_t, true>)
                               : reinterpret_cast<const void*>(hist_kernel<uint8_t, false>))
                       : (wide ? reinterpret_cast<const void*>(hist_kernel<int32_t, true>)
                               : reinterpret_cast<const void*>(hist_kernel<int32_t, false>));
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, fn, threads, smem_bytes);
}

const char* mmlspark_cuda_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

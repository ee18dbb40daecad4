// Flash-attention forward with the per-row logsumexp (K2), for Hopper.
//
// Replaces mmlspark_tpu/nn/attention.py::_flash_fwd_lse, the Pallas TPU
// kernel (body `_flash_kernel`) that kept a (block_q, block_k) score tile
// and the online-softmax state in VMEM across a sequential key-block grid
// axis. Here a block owns a (batch, head, query tile) at a time; a loop
// inside the block walks the key tiles, staged through shared memory, and
// the online-softmax state (running max m, denominator l, the f32
// accumulator) lives in registers. Nothing carries between query tiles,
// so they run in any order.
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
// operations (4 * B * H * Tq * Tk * D; three TF32 products each in f32)
// take about the same time in bf16; at long T, and in f32 at any T, the
// operations bound it. In bf16 below D = 64 neither does: each score costs
// one exponential whatever D is, so the special-function units' rate of
// ex2 sets the floor. What the design does about it, by path:
//   - "wgmma": bf16 with D = 64, 128, 192 or 256 (the serving paths, and
//     every head dim in (128, 256] that is a multiple of 8, read through
//     TMA at its true width) runs both products on Hopper's warpgroup
//     tensor-core instruction, fed by TMA through a ring of key/value
//     tiles in shared memory that a producer warpgroup keeps ahead of the
//     math; see flash_fwd_wgmma_kernel;
//   - "mma": bf16 with D = 8, 16 or 32 runs both products on mma.sync
//     (bf16 in, f32 accumulate), fed by a cp.async ring of key/value
//     tiles, with a softmax that spends its instructions on the
//     exponentials and blocks sized to fill the card; see
//     flash_fwd_mma_kernel;
//   - "tf32x3": f32 up to head dim 128 runs both products on the tensor
//     cores as three TF32 products (3xTF32), which keeps the reference's
//     f32 accuracy (its 2e-5 gate, which one TF32 pass would miss):
//     mma.sync m16n8k8, eight warps of 16 query rows, key/value tiles
//     through a cp.async ring; see flash_fwd_tf32x3_kernel;
//   - "wide": f32 above head dim 128 and bf16 above 256, on the same TF32
//     mma.sync: the head dim split among a block's warps in 64-column
//     chunks, whose partial scores are summed in shared memory in a fixed
//     order, so S is computed once per key tile; see
//     flash_fwd_wide_kernel.
// On every path each key tile is read once per query tile and shared by
// the tile's rows through shared memory; causal tiles wholly after the
// query tile are skipped (their p would be zero, so the outputs do not
// change) and the heaviest causal tiles launch first.
//
// Which kernel runs, at which built head dim and with how many query rows
// a block, is the caller's plan (mmlspark_tpu_torch/nn/attention.py:
// flash_plan); the C interface launches it or refuses it, never another.
// The kernels allocate nothing: the caller passes out and lse. Built with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and called through the C interface at the bottom (ctypes). The wgmma
// path's tensor maps are encoded with libcuda's cuTensorMapEncodeTiled,
// found at run time through cudaGetDriverEntryPoint, so nothing links
// libcuda.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <stdio.h>

#include <atomic>
#include <type_traits>

namespace {

constexpr float kNegInf = -1e30f;  // the TPU kernel's mask value

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
}

// ---------------------------------------------------------------------
// bf16 with D = 64, 128, 192 or 256: the Hopper path. A persistent grid of
// at most one block per SM walks the work items, each a (batch, head,
// 64 W-row query tile): W consumer warpgroups of 64 query rows each over
// the whole head dim, and one producer warpgroup: W = 2 (128 rows, 384
// threads) at D = 64 and 128, and at D = 192 where 128-row items give every
// SM one; else W = 1 (64 rows, 256 threads, twice the items), and always
// at D = 256, where two warpgroups spilled registers and ran slower (the
// caller's plan chooses; PERF.md, PR 9).
//
// - TMA in, no transposes: q, k and v keep the (B, T, H, D) layout. Each
//   has a 4-D tensor map over dims (D, H, T, B) with the caller's strides,
//   whose box (64, 1, rows, 1) copies `rows` rows of 64 columns (128 bytes)
//   into shared memory with the 128-byte swizzle; D takes D / 64 boxes,
//   one per 64-column chunk. TMA zero-fills rows past T, so the ragged edge
//   needs no padding (the mask still decides which keys count), and
//   columns past the tensors' true head dim d (a multiple of 8 in
//   (D - 64, D]), so d needs no pad copy; the epilogue writes columns
//   below d only. The scale is the true d's.
// - A ring of three key/value stages of 128 keys (64 from D = 128), each
//   with a "full" mbarrier per operand (TMA completes it by bytes) and an
//   "empty" one (every consumer thread arrives when it is done with the
//   stage), and two q buffers with their own full/empty pair. One producer
//   thread walks the block's items and their key tiles, waiting for a
//   stage or q buffer to empty before it refills it, so loads run up to
//   three tiles ahead of the math and the next item's q arrives while
//   this one is computed. Where that does not fit in shared memory
//   (WgTiling: D = 192 with two warpgroups, and D = 256) there is one q
//   buffer. Without a mask the items of one head run side by side, so
//   they share its keys and values in L2.
// - Both products on wgmma (bf16 in, f32 accumulate). S = Q.K^T is
//   m64nNk16 (N the key tile) over D / 16 k-steps with Q and K read from
//   shared memory, both K-major (the head dim is contiguous, as stored);
//   Q stays resident for the whole item. O += P.V is m64nDk16
//   with P from registers and V from shared memory as an MN-major operand
//   (the transpose bit): V tiles need no transposed copy. Tile j's PV
//   product and tile j + 1's S product are issued together after tile j's
//   softmax, so one wait covers both (except with two warpgroups at
//   D = 192: WgTiling::kOverlap).
// - The wgmma accumulator gives a thread rows g and g + 8 (g = lane / 4)
//   of its warp's 16 rows and columns 2t, 2t + 1 of every 8-column group
//   (t = lane % 4): the mma.sync C layout, so the online softmax runs in
//   registers with quad shuffles for the row max, and two neighbouring
//   8-key groups of S, rounded to bf16, are the register A fragment of the
//   PV product. That rounding is the TPU kernel's cast of p to v's dtype;
//   l sums the unrounded f32 p.
// - The softmax works in base 2: s * log2(e) is folded into the scale,
//   p = 2^(s - m) with the max m tracked in base 2, and lse = m ln 2 +
//   ln l. Masked keys (past Tk, or after the query under causal) are left
//   out of the max and their p is set to 0 from the mask flags, one bit a
//   key. Two warpgroups take turns at the softmax (named barriers):
//   left alone they fall into step and run their softmaxes, and then
//   their products, at the same time, while in turns one's softmax runs
//   beside the other's products.
// - Shared memory is 128 KB (D = 64), 160 KB (D = 128), 192 KB (D = 192)
//   or 224 KB (D = 256), so one block runs per SM. With two warpgroups its
//   12 warps start with 168 registers a thread; the producer warpgroup
//   drops to 40 with setmaxnreg and the consumers rise to 232. Without it
//   the compiler serializes the wgmma products. With one, its 8 warps have
//   255 from the start (O takes 96 registers a thread at D = 192, 128 at
//   D = 256; S 32, P 16).
// - The warp index comes through a shuffle, so ptxas knows it uniform and
//   the producer/consumer branch is no divergent path: in one, a fence it
//   inserts serializes every wgmma (C7520; 25-40% slower at D > 128).
// - A barrier wait that has not completed after 10 s traps, so a fault
//   (a copy that never lands) fails the launch instead of hanging the card.
// ---------------------------------------------------------------------

constexpr int kWgConsumers = 256;   // threads of two consumer warpgroups
// registers a thread once the producer has given its own up (two consumer
// warpgroups): 384 threads start with 168 each (the most 12 warps leave a
// thread), and 128 x 40 + 256 x 232 is the same 384 x 168. With one
// consumer warpgroup, 256 threads may each hold 255 from the start, and
// nothing is moved
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
constexpr int kSwizzleCols = 64;    // bf16 columns of one 128-byte swizzle row
constexpr uint64_t kWaitLimitNs = 10000000000ull;
constexpr int kSmemLimit = 232448;  // dynamic shared memory a block may take (227 KB)

// W consumer warpgroups of 64 query rows each (a work item of 64 W rows)
// and one producer warpgroup. Keys per ring tile: 128, or 64 from D = 128
// on, where S (kKeys / 2), O (D / 2) and P (kKeys / 4) registers a thread
// must fit beside each other for the products to stay in flight. Three
// ring stages and two q buffers where they fit in shared memory, else
// fewer: the ring keeps its third stage first (one q buffer at D = 192
// with two warpgroups, and at D = 256)
template <int D, int W>
struct WgTiling {
    static constexpr int kRows = 64 * W;                              // query rows an item
    static constexpr int kConsumers = 128 * W;
    static constexpr int kThreads = kConsumers + 128;
    static constexpr int kKeys = D == 64 ? 128 : 64;
    // tile j's PV product in flight beside tile j + 1's S product; not
    // with two warpgroups above D = 128, where O, S and P held at once do
    // not fit the registers ptxas gives a thread (the 168 of 12 warps: it
    // does not count the setmaxnreg rise), so the products serialize:
    // there the two warpgroups' turns are the overlap. (Two warpgroups
    // at D = 256 spilled even so, and one ran faster: D = 256 takes one.)
    static constexpr bool kOverlap = !(W == 2 && D > 128);
    static constexpr int kHalves = D / kSwizzleCols;                  // 64-column boxes a row
    static constexpr int kQBytes = kRows * D * 2;
    static constexpr int kTileBytes = kKeys * D * 2;                  // one K or V tile
    // room for the tiles: the limit less the alignment slack and barriers
    static constexpr int kRoom = kSmemLimit - 1024 - 8 * 16;
    static constexpr int kStages = kQBytes + 6 * kTileBytes <= kRoom ? 3 : 2;
    static constexpr int kQBufs = 2 * kQBytes + 2 * kStages * kTileBytes <= kRoom ? 2 : 1;
    static constexpr int kBarriers = 2 * kQBufs + 3 * kStages;
    // the q buffers, the ring, the barriers, and 1024 bytes of slack to
    // align the swizzled tiles to the 1024-byte period of the 128-byte
    // swizzle
    static constexpr int kSmemBytes =
        kQBufs * kQBytes + 2 * kStages * kTileBytes + 8 * kBarriers + 1024;
    static_assert(kSmemBytes <= kSmemLimit, "wgmma tiles exceed shared memory");
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
                 "r"(bytes)
                 : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    return done != 0;
}

__device__ __forceinline__ uint64_t global_ns() {
    uint64_t t;
    asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
    return t;
}

// wait until the phase of parity `parity` of `bar` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
    if (mbar_try_wait(bar, parity)) return;
    const uint64_t t0 = global_ns();
    while (!mbar_try_wait(bar, parity)) {
        if (global_ns() - t0 > kWaitLimitNs) __trap();
    }
}

// one TMA box of a 4-D map at element coordinates (c0, c1, c2, c3) into
// shared memory at `dst`, completing `bar` by its bytes
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
    asm volatile(
        "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
        : "memory");
}

// wgmma shared-memory matrix descriptor for a 128-byte-swizzled operand:
// start address, leading and stride byte offsets (all in 16-byte units)
// and the layout type 1 (128-byte swizzle) in bits 62-63
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lead, uint32_t stride) {
    return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
           static_cast<uint64_t>((lead & 0x3FFFF) >> 4) << 16 |
           static_cast<uint64_t>((stride & 0x3FFFF) >> 4) << 32 | 1ull << 62;
}

template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// Named barriers 1 and 2 take the two consumer warpgroups' softmaxes in
// turns: warpgroup w waits on barrier 1 + w before its softmax and
// arrives on the other's after it
constexpr int kSoftmaxBarrier = 1;

__device__ __forceinline__ void named_sync(int id) {
    asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(kWgConsumers) : "memory");
}

__device__ __forceinline__ void named_arrive(int id) {
    asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "n"(kWgConsumers) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
    asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keep the compiler from touching accumulator registers while a wgmma
// that writes them may be in flight
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

#define MMLSPARK_ACC8(d, i)                                                              \
    "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]),         \
        "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define MMLSPARK_ACC32(d) \
    MMLSPARK_ACC8(d, 0), MMLSPARK_ACC8(d, 8), MMLSPARK_ACC8(d, 16), MMLSPARK_ACC8(d, 24)
#define MMLSPARK_ACC64(d)                                                                \
    MMLSPARK_ACC8(d, 0), MMLSPARK_ACC8(d, 8), MMLSPARK_ACC8(d, 16), MMLSPARK_ACC8(d, 24), \
        MMLSPARK_ACC8(d, 32), MMLSPARK_ACC8(d, 40), MMLSPARK_ACC8(d, 48), MMLSPARK_ACC8(d, 56)

#define MMLSPARK_ACC96(d) \
    MMLSPARK_ACC64(d), MMLSPARK_ACC8(d, 64), MMLSPARK_ACC8(d, 72), MMLSPARK_ACC8(d, 80), \
        MMLSPARK_ACC8(d, 88)
#define MMLSPARK_ACC128(d)                                                              \
    MMLSPARK_ACC64(d), MMLSPARK_ACC8(d, 64), MMLSPARK_ACC8(d, 72), MMLSPARK_ACC8(d, 80), \
        MMLSPARK_ACC8(d, 88), MMLSPARK_ACC8(d, 96), MMLSPARK_ACC8(d, 104),             \
        MMLSPARK_ACC8(d, 112), MMLSPARK_ACC8(d, 120)

// d (+)= A.B, m64nNk16, A and B from shared memory, both K-major;
// scale_d == 0 ignores d's old value
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, 0, 0;\n}\n"
        : MMLSPARK_ACC32(d)
        : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p, 1, 1, 0, 0;\n}\n"
        : MMLSPARK_ACC64(d)
        : "l"(da), "l"(db), "r"(scale_d));
}

// d += A.B, m64nNk16, A from registers (the mma.sync A fragment per
// warp), B from shared memory MN-major (transpose bit set)
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : MMLSPARK_ACC32(d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : MMLSPARK_ACC64(d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// N = 192 and 256: the O accumulator of head dims 192 and 256
__device__ __forceinline__ void wgmma_rs(float (&d)[96], const uint32_t (&a)[4], uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95}, "
        "{%96, %97, %98, %99}, %100, p, 1, 1, 1;\n}\n"
        : MMLSPARK_ACC96(d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[128], const uint32_t (&a)[4], uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
        "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
        "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
        : MMLSPARK_ACC128(d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ float exp2_approx(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
    return y;
}

// One key tile of the online softmax on a thread's S accumulator `s`
// (raw q.k over NK keys, NK / 2 values: rows r = (i % 4) / 2 of {g, g + 8}, key
// k0 + 8 (i / 4) + 2t + (i % 2)). Leaves p in `s`, updates the base-2
// running max m and the thread's share of l, and returns in corr the
// factor the accumulator must be scaled by. kMasked checks every key
// against Tk and, under causal, the query position.
template <bool kMasked, int NK>
__device__ __forceinline__ void softmax_tile(float (&s)[NK / 2], float (&m)[2],
                                             float (&l)[2], float (&corr)[2], int64_t k0,
                                             const int64_t (&qpos)[2], int64_t tk, int causal,
                                             float scale_log2, int t) {
    // the mask flags, one bit per (row, key) of the thread: bit 2 (i / 4)
    // + (i % 2) of word (i % 4) / 2 keeps key k0 + 8 (i / 4) + 2t + (i % 2)
    uint32_t kept[2] = {0xffffffffu, 0xffffffffu};
    if constexpr (kMasked) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            // keys of this tile at offsets below `lim` count for row r
            int64_t lim = tk - k0;
            if (causal && qpos[r] + 1 - k0 < lim) lim = qpos[r] + 1 - k0;
            const int lim_t = static_cast<int>(lim < 0 ? 0 : lim > NK ? NK : lim) - 2 * t;
            kept[r] = 0;
#pragma unroll
            for (int c = 0; c < NK / 8; ++c) {
                kept[r] |= static_cast<uint32_t>(8 * c < lim_t) << (2 * c);
                kept[r] |= static_cast<uint32_t>(8 * c + 1 < lim_t) << (2 * c + 1);
            }
        }
    }
    auto keep = [&](int i) {
        return !kMasked || ((kept[(i % 4) / 2] >> (2 * (i / 4) + (i % 2))) & 1u);
    };
    // the row max and row sum in four independent chains a row
    float mx4[2][4], ps4[2][4];
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) mx4[r][c] = -INFINITY, ps4[r][c] = 0.0f;
#pragma unroll
    for (int i = 0; i < NK / 2; ++i)
        if (keep(i)) mx4[(i % 4) / 2][(i / 4) % 4] = fmaxf(mx4[(i % 4) / 2][(i / 4) % 4], s[i]);
    float mx[2], m_new[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(fmaxf(mx4[r][0], mx4[r][1]), fmaxf(mx4[r][2], mx4[r][3]));
        // the four threads of a quad hold one row
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        // the scale is positive, so the max of the scaled scores is the
        // scaled max
        m_new[r] = fmaxf(m[r], mx[r] * scale_log2);
        corr[r] = exp2_approx(m[r] - m_new[r]);
        m[r] = m_new[r];
    }
#pragma unroll
    for (int i = 0; i < NK / 2; ++i) {
        const int r = (i % 4) / 2;
        s[i] = keep(i) ? exp2_approx(fmaf(s[i], scale_log2, -m_new[r])) : 0.0f;   // s now holds p
        ps4[r][(i / 4) % 4] += s[i];
    }
#pragma unroll
    for (int r = 0; r < 2; ++r)
        l[r] = l[r] * corr[r] + ((ps4[r][0] + ps4[r][1]) + (ps4[r][2] + ps4[r][3]));
}

// The accumulator scaled by corr, and p rounded to bf16 into the A
// fragments of the PV product's 16-key steps
template <int D, int NK>
__device__ __forceinline__ void scale_and_pack(float (&o)[D / 2], const float (&corr)[2],
                                               const float (&p)[NK / 2],
                                               uint32_t (&pa)[NK / 16][4]) {
    // once the row maxima settle, corr is 1 for the whole warp: skip
    if (__any_sync(0xffffffffu, corr[0] != 1.0f || corr[1] != 1.0f)) {
#pragma unroll
        for (int i = 0; i < D / 2; ++i) o[i] *= corr[(i % 4) / 2];
    }
#pragma unroll
    for (int kt = 0; kt < NK / 16; ++kt) {
        pa[kt][0] = pack_bf16(p[8 * kt], p[8 * kt + 1]);
        pa[kt][1] = pack_bf16(p[8 * kt + 2], p[8 * kt + 3]);
        pa[kt][2] = pack_bf16(p[8 * kt + 4], p[8 * kt + 5]);
        pa[kt][3] = pack_bf16(p[8 * kt + 6], p[8 * kt + 7]);
    }
}

// One work item of the wgmma kernel: a (batch, head, 128-row query tile),
// and how many key tiles it walks (keys after the tile's last query are
// masked for all its rows under causal: skipped). Without a mask the items
// of one head are numbered together, so the blocks that run at once share
// its keys and values in L2; under a causal mask the later query tiles,
// which hold the most keys, come first.
struct WgWork {
    int64_t bh, q0;
    int b, h, n_tiles;
};

template <int NK, int ROWS>
__device__ __forceinline__ WgWork wg_work(int64_t w, int64_t num_bh, int heads,
                                          int64_t num_q_tiles, int64_t tk, int causal) {
    WgWork x;
    x.bh = causal ? w % num_bh : w / num_q_tiles;
    x.q0 = (causal ? num_q_tiles - 1 - w / num_bh : w % num_q_tiles) * ROWS;
    x.b = static_cast<int>(x.bh / heads);
    x.h = static_cast<int>(x.bh % heads);
    int64_t kend = tk;
    if (causal && x.q0 + ROWS < kend) kend = x.q0 + ROWS;
    x.n_tiles = static_cast<int>((kend + NK - 1) / NK);
    return x;
}

// The shared-memory map of the wgmma kernel: the q buffers (work item i
// uses buffer i % kQBufs, so with two the next item's q loads during this
// one), the ring of K/V stages (stage s: K then V, each kHalves swizzled
// (kKeys x 64) boxes) and the mbarriers after them
template <int D, int W>
struct WgSmem {
    using Tl = WgTiling<D, W>;
    static constexpr int S = Tl::kStages;
    static constexpr int QB = Tl::kQBufs;
    uint32_t base, kv, bars;
    __device__ explicit WgSmem(uint32_t b)
        : base(b), kv(b + QB * Tl::kQBytes), bars(b + QB * Tl::kQBytes + 2 * S * Tl::kTileBytes) {}
    __device__ uint32_t q(int buf) const { return base + buf * Tl::kQBytes; }
    __device__ uint32_t q_full(int buf) const { return bars + 8u * buf; }
    __device__ uint32_t q_empty(int buf) const { return bars + 8u * (QB + buf); }
    __device__ uint32_t k_full(int s) const { return bars + 8u * (2 * QB + s); }
    __device__ uint32_t v_full(int s) const { return bars + 8u * (2 * QB + S + s); }
    __device__ uint32_t empty(int s) const { return bars + 8u * (2 * QB + 2 * S + s); }
    __device__ uint32_t k_tile(int s) const { return kv + 2u * s * Tl::kTileBytes; }
    __device__ uint32_t v_tile(int s) const { return kv + (2u * s + 1) * Tl::kTileBytes; }
};

// The consumer warpgroups' part of flash_fwd_wgmma_kernel: for each of the
// block's work items, warpgroup wg owns query rows q0 + 64 wg .. + 63 over
// the whole head dim, so S is computed once per (query tile, key tile).
// `d` is the head dim of q, k, v and out (D's boxes read zeros past it).
template <int D, int W>
__device__ __forceinline__ void consume(const WgSmem<D, W>& sm, int warp, int lane,
                                        __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                                        int64_t num_work, int64_t num_bh, int heads, int64_t tq,
                                        int64_t tk, int64_t num_q_tiles, int d, int causal,
                                        float scale_log2) {
    using Tl = WgTiling<D, W>;
    constexpr int S = Tl::kStages;
    constexpr int QB = Tl::kQBufs;
    constexpr int NK = Tl::kKeys;
    const int wg = warp / 4;
    const int g = lane / 4;
    const int t = lane % 4;
    float o[D / 2];
    float s[NK / 2];
#pragma unroll
    for (int i = 0; i < NK / 2; ++i) s[i] = 0.0f;
    uint32_t pa[NK / 16][4];
    int use = 0;     // ring tiles consumed so far, over all work items
    // warpgroup 0 takes the first softmax turn
    if (W == 2 && wg == 1) named_arrive(kSoftmaxBarrier);

    // S = Q.K^T over D / 16 steps of 16 columns; a step within a 128-byte
    // swizzle row advances the start address by 32 bytes, one to the next
    // 64-column box by the box's bytes, each added to the first
    // descriptor's address field (16-byte units)
    auto issue_qk = [&](int qbuf, int st) {
        const uint64_t da0 = sw128_desc(sm.q(qbuf) + wg * 64 * 128, 16, 1024);
        const uint64_t db0 = sw128_desc(sm.k_tile(st), 16, 1024);
#pragma unroll
        for (int ks = 0; ks < D / 16; ++ks) {
            const uint32_t col = (ks % 4) * 32;
            wgmma_ss(s, da0 + (((ks / 4) * Tl::kRows * 128 + col) >> 4),
                     db0 + (((ks / 4) * NK * 128 + col) >> 4), ks > 0);
        }
        wgmma_commit();
    };

    int item = 0;
    for (int64_t w = blockIdx.x; w < num_work; w += gridDim.x, ++item) {
        const WgWork x = wg_work<NK, Tl::kRows>(w, num_bh, heads, num_q_tiles, tk, causal);
        const int qbuf = item % QB;
        const int64_t wg_q0 = x.q0 + 64 * wg;
        const int64_t qpos[2] = {wg_q0 + 16 * (warp % 4) + g, wg_q0 + 16 * (warp % 4) + g + 8};
#pragma unroll
        for (int i = 0; i < D / 2; ++i) o[i] = 0.0f;
        float m[2] = {kNegInf, kNegInf};
        float l[2] = {0.0f, 0.0f};
        float corr[2];

        // the softmax of tile j, which with two warpgroups runs while the
        // other one's products occupy the tensor cores (the two take
        // turns); a tile inside the sequence and, under causal, wholly at or
        // before the warpgroup's first query has nothing to mask
        auto softmax = [&](int j) {
            const int64_t k0 = static_cast<int64_t>(j) * NK;
            if (W == 2) named_sync(kSoftmaxBarrier + wg);
            if (k0 + NK <= tk && (!causal || k0 + NK - 1 <= wg_q0))
                softmax_tile<false, NK>(s, m, l, corr, k0, qpos, tk, causal, scale_log2, t);
            else
                softmax_tile<true, NK>(s, m, l, corr, k0, qpos, tk, causal, scale_log2, t);
            if (W == 2) named_arrive(kSoftmaxBarrier + 1 - wg);
            scale_and_pack<D, NK>(o, corr, s, pa);
        };
        // O += P.V over NK / 16 steps of 16 keys (16 swizzle rows, 2048
        // bytes), N = D; the leading offset steps between the 64-column
        // boxes of V
        auto issue_pv = [&](int st) {
            mbar_wait(sm.v_full(st), (use / S) & 1);
            wgmma_fence();
#pragma unroll
            for (int kt = 0; kt < NK / 16; ++kt)
                wgmma_rs(o, pa[kt], sw128_desc(sm.v_tile(st) + kt * 2048, NK * 128, 1024));
            wgmma_commit();
        };

        mbar_wait(sm.q_full(qbuf), (item / QB) & 1);
        if (x.n_tiles > 0) {
            mbar_wait(sm.k_full(use % S), (use / S) & 1);
            wgmma_fence();
            issue_qk(qbuf, use % S);
            // Tile j's S product is in flight on entry. After its softmax,
            // tile j's PV product and tile j + 1's S product are issued
            // together, so the wait for the first overlaps the second
            // (kOverlap; else the PV product completes first). The last
            // tile is peeled off: every product in the loop is issued on
            // every pass (a product issued under a branch makes the
            // compiler serialize them all).
            for (int j = 0; j < x.n_tiles - 1; ++j, ++use) {
                wgmma_wait<0>();
                fence_regs(s);
                softmax(j);
                issue_pv(use % S);
                if constexpr (!Tl::kOverlap) {
                    wgmma_wait<0>();
                    fence_regs(o);
                    mbar_arrive(sm.empty(use % S));
                }
                mbar_wait(sm.k_full((use + 1) % S), ((use + 1) / S) & 1);
                if constexpr (!Tl::kOverlap) wgmma_fence();
                issue_qk(qbuf, (use + 1) % S);
                if constexpr (Tl::kOverlap) {
                    wgmma_wait<1>();
                    fence_regs(o);
                    mbar_arrive(sm.empty(use % S));
                }
            }
            wgmma_wait<0>();
            fence_regs(s);
            // q is free for a later item after its last S product
            mbar_arrive(sm.q_empty(qbuf));
            softmax(x.n_tiles - 1);
            issue_pv(use % S);
            wgmma_wait<0>();
            fence_regs(o);
            mbar_arrive(sm.empty(use % S));
            ++use;
        } else {
            mbar_arrive(sm.q_empty(qbuf));
        }

        constexpr float kLn2 = 0.6931471805599453f;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            float lr = l[r] + __shfl_xor_sync(0xffffffffu, l[r], 1);
            lr += __shfl_xor_sync(0xffffffffu, lr, 2);
            if (qpos[r] >= tq) continue;
            const float denom = fmaxf(lr, 1e-30f);
            // one division a row, not one an element
            const float inv = lr > 0.0f ? 1.0f / denom : 0.0f;
            __nv_bfloat16* op = out + ((x.b * tq + qpos[r]) * heads + x.h) * d;
            // d is a multiple of 8: an 8-column group is wholly in or out
#pragma unroll
            for (int n = 0; n < D / 8; ++n) {
                if (D > 128 && n * 8 >= d) break;
                const float x0 = o[4 * n + 2 * r] * inv;
                const float x1 = o[4 * n + 2 * r + 1] * inv;
                *reinterpret_cast<__nv_bfloat162*>(op + n * 8 + 2 * t) =
                    __floats2bfloat162_rn(x0, x1);
            }
            if (t == 0)
                lse[x.bh * tq + qpos[r]] = lr > 0.0f ? m[r] * kLn2 + logf(denom) : INFINITY;
        }
    }
    // warpgroup 1's last hand-over (or its first, if there was no key
    // tile) is taken here, so both barriers end with every arrival matched
    if (W == 2 && wg == 0) named_sync(kSoftmaxBarrier);
}

// Persistent: the grid has at most one block per SM, and block i takes
// work items i, i + gridDim.x, ... The producer runs ahead across items,
// so the next item's q (with two q buffers) and first key tiles load
// while the consumers finish the current one.
template <int D, int W>
__global__ void __launch_bounds__(WgTiling<D, W>::kThreads, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                       const __grid_constant__ CUtensorMap k_map,
                       const __grid_constant__ CUtensorMap v_map,
                       __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                       int64_t num_work, int64_t num_bh, int heads, int64_t tq, int64_t tk,
                       int64_t num_q_tiles, int d, int causal, float scale_log2) {
    using Tl = WgTiling<D, W>;
    constexpr int S = Tl::kStages;
    constexpr int QB = Tl::kQBufs;
    extern __shared__ uint8_t smem_raw[];
    const WgSmem<D, W> sm((smem_addr(smem_raw) + 1023u) & ~1023u);

    if (threadIdx.x == 0) {
        for (int buf = 0; buf < QB; ++buf) {
            mbar_init(sm.q_full(buf), 1);
            mbar_init(sm.q_empty(buf), Tl::kConsumers);
        }
        for (int s = 0; s < S; ++s) {
            mbar_init(sm.k_full(s), 1);
            mbar_init(sm.v_full(s), 1);
            mbar_init(sm.empty(s), Tl::kConsumers);
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    // the warp index through a shuffle: ptxas then knows it uniform (see
    // above)
    const int warp = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x / 32), 0);
    const int lane = threadIdx.x % 32;
    if (warp >= Tl::kConsumers / 32) {
        // with two consumer warpgroups the producer warpgroup gives its
        // registers to them; one thread issues every copy
        if constexpr (W == 2) setmaxnreg_dec<kProducerRegs>();
        if (warp == Tl::kConsumers / 32 && lane == 0) {
            int fill = 0;    // ring tiles filled so far, over all work items
            int item = 0;
            for (int64_t w = blockIdx.x; w < num_work; w += gridDim.x, ++item) {
                const WgWork x =
                    wg_work<Tl::kKeys, Tl::kRows>(w, num_bh, heads, num_q_tiles, tk, causal);
                // the consumers are done with this buffer's previous item
                // (QB items back; the first use of a buffer passes at once)
                const int qbuf = item % QB;
                mbar_wait(sm.q_empty(qbuf), ((item / QB) & 1) ^ 1);
                mbar_expect_tx(sm.q_full(qbuf), Tl::kQBytes);
                for (int c = 0; c < Tl::kHalves; ++c)
                    tma_load_4d(sm.q(qbuf) + c * Tl::kRows * 128, &q_map, sm.q_full(qbuf),
                                c * kSwizzleCols, x.h, static_cast<int>(x.q0), x.b);
                for (int j = 0; j < x.n_tiles; ++j, ++fill) {
                    const int s = fill % S;
                    // a stage's first fill passes at once: the barrier's
                    // phase before phase 0 counts as complete
                    mbar_wait(sm.empty(s), ((fill / S) & 1) ^ 1);
                    const int k0 = j * Tl::kKeys;
                    mbar_expect_tx(sm.k_full(s), Tl::kTileBytes);
                    for (int c = 0; c < Tl::kHalves; ++c)
                        tma_load_4d(sm.k_tile(s) + c * Tl::kKeys * 128, &k_map, sm.k_full(s),
                                    c * kSwizzleCols, x.h, k0, x.b);
                    mbar_expect_tx(sm.v_full(s), Tl::kTileBytes);
                    for (int c = 0; c < Tl::kHalves; ++c)
                        tma_load_4d(sm.v_tile(s) + c * Tl::kKeys * 128, &v_map, sm.v_full(s),
                                    c * kSwizzleCols, x.h, k0, x.b);
                }
            }
        }
    } else {
        if constexpr (W == 2) setmaxnreg_inc<kConsumerRegs>();
        consume<D, W>(sm, warp, lane, out, lse, num_work, num_bh, heads, tq, tk, num_q_tiles, d,
                      causal, scale_log2);
    }
}

// ---------------------------------------------------------------------
// f32 at head dims up to 128: the "tf32x3" path. Both products run on the
// tensor cores as 3xTF32: x = x_hi + x_lo with x_hi = cvt.rna.tf32(x) and
// x_lo = cvt.rna.tf32(x - x_hi), and a.b = a_lo.b_hi + a_hi.b_lo +
// a_hi.b_hi, summed into one f32 accumulator, small terms first. tf32
// products are exact in f32; dropping a_lo.b_lo costs about 2^-22 of
// each product, far inside the reference's f32 gate (atol 2e-5, rtol
// 1e-5), which one TF32 pass (2^-11) misses.
//
// - mma.sync m16n8k8 (tf32 in, f32 accumulate), not wgmma: wgmma takes a
//   tf32 B operand from shared memory only K-major, and in O += P.V the K
//   dim is the key while V is stored (key, D), D contiguous; tf32 has no
//   transpose bit, so wgmma would need a transposed, split copy of every
//   V tile. The split is done in registers, on the fragments a thread
//   loads.
// - Eight warps own 16 query rows each, 128 a block (four warps, 64
//   rows, measured 6% slower at the serving shape: each key tile then
//   feeds half as many rows). Fragments (PTX ISA,
//   "mma.m16n8k8", tf32), g = lane / 4, t = lane % 4: A a0 = (g, k t),
//   a1 = (g + 8, k t), a2 = (g, k t + 4), a3 = (g + 8, k t + 4); B b0 =
//   (k t, n g), b1 = (k t + 4, n g); C c0, c1 = (g, n 2t, 2t + 1), c2, c3
//   = (g + 8, n 2t, 2t + 1).
// - No shuffles between the two products. A product sums over k in any
//   order, so in both products k index t stands for element 2t of an
//   8-wide step and t + 4 for element 2t + 1. Then S's C fragment of an
//   8-key group is, as it stands, the A fragment of the PV step over
//   those keys (a0 = c0, a1 = c2, a2 = c1, a3 = c3); v's B fragment is
//   keys 2t and 2t + 1 of column g; q's and k's fragments are float2
//   loads of dims 2t, 2t + 1.
// - Feed: a ring of three key/value stages in shared memory, filled by
//   cp.async.cg 16-byte copies two tiles ahead of the math (rows past Tk
//   arrive as zeros), one __syncthreads a tile. The q tile is copied once
//   and split at each use, so no register holds it across tiles (at
//   D = 128 its fragments alone would take 128 registers). Row pitches
//   put every fragment load of a warp in 32 distinct banks: q and K rows
//   are padded by 8 floats (16 at D = 8), so a half-warp's float2 loads
//   of rows g at dims 2t cover the banks once; V rows by 4, so the scalar
//   loads of keys 2t (or 2t + 1) x columns g do.
// - The softmax in base 2, as on the wgmma path (scale * log2(e) folded
//   into the scale, lse = m ln 2 + ln l); masked keys are left out of the
//   max and their p set to 0. In f32, p goes to the PV product unrounded
//   (split like any operand), and l sums the same p.
// - Shared memory 40 KB (D = 8) to 173 KB (D = 128): 64-key tiles up to
//   D = 32, 32-key tiles above, so that two blocks share an SM at D = 64.
// - What bounds it: not the tensor pipe. mma.sync m16n8k8 issues TF32 at
//   about three times this kernel's rate when nothing else is in the
//   loop, and three products into one accumulator cost nothing; with the
//   operands split at each use, as here, the rate halves
//   (tools/mma_rate.cu). The instructions around each product (the hi/lo
//   splits, the fragment loads) are the likely limit; taking the splits
//   off the inner loop by storing K and V split doubled the loads and did
//   not gain (PERF.md, the tf32x3 findings).
// ---------------------------------------------------------------------

template <int D>
struct Tf32Tiling {
    static constexpr int kWarps = 8;
    static constexpr int kRows = 16 * kWarps;              // query rows a block
    static constexpr int kThreads = 32 * kWarps;
    static constexpr int kKeys = D >= 64 ? 32 : 64;        // keys a ring tile
    static constexpr int kStages = 3;
    static constexpr int kLdK = D + (D == 8 ? 16 : 8);     // q and K row pitch (floats)
    static constexpr int kLdV = D + 4;                     // V row pitch
    static constexpr int kStageFloats = kKeys * (kLdK + kLdV);
    static constexpr int kSmemBytes = 4 * (kRows * kLdK + kStages * kStageFloats);
};

__device__ __forceinline__ uint32_t tf32_rna(float x) {
    uint32_t r;
    asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
    return r;
}

// x as hi + lo, both tf32 values
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
    hi = tf32_rna(x);
    lo = tf32_rna(x - __uint_as_float(hi));
}

__device__ __forceinline__ void split_frag(const float (&a)[4], uint32_t (&hi)[4],
                                           uint32_t (&lo)[4]) {
#pragma unroll
    for (int i = 0; i < 4; ++i) split_tf32(a[i], hi[i], lo[i]);
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
    asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a.b in 3xTF32, a given split, b as its two f32 values
__device__ __forceinline__ void mma_3xtf32(float (&c)[4], const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4], float b0, float b1) {
    uint32_t bh0, bl0, bh1, bl1;
    split_tf32(b0, bh0, bl0);
    split_tf32(b1, bh1, bl1);
    mma_tf32(c, al, bh0, bh1);
    mma_tf32(c, ah, bl0, bl1);
    mma_tf32(c, ah, bh0, bh1);
}

// a 16-byte copy to shared memory; with `valid` false it reads nothing
// and writes zeros
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
                 "r"(valid ? 16 : 0)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's copy groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// rows [row0, row0 + ROWS) of a (T, D) slice of T (f32 or bf16) with row
// stride `stride` elements into shared memory, by THREADS threads: 16-byte
// chunk c of row i lands at dst + at(i, c); rows at or past `valid` are
// zeros
template <int D, int ROWS, int THREADS, typename T, typename At>
__device__ __forceinline__ void copy_rows_async(uint32_t dst, const T* base, int64_t row0,
                                                int64_t valid, int64_t stride, At at) {
    constexpr int E = 16 / static_cast<int>(sizeof(T));     // elements a chunk
    constexpr int C = D / E;                                // chunks a row
    for (int c = threadIdx.x; c < ROWS * C; c += THREADS) {
        const int i = c / C;
        const int j = c % C;
        const bool ok = row0 + i < valid;
        cp_async16(dst + at(i, j), ok ? base + (row0 + i) * stride + j * E : base, ok);
    }
}

// the byte offset of chunk c of row i in an f32 tile of pitch LD floats
template <int LD>
struct F32Pitch {
    __device__ uint32_t operator()(int i, int c) const { return 4u * (i * LD + 4 * c); }
};

// The online softmax over one key tile of a warp's S accumulator `s` (raw
// q.k; s[n][e] is row g + 8 (e / 2), key k0 + 8n + 2t + e % 2). Leaves p
// in `s`, updates the base-2 running max m and the thread's share of l,
// and scales the accumulator `o` by the change of the max. kMasked checks
// every key against Tk and, under causal, the query position.
template <bool kMasked, int NT, int DT>
__device__ __forceinline__ void softmax_tf32(float (&s)[NT][4], float (&o)[DT][4], float (&m)[2],
                                             float (&l)[2], int64_t k0, const int64_t (&qpos)[2],
                                             int64_t tk, int causal, float scale_log2, int t) {
    auto keep = [&](int n, int e) {
        const int64_t kp = k0 + 8 * n + 2 * t + (e & 1);
        return !kMasked || (kp < tk && (!causal || qpos[e / 2] >= kp));
    };
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
            if (keep(n, e)) mx[e / 2] = fmaxf(mx[e / 2], s[n][e]);
    float m_new[2], corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        // the four threads of a quad hold one row
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        // the scale is positive, so the max of the scaled scores is the
        // scaled max
        m_new[r] = fmaxf(m[r], mx[r] * scale_log2);
        corr[r] = exp2_approx(m[r] - m_new[r]);
        m[r] = m_new[r];
    }
    float ps[2][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}};
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            s[n][e] = keep(n, e) ? exp2_approx(fmaf(s[n][e], scale_log2, -m_new[e / 2])) : 0.0f;
            ps[e / 2][n % 2] += s[n][e];
        }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + (ps[r][0] + ps[r][1]);
    // once the row maxima settle, corr is 1 for the whole warp: skip
    if (__any_sync(0xffffffffu, corr[0] != 1.0f || corr[1] != 1.0f)) {
#pragma unroll
        for (int n = 0; n < DT; ++n) {
            o[n][0] *= corr[0];
            o[n][1] *= corr[0];
            o[n][2] *= corr[1];
            o[n][3] *= corr[1];
        }
    }
}

template <int D>
__global__ void __launch_bounds__(Tf32Tiling<D>::kThreads)
flash_fwd_tf32x3_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, float* __restrict__ out,
                        float* __restrict__ lse, int64_t num_bh, int heads, int64_t tq,
                        int64_t tk, int64_t num_q_tiles, int causal, float scale_log2,
                        int64_t qsb, int64_t qst, int64_t qsh, int64_t ksb, int64_t kst,
                        int64_t ksh, int64_t vsb, int64_t vst, int64_t vsh) {
    using Tl = Tf32Tiling<D>;
    constexpr int BK = Tl::kKeys;
    constexpr int S = Tl::kStages;
    constexpr int NT = BK / 8;        // 8-key groups of S, and k-steps of the PV product
    constexpr int DT = D / 8;         // 8-wide column tiles of O, and k-steps of S
    constexpr int LDK = Tl::kLdK;
    constexpr int LDV = Tl::kLdV;
    extern __shared__ __align__(16) float smem_f32[];
    float* const qs = smem_f32;                                // [kRows][LDK]
    float* const ring = smem_f32 + Tl::kRows * LDK;            // stage s: K [BK][LDK], V [BK][LDV]

    // without a mask the query tiles of one head run side by side and share
    // its keys and values in L2; under a causal mask the later tiles, which
    // hold the most keys, go first
    const int64_t x = blockIdx.x;
    const int64_t bh = causal ? x % num_bh : x / num_q_tiles;
    const int64_t qt = causal ? num_q_tiles - 1 - x / num_bh : x % num_q_tiles;
    const int64_t b = bh / heads;
    const int64_t h = bh % heads;
    const int warp = threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    const int g = lane / 4;
    const int t = lane % 4;
    const int64_t q0 = qt * Tl::kRows;
    const int64_t wq0 = q0 + 16 * warp;          // the warp's first query row
    const int64_t qpos[2] = {wq0 + g, wq0 + g + 8};

    // keys after the tile's last query are masked for every row of the
    // tile under a causal mask: skipped
    int64_t kend = tk;
    if (causal && q0 + Tl::kRows < kend) kend = q0 + Tl::kRows;
    const int n_tiles = static_cast<int>((kend + BK - 1) / BK);

    const float* const kb = k + b * ksb + h * ksh;
    const float* const vb = v + b * vsb + h * vsh;
    constexpr int TH = Tl::kThreads;
    auto load_tile = [&](int j) {
        float* const st = ring + (j % S) * Tl::kStageFloats;
        copy_rows_async<D, BK, TH>(smem_addr(st), kb, static_cast<int64_t>(j) * BK, tk, kst,
                                   F32Pitch<LDK>());
        copy_rows_async<D, BK, TH>(smem_addr(st + BK * LDK), vb, static_cast<int64_t>(j) * BK,
                                   tk, vst, F32Pitch<LDV>());
    };
    // q joins the first group; every group is committed, empty or not, so
    // that the wait below counts the same on every pass
    if (n_tiles > 0)
        copy_rows_async<D, Tl::kRows, TH>(smem_addr(qs), q + b * qsb + h * qsh, q0, tq, qst,
                                          F32Pitch<LDK>());
#pragma unroll
    for (int j = 0; j < S - 1; ++j) {
        if (j < n_tiles) load_tile(j);
        cp_async_commit();
    }

    float o[DT][4];
#pragma unroll
    for (int n = 0; n < DT; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.0f;
    float m[2] = {kNegInf, kNegInf};
    float l[2] = {0.0f, 0.0f};
    // this thread's q row g at dims 2t, 2t + 1; row g + 8 is 8 rows on
    const float* const qrow = qs + (16 * warp + g) * LDK + 2 * t;

    for (int j = 0; j < n_tiles; ++j) {
        // tile j has landed; every thread is done with tile j - 1, whose
        // stage the copies issued next refill
        cp_async_wait<S - 2>();
        __syncthreads();
        if (j + S - 1 < n_tiles) load_tile(j + S - 1);
        cp_async_commit();
        const float* const ks = ring + (j % S) * Tl::kStageFloats;
        const float* const vs = ks + BK * LDK;

        float s[NT][4];
#pragma unroll
        for (int n = 0; n < NT; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.0f;
#pragma unroll
        for (int kk = 0; kk < DT; ++kk) {
            const float2 qa = *reinterpret_cast<const float2*>(qrow + 8 * kk);
            const float2 qb = *reinterpret_cast<const float2*>(qrow + 8 * LDK + 8 * kk);
            const float a[4] = {qa.x, qb.x, qa.y, qb.y};
            uint32_t ah[4], al[4];
            split_frag(a, ah, al);
#pragma unroll
            for (int n = 0; n < NT; ++n) {
                const float2 kv =
                    *reinterpret_cast<const float2*>(ks + (8 * n + g) * LDK + 8 * kk + 2 * t);
                mma_3xtf32(s[n], ah, al, kv.x, kv.y);
            }
        }

        // a tile inside the sequence and, under causal, wholly at or before
        // the warp's first query has nothing to mask
        const int64_t k0 = static_cast<int64_t>(j) * BK;
        if (k0 + BK <= tk && (!causal || k0 + BK - 1 <= wq0))
            softmax_tf32<false>(s, o, m, l, k0, qpos, tk, causal, scale_log2, t);
        else
            softmax_tf32<true>(s, o, m, l, k0, qpos, tk, causal, scale_log2, t);

        // O += P.V, one k-step per 8-key group: p of keys 2t, 2t + 1 is the
        // thread's own S accumulator
        const float* const vrow = vs + 2 * t * LDV + g;
#pragma unroll
        for (int kk = 0; kk < NT; ++kk) {
            const float a[4] = {s[kk][0], s[kk][2], s[kk][1], s[kk][3]};
            uint32_t ah[4], al[4];
            split_frag(a, ah, al);
#pragma unroll
            for (int n = 0; n < DT; ++n)
                mma_3xtf32(o[n], ah, al, vrow[8 * kk * LDV + 8 * n],
                           vrow[(8 * kk + 1) * LDV + 8 * n]);
        }
    }

    constexpr float kLn2 = 0.6931471805599453f;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        float lr = l[r] + __shfl_xor_sync(0xffffffffu, l[r], 1);
        lr += __shfl_xor_sync(0xffffffffu, lr, 2);
        if (qpos[r] >= tq) continue;
        const float denom = fmaxf(lr, 1e-30f);
        // one division a row, not one an element
        const float inv = lr > 0.0f ? 1.0f / denom : 0.0f;
        float* const op = out + ((b * tq + qpos[r]) * heads + h) * D + 2 * t;
#pragma unroll
        for (int n = 0; n < DT; ++n)
            *reinterpret_cast<float2*>(op + 8 * n) =
                make_float2(o[n][2 * r] * inv, o[n][2 * r + 1] * inv);
        if (t == 0) lse[bh * tq + qpos[r]] = lr > 0.0f ? m[r] * kLn2 + logf(denom) : INFINITY;
    }
}

// ---------------------------------------------------------------------
// f32 at every head dim above 128, and bf16 above 256: the "wide" path. A
// warp's O accumulator over the whole head dim would take D / 2 registers
// a thread (128 at D = 256), so the head dim is split among warps instead:
// - A block owns 16 R query rows and (up to kWideMaxCols[T] 64-column
//   chunks) all of D. Its warps form R row groups x CW column warps, CW =
//   the head dim's 64-column chunks. Warp (r, c) keeps the 16 rows of
//   group r of q's chunk c in registers, read once.
// - For each 32-key tile, staged whole (K over the block's columns and V)
//   through a two-stage cp.async ring (three stages measured no faster),
//   warp (r, c) computes its rows'
//   partial scores over chunk c and stores them in shared memory. After a
//   barrier of the row group, each of its warps sums the CW partials in
//   the fixed order c = 0 .. CW - 1, so all of them hold the same bits of
//   S and run the same online softmax (softmax_tf32); each then adds P.V
//   over its own 64 columns. S is computed once per (query tile, key
//   tile), and q is read from memory once.
// - Where CW would pass kWideMaxCols (f32 D > 320, bf16 D > 640), the
//   block's columns are one slice of CW chunks (the grid's y): S is then
//   summed over the head dim in groups of CW chunks, one ring step a
//   group, recomputed by each slice, and q's chunks are read again at each
//   group.
// - f32 runs both products in 3xTF32 on mma.sync m16n8k8 (see the tf32x3
//   path). bf16 operands widen to f32 on load and are exact in TF32 (8
//   significant bits of 11), so one TF32 product a pair is exact; p is
//   rounded to bf16 before the P.V product and l sums the unrounded p, as
//   on every bf16 path.
// - The head dim d needs only 16-byte rows (a multiple of 4 in f32, 8 in
//   bf16): the copies zero-fill columns past d, and the epilogue writes
//   only columns below d. Slice 0's column warp 0 writes lse.
// ---------------------------------------------------------------------

constexpr int kWideKeys = 32;                  // keys a tile
constexpr int kWideMaxWarps = 12;              // R x CW warps a block at most
constexpr int kWideThreads = 32 * kWideMaxWarps;

// 64-column chunks a block may hold: two ring stages of K and V tiles
// and the score partials fit in shared memory
template <typename T>
struct WideTiling {
    static constexpr int kMaxCols = sizeof(T) == 4 ? 5 : 10;
    // K and V row pitch (elements) for CW column chunks: a half-warp's
    // fragment loads of rows g at dims 2t, and V's scalar loads of keys 2t
    // at columns g, fall in distinct banks
    __host__ __device__ static constexpr int ld_k(int cw) { return 64 * cw + 8; }
    __host__ __device__ static constexpr int ld_v(int cw) {
        return 64 * cw + (sizeof(T) == 4 ? 4 : 8);
    }
    __host__ __device__ static constexpr int stage_elems(int cw) {
        return kWideKeys * (ld_k(cw) + ld_v(cw));
    }
    // two stages, then the partials: R x CW warps of 16 x 32 floats
    __host__ __device__ static constexpr int smem_bytes(int r, int cw) {
        return 2 * stage_elems(cw) * static_cast<int>(sizeof(T)) +
               r * cw * 16 * kWideKeys * 4;
    }
};

// rows [row0, row0 + ROWS) of a (T, d) slice with row stride `stride`,
// columns [c0, c0 + 64 cw), into shared memory rows of pitch `ld`, by
// every thread of the block: 16-byte chunks of rows at or past `valid`,
// or of columns at or past d, are zeros
template <int ROWS, typename T>
__device__ __forceinline__ void copy_cols_async(uint32_t dst, const T* base, int64_t row0,
                                                int64_t valid, int64_t stride, int c0, int cw,
                                                int d, int ld) {
    constexpr int E = 16 / static_cast<int>(sizeof(T));     // elements a chunk
    const int per_row = 64 * cw / E;
    for (int c = threadIdx.x; c < ROWS * per_row; c += blockDim.x) {
        const int i = c / per_row;
        const int col = c0 + (c % per_row) * E;
        const bool ok = row0 + i < valid && col < d;
        cp_async16(dst + static_cast<uint32_t>(sizeof(T)) * (i * ld + col - c0),
                   ok ? base + (row0 + i) * stride + col : base, ok);
    }
}

__device__ __forceinline__ float2 load_pair(const float* p) {
    return *reinterpret_cast<const float2*>(p);
}

__device__ __forceinline__ float2 load_pair(const __nv_bfloat16* p) {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__device__ __forceinline__ float load_one(const float* p) { return *p; }

__device__ __forceinline__ float load_one(const __nv_bfloat16* p) { return __bfloat162float(*p); }

// the A fragment of c += a.b: an f32 value as two TF32 halves; a widened
// bf16 value is a TF32 value already (lo stays unused)
template <typename T>
__device__ __forceinline__ void wide_frag(const float (&a)[4], uint32_t (&hi)[4],
                                          uint32_t (&lo)[4]) {
    if constexpr (std::is_same<T, float>::value) {
        split_frag(a, hi, lo);
    } else {
#pragma unroll
        for (int i = 0; i < 4; ++i) hi[i] = __float_as_uint(a[i]);
    }
}

// c += a.b: 3xTF32 in f32, one exact TF32 product in bf16
template <typename T>
__device__ __forceinline__ void wide_mma(float (&c)[4], const uint32_t (&hi)[4],
                                         const uint32_t (&lo)[4], float b0, float b1) {
    if constexpr (std::is_same<T, float>::value)
        mma_3xtf32(c, hi, lo, b0, b1);
    else
        mma_tf32(c, hi, __float_as_uint(b0), __float_as_uint(b1));
}

__device__ __forceinline__ void store_pair(float* p, float a, float b) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float a, float b) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ void named_sync_n(int id, int threads) {
    asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// Launched with 32 R cw threads (R = rows / 16), grid (num_bh x query
// tiles, groups); `groups` = the head dim's chunks over cw, rounded up.
template <typename T>
__global__ void __launch_bounds__(kWideThreads, 1)
flash_fwd_wide_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                      T* __restrict__ out, float* __restrict__ lse, int64_t num_bh, int heads,
                      int64_t tq, int64_t tk, int64_t num_q_tiles, int rows, int cw, int groups,
                      int d, int causal, float scale_log2, int64_t qsb, int64_t qst, int64_t qsh,
                      int64_t ksb, int64_t kst, int64_t ksh, int64_t vsb, int64_t vst,
                      int64_t vsh) {
    using Tl = WideTiling<T>;
    constexpr int BK = kWideKeys;
    constexpr int NT = BK / 8;             // 8-key groups of S, k-steps of the PV product
    constexpr bool kBf16 = !std::is_same<T, float>::value;
    extern __shared__ __align__(16) unsigned char smem_wide[];
    T* const ring = reinterpret_cast<T*>(smem_wide);   // stage: K tile, V tile
    const int ldk = Tl::ld_k(cw);
    const int ldv = Tl::ld_v(cw);
    const int stage = Tl::stage_elems(cw);
    float* const part = reinterpret_cast<float*>(ring + 2 * stage);

    // the block order of the tf32x3 path: a head's query tiles side by
    // side, or under a causal mask the heaviest tiles first
    const int64_t x = blockIdx.x;
    const int64_t bh = causal ? x % num_bh : x / num_q_tiles;
    const int64_t qt = causal ? num_q_tiles - 1 - x / num_bh : x % num_q_tiles;
    const int64_t b = bh / heads;
    const int64_t h = bh % heads;
    const int warp = threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    const int rg = warp / cw;                    // the warp's row group
    const int c = warp % cw;                     // and column warp
    const int g = lane / 4;
    const int t = lane % 4;
    const int64_t q0 = qt * rows;
    const int64_t wq0 = q0 + 16 * rg;
    const int64_t qpos[2] = {wq0 + g, wq0 + g + 8};
    const int slice0 = blockIdx.y * cw * 64;     // the block's first output column
    const int ocol = slice0 + 64 * c;            // the warp's first output column

    int64_t kend = tk;
    if (causal && q0 + rows < kend) kend = q0 + rows;
    const int n_tiles = static_cast<int>((kend + BK - 1) / BK);
    const int n_steps = n_tiles * groups;

    const T* const qb = q + b * qsb + h * qsh;
    const T* const kb = k + b * ksb + h * ksh;
    const T* const vb = v + b * vsb + h * vsh;
    // step st: key tile st / groups, K over the columns of group st %
    // groups, and on a tile's last group also V over the block's slice
    auto load_step = [&](int st) {
        T* const sp = ring + (st % 2) * stage;
        const int64_t k0 = static_cast<int64_t>(st / groups) * BK;
        const int grp = st % groups;
        copy_cols_async<BK>(smem_addr(sp), kb, k0, tk, kst, grp * cw * 64, cw, d, ldk);
        if (grp == groups - 1)
            copy_cols_async<BK>(smem_addr(sp + BK * ldk), vb, k0, tk, vst, slice0, cw, d, ldv);
    };
    if (n_steps > 0) load_step(0);
    cp_async_commit();

    // q's A fragments of chunk col (64 columns, 8 k-steps): rows g and
    // g + 8 at dims 8 kk + 2t, 2t + 1, zeros past Tq or d
    float qa[8][4];
    auto load_q = [&](int col) {
#pragma unroll
        for (int kk = 0; kk < 8; ++kk) {
            const int cc = col + 8 * kk + 2 * t;
#pragma unroll
            for (int r = 0; r < 2; ++r) {
                float2 f = make_float2(0.0f, 0.0f);
                if (qpos[r] < tq && cc < d) f = load_pair(qb + qpos[r] * qst + cc);
                qa[kk][r] = f.x;
                qa[kk][2 + r] = f.y;
            }
        }
    };
    if (groups == 1) load_q(64 * c);

    float o[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.0f;
    float m[2] = {kNegInf, kNegInf};
    float l[2] = {0.0f, 0.0f};
    float s[NT][4];
    // this warp's partial scores, element (n, e) of lane L at (4n + e) 32 + L
    float* const my_part = part + warp * 16 * 32 + lane;
    const float* const group_part = part + rg * cw * 16 * 32 + lane;
    const bool live = wq0 < tq;                  // the row group has rows to write

    for (int st = 0; st < n_steps; ++st) {
        // step st has landed; every thread is done with step st - 1 (its
        // stage, and the partials it read), which the copies issued next
        // and the partials written next replace
        cp_async_wait<0>();
        __syncthreads();
        if (st + 1 < n_steps) load_step(st + 1);
        cp_async_commit();
        const int j = st / groups;
        const int grp = st % groups;
        const int64_t k0 = static_cast<int64_t>(j) * BK;
        // under causal, a tile wholly after the row group's last row leaves
        // its state as it is (p = 0, corr = 1); the whole group skips it
        if (!live || (causal && k0 > wq0 + 15)) continue;
        const T* const ks = ring + (st % 2) * stage;
        const T* const vs = ks + BK * ldk;

        if (grp == 0) {
#pragma unroll
            for (int n = 0; n < NT; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.0f;
        }
        if (groups > 1) load_q((grp * cw + c) * 64);
        // the partial scores over this warp's chunk of the group
#pragma unroll
        for (int kk = 0; kk < 8; ++kk) {
            uint32_t ah[4], al[4];
            wide_frag<T>(qa[kk], ah, al);
#pragma unroll
            for (int n = 0; n < NT; ++n) {
                const float2 kv = load_pair(ks + (8 * n + g) * ldk + 64 * c + 8 * kk + 2 * t);
                wide_mma<T>(s[n], ah, al, kv.x, kv.y);
            }
        }
        if (grp != groups - 1) continue;

        // S: the row group's partials summed in column-warp order, the same
        // bits in each of its warps
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) my_part[(4 * n + e) * 32] = s[n][e];
        named_sync_n(1 + rg, 32 * cw);
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                float sum = group_part[(4 * n + e) * 32];
                for (int cc = 1; cc < cw; ++cc) sum += group_part[cc * 16 * 32 + (4 * n + e) * 32];
                s[n][e] = sum;
            }

        if (k0 + BK <= tk && (!causal || k0 + BK - 1 <= wq0))
            softmax_tf32<false>(s, o, m, l, k0, qpos, tk, causal, scale_log2, t);
        else
            softmax_tf32<true>(s, o, m, l, k0, qpos, tk, causal, scale_log2, t);
        if (ocol >= d) continue;

        // O += P.V over the warp's 64 columns; in bf16 p is rounded to bf16
        // first
        const T* const vrow = vs + 2 * t * ldv + 64 * c + g;
#pragma unroll
        for (int kk = 0; kk < NT; ++kk) {
            float a[4] = {s[kk][0], s[kk][2], s[kk][1], s[kk][3]};
            if constexpr (kBf16) {
#pragma unroll
                for (int i = 0; i < 4; ++i) a[i] = __bfloat162float(__float2bfloat16_rn(a[i]));
            }
            uint32_t ah[4], al[4];
            wide_frag<T>(a, ah, al);
#pragma unroll
            for (int n = 0; n < 8; ++n)
                wide_mma<T>(o[n], ah, al, load_one(vrow + 8 * kk * ldv + 8 * n),
                            load_one(vrow + (8 * kk + 1) * ldv + 8 * n));
        }
    }

    constexpr float kLn2 = 0.6931471805599453f;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        float lr = l[r] + __shfl_xor_sync(0xffffffffu, l[r], 1);
        lr += __shfl_xor_sync(0xffffffffu, lr, 2);
        if (qpos[r] >= tq) continue;
        const float denom = fmaxf(lr, 1e-30f);
        const float inv = lr > 0.0f ? 1.0f / denom : 0.0f;
        T* const op = out + ((b * tq + qpos[r]) * heads + h) * d + ocol + 2 * t;
        // d is a multiple of 4 (f32) or 8 (bf16): a column pair is wholly
        // in or out
#pragma unroll
        for (int n = 0; n < 8; ++n)
            if (ocol + 8 * n + 2 * t < d)
                store_pair(op + 8 * n, o[n][2 * r] * inv, o[n][2 * r + 1] * inv);
        if (t == 0 && c == 0 && blockIdx.y == 0)
            lse[bh * tq + qpos[r]] = lr > 0.0f ? m[r] * kLn2 + logf(denom) : INFINITY;
    }
}

// ---------------------------------------------------------------------
// bf16 with D = 8, 16 or 32: the "mma" path. At these head dims a score
// costs 2 D multiply-adds on the tensor cores but one exponential on the
// special-function units (16 a clock an SM): the exponentials, not the
// bytes, set the floor. Measured, neither they nor the products set the
// time (removing either saves 12% and 23%): a warp runs its S product,
// softmax and PV product in turn, so latency does. Issuing the next
// tile's S product before the softmax needs a second S buffer, which
// spills more under this kernel's 128 registers and ran slower (PERF.md).
// At that cap the kernel as it is spills too: 116 bytes at D = 32, 8 at
// D = 16, none at D = 8 (torch_flash_turns.py ptxas). Lifting the cap at
// D = 32 was 5% faster in 2-warp blocks (kept) and 25% slower in 8-warp
// blocks, where it halves the warps an SM.
//
// - Both products on mma.sync, bf16 in, f32 accumulate: S = Q.K^T is
//   m16n8k16 (m16n8k8 at D = 8, one k-step of 8), O += P.V m16n8k16. Each
//   warp owns 16 query rows. The C fragment gives a thread rows g and
//   g + 8 (g = lane / 4) and keys 2t, 2t + 1 (t = lane % 4) of every
//   8-key group, so two neighbouring groups of S, rounded to bf16, are the
//   A fragment of the PV step over those 16 keys: the TPU kernel's cast of
//   p to v's dtype, while l sums the unrounded f32 p. q's A fragments are
//   read once, straight from global memory into registers.
// - Keys and values through a three-stage cp.async ring of 128-key tiles,
//   two tiles ahead of the math, one __syncthreads a tile; rows past Tk
//   arrive as zeros (the mask decides which keys count). Rows are packed
//   (D = 8: one 16-byte chunk a row) with the chunks XOR-swizzled, so the
//   eight rows each ldmatrix reads at one chunk column fall in the eight
//   16-byte bank groups: K's B fragments come by ldmatrix, V's by
//   ldmatrix.trans (keys 2t, 2t + 1 of column g), four 8x8 matrices a load.
// - The softmax of the wgmma path (softmax_tile, scale_and_pack): base 2
//   with log2(e) folded into the scale and ex2.approx; on whole tiles
//   nothing per score but the max, the fma, the ex2, the add to l and the
//   bf16 pack; mask bits from 32-bit in-tile offsets on edge tiles only;
//   the accumulator's rescale skipped when no row max of the warp moved.
// - Blocks sized to fill the card: 8 warps (128 rows) when that gives
//   every SM a block, else 2 (32 rows). Under causal a warp skips the
//   tiles wholly after its last row, and a warp wholly past Tq skips all.
// ---------------------------------------------------------------------

template <int D, int W>
struct MmaTiling {
    static constexpr int kRows = 16 * W;                   // query rows a block
    static constexpr int kThreads = 32 * W;
    static constexpr int kKeys = 128;                      // keys a ring tile
    static constexpr int kStages = 3;
    static constexpr int kChunks = D / 8;                  // 16-byte chunks a row
    static constexpr int kTileBytes = kKeys * D * 2;       // one K or V tile
    static constexpr int kSmemBytes = kStages * 2 * kTileBytes;
    // blocks an SM that the registers must allow: 16 warps (128 registers
    // a thread), except 2-warp blocks at D = 32, which run at most two an
    // SM: there 4 (255 registers), so nothing spills
    static constexpr int kMinBlocks = D == 32 && W == 2 ? 4 : 16 / W;
};

// the byte offset of chunk c of row i in a packed bf16 tile of D columns,
// swizzled: 8 / C rows share a 128-byte line, and the chunk index is XORed
// with the row's line, so 8 consecutive rows at one chunk column cover the
// line's eight 16-byte bank groups
template <int D>
struct Bf16Swizzle {
    __device__ uint32_t operator()(int i, int c) const {
        constexpr int C = D / 8;
        return static_cast<uint32_t>(i * D * 2 + 16 * (c ^ ((i / (8 / C)) % C)));
    }
};

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(addr));
}

// c += a.b, m16n8k16, bf16 in, f32 accumulate
__device__ __forceinline__ void mma_k16(float* c, const uint32_t (&a)[4], uint32_t b0,
                                        uint32_t b1) {
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a.b, m16n8k8, bf16 in, f32 accumulate: a0 rows g, a1 rows g + 8 at
// k 2t, 2t + 1; b0 k 2t, 2t + 1 of column g
__device__ __forceinline__ void mma_k8(float* c, uint32_t a0, uint32_t a1, uint32_t b0) {
    asm("mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a0), "r"(a1), "r"(b0));
}

template <int D, int W>
__global__ void __launch_bounds__(MmaTiling<D, W>::kThreads, MmaTiling<D, W>::kMinBlocks)
flash_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
                     float* __restrict__ lse, int64_t num_bh, int heads, int64_t tq, int64_t tk,
                     int64_t num_q_tiles, int causal, float scale_log2, int64_t qsb, int64_t qst,
                     int64_t qsh, int64_t ksb, int64_t kst, int64_t ksh, int64_t vsb,
                     int64_t vst, int64_t vsh) {
    using Tl = MmaTiling<D, W>;
    constexpr int BK = Tl::kKeys;
    constexpr int S = Tl::kStages;
    constexpr int C = Tl::kChunks;
    constexpr int KS = D >= 16 ? D / 16 : 1;          // k-steps of the score product
    extern __shared__ __align__(128) uint8_t smem_mma[];
    const uint32_t ring = smem_addr(smem_mma);        // stage s: K tile, then V tile

    // without a mask the query tiles of one head run side by side and share
    // its keys and values in L2; under a causal mask the later tiles, which
    // hold the most keys, go first
    const int64_t x = blockIdx.x;
    const int64_t bh = causal ? x % num_bh : x / num_q_tiles;
    const int64_t qt = causal ? num_q_tiles - 1 - x / num_bh : x % num_q_tiles;
    const int64_t b = bh / heads;
    const int64_t h = bh % heads;
    const int warp = threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    const int g = lane / 4;
    const int t = lane % 4;
    const int64_t q0 = qt * Tl::kRows;
    const int64_t wq0 = q0 + 16 * warp;          // the warp's first query row
    const int64_t qpos[2] = {wq0 + g, wq0 + g + 8};

    // keys after the tile's last query are masked for every row of the
    // tile under a causal mask: skipped
    int64_t kend = tk;
    if (causal && q0 + Tl::kRows < kend) kend = q0 + Tl::kRows;
    const int n_tiles = static_cast<int>((kend + BK - 1) / BK);

    const __nv_bfloat16* const kb = k + b * ksb + h * ksh;
    const __nv_bfloat16* const vb = v + b * vsb + h * vsh;
    auto load_tile = [&](int j) {
        const uint32_t st = ring + (j % S) * 2 * Tl::kTileBytes;
        const int64_t row0 = static_cast<int64_t>(j) * BK;
        copy_rows_async<D, BK, Tl::kThreads>(st, kb, row0, tk, kst, Bf16Swizzle<D>());
        copy_rows_async<D, BK, Tl::kThreads>(st + Tl::kTileBytes, vb, row0, tk, vst,
                                             Bf16Swizzle<D>());
    };
    // every group is committed, empty or not, so that the wait below counts
    // the same on every pass
#pragma unroll
    for (int j = 0; j < S - 1; ++j) {
        if (j < n_tiles) load_tile(j);
        cp_async_commit();
    }

    // q's A fragments: rows g (index 0) and g + 8 (index 1) at dims
    // 16 st + 2t, and (from D = 16) the same rows 8 dims on (indices 2, 3)
    uint32_t qa[KS][4];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        const bool ok = qpos[r] < tq;
        const __nv_bfloat16* const qr = q + b * qsb + h * qsh + (ok ? qpos[r] : 0) * qst + 2 * t;
#pragma unroll
        for (int st = 0; st < KS; ++st) {
            qa[st][r] = ok ? __ldg(reinterpret_cast<const unsigned int*>(qr + 16 * st)) : 0u;
            qa[st][2 + r] =
                ok && D >= 16 ? __ldg(reinterpret_cast<const unsigned int*>(qr + 16 * st + 8)) : 0u;
        }
    }

    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.0f;
    float m[2] = {kNegInf, kNegInf};
    float l[2] = {0.0f, 0.0f};
    float s[BK / 2];
    uint32_t pa[BK / 16][4];
    float corr[2];
    const bool live = wq0 < tq;                   // the warp has rows to write

    for (int j = 0; j < n_tiles; ++j) {
        // tile j has landed; every thread is done with tile j - 1, whose
        // stage the copies issued next refill
        cp_async_wait<S - 2>();
        __syncthreads();
        if (j + S - 1 < n_tiles) load_tile(j + S - 1);
        cp_async_commit();
        const int64_t k0 = static_cast<int64_t>(j) * BK;
        // under causal, a tile wholly after the warp's last row leaves its
        // state as it is (p = 0, corr = 1)
        if (!live || (causal && k0 > wq0 + 15)) continue;
        const uint32_t ks = ring + (j % S) * 2 * Tl::kTileBytes;
        const uint32_t vs = ks + Tl::kTileBytes;

        // S = Q.K^T. Matrix mt of K is 8-key group mt / C at chunk mt % C;
        // an x4 load takes four, i.e. 4 / C whole groups
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) s[i] = 0.0f;
#pragma unroll
        for (int xi = 0; xi < BK / 8 * C / 4; ++xi) {
            const int mt = 4 * xi + lane / 8;
            uint32_t r[4];
            ldsm_x4(r, ks + Bf16Swizzle<D>()(8 * (mt / C) + lane % 8, mt % C));
#pragma unroll
            for (int jj = 0; jj < 4 / C; ++jj) {
                const int n = xi * (4 / C) + jj;
                if constexpr (D == 8) {
                    mma_k8(&s[4 * n], qa[0][0], qa[0][1], r[jj]);
                } else {
#pragma unroll
                    for (int st = 0; st < KS; ++st)
                        mma_k16(&s[4 * n], qa[st], r[jj * C + 2 * st], r[jj * C + 2 * st + 1]);
                }
            }
        }

        // a tile inside the sequence and, under causal, wholly at or before
        // the warp's first query has nothing to mask
        if (k0 + BK <= tk && (!causal || k0 + BK - 1 <= wq0))
            softmax_tile<false, BK>(s, m, l, corr, k0, qpos, tk, causal, scale_log2, t);
        else
            softmax_tile<true, BK>(s, m, l, corr, k0, qpos, tk, causal, scale_log2, t);
        scale_and_pack<D, BK>(o, corr, s, pa);

        // O += P.V. Matrix mt of V is keys 16 (mt / 2C) + 8 (mt % 2) at
        // chunk (mt / 2) % C, transposed; an x4 load takes the (b0, b1)
        // pairs of two (16-key step, 8-column group) products
#pragma unroll
        for (int xi = 0; xi < BK / 16 * C / 2; ++xi) {
            const int mt = 4 * xi + lane / 8;
            uint32_t r[4];
            ldsm_x4_trans(r, vs + Bf16Swizzle<D>()(16 * (mt / (2 * C)) + 8 * (mt % 2) + lane % 8,
                                                   (mt / 2) % C));
#pragma unroll
            for (int jj = 0; jj < 2; ++jj) {
                const int mm = 4 * xi + 2 * jj;
                mma_k16(&o[4 * ((mm / 2) % C)], pa[mm / (2 * C)], r[2 * jj], r[2 * jj + 1]);
            }
        }
    }

    constexpr float kLn2 = 0.6931471805599453f;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        float lr = l[r] + __shfl_xor_sync(0xffffffffu, l[r], 1);
        lr += __shfl_xor_sync(0xffffffffu, lr, 2);
        if (qpos[r] >= tq) continue;
        const float denom = fmaxf(lr, 1e-30f);
        // one division a row, not one an element
        const float inv = lr > 0.0f ? 1.0f / denom : 0.0f;
        __nv_bfloat16* const op = out + ((b * tq + qpos[r]) * heads + h) * D + 2 * t;
#pragma unroll
        for (int n = 0; n < D / 8; ++n)
            *reinterpret_cast<__nv_bfloat162*>(op + 8 * n) =
                __floats2bfloat162_rn(o[4 * n + 2 * r] * inv, o[4 * n + 2 * r + 1] * inv);
        if (t == 0) lse[bh * tq + qpos[r]] = lr > 0.0f ? m[r] * kLn2 + logf(denom) : INFINITY;
    }
}

// libcuda's cuTensorMapEncodeTiled (CUDA 12.0 ABI), looked up once.
using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                   const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                   CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
    static const EncodeTiledFn fn = [] {
        void* p = nullptr;
        cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
        const cudaError_t err = cudaGetDriverEntryPointByVersion(
            "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
        const cudaError_t err =
            cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
        return err == cudaSuccess && found == cudaDriverEntryPointSuccess
                   ? reinterpret_cast<EncodeTiledFn>(p)
                   : nullptr;
    }();
    return fn;
}

// Error codes of the host side, beside cudaError_t's
constexpr int kErrNoEncoder = -1;              // libcuda has no cuTensorMapEncodeTiled
constexpr int kErrPlan = -2;                   // the plan names no kernel built here
constexpr int kErrEncodeBase = -1000;          // -1000 - CUresult of a refused map

// The tensor map of a (B, T, H, D) bf16 tensor over dims (D, H, T, B)
// with element strides st = (batch, time, head), box (64, 1, rows, 1),
// 128-byte swizzle, zeros past the edge. A dim of extent 1 is never
// stepped, so its stride is replaced by a packed one.
CUresult encode_map(EncodeTiledFn enc, CUtensorMap* map, const void* ptr, int d, int heads,
                    int64_t t, int64_t batch, const int64_t* st, uint32_t rows) {
    const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(heads),
                                static_cast<cuuint64_t>(t),
                                static_cast<cuuint64_t>(batch)};
    const int64_t elem[3] = {st[2], st[1], st[0]};            // head, time, batch
    cuuint64_t strides[3];
    int64_t packed = d;
    for (int i = 0; i < 3; ++i) {
        strides[i] = static_cast<cuuint64_t>(dims[i + 1] == 1 ? packed : elem[i]) * 2;
        packed = static_cast<int64_t>(strides[i] / 2) * static_cast<int64_t>(dims[i + 1]);
    }
    const cuuint32_t box[4] = {kSwizzleCols, 1, rows, 1};
    const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
    return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides,
               box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
               CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// Above 48 KB of dynamic shared memory a kernel launches only after this
// attribute is set; set once a device (`configured` holds a bit a device)
template <typename Kernel>
cudaError_t allow_smem(Kernel* kernel, int bytes, int device, std::atomic<uint64_t>& configured) {
    const uint64_t bit = device < 64 ? 1ull << device : 0;
    if (configured.load() & bit) return cudaSuccess;
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err == cudaSuccess) configured.fetch_or(bit);
    return err;
}

template <int D, int W>
int launch_wgmma(const void* q, const void* k, const void* v, void* out, float* lse,
                 int64_t batch, int heads, int64_t tq, int64_t tk, int d, int causal, float scale,
                 const int64_t* st, int device, cudaStream_t stream) {
    using Tl = WgTiling<D, W>;
    const EncodeTiledFn enc = encode_tiled();
    if (enc == nullptr) return kErrNoEncoder;
    CUtensorMap maps[3];
    const void* ptrs[3] = {q, k, v};
    // with no keys the kernel loads no key tile: k and v take q's map
    for (int i = 0; i < (tk > 0 ? 3 : 1); ++i) {
        const CUresult res = encode_map(enc, &maps[i], ptrs[i], d, heads, i == 0 ? tq : tk, batch,
                                        st + 3 * i, i == 0 ? Tl::kRows : Tl::kKeys);
        if (res != CUDA_SUCCESS) return kErrEncodeBase - static_cast<int>(res);
    }
    if (tk == 0) maps[1] = maps[2] = maps[0];
    static std::atomic<uint64_t> configured{0};
    cudaError_t err =
        allow_smem(flash_fwd_wgmma_kernel<D, W>, Tl::kSmemBytes, device, configured);
    if (err != cudaSuccess) return err;
    int sms = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
    const int64_t num_bh = batch * heads;
    const int64_t num_q_tiles = (tq + Tl::kRows - 1) / Tl::kRows;
    const int64_t num_work = num_bh * num_q_tiles;
    if (batch > 0x7fffffffLL || tq > 0x7fffffffLL || tk > 0x7fffffffLL)
        return cudaErrorInvalidConfiguration;
    const int blocks = static_cast<int>(num_work < sms ? num_work : sms);
    constexpr float kLog2e = 1.4426950408889634f;
    flash_fwd_wgmma_kernel<D, W><<<blocks, Tl::kThreads, Tl::kSmemBytes, stream>>>(
        maps[0], maps[1], maps[2], static_cast<__nv_bfloat16*>(out), lse, num_work, num_bh, heads,
        tq, tk, num_q_tiles, d, causal, scale * kLog2e);
    return cudaGetLastError();
}

template <int D>
int launch_tf32x3(const void* q, const void* k, const void* v, void* out, float* lse,
                  int64_t batch, int heads, int64_t tq, int64_t tk, int causal, float scale,
                  const int64_t* st, int device, cudaStream_t stream) {
    using Tl = Tf32Tiling<D>;
    static std::atomic<uint64_t> configured{0};
    const cudaError_t err =
        allow_smem(flash_fwd_tf32x3_kernel<D>, Tl::kSmemBytes, device, configured);
    if (err != cudaSuccess) return err;
    const int64_t num_bh = batch * heads;
    const int64_t num_q_tiles = (tq + Tl::kRows - 1) / Tl::kRows;
    const int64_t blocks = num_bh * num_q_tiles;
    if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
    constexpr float kLog2e = 1.4426950408889634f;
    flash_fwd_tf32x3_kernel<D><<<static_cast<unsigned>(blocks), Tl::kThreads, Tl::kSmemBytes,
                                 stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        static_cast<float*>(out), lse, num_bh, heads, tq, tk, num_q_tiles, causal,
        scale * kLog2e, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8]);
    return cudaGetLastError();
}

// the wide kernel's column warps for head dim d: its 64-column chunks, at
// most WideTiling::kMaxCols
template <typename T>
int wide_cols(int d) {
    const int chunks = (d + 63) / 64;
    return chunks < WideTiling<T>::kMaxCols ? chunks : WideTiling<T>::kMaxCols;
}

template <typename T>
int launch_wide(const void* q, const void* k, const void* v, void* out, float* lse,
                int64_t batch, int heads, int64_t tq, int64_t tk, int d, int rows, int causal,
                float scale, const int64_t* st, int device, cudaStream_t stream) {
    const int cw = wide_cols<T>(d);
    const int groups = ((d + 63) / 64 + cw - 1) / cw;
    if (rows < 16 || rows % 16 || rows / 16 * cw > kWideMaxWarps) return kErrPlan;
    static std::atomic<uint64_t> configured{0};
    const cudaError_t err = allow_smem(flash_fwd_wide_kernel<T>, kSmemLimit, device, configured);
    if (err != cudaSuccess) return err;
    const int64_t num_bh = batch * heads;
    const int64_t num_q_tiles = (tq + rows - 1) / rows;
    const int64_t blocks = num_bh * num_q_tiles;
    if (blocks > 0x7fffffffLL || groups > 65535) return cudaErrorInvalidConfiguration;
    constexpr float kLog2e = 1.4426950408889634f;
    const dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(groups));
    flash_fwd_wide_kernel<T><<<grid, 32 * (rows / 16) * cw,
                               WideTiling<T>::smem_bytes(rows / 16, cw), stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<T*>(out), lse, num_bh, heads, tq, tk, num_q_tiles, rows, cw, groups, d,
        causal, scale * kLog2e, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8]);
    return cudaGetLastError();
}

template <int D, int W>
int launch_mma(const void* q, const void* k, const void* v, void* out, float* lse,
               int64_t batch, int heads, int64_t tq, int64_t tk, int causal, float scale,
               const int64_t* st, int device, cudaStream_t stream) {
    using Tl = MmaTiling<D, W>;
    static std::atomic<uint64_t> configured{0};
    const cudaError_t err =
        allow_smem(flash_fwd_mma_kernel<D, W>, Tl::kSmemBytes, device, configured);
    if (err != cudaSuccess) return err;
    const int64_t num_bh = batch * heads;
    const int64_t num_q_tiles = (tq + Tl::kRows - 1) / Tl::kRows;
    const int64_t blocks = num_bh * num_q_tiles;
    if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
    constexpr float kLog2e = 1.4426950408889634f;
    flash_fwd_mma_kernel<D, W><<<static_cast<unsigned>(blocks), Tl::kThreads, Tl::kSmemBytes,
                                 stream>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out), lse, num_bh,
        heads, tq, tk, num_q_tiles, causal, scale * kLog2e, st[0], st[1], st[2], st[3], st[4],
        st[5], st[6], st[7], st[8]);
    return cudaGetLastError();
}

// the kernels, as the caller's plan names them
constexpr int kPathMma = 0;
constexpr int kPathWgmma = 1;
constexpr int kPathTf32x3 = 2;
constexpr int kPathWide = 3;

// Launches the plan (path, built head dim kd, query rows a block or work
// item) on tensors of head dim d, or returns kErrPlan for a plan no kernel
// here takes: f32 on "tf32x3" at kd = d in {8, ..., 128}, 128 rows; bf16
// on "mma" at kd = d in {8, 16, 32}, 128 or 32 rows (8 or 2 warps); bf16
// on "wgmma" at kd in {64, 128} = d, 128 rows, or kd in {192, 256} from d,
// a multiple of 8 above kd - 64 (TMA reads zeros past d), 128 or 64 rows
// at 192 (two or one consumer warpgroups), 64 at 256; f32 and bf16 on
// "wide" at kd = d above 128 with
// 16-byte rows, rows a multiple of 16 whose row groups times its column
// warps are at most 12.
int launch_plan(int dtype, int plan_path, int kd, int rows, const void* q, const void* k,
                const void* v, void* out, float* lse, int64_t batch, int heads, int64_t tq,
                int64_t tk, int d, int causal, float scale, const int64_t* st, int device,
                cudaStream_t stream) {
#define MMLSPARK_ARGS q, k, v, out, lse, batch, heads, tq, tk, causal, scale, st, device, stream
    if (plan_path == kPathWide) {
        if (kd != d || d <= 128) return kErrPlan;
        if (dtype == 0 && d % 4 == 0)
            return launch_wide<float>(q, k, v, out, lse, batch, heads, tq, tk, d, rows, causal,
                                      scale, st, device, stream);
        if (dtype == 1 && d % 8 == 0)
            return launch_wide<__nv_bfloat16>(q, k, v, out, lse, batch, heads, tq, tk, d, rows,
                                              causal, scale, st, device, stream);
        return kErrPlan;
    }
    if (plan_path == kPathTf32x3 && dtype == 0 && kd == d && rows == 128) {
        switch (kd) {
            case 8: return launch_tf32x3<8>(MMLSPARK_ARGS);
            case 16: return launch_tf32x3<16>(MMLSPARK_ARGS);
            case 32: return launch_tf32x3<32>(MMLSPARK_ARGS);
            case 64: return launch_tf32x3<64>(MMLSPARK_ARGS);
            case 128: return launch_tf32x3<128>(MMLSPARK_ARGS);
            default: return kErrPlan;
        }
    }
    if (plan_path == kPathMma && dtype == 1 && kd == d && (rows == 128 || rows == 32)) {
        const bool w8 = rows == 128;
        switch (kd) {
            case 8: return w8 ? launch_mma<8, 8>(MMLSPARK_ARGS) : launch_mma<8, 2>(MMLSPARK_ARGS);
            case 16:
                return w8 ? launch_mma<16, 8>(MMLSPARK_ARGS) : launch_mma<16, 2>(MMLSPARK_ARGS);
            case 32:
                return w8 ? launch_mma<32, 8>(MMLSPARK_ARGS) : launch_mma<32, 2>(MMLSPARK_ARGS);
            default: return kErrPlan;
        }
    }
#undef MMLSPARK_ARGS
    if (plan_path == kPathWgmma && dtype == 1 && (rows == 128 || rows == 64) && d % 8 == 0 &&
        (kd <= 128 ? d == kd : d > kd - 64 && d <= kd)) {
#define MMLSPARK_WGMMA(D, W)                                                                \
    launch_wgmma<D, W>(q, k, v, out, lse, batch, heads, tq, tk, d, causal, scale, st, device, \
                       stream)
        const bool two = rows == 128;
        switch (kd) {
            case 64: return two ? MMLSPARK_WGMMA(64, 2) : kErrPlan;
            case 128: return two ? MMLSPARK_WGMMA(128, 2) : kErrPlan;
            case 192: return two ? MMLSPARK_WGMMA(192, 2) : MMLSPARK_WGMMA(192, 1);
            case 256: return two ? kErrPlan : MMLSPARK_WGMMA(256, 1);
            default: return kErrPlan;
        }
#undef MMLSPARK_WGMMA
    }
    return kErrPlan;
}

}  // namespace

extern "C" {

// Attention forward of q (B, Tq, H, d) against k, v (B, Tk, H, d), all of
// `dtype` 0 (f32) or 1 (bf16), by the caller's plan: `path` (0 mma.sync in
// bf16, 1 wgmma, 2 3xTF32 on mma.sync, 3 the wide path), the kernel's
// built head dim `kd` and its query rows a block or work item (see
// launch_plan; mmlspark_tpu_torch/nn/attention.py:flash_plan makes the
// plan). `strides` holds the (batch, time, head) element strides of q, k
// and v in that order; the head dim is contiguous. Writes out (B, Tq, H,
// d) contiguous in the input dtype and lse (B, H, Tq) f32. Returns 0 on
// success, else a cudaError_t code or one of the negative codes above
// (mmlspark_flash_error_string names both); a plan no kernel here takes
// launches nothing.
int mmlspark_flash_fwd(const void* q, const void* k, const void* v,
                       void* out, float* lse, int dtype, int64_t batch,
                       int heads, int64_t tq, int64_t tk, int head_dim,
                       int causal, float scale, const int64_t* strides,
                       int device, void* stream, int path, int kd, int rows) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return err;
    if (dtype != 0 && dtype != 1) return cudaErrorInvalidValue;
    return launch_plan(dtype, path, kd, rows, q, k, v, out, lse, batch, heads, tq, tk, head_dim,
                       causal, scale, strides, device, static_cast<cudaStream_t>(stream));
}

const char* mmlspark_flash_error_string(int code) {
    static thread_local char msg[96];
    if (code == kErrNoEncoder) return "libcuda has no cuTensorMapEncodeTiled";
    if (code == kErrPlan) return "no kernel of this library takes the launch plan";
    if (code <= kErrEncodeBase) {
        snprintf(msg, sizeof msg, "cuTensorMapEncodeTiled refused a tensor map (CUresult %d)",
                 kErrEncodeBase - code);
        return msg;
    }
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

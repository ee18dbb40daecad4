"""K2's launch plan (`flash_plan`), on the CPU.

The plan decides, for a CUDA tensor, which kernel of csrc/flash_attn.cu
runs, at which built head dim, whether the inputs are first copied into
zero-padded tensors, and how many query rows a block or work item takes.
The kernels refuse a plan they cannot launch, so these rules are the
port's whole dispatch: every head dim 1..320 in both dtypes, every
chip_smoke.FLASH_SHAPES row against the path its smoke row asserts, the
fill rules of the "mma" and "wgmma" paths, and the "wide" kernel's warps
and shared memory.
"""

import math

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import chip_smoke  # noqa: E402
from mmlspark_tpu_torch.nn import attention as att  # noqa: E402

SMS = 132                         # an H100 SXM
SMEM_LIMIT = 232448               # dynamic shared memory a block may take


def _expected(dtype, d):
    """(path, built D, width read, pad copy) restated from the kernels'
    head dims: f32 up to 128 and bf16 up to 32 on the mma.sync kernels at
    8/16/32/64/128; bf16 up to 256 on wgmma at 64/128 (padded) or 192/256
    (unpadded where rows are 16 bytes); the rest on "wide" unpadded where
    rows are 16 bytes."""
    built = [8, 16, 32, 64, 128]
    if dtype == torch.float32 and d <= 128 or dtype == torch.bfloat16 and d <= 32:
        dk = min(x for x in built if x >= d)
        return ("tf32x3" if dtype == torch.float32 else "mma"), dk, dk, dk != d
    if dtype == torch.bfloat16 and d <= 128:
        dk = 64 if d <= 64 else 128
        return "wgmma", dk, dk, dk != d
    if dtype == torch.bfloat16 and d <= 256:
        width = math.ceil(d / 8) * 8
        return "wgmma", 192 if d <= 192 else 256, width, width != d
    width = math.ceil(d / (4 if dtype == torch.float32 else 8)) * (4 if dtype == torch.float32
                                                                  else 8)
    return "wide", width, width, width != d


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_plan_of_every_head_dim_up_to_320(dtype):
    elem = 4 if dtype == torch.float32 else 2
    for d in range(1, 321):
        plan = att.flash_plan(dtype, d, 4, 4, 512, SMS)
        assert (plan.path, plan.d_kernel, plan.width, plan.pad) == _expected(dtype, d), d
        # what the kernel reads has 16-byte rows and is never narrower
        assert plan.width >= d and plan.width * elem % 16 == 0, (d, plan)
        if plan.path == "wgmma" and plan.d_kernel > 128:
            # the tensor maps read zeros past the width; no box lies wholly past it
            assert plan.d_kernel - 64 < plan.width <= plan.d_kernel, (d, plan)
        if plan.path == "wide":
            assert d > (128 if dtype == torch.float32 else 256)
    # no pad copy above 128 wherever the rows are 16 bytes
    for d in range(129, 321):
        plan = att.flash_plan(dtype, d, 4, 4, 512, SMS)
        assert plan.pad == (d * elem % 16 != 0), d


@pytest.mark.parametrize("row", chip_smoke.FLASH_SHAPES, ids=[r[0] for r in chip_smoke.FLASH_SHAPES])
def test_plan_of_every_smoke_row_is_the_path_it_asserts(row):
    name, b, tq, tk, h, d, dtype, causal = row
    plan = att.flash_plan(dtype, d, b, h, tq, SMS)
    assert plan.path == chip_smoke.flash_path(dtype, d), name
    assert plan.pad == chip_smoke.flash_pads(dtype, d), name


@pytest.mark.parametrize("d", [136, 160, 192])
def test_wgmma_takes_64_row_items_only_where_128_row_items_leave_sms_idle(d):
    # the serving shape of the d192 rows: 4 x 4 heads x 4 tiles of 128 rows
    # = 64 items on 132 SMs, so 128 items of 64 rows
    assert att.flash_plan(torch.bfloat16, d, 4, 4, 512, SMS).rows == 64
    # slice_transformer's minibatch: 64 x 8 heads x 4 tiles = 2,048 items
    assert att.flash_plan(torch.bfloat16, d, 64, 8, 512, SMS).rows == 128
    for b, h, tq in [(1, 1, 1), (2, 8, 1000), (8, 4, 1024), (33, 1, 512), (1, 132, 128),
                     (1, 131, 128), (1, 66, 129)]:
        items = b * h * math.ceil(tq / 128)
        want = 128 if items >= SMS else 64
        assert att.flash_plan(torch.bfloat16, d, b, h, tq, SMS).rows == want, (b, h, tq)


@pytest.mark.parametrize("d", [200, 256])
def test_wgmma_takes_64_row_items_at_head_dim_256(d):
    # one consumer warpgroup at any fill (PERF.md PR 9: two ran slower)
    for b, h, tq in [(1, 1, 1), (4, 4, 512), (16, 4, 512), (64, 8, 512)]:
        assert att.flash_plan(torch.bfloat16, d, b, h, tq, SMS).rows == 64, (b, h, tq)


@pytest.mark.parametrize("d", [40, 64, 96, 128])
def test_wgmma_takes_128_row_items_at_head_dims_up_to_128(d):
    # where 64-row items ran slower (ragged_causal_bf16, PERF.md PR 9)
    for b, h, tq in [(1, 1, 1), (2, 8, 1000), (64, 8, 512)]:
        assert att.flash_plan(torch.bfloat16, d, b, h, tq, SMS).rows == 128, (b, h, tq)


@pytest.mark.parametrize("d", [8, 16, 24, 32])
def test_mma_takes_8_warp_blocks_only_where_they_give_every_sm_one(d):
    for b, h, tq in [(64, 4, 512), (4, 4, 300), (16, 4, 300), (1, 132, 128), (1, 131, 128)]:
        items = b * h * math.ceil(tq / 128)
        want = 128 if items >= SMS else 32
        assert att.flash_plan(torch.bfloat16, d, b, h, tq, SMS).rows == want, (b, h, tq)
    # f32 blocks are 128 rows at any shape
    assert att.flash_plan(torch.float32, d, 1, 1, 1, SMS).rows == 128


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_wide_blocks_fit_their_warps_and_shared_memory(dtype):
    elem = 4 if dtype == torch.float32 else 2
    max_cols = 5 if dtype == torch.float32 else 10
    for d in list(range(129, 1025, 4)) + [2048, 4096]:
        plan = att.flash_plan(dtype, d, 4, 4, 512, SMS)
        if plan.path != "wide":
            continue
        cols = min(math.ceil(plan.width / 64), max_cols)
        groups = math.ceil(math.ceil(plan.width / 64) / cols)
        r = plan.rows // 16
        assert plan.rows % 16 == 0 and 1 <= r <= 4 and r * cols <= 12, (d, plan)
        # as many row groups as the warps allow
        assert r == 4 or (r + 1) * cols > 12, (d, plan)
        # two stages of 32 keys of K (pitch + 8) and V (pitch + 4 in f32, + 8
        # in bf16), then the partial scores: 16 x 32 floats a warp
        ld_k, ld_v = 64 * cols + 8, 64 * cols + (4 if elem == 4 else 8)
        smem = 2 * 32 * (ld_k + ld_v) * elem + r * cols * 16 * 32 * 4
        assert smem <= SMEM_LIMIT, (d, smem)
        # S once per key tile wherever a block holds the whole head dim
        assert (groups == 1) == (plan.width <= 64 * max_cols), d


def test_plan_refuses_what_no_kernel_takes():
    with pytest.raises(ValueError, match="head dim 0"):
        att.flash_plan(torch.float32, 0, 1, 1, 1, SMS)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        att.flash_plan(torch.float16, 64, 1, 1, 1, SMS)

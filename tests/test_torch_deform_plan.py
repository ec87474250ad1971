"""K4's launch plan (``vlfm_tpu_torch.ops.deform_gather.deform_plan``) on
the CPU.

The plan is the kernel's whole launch: the tap vector, the lane groups, the
tile, the sample loop, the bulk copies, the grid and the shared memory
(``csrc/deform_gather.cu:smem_bytes``: 16 bytes of mbarriers, two sample
tables of 32 bytes a sample, and with bulk copies two stage buffers of each
tile's grids and weights, each 16-byte aligned). Every expected figure below
is worked out by hand from those rules, for GroundingDINO's encoder and
decoder shapes, the shapes of ``chip_smoke.py`` phase 13 and of the card
tests, a misaligned value or grids pointer, odd and wide heads, and sample
counts that force fewer warps or refuse the call.
"""

import pytest
import torch

from vlfm_tpu_torch.ops import deform_gather as D

F32, BF16 = torch.float32, torch.bfloat16
ENC = (8, 13294, 8, 32, 4, 4)  # B, Q = S, nh, dh, levels, points
DEC = (8, 900, 8, 32, 4, 4)
FIELDS = ("vec", "load_bytes", "lanes", "chunks", "items_per_warp", "warps", "tile_items", "samples", "bulk",
          "grid", "smem_bytes")


@pytest.mark.parametrize("shape,dtypes,aligns,want", [
    # GroundingDINO: f32 value, 16-byte taps over 8 lanes; 32 items x 16
    # samples a tile: 16 + 64 * 512 + 2 * (4096 + 2048) bytes; 2 blocks an SM.
    (ENC, (F32, F32), (16, 16), (4, 16, 8, 1, 4, 8, 32, "16", True, 264, 45072)),
    (ENC, (BF16, BF16), (16, 16), (8, 16, 4, 1, 8, 8, 64, "16", True, 264, 86032)),
    (DEC, (F32, F32), (16, 16), (4, 16, 8, 1, 4, 8, 32, "16", True, 264, 45072)),
    (DEC, (BF16, F32), (16, 16), (8, 16, 4, 1, 8, 8, 64, "16", True, 264, 90128)),
    # chip_smoke.py's and the CPU tests' ragged shape: 9 samples, generic loop.
    ((1, 70, 2, 16, 3, 3), (F32, F32), (16, 16), (4, 16, 4, 1, 8, 8, 64, "generic", True, 3, 50704)),
    ((1, 70, 2, 16, 3, 3), (BF16, F32), (16, 16), (8, 16, 2, 1, 16, 8, 128, "generic", True, 2, 101392)),
    # The card tests' shapes.
    ((2, 1200, 8, 32, 4, 4), (F32, F32), (16, 16), (4, 16, 8, 1, 4, 8, 32, "16", True, 264, 45072)),
    ((2, 900, 8, 32, 4, 4), (BF16, F32), (16, 16), (8, 16, 4, 1, 8, 8, 64, "16", True, 225, 90128)),
    ((1, 33, 3, 40, 1, 2), (BF16, BF16), (16, 16), (8, 16, 8, 1, 4, 8, 32, "generic", True, 4, 5392)),
    ((1, 5, 1, 128, 2, 20), (F32, BF16), (16, 16), (4, 16, 32, 1, 1, 8, 8, "generic", True, 1, 26896)),
    # An odd head: one element a lane, 33 of them over 32 lanes x 2.
    ((1, 5, 1, 33, 2, 8), (F32, F32), (16, 16), (1, 4, 32, 2, 1, 8, 8, "16", True, 1, 11280)),
    ((1, 5, 1, 33, 2, 8), (BF16, BF16), (16, 16), (1, 2, 32, 2, 1, 8, 8, "16", True, 1, 10768)),
    # A value view 4 or 8 bytes off a 16-byte boundary: narrower taps.
    ((2, 1200, 8, 32, 4, 4), (F32, F32), (4, 16), (1, 4, 32, 1, 1, 8, 8, "16", True, 264, 11280)),
    ((2, 1200, 8, 32, 4, 4), (F32, F32), (8, 16), (2, 8, 16, 1, 2, 8, 16, "16", True, 264, 22544)),
    ((2, 1200, 8, 32, 4, 4), (BF16, F32), (4, 16), (2, 4, 16, 1, 2, 8, 16, "16", True, 264, 22544)),
    # Grids or weights off a 16-byte boundary: the threads read them.
    (ENC, (F32, F32), (16, 4), (4, 16, 8, 1, 4, 8, 32, "16", False, 264, 32784)),
    # 1,000 samples an item: fewer warps until a block fits its share.
    ((1, 2, 1, 128, 8, 125), (F32, F32), (16, 16), (4, 16, 32, 1, 1, 1, 1, "generic", True, 2, 88016)),
    # 1,001 samples: a tile's 8,008 grid bytes are no multiple of 16.
    ((1, 2, 1, 128, 7, 143), (F32, F32), (16, 16), (4, 16, 32, 1, 1, 1, 1, "generic", False, 2, 64080)),
])
def test_plan(shape, dtypes, aligns, want):
    plan = D.deform_plan(*shape, *dtypes, aligns[0], tables_align=aligns[1])
    assert {k: getattr(plan, k) for k in FIELDS} == dict(zip(FIELDS, want))
    assert plan.block == 32 * plan.warps
    assert plan.items_per_warp * plan.lanes == 32
    assert plan.lanes * plan.chunks * plan.vec >= shape[3] > plan.lanes // 2 * plan.chunks * plan.vec


def test_plan_grid_follows_the_card():
    assert D.deform_plan(*ENC, F32, F32, 16, sms=114).grid == 228
    assert D.deform_plan(1, 10, 8, 32, 4, 4, F32, F32, 16, sms=114).grid == 3  # 80 items, 3 tiles


def test_plan_refuses_samples_beyond_shared_memory():
    with pytest.raises(ValueError, match="3200 samples per item"):
        D.deform_plan(1, 2, 1, 128, 8, 400, F32, F32, 16)


def test_plan_describes_itself():
    text = D.deform_plan(*ENC, F32, F32, 16).describe()
    assert text.startswith("16-byte taps, 8 lanes x 1 an item, 4 items a warp, 32 a tile, 16-sample loop")
    assert "bulk copies" in text and "264 blocks x 256 threads, 45072 B shared" in text


@pytest.mark.parametrize("ptr,want", [(0, 16), (4096, 16), (4100, 4), (4104, 8), (4098, 2), (4097, 1)])
def test_alignment(ptr, want):
    assert D.alignment(ptr) == want

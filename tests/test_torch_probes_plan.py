"""T5's launch plan (`probes.pairloop_plan`), host-side: the units of work
(batch row, row block of `PAIRLOOP_ROWS` q rows, head) a block takes and
the blocks of a launch, checked against the kernel's cut of the units into
contiguous ranges (block i: units [i * per, (i + 1) * per))."""

import pytest

from tokensgen_tpu_torch.kernels import probes as P

SMS = 132  # an H100's SMs


def _ranges(units, per, blocks):
    return [range(i * per, min(units, (i + 1) * per)) for i in range(blocks)]


@pytest.mark.parametrize("batch,sq,heads,block_q,sms", [
    (1, 17776, 48, P.PAIRLOOP_WAVE, SMS),  # the script's cross1 call
    (2, 17776, 48, P.PAIRLOOP_WAVE, SMS),
    (1, 17776, 48, 1024, SMS),
    (2, 300, 8, P.PAIRLOOP_WAVE, SMS),  # the card tests' shape
    (2, 300, 8, 128, SMS),
    (1, 1, 4, P.PAIRLOOP_WAVE, SMS),
    (3, 1000, 5, P.PAIRLOOP_WAVE, 7),
])
def test_pairloop_plan_covers_every_unit_once(batch, sq, heads, block_q, sms):
    """Every unit falls in exactly one block's range, no block is empty, and
    the one-wave plan launches at most one block a SM."""
    per, blocks = P.pairloop_plan(batch, sq, heads, block_q, sms)
    units = batch * -(-sq // P.PAIRLOOP_ROWS) * heads
    seen = [u for r in _ranges(units, per, blocks) for u in r]
    assert seen == list(range(units))
    assert all(len(r) > 0 for r in _ranges(units, per, blocks))
    if block_q == P.PAIRLOOP_WAVE:
        assert blocks <= sms


def test_pairloop_plan_at_the_script_shape():
    """17,776 q rows x 48 heads: 139 row blocks, 6,672 units; one wave gives
    131 blocks of 51 units (the makespan of 132 even blocks, 50.5, rounded
    up), where whole row blocks of the script's 1,024 rows give 18 blocks of
    384 units (8 row blocks x 48 heads)."""
    assert P.pairloop_plan(1, 17776, 48, P.PAIRLOOP_WAVE, SMS) == (51, 131)
    assert P.pairloop_plan(1, 17776, 48, 1024, SMS) == (384, 18)
    assert P.pairloop_plan(1, 17776, 48, 128, SMS) == (48, 139)


@pytest.mark.parametrize("block_q", [64, 100, -128])
def test_pairloop_plan_refuses_other_blocks(block_q):
    with pytest.raises(ValueError):
        P.pairloop_plan(1, 17776, 48, block_q, SMS)


def test_pairloop_block_q_values_are_planned():
    """Every value of `PAIRLOOP_BLOCK_Q` has a plan (the wrapper's check and
    the plan agree)."""
    for block_q in P.PAIRLOOP_BLOCK_Q:
        per, blocks = P.pairloop_plan(1, 17776, 48, block_q, SMS)
        assert per >= 1 and blocks >= 1


# T7's output-tile walk (`probes.matmul_tiles`, the kernel's `tile_coords`):
# the DiT's four dense shapes at M = 36,352 (the CLI's) and ragged ones
MATMUL_SHAPES = [(36352, 12288), (36352, 3072), (36352, 9216), (300, 136), (1000, 520),
                 (128, 256), (1, 8), (4096, 2048)]


@pytest.mark.parametrize("m,n", MATMUL_SHAPES)
def test_matmul_tiles_cover_every_tile_once(m, n):
    """Tile ids 0 .. tiles - 1 map onto every (row tile, column tile) of an
    [m, n] output exactly once, and the blocks of a persistent grid (block i:
    ids i, i + grid, ...) share them out with none left over or taken
    twice."""
    tm, tn = -(-m // P.MATMUL_TILE[0]), -(-n // P.MATMUL_TILE[1])
    order = P.matmul_tiles(m, n)
    assert sorted(order) == [(i, j) for i in range(tm) for j in range(tn)]
    grid = min(SMS, tm * tn)  # the kernel's persistent grid
    taken = sorted(t for b in range(grid) for t in range(b, tm * tn, grid))
    assert taken == list(range(tm * tn))


@pytest.mark.parametrize("m,n", MATMUL_SHAPES)
def test_matmul_tiles_raster_groups(m, n):
    """Consecutive ids walk `MATMUL_GROUP` row tiles down one column tile
    before the next column (fewer in the last group), so the ids of one
    group hold only its own row tiles and every column tile."""
    tm, tn = -(-m // P.MATMUL_TILE[0]), -(-n // P.MATMUL_TILE[1])
    order = P.matmul_tiles(m, n)
    per = P.MATMUL_GROUP * tn
    for start in range(0, tm * tn, per):
        group = order[start:start + per]
        first = start // per * P.MATMUL_GROUP
        rows = min(tm - first, P.MATMUL_GROUP)
        assert {r for r, _ in group} == set(range(first, first + rows))
        assert group == [(first + i % rows, i // rows) for i in range(len(group))]


def test_matmul_tiles_at_ff_up():
    """ff up ([36,352, 3072] x [3072, 12288]): 284 x 48 = 13,632 tiles of 128
    x 256 on 132 blocks; the first wave (ids 0-131) reads 8 row tiles of a
    and 17 column tiles of b (where row-major order would read 3 and 48)."""
    order = P.matmul_tiles(36352, 12288)
    assert len(order) == 284 * 48
    wave = order[:SMS]
    assert len({r for r, _ in wave}) == 8 and len({c for _, c in wave}) == 17


# T1's tiles (`probes.SWEEP_CONFIGS`, csrc/probes_hopper.cuh `SweepGeom`) and
# T4a's resident keys (`pairinner_smem_bytes`): the host mirrors of their
# builds' shared memory
SMEM_MAX = 232448  # an H100 block's


@pytest.mark.parametrize("config", P.SWEEP_CONFIGS)
def test_sweep_config_is_on_the_documented_axes(config):
    """Every built T1 tile is a combination of `SWEEP_AXES` (block_q 128 /
    256, block_kv 128 / 192, hblk 1 / 2) with at most two chains a
    warpgroup, and the default is one of them."""
    bq, bkv, hb = config
    assert bq in P.SWEEP_AXES["block_q"] and bkv in P.SWEEP_AXES["block_kv"]
    assert hb in P.SWEEP_AXES["hblk"] and bq // 128 * hb <= 2
    assert P.SWEEP_DEFAULT in P.SWEEP_CONFIGS


@pytest.mark.parametrize("config", P.SWEEP_CONFIGS)
def test_sweep_geometry_fits_a_block(config):
    """T1's shared memory at each built tile: the q tile and at least two
    K / V slots (every slot that fits, up to four) within a block's 227 KB,
    and one more slot would not fit where fewer than four are taken."""
    bq, bkv, hb = config
    smem = P.sweep_smem_bytes(bq, bkv, hb)
    # K and V of hblk heads, the tile's key biases (bkv + 4 floats in whole 128 bytes)
    slot = hb * 2 * bkv * 128 + -(-(bkv + 4) * 4 // 128) * 128
    slots = (smem - 1024 - hb * bq * 128 - 8) // (slot + 16)
    assert 2 <= slots <= P.SWEEP_MAX_SLOTS and smem <= SMEM_MAX
    if slots < P.SWEEP_MAX_SLOTS:
        assert smem + slot + 16 > SMEM_MAX


def test_sweep_geometry_at_the_built_tiles():
    """(128, 128, 1): 16 KB of q, four 32 KB slots; (128, 128, 2): 32 KB of
    q (two heads), three 64 KB slots; (256, 128, 1): 32 KB of q, four 32 KB
    slots; each slot with 640 bytes for its key biases (132 floats), plus 1 KB of slack
    and the mbarriers."""
    assert P.sweep_smem_bytes(128, 128, 1) == 1024 + 16384 + 4 * (32768 + 640) + 8 * 9
    assert P.sweep_smem_bytes(128, 128, 2) == 1024 + 32768 + 3 * (65536 + 640) + 8 * 7
    assert P.sweep_smem_bytes(256, 128, 1) == 1024 + 32768 + 4 * (32768 + 640) + 8 * 9


@pytest.mark.parametrize("skv", [1, 100, 128, 129, 256, 300, 480, 511, P.RESIDENT_MAX])
def test_pairinner_geometry_fits_a_block(skv):
    """T4a holds ceil(Skv / 128) K' / V tiles of 32 KB whole, with each
    warpgroup's q slots and staging box, within a block's shared memory at
    every Skv up to `RESIDENT_MAX`; at 128 keys or fewer two blocks fit a
    SM (228 KB)."""
    smem = P.pairinner_smem_bytes(skv)
    assert smem <= SMEM_MAX
    assert smem - P.pairinner_smem_bytes(1) == (-(-skv // 128) - 1) * 32768
    if skv <= 128:
        assert 2 * (smem + 1024) <= 228 * 1024


@pytest.mark.parametrize("block_q", P.PAIRINNER_BLOCK_Q)
def test_pairinner_waves_at_the_script_shape(block_q):
    """T4a's grid at the script's cross1 call (17,776 q rows, 48 heads) on
    132 SMs, one block a SM: 512 rows give 35 q blocks (1,680 blocks, 12.7
    waves), 1,024 give 18 (864, 6.5), 2,048 give 9 (432, 3.3); the last
    wave's idle share is what its blocks leave of 132."""
    blocks, waves, idle = P.pairinner_waves(1, 17776, 48, block_q, 132)
    q_blocks = {512: 35, 1024: 18, 2048: 9}[block_q]
    assert blocks == 48 * q_blocks and waves == pytest.approx(blocks / 132)
    assert idle == pytest.approx((132 - blocks % 132) / 132)
    assert P.pairinner_waves(2, 17776, 48, block_q, 132)[0] == 2 * blocks
    assert P.pairinner_waves(1, 17776, 48, block_q, 132, per_sm=2)[1] == pytest.approx(waves / 2)


def test_pairinner_waves_without_a_tail():
    """A grid that fills its last wave leaves no slot idle."""
    assert P.pairinner_waves(1, 1024 * 11, 12, 1024, 132) == (132, 1.0, 0.0)

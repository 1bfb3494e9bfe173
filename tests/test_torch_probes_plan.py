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

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

"""`tokensgen_tpu_torch/train/memory.py`: the port's training memory budget
per card, from its modules built on the meta device, against the JAX
package's `train/memory.py` rows built from the JAX trees, and its fit
verdicts for one H100 80 GB card."""

import pytest

from tokensgen_tpu.train import memory as JM
from tokensgen_tpu_torch.train import memory as TM


@pytest.fixture(scope="module")
def jax_rows():
    """The JAX budgets at one data rank without accumulation (the port sums
    micro-batch gradients in ``.grad``: no accumulator row to hold)."""
    return {"to2v": JM.to2v_budget(per_device_batch=2, accum=1, zero_ranks=1).rows,
            "t2to": JM.t2to_budget(per_device_batch=3, accum=1, zero_ranks=1).rows}


def _opt(rows):
    return next(v for k, v in rows.items() if k.startswith("optimizer"))


def test_parameter_and_optimizer_rows_match_jax(jax_rows):
    """The parameter rows equal the JAX trees' bytes; the optimizer rows
    too, f32 AdamW to 1e-6 GiB (JAX adds a few int32 step counts) and the
    int8 AdamW to 0.5% (the port's tensors split some of the JAX leaves, so
    a few more fall under the 4,096-value threshold that keeps f32
    moments)."""
    t2to = TM.t2to_budget(per_device_batch=3, zero_ranks=1).rows
    j = jax_rows["t2to"]
    assert t2to["params (f32 masters, replicated)"] == pytest.approx(
        j["params (f32 masters, replicated)"], abs=1e-9)
    assert t2to["bf16 compute copy (per-block transient)"] == pytest.approx(
        j["bf16 compute copy (per-block transient)"], abs=1e-9)
    assert _opt(t2to) == pytest.approx(_opt(j), abs=1e-6)
    to2v = TM.to2v_budget(per_device_batch=2, zero_ranks=1).rows
    j = jax_rows["to2v"]
    for key in ("frozen base params (bf16, replicated)", "trainable masters (f32, replicated)"):
        assert to2v[key] == pytest.approx(j[key], abs=1e-9), key
    assert _opt(to2v) == pytest.approx(_opt(j), rel=5e-3)


def test_shipped_t2to_fits_one_card_only_under_zero1():
    """`train_t2to.yaml` as shipped (f32 AdamW, bs 3, 24 chunks): 16 B a
    parameter does not fit one 80 GB card at one rank; ZeRO-1 over 4 cards
    brings the optimizer state to a quarter and the total under the card."""
    one, four = TM.t2to_budget(zero_ranks=1), TM.t2to_budget(zero_ranks=4)
    assert not one.fits(), one.table()
    assert four.fits(), four.table()
    assert _opt(four.rows) == pytest.approx(_opt(one.rows) / 4, rel=1e-3)
    assert 20.0 < four.rows["params (f32 masters, replicated)"] < 21.5
    int8 = TM.t2to_budget(zero_ranks=1, use_8bit_adam=True)
    assert _opt(int8.rows) < _opt(one.rows) / 3.5


def test_to2v_budget_and_activations_scale():
    """The To2V adapter trainer fits one card at bs 2; ZeRO-1 divides its
    int8 state; the checkpointed block inputs scale with the batch."""
    b1, b2 = TM.to2v_budget(per_device_batch=1), TM.to2v_budget(per_device_batch=2)
    assert b2.fits(), b2.table()
    key = "checkpointed block inputs (bf16)"
    assert b2.rows[key] == pytest.approx(2 * b1.rows[key])
    assert _opt(TM.to2v_budget(zero_ranks=4).rows) < _opt(b2.rows) / 3.5
    assert "DOES NOT FIT" in TM.t2to_budget(zero_ranks=1).table()

"""T6's key-split form on the CPU (`probes.flash_loop_split_plain`, the card's
decomposition of the chained flash loop: per split of the keys and per chain,
the chain's q recomputed from k[:, :d] by the split itself, the split's
partial acc, the int32 / f32 workspace, out = f32(acc_a + acc_b)) held to
T6's plain version `flash_loop_plain` (int8 bit-equal; bf16 within 1e-5 of
the output's largest entry: the split products sum in another grouping) and
to the JAX package's Pallas probe (`_flash_like_kernel`,
tools/bench_pallas_int8.py) in interpret mode, with ragged m and n and
n = d; and the split plan `flash_loop_split` at the CLI's shapes. Inputs are
made from a seed with numpy."""

import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from tokensgen_tpu_torch.kernels import probes as P

TOL = 1e-5  # bf16: f32 sums regrouped by the splits


def _inputs(dtype, m, n, d, seed):
    rng = np.random.default_rng(seed)
    shapes = ((m, d), (d, n), (n, d))
    if dtype == "int8":
        return [rng.integers(-127, 127, s).astype(np.int8) for s in shapes]
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _torch(arrs, dtype):
    return [torch.from_numpy(a.astype(np.float32)).to(getattr(torch, dtype)) for a in arrs]


def _agree(got, want, dtype):
    if dtype == "int8":
        assert torch.equal(got, want)
    else:
        assert (got - want).abs().max() <= TOL * want.abs().max()


# (m, n, d, split): ragged m (not a multiple of the card's 64 rows), n ragged
# to the split and to the chunk, n = d (one split holding the chain's keys),
# a split that is a multiple of the chunk with a short last split
@pytest.mark.parametrize("m, n, d, split", [(40, 208, 128, 128), (40, 128, 128, 128),
                                            (72, 400, 128, 256), (24, 96, 16, 32)])
@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
def test_split_form_matches_plain(dtype, m, n, d, split):
    """The key-split form against `flash_loop_plain` at 5 steps."""
    args = _torch(_inputs(dtype, m, n, d, seed=m + n + split), dtype)
    _agree(P.flash_loop_split_plain(*args, 5, split), P.flash_loop_plain(*args, 5), dtype)


@pytest.mark.parametrize("m, n, split", [(40, 208, 128), (24, 128, 128)])
@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
def test_split_form_matches_pallas_probe(dtype, m, n, split):
    """The key-split form at d = 128 against `_flash_like_kernel` in interpret
    mode for 3 steps (ragged m and n; n = d): int8 bit-equal; bf16 within
    1e-2 of the output's largest entry, as tests/test_torch_probes.py holds
    the plain version (an f32 sum's last bit can move one bf16 rounding)."""
    mod = importlib.import_module("tools.bench_pallas_int8")
    d, iters = 128, 3
    arrs = _inputs(dtype, m, n, d, seed=7 + n)
    jdt, acc = (jnp.int8, jnp.int32) if dtype == "int8" else (jnp.bfloat16, jnp.float32)
    jargs = [jnp.asarray(a, jdt) for a in arrs]
    want = np.asarray(pl.pallas_call(
        functools.partial(mod._flash_like_kernel, acc_t=acc, iters=iters),
        out_shape=jax.ShapeDtypeStruct((m, d), jnp.float32), interpret=True)(*jargs))
    targs = [torch.from_numpy(np.asarray(a.astype(jnp.float32))).to(getattr(torch, dtype))
             for a in jargs]
    got = P.flash_loop_split_plain(*targs, iters, split).numpy()
    if dtype == "int8":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-2 * np.abs(want).max())


@pytest.mark.parametrize("dtype, n, split", [(torch.int8, 2048, 512), (torch.int8, 1024, 256),
                                             (torch.bfloat16, 2048, 256),
                                             (torch.bfloat16, 1024, 256)])
def test_split_plan_at_cli_shapes(dtype, n, split):
    """At the CLI's m = 2,048 on 132 SMs: int8 holds 512 keys a block at n =
    2,048 (128 blocks, one wave) and 256 at 1,024 (128 blocks, where 512
    would leave half the card idle); bf16 256 at both (256 blocks in two
    waves at 2,048). Every split is a multiple of the chunk within what a
    block holds."""
    got = P.flash_loop_split(2048, n, dtype, 132)
    assert got == split
    assert got % P.FLASH_LOOP_CHUNK[dtype] == 0 and got <= P.FLASH_LOOP_MAX_SPLIT[dtype]


def test_split_plan_small_shapes():
    """A few rows and keys: one chunk a block when that alone fills no wave."""
    assert P.flash_loop_split(40, 208, torch.int8, 132) == 128
    assert P.flash_loop_split(40, 208, torch.bfloat16, 132) == 64
    assert P.flash_loop_split(40, 128, torch.bfloat16, 132) == 64

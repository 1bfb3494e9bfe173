"""The float32 K4's 3xTF32 split (csrc/attention_f32.cu), on the host, with
no card: the TF32 rounding it applies, hi + lo against x, and the kernel's
arithmetic (q', k, p and v split; each product as hi.lo + lo.hi + hi.hi;
the exp2 softmax) against a float64 attention within the card bounds the
kernel is held to. One TF32 pass (hi.hi) falls outside them."""

import numpy as np
import pytest
import torch

# the float32 K4's card bounds (chip_smoke.py, tests/test_torch_kernels_cuda.py):
# relative L2 error and max abs error relative to max|ref|
F32_REL_L2_BOUND = 1e-5
F32_MAX_ABS_REL = 2.0 ** -14
LOG2E = 1.4426950408889634


def rna_tf32(x: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32 on the int32 view of float32 ``x``: round to 10
    mantissa bits, ties away from zero, by adding half a unit of the 13
    dropped bits to the magnitude and clearing them (the kernel's tf32());
    inf and nan pass through."""
    bits = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    r = (bits + 0x1000) & 0xFFFFE000
    r = torch.where(r >= 2 ** 31, r - 2 ** 32, r).to(torch.int32).view(torch.float32)
    return torch.where(torch.isfinite(x), r, x)


def rna_reference(x: np.ndarray) -> np.ndarray:
    """The nearest TF32 value to float32 ``x``, ties away from zero, in
    float64: TF32 keeps float32's exponent range and 10 mantissa bits, so its
    unit in the last place is 2^(e - 10) for |x| in [2^e, 2^(e + 1)), e >=
    -126 (denormals 2^-136 apart); past the largest TF32 value it rounds to
    inf."""
    a = np.abs(x.astype(np.float64))
    e = np.maximum(np.floor(np.log2(np.where(a > 0, a, 1.0))), -126.0)
    ulp = np.exp2(e - 10.0)
    with np.errstate(over="ignore"):
        return np.copysign(np.floor(a / ulp + 0.5) * ulp, x).astype(np.float32)


def split(x: torch.Tensor):
    """x = hi + lo, both TF32, as the kernel splits every operand."""
    hi = rna_tf32(x)
    return hi, rna_tf32(x - hi)


def _bits(x: torch.Tensor) -> list:
    return (x.view(torch.int32).to(torch.int64) & 0xFFFFFFFF).tolist()


def _f32(*bits) -> torch.Tensor:
    return torch.tensor([b - 2 ** 32 if b >= 2 ** 31 else b for b in bits],
                        dtype=torch.int32).view(torch.float32)


@pytest.mark.parametrize("x,want", [
    (0x3F800000, 0x3F800000),  # 1.0: a TF32 value
    (0xC0600000, 0xC0600000),  # -3.5: a TF32 value
    (0x3F802000, 0x3F802000),  # 1 + 2^-9: the last TF32 mantissa bit set
    (0x3F801000, 0x3F802000),  # 1 + 2^-11: a tie, away from zero (even would give 1)
    (0xBF801000, 0xBF802000),  # its negative: away from zero
    (0x3F800FFF, 0x3F800000),  # just under the tie: down
    (0x3F801001, 0x3F802000),  # just over the tie: up
    (0x3F7FF000, 0x3F800000),  # a tie that carries into the exponent
    (0x7F7FE000, 0x7F7FE000),  # the largest finite TF32 value
    (0x7F7FEFFF, 0x7F7FE000),  # under the tie above it
    (0x7F7FF000, 0x7F800000),  # the tie above it: past the range, inf
    (0x7F7FFFFF, 0x7F800000),  # float32's largest: inf
    (0x00000001, 0x00000000),  # the smallest denormal: to zero
    (0x00000FFF, 0x00000000),  # a denormal under a tie
    (0x00001000, 0x00002000),  # a denormal tie: away from zero
    (0x80001000, 0x80002000),  # its negative
    (0x007FF000, 0x00800000),  # the largest denormal's tie: the smallest normal
    (0x7F800000, 0x7F800000),  # inf passes
    (0xFF800000, 0xFF800000),  # -inf passes
])
def test_rna_tf32_hand_picked(x, want):
    """Exact TF32 values, ties, the largest finite values and denormals:
    the integer form against the expected bits and against the float64
    rounding."""
    out = rna_tf32(_f32(x))
    assert _bits(out) == [want]
    xf = _f32(x).numpy()
    if np.isfinite(xf).all():
        assert _bits(torch.from_numpy(rna_reference(xf))) == [want]


def test_rna_tf32_passes_nan():
    """Every nan stays nan, whatever its payload (the integer form alone
    would turn 0x7F800001 into inf and 0x7FFFFFFF into -0)."""
    x = _f32(0x7FC00000, 0x7F800001, 0x7FFFFFFF, 0xFFC00000)
    assert torch.isnan(rna_tf32(x)).all()


def test_rna_tf32_matches_float64_rounding():
    """On 200,000 random finite bit patterns (every exponent, denormals
    included) the integer form is the float64 round-to-nearest, ties away,
    bit for bit."""
    rng = np.random.default_rng(22)
    bits = rng.integers(0, 2 ** 32, size=200_000, dtype=np.uint64)
    bits = bits[(bits >> 23 & 0xFF) != 0xFF]  # finite
    x = torch.from_numpy(bits.astype(np.uint32).view(np.int32)).view(torch.float32)
    want = torch.from_numpy(rna_reference(x.numpy()))
    assert torch.equal(rna_tf32(x).view(torch.int32), want.view(torch.int32))


def test_split_carries_x_to_2_pow_minus_22():
    """hi + lo carries x to within 2^-22 |x|, both halves TF32 (their 13
    low bits clear), over normal values of exponents -60..60."""
    rng = np.random.default_rng(23)
    x = torch.from_numpy((rng.normal(size=100_000) * np.exp2(rng.integers(-60, 61, 100_000)))
                         .astype(np.float32))
    hi, lo = split(x)
    for half in (hi, lo):
        assert not (half.view(torch.int32) & 0x1FFF).any()
    err = (x.double() - hi.double() - lo.double()).abs()
    assert (err <= 2.0 ** -22 * x.double().abs()).all()


def _errors(out: torch.Tensor, ref: torch.Tensor):
    diff = out.double() - ref
    return (diff.norm() / ref.norm()).item(), (diff.abs().max() / ref.abs().max()).item()


# The kernel's arithmetic on numpy-seeded normal inputs at [2, 16, 257, d]
# against a float64 attention. Measured on the host over the six cases: the
# split's relative L2 error is 1.41e-7 to 1.53e-7 and its max abs error
# 1.66e-7 to 2.76e-7 of max|ref|, 65-71x and 221-368x under the bounds; one
# pass gives 4.10e-4 to 4.50e-4 and 5.16e-4 to 7.69e-4, 41-45x and 8.5-12.6x
# over them. (On the card the tensor cores' accumulation adds its own
# rounding: 5.3e-7 relative L2 at DINOv2's shape.)
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("d", [16, 32, 64])
def test_kernel_arithmetic_within_card_bounds(d, masked):
    """q' = q * scale * log2 e, k, p and v split; s = q'_hi.k_lo + q'_lo.k_hi
    + q'_hi.k_hi (exact TF32 products, accumulated in float64 and rounded to
    f32 as the tensor cores' f32 accumulator); key bias times log2 e; p =
    exp2(s - max) in f32; o = p_hi.v_lo + p_lo.v_hi + p_hi.v_hi over the f32
    row sum: within the card bounds of a float64 softmax(scale q k^T + bias)
    v. One TF32 pass (q'_hi.k_hi, p_hi.v_hi) is outside them. ``masked``: a
    -1e9 bias on the first third of sample 1's keys."""
    rng = np.random.default_rng(40 + d)
    b, h, s = 2, 16, 257
    q, k, v = (torch.from_numpy(rng.normal(size=(b, h, s, d)).astype(np.float32))
               for _ in range(3))
    bias = torch.zeros(b, s)
    if masked:
        bias[1, : s // 3] = -1e9
    scale = d ** -0.5

    ref = torch.softmax(scale * q.double() @ k.double().transpose(-1, -2)
                        + bias.double()[:, None, None, :], dim=-1) @ v.double()

    qh, ql = split((q * np.float32(scale * LOG2E)).float())
    kh, kl = split(k)
    vh, vl = split(v)

    def attend(terms: int) -> torch.Tensor:
        def product(ah, al, bh, bl):
            ah, al, bh, bl = (x.double() for x in (ah, al, bh, bl))
            acc = ah @ bh
            if terms == 3:
                acc = ah @ bl + al @ bh + acc
            return acc.float()

        sc = product(qh, ql, kh.transpose(-1, -2), kl.transpose(-1, -2))
        sc = sc + (bias * np.float32(LOG2E))[:, None, None, :]
        p = torch.exp2(sc - sc.amax(-1, keepdim=True))
        ph, pl = split(p)
        return product(ph, pl, vh, vl) / p.sum(-1, keepdim=True)

    rel, mx = _errors(attend(3), ref)
    assert rel <= F32_REL_L2_BOUND and mx <= F32_MAX_ABS_REL
    rel1, mx1 = _errors(attend(1), ref)
    assert rel1 > F32_REL_L2_BOUND and mx1 > F32_MAX_ABS_REL

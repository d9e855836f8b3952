"""The host side of the redesigned S2/S11, S9, S3/S12 and S4/S5
kernels, on the CPU.

- ``sub_gather``'s launch plan (lux_tpu_torch/ops/sub_gather.py
  ``plan``, ``plan_ctas``, ``plan_smem``): for every M from 1 to
  MAX_M, its CTAs write every (row, column) exactly once, a staged CTA
  stages whole blocks and fits a block's 227 KB of shared memory; and
  the tiles, each gathering only from its own staged rows, give
  ``sub_gather_plain``'s answer bit for bit.
- ``onehot_reduce``'s product form (csrc/onehot_mma.cu): the three bf16
  parts of each value, lane w = 16 n + m split over the mma's rows and
  columns, summed part by part and added (hi + mid) + lo, agree with
  ``onehot_reduce_plain`` at the kernel's tolerance (rtol/atol 1e-5);
  and ``mma_count`` counts three mma a (chunk, 16-entry k-step).
- ``transposed_reduce``'s plan (ops/transposed_reduce.py ``plan``,
  ``plan_ctas``) reads every (e, column) once, and its split-and-combine
  order agrees with ``transposed_reduce_plain`` (rtol/atol 1e-5).
- ``elementwise``: bf16 chain10's once-rounded bf16 adds equal the
  plain version's f32 adds rounded to bf16, and the tile named in
  ops/elementwise.py is the kernel's.

The kernels themselves run only on the card (chip_smoke.py's ``probes``
phase holds them to their plain versions there).
"""

import re

import numpy as np
import pytest
import torch

from lux_tpu_torch import _kernels
from lux_tpu_torch.ops import elementwise as ew
from lux_tpu_torch.ops.chunk_reduce import KernelInputError
from lux_tpu_torch.ops.elementwise import elementwise_plain
from lux_tpu_torch.ops.onehot_reduce import (K_STEP, MMAS_A_STEP,
                                             mma_count, onehot_reduce_plain)
from lux_tpu_torch.ops.sub_gather import (DIRECT_M, MAX_M, SMEM_BYTES,
                                          STAGED_MAX_M, W, plan, plan_ctas,
                                          plan_smem, sub_gather_plain)
from lux_tpu_torch.ops.transposed_reduce import COLS as TR_COLS
from lux_tpu_torch.ops.transposed_reduce import SLICES as TR_SLICES
from lux_tpu_torch.ops.transposed_reduce import plan as transposed_plan
from lux_tpu_torch.ops.transposed_reduce import \
    plan_ctas as transposed_plan_ctas
from lux_tpu_torch.ops.transposed_reduce import transposed_reduce_plain

N_BLOCKS = (1, 2, 7, 15)


def _check_cover(p, M, n_blocks):
    """Every (row, column) of [n_blocks * M, 128] written by exactly one
    CTA of plan ``p``; staged CTAs hold whole blocks within 227 KB."""
    ctas = plan_ctas(p, M, n_blocks)
    R = n_blocks * M
    r0, rows, c0, cw = ctas.T
    assert (rows > 0).all() and (cw > 0).all()
    assert (c0 % cw == 0).all() and (W % cw == 0).all()
    # per column strip, the row intervals tile [0, R) in order
    for c in np.unique(c0):
        sel = c0 == c
        assert len(np.unique(cw[sel])) == 1
        order = np.argsort(r0[sel], kind="stable")
        a, n = r0[sel][order], rows[sel][order]
        assert a[0] == 0 and a[-1] + n[-1] == R
        assert (a[1:] == a[:-1] + n[:-1]).all()
    # the strips tile the 128 columns
    strips = np.unique(np.stack([c0, cw], 1), axis=0)
    assert strips[0, 0] == 0 and strips[-1].sum() == W
    assert (strips[1:, 0] == strips[:-1].sum(1)).all()
    if p["mode"] == "staged":
        assert (r0 % M == 0).all() and (rows % M == 0).all()
        assert plan_smem(p, M) <= SMEM_BYTES
    assert 32 <= p["threads"] <= 1024 and p["threads"] % 32 == 0


@pytest.mark.parametrize("lo", range(1, MAX_M + 1, 512))
def test_sub_gather_plan_covers_every_word_once(lo):
    for M in range(lo, min(lo + 512, MAX_M + 1)):
        p = plan(M)
        assert p["mode"] == ("staged" if DIRECT_M < M <= STAGED_MAX_M
                             else "direct")
        for nb in N_BLOCKS:
            _check_cover(p, M, nb)
        # the other mode's plan at this M is whole too
        _check_cover(plan(M, "direct" if p["mode"] == "staged"
                          else "staged"), M, 3)


@pytest.mark.parametrize("M", [1, 3, 8, 9, 63, 64, 65, 128, 129, 256, 257,
                               512, 513, 1024, 4096, MAX_M])
def test_sub_gather_plan_boundaries(M):
    """The strip widths, tile sizes and threads at each M where the
    plan changes."""
    p, s = plan(M), plan(M, "staged")
    if M <= 64:
        assert (s["cw"], s["K"], s["threads"]) == (W, 64 // M, 256)
    else:
        assert s["K"] == 1 and s["cw"] >= 8
        # the widest power-of-two strip within 64 KB, 8 columns at least
        assert M * s["cw"] * 4 <= 64 * 1024 or s["cw"] == 8
        assert s["cw"] == W or M * s["cw"] * 8 > 64 * 1024
    assert plan_smem(s, M) <= SMEM_BYTES
    assert plan_smem(p, M) == (plan_smem(s, M) if p["mode"] == "staged"
                               else 0)


def _tile_gather(x, idx, M, p):
    """sub_gather computed CTA by CTA as the kernel does: a staged CTA
    gathers only from the rows it staged (torch.gather raises on an
    index outside them), a direct one from each row's block in x."""
    out = torch.full_like(x, float("nan"))
    for r0, rows, c0, cw in plan_ctas(p, M, x.shape[0] // M):
        first = (torch.arange(r0, r0 + rows) // M * M)[:, None]
        ids = idx[r0:r0 + rows, c0:c0 + cw].long()
        if p["mode"] == "staged":
            src, at = x[r0:r0 + rows, c0:c0 + cw], first - r0 + ids
        else:
            src, at = x[:, c0:c0 + cw], first + ids
        out[r0:r0 + rows, c0:c0 + cw] = torch.gather(src, 0, at)
    return out


@pytest.mark.parametrize("M", [1, 3, 8, 9, 64, 65, 129, 257, 512, 513])
@pytest.mark.parametrize("mode", ["staged", "direct"])
def test_sub_gather_tiles_give_the_plain_answer(M, mode):
    rng = np.random.default_rng(M)
    for nb in (1, 5, 15):
        R = M * nb
        x = torch.from_numpy(rng.random((R, W), np.float32))
        idx = torch.from_numpy(rng.integers(0, M, (R, W)).astype(np.int32))
        got = _tile_gather(x, idx, M, plan(M, mode))
        want = sub_gather_plain(x, idx, M)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_sub_gather_plan_refusals():
    for M in (0, MAX_M + 1):
        with pytest.raises(KernelInputError):
            plan(M)
    with pytest.raises(KernelInputError):
        plan(8, "ring")


def _bf16(t):
    return t.to(torch.bfloat16).to(torch.float32)


def _onehot_emulated(vals, rel, W):
    """csrc/onehot_mma.cu's product in float64: A[m, e] = (lane % 16 ==
    m), B_p[e, n] = part p where lane / 16 == n; out[16 n + m] =
    (D_hi + D_mid) + D_lo, each D a sum of exact products."""
    hi = _bf16(vals)
    mid = _bf16(vals - hi)
    lo = _bf16(vals - hi - mid)
    live = (rel >= 0) & (rel < W)
    m = torch.where(live, rel % 16, -1).long()
    n = torch.where(live, rel // 16, -1).long()
    A = (m[:, None, :] == torch.arange(16)[None, :, None]).double()
    D = []
    for part in (hi, mid, lo):
        B = torch.where(n[:, :, None] == torch.arange(8)[None, None, :],
                        part.double()[:, :, None], 0.0)
        D.append(torch.bmm(A, B).float())       # [C, 16 m, 8 n]
    out = ((D[0] + D[1]) + D[2]).transpose(1, 2).reshape(-1, 128)
    return out[:, :W]


@pytest.mark.parametrize("W", [1, 37, 100, 128])
@pytest.mark.parametrize("sort", [True, False])
def test_onehot_product_form_matches_plain(W, sort):
    rng = np.random.default_rng(W)
    C, E = 40, 300
    vals = torch.from_numpy(rng.random((C, E), np.float32) * 4 - 2)
    rel = rng.integers(-3, 131, (C, E))
    rel = np.sort(rel, axis=1) if sort else rel
    rel = torch.from_numpy(rel.astype(np.int32))
    want = onehot_reduce_plain(vals, rel, W)
    torch.testing.assert_close(_onehot_emulated(vals, rel, W), want,
                               rtol=1e-5, atol=1e-5)


def test_mma_count_is_three_a_k_step():
    for C, E in ((1, 1), (3, 16), (5, 17), (81920, 512)):
        rel = torch.zeros((C, E), dtype=torch.int32)
        assert mma_count(rel, 128) == MMAS_A_STEP * C * -(-E // K_STEP)
    assert mma_count(torch.zeros((81920, 512), dtype=torch.int32), 128) \
        == 7_864_320


# S3/S12 transposed_reduce (csrc/transposed_reduce.cu): its plan, and
# its split-and-combine order emulated on the CPU


@pytest.mark.parametrize("W", [1, 37, 128])
@pytest.mark.parametrize("E", [1, 33, 512])
def test_transposed_plan_reads_every_entry_once(E, W):
    """Every (e, column) of [E, N] read by exactly one slice of one CTA.
    wg does not enter the plan (the wrapper checks it and passes nothing
    on), so this holds for every wg."""
    p = transposed_plan(E, W)
    assert p["cols"] == TR_COLS and p["cols"] % 32 == 0
    assert p["slices"] == min(TR_SLICES, E)
    assert p["smem"] == p["slices"] * W * p["cols"] * 4 <= 227 * 1024
    # the kernel's own refusal: the slices cover E, none is empty
    assert p["slices"] * p["slice"] >= E > (p["slices"] - 1) * p["slice"]
    for N in (1, 127, 1001, 65536):
        seen = np.zeros((E, N), np.int16)
        for cta, sl, c0, n, e0, rows in transposed_plan_ctas(p, E, N):
            assert c0 == cta * p["cols"] and 1 <= n <= p["cols"]
            assert e0 == sl * p["slice"] and rows >= 1
            seen[e0:e0 + rows, c0:c0 + n] += 1
        assert (seen == 1).all()


def test_transposed_plan_refusals():
    for args in ((0, 128), (4, 0), (4, 129)):
        with pytest.raises(KernelInputError):
            transposed_plan(*args)


def _transposed_emulated(vals, rel, W, p):
    """csrc/transposed_reduce.cu's sums in float32, all columns at once:
    slice k of a column adds rows [k slice, (k + 1) slice) in row order
    into its own [W, N] accumulator; the slices' accumulators are then
    summed in slice order."""
    vals, rel = vals.numpy(), rel.numpy()
    E, N = vals.shape
    cols = np.arange(N)
    acc = np.zeros((p["slices"], W, N), np.float32)
    for k in range(p["slices"]):
        for e in range(k * p["slice"], min(E, (k + 1) * p["slice"])):
            live = (rel[e] >= 0) & (rel[e] < W)
            acc[k, rel[e][live], cols[live]] += vals[e][live]
    out = acc[0]
    for k in range(1, p["slices"]):
        out = out + acc[k]
    return torch.from_numpy(out)


@pytest.mark.parametrize("W", [1, 37, 128])
@pytest.mark.parametrize("sort", [True, False])
def test_transposed_split_order_matches_plain(W, sort):
    """The kernel's order of a column's sum (row order within a slice,
    the slices in order) against the plain scatter_add at the probes'
    rtol/atol 1e-5, with E under, at and no multiple of the slices; the
    plan, and so the answer, is the same at every wg."""
    rng = np.random.default_rng(W + sort)
    for E, N in ((1, 40), (2, 65), (33, 301), (100, 97), (512, 130)):
        rel = rng.integers(-3, 131, (E, N))
        rel = np.sort(rel, axis=0) if sort else rel
        vals = torch.from_numpy(rng.random((E, N), np.float32))
        rel = torch.from_numpy(rel.astype(np.int32))
        want = transposed_reduce_plain(vals, rel, W)
        got = _transposed_emulated(vals, rel, W, transposed_plan(E, W))
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


# S4/S5 elementwise's bf16 chain10 (csrc/elementwise.cu) adds natively in
# bf16 (add.rn.bf16x2): the exact sum rounded once to bf16.  The plain
# version adds in f32 and rounds the f32 sum to bf16.


def _round_bf16(x):
    """float64 ``x`` rounded once to bf16, nearest even (8 significant
    bits, subnormals down to 2**-133, overflow to inf): its uint16
    bits."""
    with np.errstate(invalid="ignore", over="ignore"):
        _, e = np.frexp(x)
        q = np.maximum(e - 8, -133)            # the bf16 quantum at x
        y = np.ldexp(np.rint(np.ldexp(x, -q)), q)
        y = np.where(np.abs(y) > BF16_MAX, np.copysign(np.inf, x), y)
        y = np.where(np.isfinite(x), y, x)
    return (y.astype(np.float32).view(np.uint32) >> 16).astype(np.uint16)


BF16_MAX = float(torch.finfo(torch.bfloat16).max)


def _bf16_bits(bits):
    return torch.from_numpy(bits.astype(np.uint16).view(np.int16)).view(
        torch.bfloat16)


def _bits(t):
    return t.view(torch.int16).numpy().view(np.uint16)


def test_bf16_add_rounded_once_equals_f32_add_rounded():
    """On all 65,536 bf16 patterns of ``a`` against a seeded sample of
    ``b`` (and zeros, the largest finite values, subnormals, infs and a
    NaN): the plain version's f32 add rounded to bf16 (torch's bf16 add,
    and the f32 sum rounded here) gives the bits of the sum computed in
    float64 and rounded once to bf16 (the float64 sum of two bf16 values
    is exact or rounded innocuously: 53 >= 2 x 8 + 2); NaN positions
    are equal."""
    a_bits = np.arange(1 << 16, dtype=np.uint16)
    rng = np.random.default_rng(0)
    b_all = np.concatenate([
        rng.integers(0, 1 << 16, 192).astype(np.uint16),
        np.array([0x0000, 0x8000, 0x7F7F, 0xFF7F, 0x0001, 0x8001, 0x007F,
                  0x0080, 0x7F80, 0xFF80, 0x7FC0, 0x3F80, 0xBF80],
                 np.uint16)])
    a = _bf16_bits(a_bits)
    a64 = a.double().numpy()
    a32 = a.float().numpy()
    for b_bits in np.array_split(b_all, 8):
        b = _bf16_bits(b_bits)
        got = _bits(a[:, None] + b[None, :])       # torch: f32, rounded
        with np.errstate(invalid="ignore", over="ignore"):
            f32 = _round_bf16((a32[:, None] + b.float().numpy()[None, :])
                              .astype(np.float64))
            exact = a64[:, None] + b.double().numpy()[None, :]
        once = _round_bf16(exact)
        nan = np.isnan(exact)
        assert np.array_equal(np.isnan(_bf16_bits(got).float().numpy()), nan)
        assert np.array_equal(got[~nan], once[~nan])
        assert np.array_equal(f32[~nan], once[~nan])


def test_bf16_chain10_rounded_once_a_step_equals_plain():
    """chain10 in bf16, ten adds each rounded once from float64, equals
    the plain version (each add in f32, rounded to bf16) bit for bit
    outside NaN, on every bf16 pattern of ``a``."""
    a = _bf16_bits(np.arange(1 << 16, dtype=np.uint16))
    rng = np.random.default_rng(1)
    for b_bits in (rng.integers(0, 1 << 16, 1 << 16).astype(np.uint16),
                   np.full(1 << 16, 0x3C00, np.uint16)):
        b = _bf16_bits(b_bits)
        want = _bits(elementwise_plain("chain10", a, b))
        x, b64 = a.double().numpy(), b.double().numpy()
        for _ in range(10):
            with np.errstate(invalid="ignore"):
                x = _bf16_bits(_round_bf16(x + b64)).double().numpy()
        nan = np.isnan(x)
        assert np.array_equal(np.isnan(_bf16_bits(want).float().numpy()), nan)
        once = _bits(_bf16_bits(_round_bf16(x)))
        assert np.array_equal(want[~nan], once[~nan])


def _cu_constant(name):
    text = (_kernels.CSRC / "elementwise.cu").read_text()
    found = re.findall(rf"constexpr int {name} = (\d+);", text)
    assert len(found) == 1, name
    return int(found[0])


@pytest.mark.parametrize("body", sorted(ew.BODIES))
def test_elementwise_tile_matches_kernel(body):
    """ops/elementwise.py's THREADS and UNROLL (chip_smoke.py's tile
    boundary cases) are csrc/elementwise.cu's kThreads, kUnroll and
    kUnrollChain32."""
    assert ew.THREADS == _cu_constant("kThreads")
    want = _cu_constant("kUnrollChain32" if body == "chain32" else "kUnroll")
    assert ew.UNROLL[body] == want

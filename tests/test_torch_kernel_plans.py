"""The host side of the redesigned S2/S11 and S9 kernels, on the CPU.

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

The kernels themselves run only on the card (chip_smoke.py's ``probes``
phase holds them to their plain versions there).
"""

import numpy as np
import pytest
import torch

from lux_tpu_torch.ops.chunk_reduce import KernelInputError
from lux_tpu_torch.ops.onehot_reduce import (K_STEP, MMAS_A_STEP,
                                             mma_count, onehot_reduce_plain)
from lux_tpu_torch.ops.sub_gather import (DIRECT_M, MAX_M, SMEM_BYTES,
                                          STAGED_MAX_M, W, plan, plan_ctas,
                                          plan_smem, sub_gather_plain)

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

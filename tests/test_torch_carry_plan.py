"""The host side of S7's single-pass design (csrc/carry.cu), on the CPU.

- The tile protocol, emulated in numpy float32: each tile scans its
  rows from a carry of 0 and finds its first start; a tile with a start
  (and tile 0) shows P, the value at its last row, at once; one without
  shows A, its own sum, then P = carry + A once it knows its carry; a
  look-back walks t-1, t-2, ... to the first P and folds
  ((P_s + A_{s+1}) + ...) + A_{t-1}; rows before the first start get
  carry + local.  Tiles run in random orders and every predecessor that
  has shown both shows A or P at random: the result is bit-equal across
  orders and to the sequential P chain, and agrees with
  ``carry_combine_plain`` at rtol/atol 1e-5.
- ops/carry.py's CARRY_TILE and CARRY_LANES are carry.cu's kTile and
  kLanes; ``carry_slots`` counts one slot a (tile, column group).
- The wrapper refuses a non-contiguous input for that (the other
  refusals are tests/test_torch_probes.py's BAD_CALLS).
- The status scratch is kept per (device, stream): calls on other
  streams never share one, a stream's grows and is never shrunk, and a
  stream that is capturing a graph gets none it does not already hold
  (the C functions and the capture query are stood in for).
- chip_smoke.py's ``carry_combined`` (S7 on an engine's partials, then
  the take of each tile's last chunk) gives ``combine_partials``'
  result at the smoke's tolerance.

The kernel itself runs only on the card (chip_smoke.py's ``probes``
phase holds it to its plain version there, bit-equal twice, through a
CUDA graph's replays, and counts its launches with torch.profiler).
"""

import re

import numpy as np
import pytest
import torch

from lux_tpu_torch import _kernels
from lux_tpu_torch.ops import carry as carry_mod
from lux_tpu_torch.ops.carry import (CARRY_LANES, CARRY_TILE, carry_combine,
                                     carry_combine_plain, carry_slots)
from lux_tpu_torch.ops.chunk_reduce import KernelInputError

F32 = np.float32


def _cu_constant(name, source="carry.cu"):
    text = (_kernels.CSRC / source).read_text()
    found = re.findall(rf"constexpr int {name} = (\d+);", text)
    assert len(found) == 1, name
    return int(found[0])


def _local(rows, starts):
    """A tile's scan from a carry of 0: (local values, last, first)."""
    vals = np.empty_like(rows)
    acc = np.zeros(rows.shape[1], F32)
    for j in range(rows.shape[0]):
        acc = rows[j].copy() if starts[j] else (acc + rows[j]).astype(F32)
        vals[j] = acc
    hit = np.flatnonzero(starts)
    return vals, acc, int(hit[0]) if hit.size else rows.shape[0]


def _emulate_group(part, starts, tile, rng):
    """One column group's chained scan, tiles stepped in a random order
    (``rng`` None: in tile order, each predecessor seen as P)."""
    C = part.shape[0]
    nT = -(-C // tile)
    out = np.empty_like(part)
    A, P, state = {}, {}, {}
    for t in range(nT):
        rows = part[t * tile:(t + 1) * tile]
        state[t] = _local(rows, starts[t * tile:(t + 1) * tile])

    def scan(t):
        vals, last, first = state[t]
        n = vals.shape[0]
        if first < n:
            P[t] = last
        elif t == 0:
            P[t] = (F32(0) + last).astype(F32)
        else:
            A[t] = last
        out[t * tile:t * tile + n][first:] = vals[first:]

    def look(t):
        """False while a predecessor it must read has shown nothing."""
        vals, last, first = state[t]
        if first == 0:
            return True
        carry = np.zeros(vals.shape[1], F32)
        if t > 0:
            chain, u = [], t - 1
            while True:
                if u not in P and u not in A:
                    return False
                show_p = u in P and (u not in A or rng is None
                                     or rng.random() < 0.5)
                if show_p:
                    break
                chain.append(u)
                u -= 1
            carry = P[u].copy()
            for w in reversed(chain):
                carry = (carry + A[w]).astype(F32)
            if first == vals.shape[0]:
                P[t] = (carry + last).astype(F32)
        out[t * tile:t * tile + first] = (carry + vals[:first]).astype(F32)
        return True

    if rng is None:
        for t in range(nT):
            scan(t)
            assert look(t)
        return out
    waiting = []
    todo = list(rng.permutation(nT))
    while todo or waiting:
        ready = [t for t in waiting if look(t)]
        waiting = [t for t in waiting if t not in ready]
        if todo and (not waiting or rng.random() < 0.7):
            t = todo.pop()
            scan(t)
            if not look(t):
                waiting.append(t)
        elif waiting and not ready:
            # only a tile not scanned yet can unblock the waiting ones
            assert todo, "look-back waits on a tile that never runs"
    return out


def emulate(part, start, tile=CARRY_TILE, rng=None):
    """carry.cu's result for part [C, W] f32 and start [C] int32: each
    group of CARRY_LANES columns its own chained scan."""
    starts = start.reshape(-1) == 1
    return np.concatenate([_emulate_group(part[:, g:g + CARRY_LANES],
                                          starts, tile, rng)
                           for g in range(0, part.shape[1], CARRY_LANES)],
                          axis=1)


def _starts(rng, C, p, first=1):
    st = (rng.random(C) < p).astype(np.int32)
    st[0] = first
    return st


CASES = {
    # C not a multiple of the tile; starts rare enough that A shows
    "C1001_p0.005": lambda rng: (1001, _starts(rng, 1001, 0.005)),
    "C1001_p0.3": lambda rng: (1001, _starts(rng, 1001, 0.3)),
    "start0_zero": lambda rng: (1001, _starts(rng, 1001, 0.01, first=0)),
    "start_every_row": lambda rng: (1001, np.ones(1001, np.int32)),
    "no_start": lambda rng: (1001, np.zeros(1001, np.int32)),
    "one_segment_many_tiles": lambda rng: (4099, _starts(rng, 4099, 0.0)),
}


@pytest.mark.parametrize("W", [1, 37, 128, 200])
@pytest.mark.parametrize("case", sorted(CASES))
def test_protocol_bit_equal_across_orders(case, W):
    rng = np.random.default_rng(7)
    C, start = CASES[case](rng)
    part = rng.random((C, W), dtype=F32)
    chain = emulate(part, start)
    for seed in range(3):
        got = emulate(part, start, rng=np.random.default_rng(seed))
        assert np.array_equal(got.view(np.int32), chain.view(np.int32))
    want = carry_combine_plain(torch.from_numpy(part),
                               torch.from_numpy(start)).numpy()
    np.testing.assert_allclose(chain, want, rtol=1e-5, atol=1e-5)


def test_protocol_folds_over_a_shown_aggregate():
    """A tile whose predecessor shows A folds past it: with one start
    on row 0 only, every tile but 0 shows A first, and an order that
    reads each A still gives the P chain's bits."""
    rng = np.random.default_rng(3)
    C = 20 * CARRY_TILE + 5
    part = rng.random((C, 3), dtype=F32)
    start = _starts(rng, C, 0.0)

    class AlwaysA:
        def random(self):
            return 0.9                       # never show P beside an A

        def permutation(self, n):
            return np.arange(n)[::-1]        # tile 0 scans first

    got = emulate(part, start, rng=AlwaysA())
    assert np.array_equal(got.view(np.int32),
                          emulate(part, start).view(np.int32))


def test_carry_tile_and_lanes_match_kernel():
    """CARRY_TILE and CARRY_LANES are carry.cu's kTile and kLanes (the C
    function refuses another tile); fused_carry.cu's kTile is
    FUSED_TILE."""
    from lux_tpu_torch.ops.carry import FUSED_TILE
    assert CARRY_TILE == _cu_constant("kTile")
    assert CARRY_LANES == _cu_constant("kLanes")
    assert FUSED_TILE == _cu_constant("kTile", "fused_carry.cu")


@pytest.mark.parametrize("C,W,want", [(1, 1, 1), (64, 128, 1),
                                      (65, 128, 2), (57_664, 128, 901),
                                      (1001, 200, 32), (1001, 256, 32),
                                      (1001, 257, 48)])
def test_carry_slots(C, W, want):
    assert carry_slots(C, W) == want


def test_wrapper_refuses_non_contiguous_by_name():
    """A non-contiguous input on a device other than the CPU is refused
    for that, before the device is looked at (tests/test_torch_probes.py
    BAD_CALLS has the other refusals)."""
    meta = dict(device="meta")
    with pytest.raises(KernelInputError, match="contiguous"):
        carry_combine(torch.empty(16, 40, **meta).T,
                      torch.empty(40, dtype=torch.int32, **meta))


@pytest.fixture
def status_stand_in(monkeypatch):
    """ops/carry.py's scratch table empty, its status bytes a stand-in
    (8 + 16 a slot), the scratch on the meta device, and a switch for
    whether the current stream is capturing."""
    capturing = [False]
    monkeypatch.setattr(carry_mod, "_STATUS", {})
    monkeypatch.setattr(carry_mod, "_carry_fns",
                        lambda: (None, lambda slots: 8 + 16 * slots))
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: capturing[0])
    return capturing


def test_status_kept_per_stream(status_stand_in):
    dev = torch.device("meta", 0)
    a, cap_a = carry_mod._status(dev, 11, 10)
    b, cap_b = carry_mod._status(dev, 22, 10)
    assert (cap_a, cap_b) == (10, 10) and a is not b
    assert carry_mod._status(dev, 11, 7)[0] is a
    assert carry_mod._status(torch.device("meta", 1), 11, 7)[0] is not a
    assert a.numel() * 8 >= 8 + 16 * 10


def test_status_grows_never_shrinks(status_stand_in):
    dev = torch.device("meta", 0)
    carry_mod._status(dev, 11, 10)
    _, cap = carry_mod._status(dev, 11, 12)
    assert cap == 20                        # at least twice the last
    assert carry_mod._status(dev, 11, 5)[1] == 20
    assert len(carry_mod._STATUS[(0, 11)]) == 2   # the old one is kept


def test_status_not_made_while_capturing(status_stand_in):
    dev = torch.device("meta", 0)
    carry_mod._status(dev, 11, 10)
    status_stand_in[0] = True
    assert carry_mod._status(dev, 11, 10)[1] == 10   # held: reused
    with pytest.raises(KernelInputError, match="before the capture"):
        carry_mod._status(dev, 22, 10)
    with pytest.raises(KernelInputError, match="before the capture"):
        carry_mod._status(dev, 11, 11)


@pytest.mark.parametrize("num_parts", [1, 3])
def test_carry_combined_matches_combine_partials(num_parts):
    """chip_smoke.py's carry_combined on a CPU engine with multi-chunk
    tiles (carry_combine takes its plain version for CPU tensors) gives
    combine_partials' result at CARRY_COMBINED_TOL."""
    import chip_smoke
    from lux_tpu_torch.apps import pagerank
    from lux_tpu_torch.convert import rmat_graph
    from lux_tpu_torch.ops.chunk_reduce import chunk_partials
    from lux_tpu_torch.ops.tiled import combine_partials
    g = rmat_graph(9, 16, seed=2)
    eng = pagerank.build_engine(g, num_parts, tile_e=16, device="cpu")
    assert eng._plan.max_len > 1            # tiles span several chunks
    a, t = eng.arrays, eng.tiles
    msgs = eng._messages(eng.init_state().reshape(-1))
    C = eng.num_parts * t.n_chunks
    partials = chunk_partials(msgs.reshape(C, t.E),
                              a["rel_dst"].reshape(C, t.E), t.W, "sum")
    red = combine_partials(partials, t, a["chunk_start"], a["last_chunk"],
                           eng.vpad, "sum", eng._plan)
    starts = a["chunk_start"].to(torch.int32).reshape(-1)
    got = chip_smoke.carry_combined(torch, eng, partials, starts)
    assert got.shape == red.shape
    assert torch.allclose(got, red, **chip_smoke.CARRY_COMBINED_TOL)
    assert bool((red == 0).any()) and bool((red > 0).any())

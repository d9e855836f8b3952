"""The device health watchdog: O(1) checks inside the iteration loops,
decoded and raised on the host (counterpart of lux_tpu/health.py).

A NaN residual compares False against ``run_until``'s ``res > tol`` and
would report convergence on a garbage state; a truncated push frontier
can spin forever.  The engines' guarded variants
(``PullEngine.run_health`` / ``run_until_health``,
``PushEngine.converge_health``) fold each iteration's checks into a
fixed ``int32[6]`` HEALTH WORD on the device, and the host decodes it
once per run or segment (:func:`ensure_ok`), raising a typed
:class:`HealthError` with the diagnosis.

Health word layout (int32[6], the reference's):

    [0] flags      bitmask of tripped checks (0 = healthy)
    [1] iteration  first iteration any check tripped (-1 = none)
    [2] part       first part with non-finite state at trip (-1 = n/a)
    [3] count      non-finite values at trip
    [4] aux        pull: float32 residual at trip, its bits as int32;
                   push: global frontier size at trip
    [5] tick       iterations the watchdog has observed; the word and
                   its aux (the WATCH tuple: pull ``(word, window)``,
                   push ``(word, stall)``) are threaded across segment
                   boundaries by the segmented drivers, so the window
                   checks keep their history and trip iterations are
                   global to the run

Checks: pull ``NONFINITE_STATE`` / ``NONFINITE_RESIDUAL`` (NaN or Inf
in the new state / the residual), ``DIVERGENCE`` (the trailing
``WINDOW`` residuals strictly increasing and grown more than
``DIVERGENCE_GROWTH`` times), ``OSCILLATION`` (their differences
strictly alternating in sign with no net decrease); push
``NONFINITE_STATE`` (NaN labels; +Inf is the unreached sentinel and
never trips) and ``FRONTIER_STALL`` (``STALL_N`` consecutive
iterations with a non-empty frontier, an unchanged active count and
bit-identical labels: the truncation livelock).

The word and window are device tensors and every update here is a
tensor op on the device: the tick indexes the window ring by tensor
indexing, never by a host read.  The host side (``digest``,
``ensure_ok``) reads the 24-byte word once.
"""

from __future__ import annotations

import numpy as np
import torch

# flag bits — one per check; FLAG_NAMES is the wire/diagnosis naming
NONFINITE_STATE = 1
NONFINITE_RESIDUAL = 2
DIVERGENCE = 4
OSCILLATION = 8
FRONTIER_STALL = 16

FLAG_NAMES = {
    NONFINITE_STATE: "nonfinite_state",
    NONFINITE_RESIDUAL: "nonfinite_residual",
    DIVERGENCE: "divergence",
    OSCILLATION: "oscillation",
    FRONTIER_STALL: "frontier_stall",
}

# trailing-residual window (pull divergence / oscillation)
WINDOW = 8
# divergence needs strict growth AND this much net blow-up over the
# window, so a noisy but converging trajectory cannot trip it
DIVERGENCE_GROWTH = 16.0
# consecutive no-progress iterations before a push stall trips
STALL_N = 16

HEALTH_LEN = 6


class HealthError(RuntimeError):
    """The watchdog tripped.  Carries the diagnosis: ``checks`` (list
    of FLAG_NAMES values), ``iteration`` (global, -1 unknown), ``part``
    (-1 n/a), ``engine`` ('pull' | 'push') and ``count``.
    resilience.classify treats it as FATAL: the corruption is in the
    state, so a blind retry would rerun into the same diagnosis."""

    def __init__(self, message: str, *, checks=(), iteration: int = -1,
                 part: int = -1, engine: str = "?", count: int = 0):
        super().__init__(message)
        self.checks = list(checks)
        self.iteration = int(iteration)
        self.part = int(part)
        self.engine = str(engine)
        self.count = int(count)


# -- device-side word construction -------------------------------------

def init_word(device=None) -> torch.Tensor:
    """[0, -1, -1, 0, 0, 0], filled on the device (no host copy, so a
    guarded run's only host read is its decode)."""
    h = torch.zeros((HEALTH_LEN,), dtype=torch.int32, device=device)
    h[1:3] = -1
    return h


def init_window(device=None) -> torch.Tensor:
    return torch.zeros((WINDOW,), dtype=torch.float32, device=device)


def init_stall(device=None) -> torch.Tensor:
    """The push watch's consecutive-stall counter (int32 scalar)."""
    return torch.zeros((), dtype=torch.int32, device=device)


def record(h, flags, part, count, aux) -> torch.Tensor:
    """Fold one iteration's tripped ``flags`` into the word ``h``:
    flags accumulate (OR), the diagnosis slots are written only by the
    FIRST tripping iteration (at the current tick, h[5], which this
    also advances).  All arguments are device tensors."""
    i32 = torch.int32
    flags = flags.to(i32)
    tick = h[5]
    first = (h[0] == 0) & (flags != 0)
    return torch.stack([
        h[0] | flags,
        torch.where(first, tick, h[1]),
        torch.where(first, part.to(i32), h[2]),
        torch.where(first, count.to(i32), h[3]),
        torch.where(first, aux.to(i32), h[4]),
        tick + 1])


def nonfinite_parts(state: torch.Tensor) -> torch.Tensor:
    """Per-part non-finite counts [num_parts] int32 (zeros for integer
    states)."""
    if not state.dtype.is_floating_point:
        return torch.zeros((state.shape[0],), dtype=torch.int32,
                           device=state.device)
    bad = ~torch.isfinite(state)
    return bad.reshape(state.shape[0], -1).sum(1, dtype=torch.int32)


def nan_parts(state: torch.Tensor) -> torch.Tensor:
    """Per-part NaN counts [rows] int32 — the push-label check: +/-Inf
    is the unreached sentinel and never trips (zeros for integer
    labels)."""
    if not state.dtype.is_floating_point:
        return torch.zeros((state.shape[0],), dtype=torch.int32,
                           device=state.device)
    bad = torch.isnan(state)
    return bad.reshape(state.shape[0], -1).sum(1, dtype=torch.int32)


def first_bad_part(bad_pp: torch.Tensor) -> torch.Tensor:
    """Index of the first part with non-finite values, -1 if none
    (int32 scalar on the device)."""
    hit = bad_pp > 0
    first = torch.argmax(hit.to(torch.int32))
    return torch.where(hit.any(), first, -1).to(torch.int32)


def _f32_bits(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float32).reshape(()).view(torch.int32)


def pull_update(h, win, state, res):
    """One pull iteration's health update.  ``state`` is the NEW
    [num_parts, vpad, ...] state, ``res`` the iteration's max-abs
    residual (a float32 scalar).  Returns (word, window) — thread both
    across segments so the window checks keep their history (the
    word's tick, h[5], indexes the ring)."""
    tick = h[5]
    bad_pp = nonfinite_parts(state)
    nf = bad_pp.sum(dtype=torch.int32)
    res32 = res.to(torch.float32).reshape(())
    res_bad = ~torch.isfinite(res32)
    pos = torch.remainder(tick, WINDOW).to(torch.int64)
    win = win.index_put((pos.reshape(1),), res32.reshape(1))
    # chronological view of the ring, oldest first: the reference's
    # jnp.roll(win, -(tick % WINDOW) - 1) as a device index
    ring = torch.arange(WINDOW, device=win.device)
    chron = win[torch.remainder(ring + pos + 1, WINDOW)]
    d = chron[1:] - chron[:-1]
    full = tick >= WINDOW - 1
    div = (full & (d > 0).all()
           & (chron[-1] > DIVERGENCE_GROWTH * chron[0]))
    osc = (full & (d[1:] * d[:-1] < 0).all()
           & (chron[-1] + chron[-2] >= chron[0] + chron[1]))
    i32 = torch.int32
    flags = ((nf > 0).to(i32) * NONFINITE_STATE
             + res_bad.to(i32) * NONFINITE_RESIDUAL
             + div.to(i32) * DIVERGENCE + osc.to(i32) * OSCILLATION)
    return record(h, flags, first_bad_part(bad_pp), nf,
                  _f32_bits(res32)), win


def push_update(h, stall, old_label, new_label, old_cnt, new_cnt):
    """One relax iteration's push health update: NaN labels, and the
    truncation livelock — a non-empty frontier, an identical active
    count and bit-identical labels for STALL_N consecutive steps (a
    zero-progress step that SHRINKS the active set resets the count).
    ``old_cnt`` / ``new_cnt`` are int32 device scalars.  Returns
    (word, stall)."""
    badp = nan_parts(new_label)
    nf = badp.sum(dtype=torch.int32)
    chg = (new_label != old_label).sum(dtype=torch.int32)
    stalled = (chg == 0) & (new_cnt > 0) & (new_cnt == old_cnt)
    stall = torch.where(stalled, stall + 1, torch.zeros_like(stall))
    i32 = torch.int32
    flags = ((nf > 0).to(i32) * NONFINITE_STATE
             + (stall >= STALL_N).to(i32) * FRONTIER_STALL)
    return record(h, flags, first_bad_part(badp), nf, new_cnt), stall


# -- host-side decode / raise -------------------------------------------

def _fetch(hvec) -> np.ndarray:
    if isinstance(hvec, (tuple, list)):        # a WATCH tuple
        hvec = hvec[0]
    if isinstance(hvec, torch.Tensor):
        hvec = hvec.detach().cpu().numpy()
    return np.asarray(hvec).astype(np.int64)


def flag_names(flags: int) -> list[str]:
    return [name for bit, name in sorted(FLAG_NAMES.items())
            if flags & bit]


def digest(hvec, engine: str, base_iter: int = 0) -> dict:
    """Host-side diagnosis dict of a (device) health word or watch.
    ``base_iter`` offsets the in-run iteration to a global count when
    the run was one segment of a longer whole."""
    h = _fetch(hvec)
    flags = int(h[0])
    out = {"engine": engine, "tripped": bool(flags),
           "flags": flag_names(flags)}
    if flags:
        out["iteration"] = int(h[1]) + base_iter if h[1] >= 0 else -1
        out["part"] = int(h[2])
        out["count"] = int(h[3])
        if engine == "pull":
            out["residual"] = float(np.int32(h[4]).view(np.float32))
        else:
            out["frontier"] = int(h[4])
    return out


def ensure_ok(hvec, engine: str, base_iter: int = 0,
              where: str = "run") -> dict:
    """Fetch + decode one health word (one 24-byte read); healthy
    returns the digest, a tripped word emits a ``health_trip``
    telemetry event and raises HealthError with the diagnosis."""
    from lux_tpu_torch import telemetry

    d = digest(hvec, engine, base_iter)
    if not d["tripped"]:
        return d
    telemetry.current().emit("health_trip", where=where, **d)
    detail = (f"residual={d.get('residual'):.6g}" if engine == "pull"
              else f"frontier={d.get('frontier')}")
    raise HealthError(
        f"{where}: health watchdog tripped "
        f"[{'+'.join(d['flags'])}] at iteration {d['iteration']}, "
        f"part {d['part']} ({d['count']} bad values, {detail})",
        checks=d["flags"], iteration=d["iteration"], part=d["part"],
        engine=engine, count=d["count"])

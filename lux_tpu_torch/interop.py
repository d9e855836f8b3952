"""Carrying graph arrays and state across from the reference.

``from_reference`` builds a port pull engine on exactly the arrays a
``lux_tpu`` pull engine iterates (its ``eng.arrays``, turned into numpy
by the caller) and returns it with the state as a tensor, so both
packages can iterate from the same bits; ``push_from_reference`` does
the same for a ``lux_tpu`` push engine and its (label, active) state.
Graph arrays are to this system what weights are to a model.
``watch_from_reference`` / ``watch_to_numpy`` carry a health WATCH
(health.py) across in either direction; checkpoint files need no
conversion (checkpoint.py writes the reference's format).  Nothing
here imports the reference: the caller hands over plain numpy arrays
and a dict of scalars.
"""

from __future__ import annotations

import numpy as np
import torch

from lux_tpu_torch.apps.pagerank import make_program
from lux_tpu_torch.engine.pull import TILED_KEYS, PullEngine
from lux_tpu_torch.engine.push import SPARSE_KEYS, PushEngine
from lux_tpu_torch.ops.owner import OWNER_SCAN_KEYS, OwnerGeometry
from lux_tpu_torch.ops.pagegather import (PAGED_DOT_KEYS, PAGED_KEYS,
                                          PAGED_OWNER_KEYS,
                                          PAGEMAJOR_OWNER_RECV_KEYS,
                                          PAGEMAJOR_OWNER_SEND_KEYS,
                                          PageGeometry)
from lux_tpu_torch.ops.pairs import PAIR_DOT_KEYS, PAIR_KEYS, PairGeometry
from lux_tpu_torch.ops.tiled import TileGeometry

COMMON_META = ("vpad", "nv", "ne", "num_parts")
META_KEYS = ("W", "E", "n_tiles", "n_chunks", "needs_scan") + COMMON_META
PAGED_META_KEYS = ("classes", "R", "Rp", "n_tiles", "n_slots",
                   "mode") + COMMON_META
PAIR_META_KEYS = ("classes", "R", "Rp", "n_tiles", "n_slots")
PUSH_META_KEYS = ("queue_cap", "edge_budget", "enable_sparse",
                  "sparse_threshold", "delta")
OWNER_META_KEYS = ("W", "E", "n_tiles", "G", "n_chunks", "needs_scan")


def _require(meta: dict, keys):
    missing = [k for k in keys if k not in meta]
    if missing:
        raise KeyError(f"meta lacks {missing}")


def _geometry(arrays: dict, meta: dict):
    """The dense layout carried in ``meta`` -> (host arrays of its keys,
    the from_arrays keyword arguments)."""
    paged = meta.get("mode") in ("paged", "pagemajor")
    _require(meta, PAGED_META_KEYS if paged else
             COMMON_META if meta.get("owner") is not None else META_KEYS)
    kw = dict(nv=meta["nv"], ne=meta["ne"], num_parts=meta["num_parts"],
              vpad=meta["vpad"])
    if paged:
        kw["pages"] = PageGeometry(
            classes=tuple((int(c), int(L)) for c, L in meta["classes"]),
            R=int(meta["R"]), Rp=int(meta["Rp"]),
            n_tiles=int(meta["n_tiles"]), n_slots=int(meta["n_slots"]),
            mode=meta["mode"], route=int(meta.get("route", 0)),
            owner=bool(meta.get("owner_pages", False)))
        kw["tiles"] = None
        keys = PAGED_KEYS + ("deg", "nvp", "pg_w", "pg_vrs") \
            + PAGED_DOT_KEYS + PAGED_OWNER_KEYS + ("own_pg_w",) \
            + PAGEMAJOR_OWNER_SEND_KEYS + ("own_pm_w",) \
            + PAGEMAJOR_OWNER_RECV_KEYS
    else:
        if meta.get("owner") is not None:
            om = meta["owner"]
            _require(om, OWNER_META_KEYS)
            kw["owner"] = OwnerGeometry(
                W=int(om["W"]), E=int(om["E"]), n_tiles=int(om["n_tiles"]),
                G=int(om["G"]), n_chunks=int(om["n_chunks"]),
                needs_scan=bool(om["needs_scan"]))
            kw["tiles"] = None
            keys = OWNER_SCAN_KEYS + ("deg", "nvp")
        else:
            kw["tiles"] = TileGeometry(W=int(meta["W"]), E=int(meta["E"]),
                                       n_tiles=int(meta["n_tiles"]),
                                       n_chunks=int(meta["n_chunks"]),
                                       needs_scan=bool(meta["needs_scan"]))
            keys = TILED_KEYS + ("weight", "chunk_tile")
        if meta.get("pairs") is not None:
            pm = meta["pairs"]
            _require(pm, PAIR_META_KEYS)
            kw["pairs"] = PairGeometry(
                classes=tuple((int(c), int(L)) for c, L in pm["classes"]),
                R=int(pm["R"]), Rp=int(pm["Rp"]),
                n_tiles=int(pm["n_tiles"]), n_slots=int(pm["n_slots"]))
            kw["pair_stream"] = meta.get("pair_stream")
            keys += PAIR_KEYS + ("pair_weight",) + PAIR_DOT_KEYS
    host = {k: np.asarray(arrays[k]) for k in keys if k in arrays}
    # a query-batched program's extra arrays (the [P, vpad, B] resets)
    host.update({k: np.asarray(v) for k, v in arrays.items()
                 if k.startswith("prog_")})
    return host, kw


def _state(x, eng, what: str) -> torch.Tensor:
    st = torch.tensor(np.asarray(x), device=eng.device)
    if tuple(st.shape[:2]) != (eng.num_parts, eng.vpad):
        raise ValueError(f"{what} {tuple(st.shape)} is not [num_parts, "
                         f"vpad, ...] = [{eng.num_parts}, {eng.vpad}, "
                         f"...]")
    return st


def from_reference(arrays: dict, state: np.ndarray, *, meta: dict,
                   program=None, device=None):
    """arrays: the reference engine's graph arrays as numpy; state: its
    padded [num_parts, vpad, ...] state; meta: its geometry; program:
    the port's program of the same app (None: PageRank's; its chunk
    weights are not carried).  Returns (PullEngine, state
    tensor on ``device``).

    - tiled engine: arrays src_slot, rel_dst, chunk_start, last_chunk,
      deg, nvp; meta W, E, n_tiles, n_chunks, needs_scan + the common
      keys (vpad, nv, ne, num_parts).  With pair rows (the residual's
      tiled arrays, then) also arrays pair_rowbind, pair_rel,
      pair_tile_pos (+ pair_weight) and meta ``pairs``, a dict of the
      stacked plan's classes, R, Rp, n_tiles, n_slots (and
      ``pair_stream``, None for the reference's default);
    - paged engine (meta ``mode`` "paged" or "pagemajor"): arrays
      pg_ids, pg_sl (uint32), pg_rel, pg_tp, deg, nvp, and pg_w /
      pg_vrs where the reference has them; meta classes, R, Rp,
      n_tiles, n_slots, mode + the common keys.  An owner paged engine
      (meta ``owner_pages`` True) carries own_pg_ids, own_pg_sl,
      own_pg_rel, own_pg_tp (+ own_pg_w), an owner page-major one
      own_pm_ids, own_pm_gsl, own_pm_vrs, own_pm_rel, own_pm_tp (+
      own_pm_w) and meta ``route`` (its Mg); the reference's
      PagedPlan.n_tiles is G for the first, the tiles a part for the
      second.

    - owner-exchange engine (meta ``owner``, a dict of the reference's
      OwnerLayout W, E, n_tiles, G, n_chunks, needs_scan): arrays own_sr
      (uint32) and own_nv (uint16), or own_src and own_rel, and own_cs,
      own_lc, deg, nvp (+ own_w; + own_ep, own_et when it streams; +
      the pair arrays and meta ``pairs`` as above) + the common keys.

    Programs reading the destination carry ``chunk_tile``; dot
    programs (colfilter) also pair_row_tile, pair_tile0 or pg_rt,
    pg_t0, as the reference builds them.  A query-batched program
    (``apps.pagerank.make_batched_program``) carries its extra arrays
    ``prog_<name>`` ([P, vpad, B] each) and a [P, vpad, B] state."""
    host, kw = _geometry(arrays, meta)
    if program is None:
        program = make_program()
        host.pop("weight", None)        # PageRank reads no weights
        host.pop("own_w", None)
    eng = PullEngine.from_arrays(program, host, device=device, **kw)
    return eng, _state(state, eng, "state")


def push_from_reference(arrays: dict, label, active, *, meta: dict,
                        program, device=None):
    """A port PushEngine on exactly the arrays of a ``lux_tpu`` push
    engine (its ``eng.arrays`` as numpy) and its padded (label, active)
    state.  ``program`` is the port's program of the same app (e.g.
    ``apps.sssp.make_program(start)``).  ``meta`` holds the dense
    layout as for ``from_reference`` (with ``weight`` carried when the
    engine has it) plus the engine's ``queue_cap``, ``edge_budget``,
    ``enable_sparse``, ``sparse_threshold`` and ``delta``; sparse
    engines carry src_ids, src_off, ss_dst, part_start (+ ss_weight).
    A query-batched program's labels and active mask are [P, vpad, B].
    Returns (PushEngine, label tensor, active tensor)."""
    _require(meta, PUSH_META_KEYS)
    host, kw = _geometry(arrays, meta)
    if meta["enable_sparse"]:
        for k in SPARSE_KEYS + ("ss_weight",):
            if k in arrays:
                host[k] = np.asarray(arrays[k])
    eng = PushEngine.from_arrays(
        program, host, queue_cap=int(meta["queue_cap"]),
        edge_budget=int(meta["edge_budget"]),
        enable_sparse=bool(meta["enable_sparse"]),
        sparse_threshold=int(meta["sparse_threshold"]),
        delta=meta["delta"], device=device, **kw)
    return (eng, _state(label, eng, "label"),
            _state(np.asarray(active, bool), eng, "active"))


def watch_from_reference(watch, device=None):
    """A health WATCH of the reference — pull ``(word int32[6], window
    float32[8])`` or push ``(word, stall int32)``, as numpy — as the
    port's device tensors, bits kept, so a guarded run begun in
    ``lux_tpu`` continues here with its window history and stall
    count."""
    word, aux = (np.asarray(x) for x in watch)
    if word.shape != (6,) or word.dtype != np.int32:
        raise ValueError(f"health word must be int32[6], got "
                         f"{word.dtype}{word.shape}")
    if aux.dtype not in (np.float32, np.int32):
        raise ValueError(f"watch aux must be float32 (pull window) or "
                         f"int32 (push stall), got {aux.dtype}")
    return (torch.tensor(word, device=device),
            torch.tensor(aux, device=device))


def watch_to_numpy(watch):
    """A port WATCH as numpy arrays (the reference's dtypes), for a
    guarded run to continue in ``lux_tpu``."""
    return tuple(x.detach().cpu().numpy() for x in watch)

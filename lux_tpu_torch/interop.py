"""Carrying graph arrays and state across from the reference.

``from_reference`` builds a port pull engine on exactly the arrays a
``lux_tpu`` pull engine iterates (its ``eng.arrays``, turned into numpy
by the caller) and returns it with the state as a tensor, so both
packages can iterate from the same bits; ``push_from_reference`` does
the same for a ``lux_tpu`` push engine and its (label, active) state.
Graph arrays are to this system what weights are to a model.  Nothing
here imports the reference: the caller hands over plain numpy arrays
and a dict of scalars.
"""

from __future__ import annotations

import numpy as np
import torch

from lux_tpu_torch.apps.pagerank import make_program
from lux_tpu_torch.engine.pull import TILED_KEYS, PullEngine
from lux_tpu_torch.engine.push import SPARSE_KEYS, PushEngine
from lux_tpu_torch.ops.pagegather import (PAGED_DOT_KEYS, PAGED_KEYS,
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


def _require(meta: dict, keys):
    missing = [k for k in keys if k not in meta]
    if missing:
        raise KeyError(f"meta lacks {missing}")


def _geometry(arrays: dict, meta: dict):
    """The dense layout carried in ``meta`` -> (host arrays of its keys,
    the from_arrays keyword arguments)."""
    paged = meta.get("mode") in ("paged", "pagemajor")
    _require(meta, PAGED_META_KEYS if paged else META_KEYS)
    kw = dict(nv=meta["nv"], ne=meta["ne"], num_parts=meta["num_parts"],
              vpad=meta["vpad"])
    if paged:
        kw["pages"] = PageGeometry(
            classes=tuple((int(c), int(L)) for c, L in meta["classes"]),
            R=int(meta["R"]), Rp=int(meta["Rp"]),
            n_tiles=int(meta["n_tiles"]), n_slots=int(meta["n_slots"]),
            mode=meta["mode"])
        kw["tiles"] = None
        keys = PAGED_KEYS + ("deg", "nvp", "pg_w", "pg_vrs") \
            + PAGED_DOT_KEYS
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
      n_tiles, n_slots, mode + the common keys.

    Programs reading the destination carry ``chunk_tile``; dot
    programs (colfilter) also pair_row_tile, pair_tile0 or pg_rt,
    pg_t0, as the reference builds them.  A query-batched program
    (``apps.pagerank.make_batched_program``) carries its extra arrays
    ``prog_<name>`` ([P, vpad, B] each) and a [P, vpad, B] state."""
    host, kw = _geometry(arrays, meta)
    if program is None:
        program = make_program()
        host.pop("weight", None)        # PageRank reads no weights
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

"""Carrying graph arrays and state across from the reference.

``from_reference`` builds a port engine on exactly the arrays a
``lux_tpu`` pull engine iterates (its ``eng.arrays``, turned into numpy
by the caller) and returns it with the state as a tensor, so both
packages can iterate from the same bits.  Graph arrays are to this
system what weights are to a model.  Nothing here imports the
reference: the caller hands over plain numpy arrays and a dict of
scalars.
"""

from __future__ import annotations

import numpy as np
import torch

from lux_tpu_torch.apps.pagerank import make_program
from lux_tpu_torch.engine.pull import TILED_KEYS, PullEngine
from lux_tpu_torch.ops.tiled import TileGeometry

META_KEYS = ("W", "E", "n_tiles", "n_chunks", "needs_scan", "vpad", "nv",
             "ne", "num_parts")


def from_reference(arrays: dict, state: np.ndarray, *, meta: dict,
                   device=None):
    """arrays: the reference engine's tiled arrays (src_slot, rel_dst,
    chunk_start, last_chunk, deg, nvp) as numpy; state: its padded
    [num_parts, vpad] state; meta: W, E, n_tiles, n_chunks, needs_scan,
    vpad, nv, ne, num_parts.  The program is PageRank.  Returns (PullEngine, state tensor on ``device``)."""
    missing = [k for k in META_KEYS if k not in meta]
    if missing:
        raise KeyError(f"meta lacks {missing}")
    tiles = TileGeometry(W=int(meta["W"]), E=int(meta["E"]),
                         n_tiles=int(meta["n_tiles"]),
                         n_chunks=int(meta["n_chunks"]),
                         needs_scan=bool(meta["needs_scan"]))
    host = {k: np.asarray(arrays[k]) for k in TILED_KEYS}
    eng = PullEngine.from_arrays(
        make_program(), host, tiles, nv=meta["nv"], ne=meta["ne"],
        num_parts=meta["num_parts"], vpad=meta["vpad"], device=device)
    st = torch.tensor(np.asarray(state), device=eng.device)
    if tuple(st.shape) != (eng.num_parts, eng.vpad):
        raise ValueError(f"state {tuple(st.shape)} is not [num_parts, "
                         f"vpad] = [{eng.num_parts}, {eng.vpad}]")
    return eng, st

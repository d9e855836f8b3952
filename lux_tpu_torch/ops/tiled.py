"""Tiled (chunked) edge layout and the scatter-free segment reduction
(counterpart of lux_tpu/ops/tiled.py:63-160, :166, :398-469, :800,
:812).

The host re-lays each part's dst-sorted edges into fixed-shape chunks
bound to output vertex tiles:

- output vertices are grouped into tiles of ``W``; each tile owns a
  whole number of ``E``-edge chunks -> arrays ``[C, E]``;
- within a chunk every edge's destination is a relative lane in
  ``[0, W)`` (int8, -1 = pad lane);
- the chunk's partial ``[W]`` is the chunk_partials kernel
  (ops/chunk_reduce.py); chunks of one tile are then folded by a
  segmented combine and the tile's last chunk is taken.

The arrays are array-equal to the reference's for the same graph: the
chunk count is padded to a multiple of 8 (pad chunks are isolated
identity segments, owned by the pad tile ``n_tiles``).

The matrix-unit forms (``use_mxu=True``; lux_tpu/ops/tiled.py:174-352,
:404-415, :481-535) reduce by contracting against a one-hot lane
matrix instead of kernel B1:

- a scalar float32 sum is kernel S9 (ops/onehot_reduce.py,
  csrc/onehot_mma.cu: ``mma.sync`` on the tensor cores);
- every other contraction is a ``torch.bmm`` / ``torch.matmul`` whose
  result is exact: float sums in full float32, integer sums through
  byte planes, the min/max tournament's 0/1 counts in float16;
- the segmented sum combine is the scan-as-matmul recurrence.

Exactness traps these forms step around (each named where it bites):
cuBLAS has no int32 GEMM (``torch._int_mm`` takes 2-D int8 only, m >
16 and k, n multiples of 8), so integer sums go through float32 byte
planes, exact while a plane's sum stays below 2^24; a bfloat16 product
rounds counts above 256, so the tournament counts in float16 (exact to
2,048); and every float32 product here runs with TF32 off
(``full_fp32``).  The one-hot is blocked by bytes (``MXU_BLOCK_BYTES``):
whole, it would be 4.8 GB of int8 at the main path's [73,712, 512, 128].
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

from lux_tpu_torch.ops.chunk_reduce import (chunk_partials,
                                            chunk_partials_batched)
from lux_tpu_torch.ops.segment import identity_for


def _ceil_div(a, b):
    return (a + b - 1) // b


@dataclasses.dataclass
class TiledLayout:
    """Host-side chunk plan for one partitioned graph (stacked over
    parts; all chunk arrays are ``[num_parts, C, ...]``)."""

    W: int                      # vertices per output tile
    E: int                      # edges per chunk
    n_tiles: int                # ceil(vpad / W), same for every part
    n_chunks: int               # padded chunk count C (max over parts)
    needs_scan: bool            # False when every tile fits in 1 chunk
    edge_gather: np.ndarray     # int64 [P, C, E] index into flat [epad]
    rel_dst: np.ndarray         # int8 [P, C, E] in [0, W); -1 = pad
    chunk_tile: np.ndarray      # int32 [P, C] owning tile; n_tiles = pad
    chunk_start: np.ndarray     # bool  [P, C] True at each tile's 1st chunk
    last_chunk: np.ndarray      # int32 [P, n_tiles] index of tile's last
                                #   chunk, -1 for edge-less tiles

    @classmethod
    def build(cls, row_ptr_local: np.ndarray, dst_local: np.ndarray,
              vpad: int, W: int = 128, E: int = 512,
              sizing_row_ptr: np.ndarray | None = None) -> "TiledLayout":
        """row_ptr_local: int [P, vpad+1] END offsets; dst_local:
        int32 [P, epad] part-local sorted destinations (pad -> vpad).
        ``sizing_row_ptr``: the row_ptr_local rows of ALL parts when
        ``row_ptr_local`` holds only a rank's (a local-parts build), so
        the chunk count and the scan's need are every rank's
        (lux_tpu/ops/tiled.py:91)."""
        if W > 128:
            raise ValueError(
                f"tile width W={W} > 128: rel_dst is int8 (valid lane "
                f"offsets 0..127, -1 = pad) and wider tiles would wrap "
                f"offsets >= 128 negative, silently dropping edges")
        if E < 1:
            raise ValueError(f"chunk width E={E} must be >= 1")
        P = row_ptr_local.shape[0]
        n_tiles = max(1, _ceil_div(vpad, W))

        def tile_chunks(rp_row):
            rp = rp_row.astype(np.int64)
            tile_lo = rp[np.minimum(np.arange(n_tiles) * W, vpad)]
            tile_hi = rp[np.minimum((np.arange(n_tiles) + 1) * W, vpad)]
            n_ch = np.maximum(0, _ceil_div(tile_hi - tile_lo, E))
            return tile_lo, tile_hi, n_ch

        per_part = [tile_chunks(row_ptr_local[p]) for p in range(P)]
        sizing = (per_part if sizing_row_ptr is None else
                  [tile_chunks(r) for r in sizing_row_ptr])
        C = max(1, int(max(int(x[2].sum()) for x in sizing)))
        C = _ceil_div(C, 8) * 8
        needs_scan = any(x[2].max(initial=0) > 1 for x in sizing)

        edge_gather = np.zeros((P, C, E), dtype=np.int64)
        rel_dst = np.full((P, C, E), -1, dtype=np.int8)
        chunk_tile = np.full((P, C), n_tiles, dtype=np.int32)
        chunk_start = np.ones((P, C), dtype=bool)   # pad chunks isolated
        last_chunk = np.full((P, n_tiles), -1, dtype=np.int32)

        lanes = np.arange(E, dtype=np.int64)
        for p in range(P):
            tile_lo, tile_hi, n_ch = per_part[p]
            nc = int(n_ch.sum())
            if nc == 0:
                continue
            ct = np.repeat(np.arange(n_tiles, dtype=np.int64), n_ch)
            tile_first = np.concatenate(([0], np.cumsum(n_ch)[:-1]))
            cj = np.arange(nc, dtype=np.int64) - tile_first[ct]
            start = tile_lo[ct] + cj * E
            idx = start[:, None] + lanes[None, :]          # [nc, E]
            valid = idx < tile_hi[ct][:, None]
            idx = np.where(valid, idx, 0)
            edge_gather[p, :nc] = idx
            rel_dst[p, :nc] = np.where(
                valid, dst_local[p][idx] - (ct * W)[:, None], -1)
            chunk_tile[p, :nc] = ct
            chunk_start[p, :nc] = cj == 0
            last_chunk[p] = np.where(n_ch > 0, np.cumsum(n_ch) - 1, -1)

        return cls(W=W, E=E, n_tiles=n_tiles, n_chunks=C,
                   needs_scan=needs_scan, edge_gather=edge_gather,
                   rel_dst=rel_dst, chunk_tile=chunk_tile,
                   chunk_start=chunk_start, last_chunk=last_chunk)

    def chunk(self, flat: np.ndarray) -> np.ndarray:
        """Re-lay a per-part flat edge array [P, epad, ...] into chunk
        form [P, C, E, ...] (host, once at build time)."""
        parts = np.arange(flat.shape[0])[:, None, None]
        return flat[parts, self.edge_gather]

    @property
    def geometry(self) -> "TileGeometry":
        return TileGeometry(W=self.W, E=self.E, n_tiles=self.n_tiles,
                            n_chunks=self.n_chunks,
                            needs_scan=self.needs_scan)


@dataclasses.dataclass(frozen=True)
class TileGeometry:
    """The scalars of a TiledLayout — all the device side needs once
    the chunk arrays are on the device (the host plan's [P, C, E]
    int64 gather index is then dropped)."""

    W: int
    E: int
    n_tiles: int
    n_chunks: int
    needs_scan: bool


def combine_op(kind: str):
    """The binary combiner for a reduce kind (NaN-propagating)."""
    return {"sum": torch.add, "min": torch.minimum,
            "max": torch.maximum}[kind]


# ---------------------------------------------------------------------
# the matrix-unit forms (use_mxu=True)

# bytes of the one-hot (or byte-plane) operands one contraction block
# holds; the reference streams STREAM_BLOCK_CHUNKS (1,024) chunks
MXU_BLOCK_BYTES = 1 << 30
# chunks of a streamed block (lux_tpu/ops/tiled.py:533): the streamed
# forms below reduce this many chunks a B1 launch, and memory_report's
# ``mxu_temp`` prices the one-hot over it
STREAM_BLOCK_CHUNKS = 1024
# engines stream the gather + partials once a [rows, C, E] f32 message
# temporary would pass this many bytes (lux_tpu/ops/tiled.py:535): the
# rule off the card (``stream_by_default``)
STREAM_MSG_BYTES = 1 << 30
# message-sized temporaries a monolithic step holds at once on the card:
# the gathered source values, the messages and the partials
MONOLITHIC_TEMPS = 3


def stream_by_default(msg_bytes: int, device) -> bool:
    """What ``stream_msgs=None`` means for a step whose monolithic form
    holds ``msg_bytes`` of messages.  On the card: stream only when
    MONOLITHIC_TEMPS of them do not fit in the device memory free now,
    since the streamed forms took 5-10x the monolithic step's time there
    and the owner layout's fused one 50x (NVIDIA H100 80GB HBM3, 700.00
    W; chip_smoke.py's owner_streamed line, PERF.md §5).  Elsewhere: the
    reference's rule, past STREAM_MSG_BYTES (read at call time)."""
    device = torch.device(device)
    if device.type == "cuda":
        free, _total = torch.cuda.mem_get_info(device)
        return MONOLITHIC_TEMPS * msg_bytes > free
    return msg_bytes > STREAM_MSG_BYTES
# block length of the scan-as-matmul combine: one [256, 256] segment
# matrix a block of chunks (lux_tpu/ops/tiled.py:475)
MXU_SCAN_BLOCK = 256
# the float16 tournament counts are exact while a count stays <= 2,048
_F16_EXACT = 2048


class MXUUnsupportedError(ValueError):
    """A (kind, dtype) the one-hot forms do not cover: they serve sum,
    min and max over <= 32-bit int, uint and float payloads."""

    def __init__(self, kind: str, dtype, why: str):
        self.kind = kind
        self.dtype = dtype
        super().__init__(f"MXU one-hot path does not support kind={kind!r} "
                         f"on dtype {dtype}: {why}")


@contextlib.contextmanager
def full_fp32():
    """Float32 products in full float32: TF32 off for cuBLAS
    (``torch.backends.cuda.matmul.allow_tf32``) and cuDNN
    (``torch.backends.cudnn.allow_tf32``), restored after.  TF32 keeps
    about three decimal digits, which no sum here may lose."""
    mm, dnn = torch.backends.cuda.matmul, torch.backends.cudnn
    prev = (mm.allow_tf32, dnn.allow_tf32)
    mm.allow_tf32 = dnn.allow_tf32 = False
    try:
        yield
    finally:
        mm.allow_tf32, dnn.allow_tf32 = prev


def _lane_onehot(rel_dst: torch.Tensor, W: int,
                 dtype=torch.float32) -> torch.Tensor:
    """[..., E] lanes -> [..., E, W] lane membership: row e is one-hot at
    rel_dst[..., e], all zero for a pad lane (-1 matches no lane)."""
    lanes = torch.arange(W, device=rel_dst.device, dtype=rel_dst.dtype)
    return (rel_dst[..., None] == lanes).to(dtype)


def _check_mxu_dtype(kind: str, dtype: torch.dtype) -> None:
    if dtype.is_complex or dtype == torch.bool or dtype.itemsize > 4:
        raise MXUUnsupportedError(
            kind, dtype, "payload has no MXU contraction (only <= 32-bit "
            "int/uint/float states)")


def _order_bits(dtype: torch.dtype) -> int:
    """Tournament rounds for a payload dtype (bits of its order
    encoding); the typed error for what has none."""
    if dtype.is_complex or dtype == torch.bool:
        raise MXUUnsupportedError(
            "min/max", dtype, "no order-preserving bit encoding (only "
            "int/uint/float payloads reduce by comparison)")
    if dtype.itemsize > 4:
        raise MXUUnsupportedError(
            "min/max", dtype, "64-bit payloads violate the 4-byte dtype "
            "discipline (no order encoding fits 32 bits)")
    return dtype.itemsize * 8


_UINT_VIEW = {2: torch.int16, 4: torch.int32}


def _unsigned_bits(x: torch.Tensor) -> torch.Tensor:
    """A float payload's bit pattern as int64 in [0, 2^bits)."""
    bits = x.dtype.itemsize * 8
    return x.view(_UINT_VIEW[x.dtype.itemsize]).to(torch.int64) & (
        (1 << bits) - 1)


def _order_encode(x: torch.Tensor) -> torch.Tensor:
    """Payload -> int64 in [0, 2^bits) whose order matches the payload
    order (the reference's uint32 values): unsigned ints as they are,
    signed ints biased by their minimum, floats by the IEEE-754
    sign-magnitude fold (negative: every bit flipped; else the sign bit
    set) -- a total order agreeing with < on non-NaN values, -0.0 below
    +0.0."""
    bits = _order_bits(x.dtype)
    if not x.dtype.is_floating_point:
        if x.dtype.is_signed:
            return x.to(torch.int64) - torch.iinfo(x.dtype).min
        return x.to(torch.int64)
    u = _unsigned_bits(x)
    sign, mask = 1 << (bits - 1), (1 << bits) - 1
    return torch.where((u & sign) != 0, (~u) & mask, u | sign)


def _order_decode(m: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Inverse of _order_encode (int64 -> the payload dtype)."""
    bits = _order_bits(dtype)
    if not dtype.is_floating_point:
        if dtype.is_signed:
            return (m + torch.iinfo(dtype).min).to(dtype)
        return m.to(dtype)
    sign, mask = 1 << (bits - 1), (1 << bits) - 1
    u = torch.where((m & sign) != 0, m ^ sign, (~m) & mask)
    u = u - ((u >> (bits - 1)) << bits)          # two's complement
    return u.to(_UINT_VIEW[dtype.itemsize]).view(dtype)


def _wrap(total: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """int64 sums -> ``dtype`` with the integer wrap-around of a sum in
    that dtype (the reference's einsum accumulates in the payload
    dtype)."""
    bits = dtype.itemsize * 8
    v = total & ((1 << bits) - 1)
    if dtype.is_signed:
        v = v - ((v >> (bits - 1)) << bits)
    return v.to(dtype)


def _byte_planes(x: torch.Tensor) -> torch.Tensor:
    """An integer tensor's low 32 bits as four float32 byte planes
    [4, ...]: each plane's values are 0..255, so a 0/1 contraction of
    up to 65,793 of them stays below 2^24, where float32 is exact.
    cuBLAS has no int32 GEMM, and ``torch._int_mm`` takes 2-D int8 with
    m > 16 and k, n multiples of 8: byte planes are the exact route."""
    u = x.to(torch.int64) & 0xFFFFFFFF
    return torch.stack([((u >> (8 * b)) & 0xFF).to(torch.float32)
                        for b in range(4)])


def _from_planes(sums: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Contracted byte planes [4, ...] (exact integers in float32) -> the
    integer sum, wrapped to ``dtype``."""
    s = sums.round().to(torch.int64)
    total = s[0] + (s[1] << 8) + (s[2] << 16) + (s[3] << 24)
    return _wrap(total, dtype)


def _block_rows(n: int, row_bytes: int) -> int:
    """Rows of a contraction block: MXU_BLOCK_BYTES of operand."""
    return max(1, min(n, MXU_BLOCK_BYTES // max(1, row_bytes)))


def _onehot_sum(vals: torch.Tensor, rel: torch.Tensor, W: int):
    """[C, E, T] payload -> [C, W, T] sums by ``torch.bmm`` against the
    one-hot, in blocks: floats in full float32 (float16 / bfloat16
    payloads widened, the result narrowed back), integers through byte
    planes."""
    C, E, T = vals.shape
    is_int = not vals.dtype.is_floating_point
    out = torch.empty((C, W, T), dtype=vals.dtype, device=vals.device)
    planes = 4 if is_int else 1
    step = _block_rows(C, E * (W + planes * T) * 4)
    with full_fp32():
        for c0 in range(0, C, step):
            sl = slice(c0, c0 + step)
            ohT = _lane_onehot(rel[sl], W).transpose(1, 2)   # [b, W, E]
            if is_int:
                x = _byte_planes(vals[sl])                  # [4, b, E, T]
                out[sl] = _from_planes(torch.matmul(ohT, x), vals.dtype)
            else:
                out[sl] = torch.bmm(ohT, vals[sl].to(torch.float32)).to(
                    vals.dtype)
    return out


def lane_occupancy(rel: torch.Tensor, W: int) -> torch.Tensor:
    """Which of each chunk's W slots a live lane maps to: lanes [n, E]
    (pads -1) -> [n, W] bool.  The layout alone decides it, so an engine
    makes it once at build (``engine_lane_occupancy``) for the
    tournament's empty slots."""
    n = rel.shape[0]
    idx = torch.where(rel >= 0, rel.long(), W)      # pads: a trash column
    occ = torch.zeros((n, W + 1), dtype=torch.bool, device=rel.device)
    occ.scatter_(1, idx, True)
    return occ[:, :W]


def engine_lane_occupancy(eng):
    """The engine's ``lane_occupancy`` over all its [P*C, E] chunks (the
    owner layout's decoded lanes on the owner exchange) when its reduce
    runs the one-hot tournament (``use_mxu`` with a min / max), else
    None."""
    if not (getattr(eng, "use_mxu", False) and not getattr(eng, "dot", False)
            and eng.program.reduce in ("min", "max")):
        return None
    a = eng.arrays
    if getattr(eng, "owner", None) is not None:
        from lux_tpu_torch.ops.owner import decoded_slots
        geom = eng.owner
        rel = decoded_slots(a)[1]
        return lane_occupancy(rel.reshape(-1, geom.E), geom.W)
    if getattr(eng, "tiles", None) is None or "rel_dst" not in a:
        return None
    return lane_occupancy(a["rel_dst"].reshape(-1, eng.tiles.E),
                          eng.tiles.W)


def _mxu_compare_reduce(vals: torch.Tensor, rel_dst: torch.Tensor, W: int,
                        kind: str, occ: torch.Tensor | None = None
                        ) -> torch.Tensor:
    """min/max per-chunk partials as one-hot contractions: a radix
    tournament over the payload's order encoding, most significant bit
    first (lux_tpu/ops/tiled.py:269-323).  Each bit plane takes two
    contractions against the shared one-hot: a vote (does a
    still-candidate lane of the slot carry the bit?) and the route-back
    that narrows each lane's candidacy to its slot's winning prefix.
    Bit-equal to kernel B1 for integers; floats take the encoding's
    total order.  Pad lanes have all-zero one-hot rows, so they never
    vote; a slot no live lane maps to gets the identity (``occ``, the
    chunks' ``lane_occupancy``, made here when not given).

    The counts are exact small integers (a vote counts at most E lanes,
    a route-back is 0 or 1), contracted in float16 on the card -- exact
    to 2,048, where bfloat16 would round counts past 256 -- and in
    float32 on the CPU or when E > 2,048."""
    if kind not in ("min", "max"):
        raise MXUUnsupportedError(kind, vals.dtype,
                                  "unknown compare-reduce kind")
    bits = _order_bits(vals.dtype)
    mask = (1 << bits) - 1
    C, E = vals.shape[:2]
    trail = tuple(vals.shape[2:])
    T = int(np.prod(trail)) if trail else 1
    m = _order_encode(vals).reshape(C, E, T)
    if kind == "min":                 # min is max of the complement
        m = (~m) & mask
    cdt = (torch.float16 if vals.device.type == "cuda"
           and E <= _F16_EXACT else torch.float32)
    res = torch.empty((C, W, T), dtype=torch.int64, device=vals.device)
    if occ is None:
        occ = lane_occupancy(rel_dst, W)
    step = _block_rows(C, E * W * cdt.itemsize + E * T * 24)
    with full_fp32():
        for c0 in range(0, C, step):
            sl = slice(c0, c0 + step)
            oh = _lane_onehot(rel_dst[sl], W, cdt)          # [b, E, W]
            ohT = oh.transpose(1, 2)
            b = oh.shape[0]
            mb = m[sl]
            cand = torch.ones((b, E, T), dtype=torch.bool,
                              device=vals.device)
            r = torch.zeros((b, W, T), dtype=torch.int64,
                            device=vals.device)
            for sh in range(bits - 1, -1, -1):
                bit = ((mb >> sh) & 1).bool()
                cnt = torch.bmm(ohT, (bit & cand).to(cdt))  # [b, W, T]
                has = cnt > 0
                r |= has.to(torch.int64) << sh
                back = torch.bmm(oh, has.to(cdt))           # [b, E, T]
                cand &= (back > 0) == bit
            res[sl] = r
    if kind == "min":
        res = (~res) & mask
    out = _order_decode(res, vals.dtype).reshape((C, W) + trail)
    ident = torch.full((), identity_for(kind, vals.dtype), dtype=vals.dtype,
                       device=vals.device)
    occb = occ.reshape((C, W) + (1,) * len(trail))
    return torch.where(occb, out, ident)


def chunk_partials_mxu(vals: torch.Tensor, rel_dst: torch.Tensor, W: int,
                       kind: str, rel32: torch.Tensor | None = None,
                       occ: torch.Tensor | None = None):
    """Per-chunk partials [C, E, ...] -> [C, W, ...] by the one-hot
    forms (the reference's ``chunk_partials(use_mxu=True)``).  A scalar
    float32 sum is kernel S9 (``rel32``: the lanes as int32, S9's
    dtype; made here when not given); other sums a ``torch.bmm``
    against the one-hot; min/max the tournament (``occ``: the chunks'
    ``lane_occupancy``)."""
    _check_mxu_dtype(kind, vals.dtype)
    if kind == "sum":
        if vals.dim() == 2 and vals.dtype == torch.float32 \
                and vals.shape[1] > 0:
            from lux_tpu_torch.ops.onehot_reduce import onehot_reduce
            if rel32 is None:
                rel32 = rel_dst.to(torch.int32)
            return onehot_reduce(vals.contiguous(), rel32.contiguous(), W)
        C, E = vals.shape[:2]
        trail = tuple(vals.shape[2:])
        out = _onehot_sum(vals.reshape(C, E, -1), rel_dst, W)
        return out.reshape((C, W) + trail)
    if kind in ("min", "max"):
        return _mxu_compare_reduce(vals, rel_dst, W, kind, occ)
    raise MXUUnsupportedError(kind, vals.dtype, "unknown reduce kind")


def _matmul_exact(A: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``A @ x`` for a 0/1 float32 matrix ``A`` [..., n, n] (at most
    256 wide) and a payload ``x`` [..., n, T]: floats in full float32,
    integers through byte planes (exact: 255 * 256 < 2^24), wrapped to
    x's dtype."""
    with full_fp32():
        if x.dtype.is_floating_point:
            return torch.matmul(A, x.to(torch.float32)).to(x.dtype)
        return _from_planes(torch.matmul(A, _byte_planes(x)), x.dtype)


def _segscan_matmul(partials: torch.Tensor, chunk_start: torch.Tensor,
                    block: int | None = None) -> torch.Tensor:
    """Segmented inclusive SUM scan along axis 0 as blocked matrix
    products (lux_tpu/ops/tiled.py:481-535): per block the
    lower-triangular same-segment matrix T[i, j] = (i >= j) & (seg i ==
    seg j), built from cumsum(flags), gives every prefix in the block in
    one contraction; rows before a block's first flag then add the
    running value carried from the blocks before, itself the same scan
    one level up over the blocks' last rows.  Integer payloads are
    bit-equal to the flag-reset scan."""
    block = MXU_SCAN_BLOCK if block is None else int(block)
    flags = chunk_start.reshape(-1).to(torch.bool)
    C = partials.shape[0]
    trail = tuple(partials.shape[1:])
    if C == 0:
        return partials
    nB = _ceil_div(C, block)
    Cp = nB * block
    x = partials.reshape(C, -1)
    if Cp != C:             # pad chunks: isolated identity segments
        x = torch.cat([x, x.new_zeros((Cp - C, x.shape[1]))])
        flags = torch.cat([flags, flags.new_ones(Cp - C)])
    x = x.reshape(nB, block, -1)
    f = flags.reshape(nB, block)
    sid = torch.cumsum(f.to(torch.int32), 1, dtype=torch.int32)
    ii = torch.arange(block, device=x.device)
    T = ((ii[:, None] >= ii[None, :])[None]
         & (sid[:, :, None] == sid[:, None, :])).to(torch.float32)
    out = _matmul_exact(T, x)
    if nB > 1:
        # the value running into block b: the inclusive scan, reset at
        # every block holding a flag, of the blocks' last rows, shifted
        last = _segscan_matmul(out[:, -1], f.any(1), block)
        carry = torch.cat([last.new_zeros((1,) + tuple(last.shape[1:])),
                           last[:-1]])
        absorb = (sid == 0)[..., None]
        out = torch.where(absorb, out + carry[:, None], out)
    return out.reshape((Cp,) + trail)[:C]


@dataclasses.dataclass(frozen=True)
class SegmentPlan:
    """Device-side plan of the segmented chunk combine, computed once
    per layout (``segment_plan``) so the per-iteration combine never
    syncs with the host."""

    pos: torch.Tensor           # int64 [R*C] position within its segment
    max_len: int                # longest segment (chunks of one tile)
    take: torch.Tensor          # int64 [R*n_tiles] flat index of last chunk
    empty: torch.Tensor         # bool [R, n_tiles] edge-less tiles


def segment_plan(chunk_start: torch.Tensor,
                 last_chunk: torch.Tensor) -> SegmentPlan:
    """chunk_start bool [R, C] (or [C]); last_chunk int [R, n_tiles]
    (or [n_tiles]).  Each run of chunks starting at a True flag is one
    segment; parts are independent because each part's first chunk is
    flagged (real first chunks and pad chunks both are)."""
    cs = chunk_start.reshape(-1).to(torch.bool)
    lc = last_chunk.reshape(-1, last_chunk.shape[-1]).to(torch.int64)
    R, n_tiles = lc.shape
    C = cs.numel() // R
    idx = torch.arange(cs.numel(), device=cs.device)
    first = torch.cummax(torch.where(cs, idx, torch.zeros_like(idx)),
                         dim=0).values
    pos = idx - first
    max_len = int(pos.max()) + 1 if pos.numel() else 1
    base = torch.arange(R, device=cs.device)[:, None] * C
    take = (base + lc.clamp(min=0)).reshape(-1)
    return SegmentPlan(pos=pos, max_len=max_len, take=take, empty=lc < 0)


def _doubling(x: torch.Tensor, pos: torch.Tensor, bound: int, comb):
    """The inclusive segmented scan of ``x`` along dim 0 by doubling,
    ``pos`` each row's position within its segment: the passes up to
    ``bound``, the longest segment."""
    tail = (1,) * (x.dim() - 1)
    d = 1
    while d < bound:
        m = (pos[d:] >= d).reshape((-1,) + tail)
        x = torch.cat([x[:d], torch.where(m, comb(x[:-d], x[d:]), x[d:])])
        d *= 2
    return x


def combine_chunks(partials: torch.Tensor, layout, chunk_start,
                   last_chunk, kind: str,
                   plan: SegmentPlan | None = None,
                   use_mxu: bool = False) -> torch.Tensor:
    """Segmented combine of per-chunk partials [R*C, W, ...] (or
    [C, W, ...]) into tile results [R, n_tiles, W, ...] (or
    [n_tiles, W, ...], following ``last_chunk``'s shape).

    An inclusive segmented scan by doubling (log2 of the longest
    segment passes; none when every tile fits in one chunk), then each
    tile's last chunk is taken; edge-less tiles get the identity and
    pad chunks (tile ``n_tiles``) are never taken.  Deterministic: the
    combine order is fixed by the layout.  ``use_mxu`` runs a sum's
    scan as ``_segscan_matmul``; min/max keep the doubling (a prefix
    min has no matmul form: each output would need its own vote)."""
    if plan is None:
        plan = segment_plan(chunk_start, last_chunk)
    trail = tuple(partials.shape[1:])
    x = partials.reshape((-1,) + trail)
    if use_mxu and kind == "sum" and plan.max_len > 1:
        x = _segscan_matmul(x, chunk_start)
    else:
        x = _doubling(x, plan.pos, plan.max_len, combine_op(kind))
    out = x[plan.take].reshape(tuple(last_chunk.shape) + trail)
    empty = plan.empty.reshape(tuple(last_chunk.shape) +
                               (1,) * len(trail))
    ident = torch.full((), identity_for(kind, x.dtype), dtype=x.dtype,
                       device=x.device)
    return torch.where(empty, ident, out)


def combine_partials(partials, layout, chunk_start, last_chunk, vpad: int,
                     kind: str, plan: SegmentPlan | None = None,
                     use_mxu: bool = False):
    """Per-chunk partials -> per-vertex results [R, vpad, ...] (or
    [vpad, ...] for one part)."""
    tiles = combine_chunks(partials, layout, chunk_start, last_chunk, kind,
                           plan, use_mxu)
    lead = tuple(last_chunk.shape[:-1])
    flat = tiles.reshape(lead + (layout.n_tiles * layout.W,) +
                         tuple(tiles.shape[len(lead) + 2:]))
    return flat.narrow(len(lead), 0, vpad)


def tiled_segment_reduce(vals, layout, chunk_start, last_chunk, rel_dst,
                         vpad: int, kind: str,
                         plan: SegmentPlan | None = None,
                         batch: int | None = None, use_mxu: bool = False,
                         rel32: torch.Tensor | None = None,
                         occ: torch.Tensor | None = None):
    """Full scatter-free segment reduce: chunked messages [R*C, E]
    (or [C, E]) -> [R, vpad] (or [vpad]).  Drop-in for
    ``segment_reduce(msgs, dst_local, vpad+1, kind)[:vpad]``; the
    per-chunk partials go through kernel B1 (ops/chunk_reduce.py).
    ``batch=B``: messages with a trailing query axis [..., E, B] ->
    [R, vpad, B], through B1's batched form (a strided view is made
    contiguous first: the kernel takes contiguous rows only).
    ``use_mxu``: the partials and a sum's combine by the one-hot forms
    (``chunk_partials_mxu``; ``rel32`` the lanes as int32 for S9,
    ``occ`` their ``lane_occupancy`` for the tournament)."""
    rel = rel_dst.reshape(-1, layout.E)
    if use_mxu:
        shape = (-1, layout.E) + (() if batch is None else (batch,))
        partials = chunk_partials_mxu(
            vals.reshape(shape), rel, layout.W, kind,
            None if rel32 is None else rel32.reshape(-1, layout.E), occ)
    elif batch is None:
        partials = chunk_partials(vals.reshape(-1, layout.E), rel,
                                  layout.W, kind)
    else:
        partials = chunk_partials_batched(
            vals.reshape(-1, layout.E, batch).contiguous(), rel, layout.W,
            kind)
    return combine_partials(partials, layout, chunk_start, last_chunk, vpad,
                            kind, plan, use_mxu)


# ---------------------------------------------------------------------
# the streamed forms (lux_tpu/ops/tiled.py:530-800): gather, messages and
# partials a block of STREAM_BLOCK_CHUNKS chunks at a time, so the
# [C, E] message temporaries never exist whole

def unpack_src_rel(packed: torch.Tensor, n_valid: torch.Tensor):
    """Decode the packed owner slots (ops/owner.OwnerLayout: the uint32
    ``src_local << 7 | rel``, carried as int32 with the same bits, and
    each chunk's live-lane count, uint16 carried as int16 bits) to (src
    int32, pads 0; rel int8, pads -1) (lux_tpu/ops/tiled.py:538).  The
    decode is five elementwise passes over the slots."""
    src = torch.bitwise_right_shift(packed, 7).bitwise_and_(0x1FFFFFF)
    rel = packed.bitwise_and(0x7F).to(torch.int8)
    lane = torch.arange(packed.shape[-1], dtype=torch.int32,
                        device=packed.device)
    pad = lane >= (n_valid.to(torch.int32) & 0xFFFF)[..., None]
    return src.masked_fill_(pad, 0), rel.masked_fill_(pad, -1)


def block_partials(flat_state: torch.Tensor, src_b: torch.Tensor, rel_b,
                   w_b, msg_fn, kind: str, W: int, use_mxu: bool = False,
                   nv_b=None, occ_b=None) -> torch.Tensor:
    """One block's gather + messages + per-chunk partials [n, E] slots
    -> [n, W, ...] (lux_tpu/ops/tiled.py:554 ``_block_partials``):
    kernel B1, or its batched form over a trailing state axis, or the
    one-hot forms under ``use_mxu`` (``occ_b``: the block's
    ``lane_occupancy``).  ``nv_b`` set: ``src_b`` holds the packed owner
    slots and ``rel_b`` is None."""
    from lux_tpu_torch.engine.pull import gather_rows
    if nv_b is not None:
        src_b, rel_b = unpack_src_rel(src_b, nv_b)
    n, E = src_b.shape
    trail = tuple(flat_state.shape[1:])
    vals = gather_rows(flat_state, src_b.reshape(-1)).view(
        (n, E) + trail)
    return reduce_partials(msg_fn(vals, w_b), rel_b, W, kind, use_mxu,
                           occ=occ_b)


def reduce_partials(msgs: torch.Tensor, rel: torch.Tensor, W: int,
                    kind: str, use_mxu: bool = False,
                    rel32: torch.Tensor | None = None,
                    occ: torch.Tensor | None = None) -> torch.Tensor:
    """Per-chunk partials of [n, E, ...] messages -> [n, W, ...]: kernel
    B1, its batched form over the flattened trailing dims, or the
    one-hot forms under ``use_mxu`` (``rel32``: S9's int32 lanes;
    ``occ``: the tournament's ``lane_occupancy``)."""
    if use_mxu:
        return chunk_partials_mxu(msgs, rel, W, kind, rel32, occ)
    n, E = msgs.shape[:2]
    mtrail = tuple(msgs.shape[2:])
    if not mtrail:
        return chunk_partials(msgs.contiguous(), rel, W, kind)
    out = chunk_partials_batched(msgs.reshape(n, E, -1).contiguous(), rel,
                                 W, kind)
    return out.view((n, W) + mtrail)


def _blocks(C: int, block_chunks: int | None):
    B = STREAM_BLOCK_CHUNKS if block_chunks is None else block_chunks
    B = max(8, min(int(B), C))
    return [(c0, min(C, c0 + B)) for c0 in range(0, C, B)]


def streamed_chunk_partials(flat_state, src_slot, rel_dst, weight, layout,
                            kind: str, msg_fn, use_mxu: bool = False,
                            block_chunks: int | None = None,
                            nvalid=None, occ=None) -> torch.Tensor:
    """Gather + messages + per-chunk partials over [C, E] slots (any
    number of parts' chunks stacked) in blocks of ``block_chunks``
    (default STREAM_BLOCK_CHUNKS) -> [C, W, ...]
    (lux_tpu/ops/tiled.py:584).  A chunk's partial does not depend on
    the blocking, so the result is the monolithic reduce's, bit for
    bit; one B1 launch a block.  ``nvalid``: ``src_slot`` holds packed
    owner slots and ``rel_dst`` is None; ``occ``: the chunks'
    ``lane_occupancy`` (use_mxu's tournament)."""
    C = src_slot.shape[0]
    out = None
    for c0, c1 in _blocks(C, block_chunks):
        part = block_partials(
            flat_state, src_slot[c0:c1],
            None if rel_dst is None else rel_dst[c0:c1],
            None if weight is None else weight[c0:c1], msg_fn, kind,
            layout.W, use_mxu,
            nv_b=None if nvalid is None else nvalid[c0:c1],
            occ_b=None if occ is None else occ[c0:c1])
        if out is None:
            out = part.new_empty((C,) + tuple(part.shape[1:]))
        out[c0:c1] = part
    return out


def streamed_tiled_reduce(flat_state, a: dict, layout, vpad: int,
                          kind: str, msg_fn, plan=None,
                          use_mxu: bool = False,
                          occ=None) -> torch.Tensor:
    """An engine's tiled path streamed: ``streamed_chunk_partials`` over
    every part's [C, E] chunks of the arrays ``a`` (src_slot, rel_dst,
    chunk_start, last_chunk, + weight), then the segmented combine ->
    [P, vpad, ...] (``occ``: the chunks' ``lane_occupancy``)."""
    n = a["src_slot"].shape[0] * layout.n_chunks
    E = layout.E
    partials = streamed_chunk_partials(
        flat_state, a["src_slot"].view(n, E), a["rel_dst"].view(n, E),
        None if "weight" not in a else a["weight"].view(n, E), layout,
        kind, msg_fn, use_mxu=use_mxu, occ=occ)
    return combine_partials(partials, layout, a["chunk_start"],
                            a["last_chunk"], vpad, kind, plan, use_mxu)


def extract_plan_width(last_chunk_rows: np.ndarray, C: int,
                       block: int | None = None) -> int:
    """The most last chunks of any (row, block): the width L a build
    needs (lux_tpu/ops/tiled.py:685)."""
    lc = np.asarray(last_chunk_rows, np.int64)
    if block is None:
        block = STREAM_BLOCK_CHUNKS
    nB = max(1, _ceil_div(C, block))
    best = 1
    for r in range(lc.shape[0]):
        live = lc[r] >= 0
        if live.any():
            cnt = np.bincount(lc[r][live] // block, minlength=nB)
            best = max(best, int(cnt.max()))
    return best


def build_extract_plan(last_chunk_rows: np.ndarray, C: int,
                       block: int | None = None, L: int | None = None):
    """Host plan of the fused streamed combine (lux_tpu/ops/tiled.py:633):
    for each ``block``-chunk slice of each row, the in-block positions
    of the tiles whose last chunk falls in it, and those tiles.
    last_chunk_rows int32 [R, n_tiles] (-1 = edge-less tile) ->
    (extr_pos int32 [R, nB, L], pad 0; extr_tile int32 [R, nB, L], pad
    n_tiles, the trash row).  The arrays are the reference's."""
    lc = np.asarray(last_chunk_rows, np.int64)
    R, n_tiles = lc.shape
    if block is None:
        block = STREAM_BLOCK_CHUNKS
    nB = max(1, _ceil_div(C, block))
    need = extract_plan_width(lc, C, block)
    if L is None:
        L = need
    elif L < need:
        raise ValueError(f"extract width L={L} < this build's {need}")
    extr_pos = np.zeros((R, nB, L), np.int32)
    extr_tile = np.full((R, nB, L), n_tiles, np.int32)
    for r in range(R):
        live = np.nonzero(lc[r] >= 0)[0]
        if not live.size:
            continue
        c = lc[r][live]
        b = c // block
        order = np.argsort(b, kind="stable")
        bs = b[order]
        newb = np.ones(len(bs), bool)
        newb[1:] = bs[1:] != bs[:-1]
        pos = np.arange(len(bs))
        gst = np.maximum.accumulate(np.where(newb, pos, 0))
        slot = pos - gst                     # rank within its block
        extr_pos[r, bs, slot] = (c[order] - bs * block).astype(np.int32)
        extr_tile[r, bs, slot] = live[order].astype(np.int32)
    return extr_pos, extr_tile


def segscan(x: torch.Tensor, start: torch.Tensor, kind: str,
            max_run: int | None = None) -> torch.Tensor:
    """Inclusive segmented scan of ``x`` [n, ...] along dim 0, a segment
    beginning at each True of ``start`` [n] (rows before the first True
    form one segment), by doubling: ceil(log2) of the longest run
    passes, ``max_run`` bounding it when the caller knows it."""
    n = x.shape[0]
    bound = n if max_run is None else min(n, int(max_run))
    if bound <= 1:
        return x
    idx = torch.arange(n, device=x.device)
    pos = idx - torch.cummax(torch.where(start, idx, 0), 0).values
    return _doubling(x, pos, bound, combine_op(kind))


def streamed_chunk_combined(flat_state, src_slot, rel_dst, weight, layout,
                            kind: str, msg_fn, chunk_start, extr_pos,
                            extr_tile, last_chunk, use_mxu: bool = False,
                            block_chunks: int | None = None, nvalid=None,
                            max_run: int | None = None,
                            occ=None) -> torch.Tensor:
    """The fused streamed form for ONE row of chunks
    (lux_tpu/ops/tiled.py:701): per block, gather + messages + partials
    (``block_partials``: one B1 launch), the segmented scan inside the
    block, the running value carried in from the previous block into
    the rows before its first segment start, and each tile's last chunk
    scattered into an [n_tiles + 1, W, ...] output (pads into the trash
    row n_tiles).  Returns [n_tiles, W, ...]; the [C, W] partials are
    never held whole.  src_slot [C, E] (packed owner slots when
    ``nvalid`` [C] is given, ``rel_dst`` None), chunk_start bool [C],
    extr_pos / extr_tile [nB, L] of ``build_extract_plan`` at the same
    block, last_chunk int [n_tiles] (its < 0 mask).  ``max_run``: the
    longest segment, bounding the scan's passes; ``occ``: the chunks'
    ``lane_occupancy`` (use_mxu's tournament)."""
    C = src_slot.shape[0]
    comb = combine_op(kind)
    n_tiles = last_chunk.shape[0]
    run = acc = None
    for b, (c0, c1) in enumerate(_blocks(C, block_chunks)):
        partials = block_partials(
            flat_state, src_slot[c0:c1],
            None if rel_dst is None else rel_dst[c0:c1],
            None if weight is None else weight[c0:c1], msg_fn, kind,
            layout.W, use_mxu,
            nv_b=None if nvalid is None else nvalid[c0:c1],
            occ_b=None if occ is None else occ[c0:c1])
        if acc is None:
            ident = identity_for(kind, partials.dtype)
            run = partials.new_full(tuple(partials.shape[1:]), ident)
            acc = partials.new_full((n_tiles + 1,) +
                                    tuple(partials.shape[1:]), ident)
        f = chunk_start[c0:c1]
        inner = segscan(partials, f, kind, max_run)
        absorb = (torch.cumsum(f.to(torch.int32), 0, dtype=torch.int32)
                  == 0).reshape(
            (-1,) + (1,) * (partials.dim() - 1))
        out = torch.where(absorb, comb(run, inner), inner)
        acc[extr_tile[b].long()] = out[extr_pos[b].long()]
        run = out[-1]
    out = acc[:n_tiles]
    empty = (last_chunk < 0).reshape((-1,) + (1,) * (out.dim() - 1))
    return torch.where(empty, torch.full((), identity_for(kind, out.dtype),
                                         dtype=out.dtype,
                                         device=out.device), out)

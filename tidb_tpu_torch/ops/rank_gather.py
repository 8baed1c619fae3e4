"""The monolithic program's tiled all_gather (K25 rank_gather).

The JAX package's `broadcast_build` and `gather_partials`
(tidb_tpu/parallel/collective.py:151,158) all_gather each column along
the mesh axis: shard r's piece lands at rows [r·n, (r+1)·n) of a buffer
every shard then holds. The port's ranks live on one device, so one
gathered buffer per column serves every rank, and the gather is one
copy per (column, rank) piece. Nothing downstream may write into a
gathered buffer in place.

The host side of K25 is `gather_plan`, a pure function of the columns'
element sizes, leading rows and per-rank lengths (so it is cached by
shape): one descriptor per column, expanded to segments (one rank's
piece of one column, with its destination offset, bytes a row and the
column's row pitch; empty pieces drop out), split into launches of
`MAX_SEGS` segments whose chunks of `CHUNK` bytes are numbered from 0.
A call then checks each column once, allocates the outputs (one
torch.empty for each group of columns that share a dtype, leading shape
and gathered length: each column is a view of one row of its group's
buffer, so a column kept alive keeps the whole buffer), packs the
pieces' and the outputs' pointers beside the cached segment table and
makes one ctypes call; csrc/rank_gather.cu copies every chunk of a
launch over a grid sized to the SMs.

`rank_gather` takes its plain version (`torch.cat`) for CPU tensors and
launches the kernel for CUDA tensors, or raises on anything it does not
take.
"""

from __future__ import annotations

import functools
import struct
from typing import List, NamedTuple, Sequence, Tuple

import torch

from tidb_tpu_torch.ops import cuda_kernels as ck

#: bytes a chunk and segments a launch (csrc/rank_gather.cu CHUNK and
#: MAX_SEGS; the card tests hold them equal to tt_rank_gather_chunk and
#: tt_rank_gather_max_segs)
CHUNK = 16384
MAX_SEGS = 80
#: one segment record (csrc/rank_gather.cu struct Rec): dst_off,
#: row_bytes, pitch, start, col, rows, row_chunks, padding
_REC = struct.Struct("<qqqqiiii")


def rank_gather_plain(columns: Sequence[Sequence[torch.Tensor]]
                      ) -> List[torch.Tensor]:
    """Plain version: each column's pieces (one per rank, 1-D (n_r,) or
    2-D (L, n_r) with the rows on the last axis) concatenated along the
    last axis in rank order."""
    return [torch.cat(list(pieces), dim=-1) for pieces in columns]


class Segment(NamedTuple):
    """One rank's non-empty piece of one column, as the kernel copies it:
    row l moves row_bytes from the piece's byte l·row_bytes to the
    output's byte dst_off + l·pitch."""
    col: int
    dst_off: int       # off_r · size: row 0's byte offset in the output
    row_bytes: int     # n_r · size
    pitch: int         # total · size
    rows: int          # L
    row_chunks: int    # ceil(row_bytes / CHUNK)
    start: int         # first chunk in its launch


class GatherPlan(NamedTuple):
    totals: Tuple[int, ...]          # gathered length of each column
    segments: Tuple[Segment, ...]    # launch after launch of MAX_SEGS
    pieces: Tuple[int, ...]          # each segment's piece, flat index
    table: bytes                     # the segments as packed records
    src: struct.Struct               # one uint64 pointer a segment
    out: struct.Struct               # one uint64 pointer a column
    #: the outputs' allocations: (dtype, shape, columns); two or more
    #: columns of one dtype, leading shape and total share one buffer
    #: of shape (k,) + shape, each column one of its rows
    groups: Tuple[Tuple[torch.dtype, Tuple[int, ...], Tuple[int, ...]], ...]


@functools.lru_cache(maxsize=256)
def gather_plan(columns: Tuple[Tuple[torch.dtype, Tuple[int, ...],
                                     Tuple[int, ...]], ...]) -> GatherPlan:
    """K25's descriptors, a pure function of shapes. columns[j] = (dtype,
    leading shape () or (L,), (n_0, ..., n_{R-1})): one descriptor per
    column, its per-rank offsets off_r = n_0 + ... + n_{r-1}, expanded
    to the non-empty segments in (column, rank) order; each run of
    MAX_SEGS segments is one launch, its chunks numbered from 0."""
    totals, segs, flat, k = [], [], [], 0
    groups = {}
    for j, (dtype, lead, lengths) in enumerate(columns):
        size = dtype.itemsize
        rows = lead[0] if lead else 1
        total = sum(lengths)
        totals.append(total)
        groups.setdefault((dtype, tuple(lead) + (total,)), []).append(j)
        off = 0
        for n in lengths:
            if n and rows:
                row_bytes = n * size
                start = 0
                if len(segs) % MAX_SEGS:
                    start = segs[-1].start + segs[-1].rows * \
                        segs[-1].row_chunks
                segs.append(Segment(j, off * size, row_bytes, total * size,
                                    rows, -(-row_bytes // CHUNK), start))
                flat.append(k)
            off += n
            k += 1
    table = b"".join(_REC.pack(s.dst_off, s.row_bytes, s.pitch, s.start,
                               s.col, s.rows, s.row_chunks, 0)
                     for s in segs)
    return GatherPlan(tuple(totals), tuple(segs), tuple(flat), table,
                      struct.Struct(f"<{len(segs)}Q"),
                      struct.Struct(f"<{len(columns)}Q"),
                      tuple((dt, shape, tuple(cols))
                            for (dt, shape), cols in groups.items()))


def _check_pieces(pieces: Sequence[torch.Tensor], dev=None):
    """K25's checks of one column's pieces, once a column: CUDA (through
    ck.require_cuda), one device, dtype and leading shape, 1-D or 2-D.
    → (the pieces, each made contiguous where it was not; their lengths;
    their data pointers)."""
    first = pieces[0]
    nd = first.dim()
    if not 1 <= nd <= 2:
        raise ck.KernelError("rank_gather: 1-D or 2-D pieces expected")
    dev = first.device if dev is None else dev
    index = -1 if dev.index is None else dev.index
    dt = first.dtype
    rows = first.shape[0]
    out, lens, ptrs = [], [], []
    for p in pieces:
        sh = p.shape
        if p.dtype != dt or p.get_device() != index or len(sh) != nd or \
                (nd == 2 and sh[0] != rows):
            raise ck.KernelError("rank_gather: a column's pieces share one "
                                 "device, dtype and leading shape")
        if not p.is_contiguous():
            p = p.contiguous()
        out.append(p)
        lens.append(sh[-1])
        ptrs.append(p.data_ptr())
    ck.require_cuda(out[0], what="rank_gather")
    return out, lens, ptrs


def _describe(columns, dev):
    """Check every column once → (its plan, every piece's pointer in
    (column, rank) order, the pieces kept alive until the launch)."""
    key, src, keep = [], [], []
    for pieces in columns:
        pieces, lens, ptrs = _check_pieces(pieces, dev)
        first = pieces[0]
        key.append((first.dtype, tuple(first.shape[:-1]), tuple(lens)))
        src += ptrs
        keep.append(pieces)
    return gather_plan(tuple(key)), src, keep


def _allocate(plan: GatherPlan, like: Sequence[torch.Tensor]
              ) -> List[torch.Tensor]:
    """The gathered columns (like[j]: a piece of column j, whose dtype and
    device new_empty takes): one allocation a group of columns that
    share a dtype, leading shape and total, each column a view of one
    row of it, so a column kept alive keeps its group's buffer."""
    outs = [None] * len(plan.totals)
    for _dt, shape, cols in plan.groups:
        if len(cols) == 1:
            outs[cols[0]] = like[cols[0]].new_empty(shape)
            continue
        buf = like[cols[0]].new_empty((len(cols),) + shape)
        for j, view in zip(cols, buf.unbind(0)):
            outs[j] = view
    return outs


def _launch(plan: GatherPlan, src: List[int], outs, dev) -> None:
    rc = ck.library("rank_gather").tt_rank_gather(
        len(plan.segments), plan.table,
        plan.src.pack(*[src[i] for i in plan.pieces]),
        plan.out.pack(*map(torch.Tensor.data_ptr, outs)),
        ck.stream_ptr(dev))
    ck.count("rank_gather")
    ck.check(rc, "rank_gather")


def rank_gather(columns: Sequence[Sequence[torch.Tensor]]
                ) -> List[torch.Tensor]:
    """K25 wrapper. columns[j]: column j's pieces, one per rank, of one
    dtype and leading shape (1-D or 2-D), on one CUDA device. → the
    gathered column per column, as rank_gather_plain. One launch for up
    to MAX_SEGS non-empty pieces, no host sync."""
    if not columns or columns[0][0].device.type == "cpu":
        return rank_gather_plain(columns)
    dev = columns[0][0].device
    plan, src, keep = _describe(columns, dev)
    outs = _allocate(plan, [pieces[0] for pieces in keep])
    if plan.segments:
        _launch(plan, src, outs, dev)
    return outs

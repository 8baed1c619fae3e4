"""The monolithic program's tiled all_gather (K25 rank_gather).

The JAX package's `broadcast_build` and `gather_partials`
(tidb_tpu/parallel/collective.py:151,158) all_gather each column along
the mesh axis: shard r's piece lands at rows [r·n, (r+1)·n) of a buffer
every shard then holds. The port's ranks live on one device, so one
gathered buffer per column serves every rank, and the gather is one
copy per (column, rank) piece: csrc/rank_gather.cu copies every piece of
every column in one launch, through a table of source and destination
pointers and byte counts (1-, 2-, 4- and 8-byte items move as aligned
words). Nothing downstream may write into a gathered buffer in place.

`rank_gather` takes its plain version (`torch.cat`) for CPU tensors and
launches the kernel for CUDA tensors, or raises on anything it does not
take.
"""

from __future__ import annotations

import ctypes
from typing import List, Sequence

import torch


def rank_gather_plain(columns: Sequence[Sequence[torch.Tensor]]
                      ) -> List[torch.Tensor]:
    """Plain version: each column's pieces (one per rank, 1-D (n_r,) or
    2-D (L, n_r) with the rows on the last axis) concatenated along the
    last axis in rank order."""
    return [torch.cat(list(pieces), dim=-1) for pieces in columns]


def _check_pieces(pieces: Sequence[torch.Tensor], dev=None) -> None:
    """K25's checks of one column's pieces: CUDA, one device, dtype and
    leading shape, 1-D or 2-D."""
    from tidb_tpu_torch.ops import cuda_kernels as ck
    first = pieces[0]
    dev = first.device if dev is None else dev
    if first.dim() not in (1, 2):
        raise ck.KernelError("rank_gather: 1-D or 2-D pieces expected")
    for p in pieces:
        ck.require_cuda(p, what="rank_gather")
        if p.device != dev or p.dtype != first.dtype or \
                p.shape[:-1] != first.shape[:-1]:
            raise ck.KernelError("rank_gather: a column's pieces share one "
                                 "device, dtype and leading shape")


def rank_gather(columns: Sequence[Sequence[torch.Tensor]]
                ) -> List[torch.Tensor]:
    """K25 wrapper. columns[j]: column j's pieces, one per rank, of one
    dtype and leading shape, on one CUDA device. → the gathered column
    per column, as rank_gather_plain. One launch for up to 128 pieces
    (a 2-D piece is one piece a row), no host sync."""
    if not columns or columns[0][0].device.type == "cpu":
        return rank_gather_plain(columns)
    from tidb_tpu_torch.ops import cuda_kernels as ck
    dev = columns[0][0].device
    outs, src, dst, nbytes = [], [], [], []
    keep = []       # the contiguous pieces stay alive until the launch
    for pieces in columns:
        pieces = [p.contiguous() for p in pieces]
        keep.append(pieces)
        _check_pieces(pieces, dev)
        first = pieces[0]
        size = first.element_size()
        total = sum(p.shape[-1] for p in pieces)
        out = torch.empty(first.shape[:-1] + (total,), dtype=first.dtype,
                          device=dev)
        rows = first.shape[0] if first.dim() == 2 else 1
        for row in range(rows):
            off = 0
            for p in pieces:
                n = p.shape[-1]
                src.append(p.data_ptr() + row * n * size)
                dst.append(out.data_ptr() + (row * total + off) * size)
                nbytes.append(n * size)
                off += n
        outs.append(out)
    k = len(src)
    src_t = (ctypes.c_uint64 * max(k, 1))(*src)
    dst_t = (ctypes.c_uint64 * max(k, 1))(*dst)
    nb_t = (ctypes.c_int64 * max(k, 1))(*nbytes)
    lib = ck.library("rank_gather")
    rc = lib.tt_rank_gather(k, ctypes.addressof(src_t),
                            ctypes.addressof(dst_t), ctypes.addressof(nb_t),
                            ck.stream_ptr(dev))
    ck.count("rank_gather")
    ck.check(rc, "rank_gather")
    return outs

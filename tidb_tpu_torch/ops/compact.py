"""Live-row compaction of a [B, cap] mask into member-major row ids (K22
member_compact).

The JAX package's micro-batcher fetches the batched program's whole
`live [B, cap]` mask and every output column with it, then takes
`np.nonzero(live[k])[0]` per member on the host
(`tidb_tpu/executor/microbatch.py` `_demux`). Here the ids are made on
the device, K18 gathers the columns through them, and only live rows
cross to the host. The individual filter path is the same call at B = 1.

`member_compact` takes its plain version for CPU tensors and launches
csrc/member_compact.cu for CUDA tensors (or raises on anything the kernel
does not take): a count pass that also scans the tiles (decoupled
look-back over a per-stream scratch, `scratch_bytes`) and copies the
total back, and a scatter pass that skips 16 KB rounds with no live
row.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Dict, Tuple

import torch

from tidb_tpu_torch.ops import cuda_kernels as ck

#: rows (mask bytes) per tile of csrc/member_compact.cu: ROUNDS rounds of
#: 256 threads x 4 loads of 16 bytes (the scatter's block is one round)
ROUNDS = 8
TILE = 131_072


def scratch_bytes(b: int, cap: int) -> int:
    """Bytes of scratch K22 takes for B members of cap rows
    (csrc/member_compact.cu's layout): a 16-byte tile counter and a
    4-byte flag a tile, rounded up to 16 bytes (zeroed each call), then
    three int64 payload slots a tile and two int64 for each of its
    ROUNDS 16 KB rounds. Sized for the most tiles a member can span at any
    byte alignment of the mask, ceil((cap + 15) / TILE)."""
    tiles = max(1, b * -(-(cap + 15) // TILE))
    return 16 + -(-4 * tiles // 16) * 16 + 8 * (3 + 2 * ROUNDS) * tiles


class _StreamScratch:
    """The K22 scratch of one stream, grown to fit, and the lock a call
    holds from its count pass to its scatter (which reads the count
    pass's tile state after the total's read-back)."""
    __slots__ = ("buf", "lock")

    def __init__(self):
        self.buf = None
        self.lock = threading.Lock()


#: (device index, stream) → that stream's _StreamScratch
_SCRATCH: Dict[Tuple[int, int], _StreamScratch] = {}
_SCRATCH_LOCK = threading.Lock()


def _stream_scratch(device, stream: int) -> _StreamScratch:
    key = (device.index, stream)
    ent = _SCRATCH.get(key)
    if ent is None:
        with _SCRATCH_LOCK:
            ent = _SCRATCH.setdefault(key, _StreamScratch())
    return ent


def member_compact_plain(live: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain torch version: per-member cumsum ranks scattered to their
    slots. → (counts [B] int64, offsets [B+1] int64, ids [total] int32),
    ids member-major and ascending within a member."""
    b, cap = live.shape
    dev = live.device
    li = live.to(torch.int64)
    counts = li.sum(dim=1)
    offsets = torch.zeros(b + 1, dtype=torch.int64, device=dev)
    offsets[1:] = torch.cumsum(counts, 0)
    total = int(offsets[-1])
    # dead rows go to one spare slot past the end, cut off below
    dst = torch.where(live, offsets[:-1, None] + torch.cumsum(li, 1) - li,
                      torch.full((), total, dtype=torch.int64, device=dev))
    rows = torch.arange(cap, dtype=torch.int32, device=dev).expand(b, cap)
    ids = torch.empty(total + 1, dtype=torch.int32, device=dev)
    ids.scatter_(0, dst.reshape(-1), rows.reshape(-1))
    return counts, offsets, ids[:total]


def member_compact(live: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K22 wrapper: `live` is a contiguous [B, cap] bool mask (B ≥ 1) at
    any byte alignment. The count pass's entry copies the total back
    (one sync) to size `ids`; allocates offsets, counts and ids."""
    if live.device.type == "cpu":
        return member_compact_plain(live)
    ck.require_cuda(live, what="member_compact")
    if live.dtype != torch.bool or live.dim() != 2:
        raise ck.KernelError("member_compact: a [B, cap] bool mask expected")
    b, cap = live.shape
    if not 1 <= b <= 65535 or cap >= 1 << 31:
        raise ck.KernelError("member_compact: 1 to 65,535 members of fewer "
                             "than 2^31 rows expected")
    dev = live.device
    offsets = torch.empty(b + 1, dtype=torch.int64, device=dev)
    counts = torch.empty(b, dtype=torch.int64, device=dev)
    lib = ck.library("member_compact")
    stream = ck.stream_ptr(dev)
    need = scratch_bytes(b, cap)
    total = ctypes.c_longlong()
    ent = _stream_scratch(dev, stream)
    with ent.lock:
        if ent.buf is None or ent.buf.numel() < need:
            ent.buf = torch.empty(need, dtype=torch.uint8, device=dev)
        scratch = ent.buf.data_ptr()
        rc = lib.tt_member_count(live.data_ptr(), b, cap, scratch,
                                 offsets.data_ptr(), counts.data_ptr(),
                                 ctypes.addressof(total), stream)
        if cap:                     # the entry launches nothing for cap 0
            ck.count("member_compact")
        ck.check(rc, "member_compact")
        ids = torch.empty(total.value, dtype=torch.int32, device=dev)
        if total.value:
            rc = lib.tt_member_scatter(live.data_ptr(), b, cap, scratch,
                                       ids.data_ptr(), stream)
            ck.check(rc, "member_compact")
    return counts, offsets, ids

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
does not take).
"""

from __future__ import annotations

from typing import Tuple

import torch

#: rows per tile of csrc/member_compact.cu
TILE = 1024


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
    """K22 wrapper: `live` is a contiguous [B, cap] bool mask (B ≥ 1).
    Reads the total back once (one sync) to size `ids`."""
    if live.device.type == "cpu":
        return member_compact_plain(live)
    from tidb_tpu_torch.ops import cuda_kernels as ck
    ck.require_cuda(live, what="member_compact")
    if live.dtype != torch.bool or live.dim() != 2:
        raise ck.KernelError("member_compact: a [B, cap] bool mask expected")
    b, cap = live.shape
    if not 1 <= b <= 65535 or cap >= 1 << 31:
        raise ck.KernelError("member_compact: 1 to 65,535 members of fewer "
                             "than 2^31 rows expected")
    dev = live.device
    ntiles = -(-cap // TILE)
    tiles = torch.empty(max(b * ntiles, 1), dtype=torch.int64, device=dev)
    offsets = torch.empty(b + 1, dtype=torch.int64, device=dev)
    counts = torch.empty(b, dtype=torch.int64, device=dev)
    lib = ck.library("member_compact")
    stream = ck.stream_ptr(dev)
    rc = lib.tt_member_count(live.data_ptr(), b, cap, tiles.data_ptr(),
                             offsets.data_ptr(), counts.data_ptr(), stream)
    ck.count("member_compact")
    ck.check(rc, "member_compact")
    total = int(offsets[b])
    ids = torch.empty(total, dtype=torch.int32, device=dev)
    if total:
        rc = lib.tt_member_scatter(live.data_ptr(), b, cap,
                                   tiles.data_ptr(), ids.data_ptr(), stream)
        ck.check(rc, "member_compact")
    return counts, offsets, ids

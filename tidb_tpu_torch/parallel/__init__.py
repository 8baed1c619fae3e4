"""Distributed fragments on the port: N ranks, each a device.

The JAX package builds a 1-D device mesh (`jax.sharding.Mesh`) whose
shards run one `shard_map` program. The port's "mesh" is the list of the
ranks' devices. Several ranks may share one device: on a machine with
one GPU every rank is `cuda:0`, and on the CPU every rank is `cpu`. The
staged paths run every rank as an ordinary single-device program and
route between stages on the host (collective.route_buckets); the
monolithic program (executor/dist_fragment.DistTreeProgram) runs every
rank in one process on one device, and its collectives are device-side
copies between the ranks' buffers (parallel/collective.py).

  reference mechanism                      port
  ------------------------------------     ---------------------------------
  region-parallel coprocessor scans        one slice per rank (shard_rows)
  MPP hash-repartition exchange            staged: per-rank bucket scatter
    (ExchangeType_Hash, mpp_exec.go)         (K23) + host routing;
                                             monolithic: K24 rank_exchange
  broadcast join small side                staged: rows concatenated on
    (ExchangeType_Broadcast)                 the host; monolithic: K25
  two-phase partial/final aggregation      staged: partials merged on the
    (AggFunc.MergePartialResult)             host; monolithic: K25 gather,
                                             K26 owner hash, owned merge
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch


def make_mesh(n_devices: int, device) -> List[torch.device]:
    """The devices of `n_devices` ranks on the engine's device type: all
    `cpu` on the CPU; `cuda:(r % device_count)` on CUDA, so ranks share
    the cards round-robin (every rank is `cuda:0` on one card)."""
    device = torch.device(device)
    if device.type != "cuda":
        return [device] * n_devices
    n_cards = torch.cuda.device_count()
    return [torch.device("cuda", r % n_cards) for r in range(n_devices)]


def shard_rows(mesh: Sequence[torch.device], arrays: Sequence):
    """Host arrays split by rows over the ranks (the region → shard map):
    rank r holds rows [r·cap, (r+1)·cap) with cap = ceil(total / ranks),
    zero-padded past the end (a padded live mask is False there).
    → per array, the ranks' device tensors."""
    nd = len(mesh)
    out = []
    for a in arrays:
        a = np.asarray(a)
        cap = -(-a.shape[0] // nd) if nd else 0
        pad = np.zeros((nd * cap,) + a.shape[1:], dtype=a.dtype)
        pad[:a.shape[0]] = a
        out.append([torch.from_numpy(pad[r * cap:(r + 1) * cap].copy())
                    .to(mesh[r]) for r in range(nd)])
    return out


def replicated(mesh: Sequence[torch.device], arrays: Sequence):
    """Host arrays placed whole on every rank: → per array, the ranks'
    tensors (one per distinct device, shared by its ranks)."""
    out = []
    for a in arrays:
        t = torch.from_numpy(np.ascontiguousarray(a))
        on = {}
        out.append([on.setdefault(d, t.to(d) if d.type != "cpu"
                                  else t.clone()) for d in mesh])
    return out

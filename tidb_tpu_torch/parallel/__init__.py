"""Distributed fragments on the port: N ranks, each a device.

The JAX package builds a 1-D device mesh (`jax.sharding.Mesh`) whose
shards run one `shard_map` program. The port's staged paths run every
rank as an ordinary single-device program (executor/dist_fragment.py)
and route between stages on the host (collective.route_buckets), so a
"mesh" here is the list of the ranks' devices. Several ranks may share
one device: on a machine with one GPU every rank is `cuda:0`, and on the
CPU every rank is `cpu`.

  reference mechanism                      port
  ------------------------------------     ---------------------------------
  region-parallel coprocessor scans        one host slice per rank
  MPP hash-repartition exchange            per-rank bucket scatter (K23
    (ExchangeType_Hash, mpp_exec.go)         hash_partition) + host routing
  broadcast join small side                every rank's filtered build rows
    (ExchangeType_Broadcast)                 concatenated on the host
  two-phase partial/final aggregation      per-rank partials merged on the
    (AggFunc.MergePartialResult)             host
"""

from __future__ import annotations

from typing import List

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

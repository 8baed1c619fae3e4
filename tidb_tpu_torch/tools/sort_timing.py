"""Time the sort formulation's kernels of one checkout on the card, for
comparing two checkouts in one machine's run.

    python tidb_tpu_torch/tools/sort_timing.py --tree DIR [--out FILE]

imports `tidb_tpu_torch` from DIR (a checkout of the repo, which builds
its own kernels into DIR/build/) and prints one JSON line of median
milliseconds (CUDA events) at chip_smoke's shapes:

  * K8 radix_sort over 8,388,608 full-range int64 words, and over
    10,485,760 words of the sparse join's layout (a dead flag, a NULL flag
    and a 62-bit key: 64 bits, 8 passes), each beside
    torch.sort(stable=True);
  * K10 over 8,388,608 rows in ~10^5 groups (cap 131,072): the gather
    entry (`group_ids` without the sorted word), the word entry where the
    checkout has one, and `factorize` end to end (K9 + K8 + K10), beside
    unique_consecutive(return_inverse=True) over the sorted keys; and the
    gather entry at the main path's shape (`k10_two_words_ms`): 8,388,608
    full-range int64 tokens (~10^5 distinct, 2% NULL, 2% dead), whose
    sort takes two words, called with K8's sorted last word.

Run two checkouts in turns (A, B, B, A), one process each, within one run
of the machine: cards and power limits differ between runs. `--profile`
adds each CUDA kernel's mean device time over those calls
(torch.profiler), under "kernels_k8_full", "kernels_k10" and
"kernels_k10_two_words"; `--ptxas` adds what `nvcc -Xptxas -v` reports
for the K8 and K10 kernels (registers, shared memory, spills), under
"ptxas".
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import tempfile


def _median_ms(fn, reps: int, warmup: int = 3) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def _sparse_word(rng, n: int):
    """Words laid out as combine_keys sorts the sparse join's key: the
    62-bit key (an odd multiple mod 2^62) under its NULL flag (all valid)
    and the dead flag (the unused tail of the build and probe buffers)."""
    import numpy as np
    k = rng.integers(0, n // 4, n).astype(np.uint64)
    key = (k * np.uint64(0x9E3779B97F4A7C15)) & np.uint64((1 << 62) - 1)
    dead = (rng.random(n) < 0.2).astype(np.uint64)
    w = key | (np.uint64(1) << np.uint64(62)) | (dead << np.uint64(63))
    return w.view(np.int64)


def _profile(calls) -> dict:
    """{kernel name: [launches, mean device µs]} over one run of each
    call, from torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for fn in calls:
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for fn in calls:
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(e, "self_cuda_time_total", 0)
        if dev_us and e.device_type.name == "CUDA":
            out[e.key[:80]] = [e.count, dev_us / max(e.count, 1)]
    return out


def _ptxas(tree: str) -> dict:
    """{kernel: {registers, smem, spill_stores}} of the sort kernels, from
    `nvcc -Xptxas -v` with the build's flags."""
    from tidb_tpu_torch.ops import cuda_kernels as ck
    out = {}
    wanted = ("pass_histograms", "onesweep_pass", "gid_words", "gid_gather",
              "words_prep", "gid_apply", "gid_totals")
    with tempfile.TemporaryDirectory() as tmp:
        for src in ("radix_sort", "sorted_groups"):
            res = subprocess.run(
                [ck.nvcc(), *ck.NVCC_FLAGS, "-Xptxas", "-v", "-o",
                 os.path.join(tmp, src + ".so"),
                 os.path.join(tree, "tidb_tpu_torch", "csrc", src + ".cu")],
                capture_output=True, text=True, check=True)
            name = None
            for line in (res.stdout + res.stderr).splitlines():
                m = re.search(r"Compiling entry function '([^']+)'", line)
                if m:
                    name = next((k for k in wanted if k in m.group(1)), None)
                    continue
                if name is None:
                    continue
                m = re.search(r"(\d+) bytes spill stores", line)
                if m:
                    out.setdefault(name, {})["spill_stores"] = int(m.group(1))
                m = re.search(r"Used (\d+) registers.*?(\d+) bytes smem",
                              line)
                if m:
                    out.setdefault(name, {}).update(
                        registers=int(m.group(1)), smem=int(m.group(2)))
    return out


def run(reps: int, prof: bool = False) -> dict:
    import numpy as np
    import torch
    from tidb_tpu_torch.ops import factorize as F
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(29)
    out = {}

    def same(what, got, want):
        for a, b in zip(got, want):
            if not torch.equal(a, b):
                raise AssertionError(f"{what}: kernel != plain version")

    n = 8_388_608
    keys = torch.from_numpy(rng.integers(-2 ** 63, 2 ** 63 - 1, n,
                                         dtype=np.int64)).to(dev)
    same("K8 full-range", F.radix_sort(keys, None, 64),
         F.radix_sort_plain(keys, None, 64))
    if prof:
        out["kernels_k8_full"] = _profile([lambda: F.radix_sort(keys, None,
                                                                64)])
    out["k8_full_ms"] = _median_ms(lambda: F.radix_sort(keys, None, 64),
                                   reps)
    out["k8_full_torch_sort_ms"] = _median_ms(
        lambda: torch.sort(keys, stable=True), reps)
    del keys

    ns = 10_485_760
    word = torch.from_numpy(_sparse_word(rng, ns)).to(dev)
    same("K8 sparse word", F.radix_sort(word, None, 64),
         F.radix_sort_plain(word, None, 64))
    out["k8_sparse_ms"] = _median_ms(lambda: F.radix_sort(word, None, 64),
                                     reps)
    out["k8_sparse_torch_sort_ms"] = _median_ms(
        lambda: torch.sort(word, stable=True), reps)
    del word

    gk = torch.from_numpy(rng.integers(0, 100_000, n)).to(dev)
    glive = torch.from_numpy(rng.random(n) > 0.02).to(dev)
    cap = 131_072
    ops = F._key_operands([(gk, None)], glive)
    res = F._lexsort_kernel(ops)
    sidx, words = res if isinstance(res, tuple) else (res, None)
    want = F.group_ids_plain(sidx, gk, None, glive, cap)
    same("K10 gather", F.group_ids(sidx, gk, None, glive, cap), want)
    out["k10_gather_ms"] = _median_ms(
        lambda: F.group_ids(sidx, gk, None, glive, cap), reps)
    if words is not None:
        same("K10 words", F.group_ids(sidx, gk, None, glive, cap, words),
             want)
        out["k10_words_ms"] = _median_ms(
            lambda: F.group_ids(sidx, gk, None, glive, cap, words), reps)
    if prof:
        calls = [lambda: F.group_ids(sidx, gk, None, glive, cap)]
        if words is not None:
            calls.append(lambda: F.group_ids(sidx, gk, None, glive, cap,
                                             words))
        out["kernels_k10"] = _profile(calls)
    # the main path's shape: a full-range BIGINT token (~10^5 distinct)
    # with 2% NULLs and 2% dead rows, whose sort takes two radix words
    # (the value, then the NULL and dead flags), through the gather entry
    # with K8's sorted last word (a checkout without that entry ignores
    # the word)
    tokens = rng.integers(-2 ** 63, 2 ** 63 - 1, 100_000, dtype=np.int64)
    tv = torch.from_numpy(tokens[rng.integers(0, 100_000, n)]).to(dev)
    tm = torch.from_numpy(rng.random(n) > 0.02).to(dev)
    tl = torch.from_numpy(rng.random(n) > 0.02).to(dev)
    sidx2, words2 = F._lexsort_kernel(F._key_operands([(tv, tm)], tl))
    if words2.count != 2:
        raise AssertionError(f"the token sort took {words2.count} words")
    want2 = F.group_ids_plain(sidx2, tv, tm, tl, cap)
    same("K10 two words", F.group_ids(sidx2, tv, tm, tl, cap, words2),
         want2)
    out["k10_two_words_groups"] = int(want2[1])
    out["k10_two_words_ms"] = _median_ms(
        lambda: F.group_ids(sidx2, tv, tm, tl, cap, words2), reps)
    if prof:
        out["kernels_k10_two_words"] = _profile(
            [lambda: F.group_ids(sidx2, tv, tm, tl, cap, words2)])
    del sidx2, words2, tv, tm, tl
    out["factorize_ms"] = _median_ms(
        lambda: F.factorize([(gk, None)], glive, cap), reps)
    sorted_keys = gk[sidx.long()]
    out["k10_unique_consecutive_ms"] = _median_ms(
        lambda: torch.unique_consecutive(sorted_keys, return_inverse=True),
        reps)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", required=True,
                    help="root of the checkout whose kernels to time")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--out", help="append the JSON line to this file too")
    ap.add_argument("--profile", action="store_true",
                    help="add each kernel's device time (torch.profiler)")
    ap.add_argument("--ptxas", action="store_true",
                    help="add the K8/K10 kernels' registers, shared memory "
                         "and spills (nvcc -Xptxas -v)")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("sort_timing: no CUDA device", file=sys.stderr)
        return 2
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    line = {"tree": tree, "card": smi.splitlines()[0] if smi else None,
            **run(args.reps, args.profile)}
    if args.ptxas:
        line["ptxas"] = _ptxas(tree)
    text = json.dumps(line)
    print(text, flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())

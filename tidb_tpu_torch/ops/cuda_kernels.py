"""Build and bind the port's hand-written CUDA kernels (csrc/*.cu).

Each source compiles with nvcc into its own shared library with a plain C
interface, on first use, into `build/tidb_tpu_torch/` under the checkout
root; the sources are built in parallel (one nvcc process each, all
started together). The libraries load with ctypes: pointers and the
stream are passed as `c_void_p`, and every C entry returns
`cudaGetLastError()`, which `check` turns into an exception.

Every wrapper that launches a kernel calls `count(name)` exactly where it
launches, so a run can show which kernels its main path went through
(`launches()` / `reset_launches()`). Importing this module loads and
builds nothing; nothing is built until a CUDA tensor reaches a wrapper:
CPU tensors take the wrappers' plain torch versions and never touch
nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "tidb_tpu_torch")

SOURCES = ("segment_reduce", "unpack_decode", "perfect_groups", "lut_join",
           "join_expand", "radix_sort", "sorted_groups", "window_scan",
           "window_frame", "distinct_pairs", "rollup_tile", "gather_columns",
           "delta_merge", "civil_date", "dict_lut", "member_compact",
           "hash_partition", "rank_gather")
#: launch counters, one per kernel (lut_join.cu holds K4 and K5,
#: join_expand.cu K6 and K7, radix_sort.cu K8 and K9, sorted_groups.cu K10
#: (its word entry `group_ids_words` and its gather entry `group_ids`) and
#: K11, window_scan.cu K12 and K13, window_frame.cu K14 and K15;
#: distinct_pairs.cu is K16, rollup_tile.cu K17, gather_columns.cu K18,
#: delta_merge.cu K19, civil_date.cu K20, dict_lut.cu K21,
#: member_compact.cu K22, hash_partition.cu K23, K24 and K26,
#: rank_gather.cu K25)
COUNTERS = ("segment_reduce", "unpack_decode", "perfect_groups",
            "lut_build", "lut_probe", "lut_order", "join_expand",
            "radix_sort", "sort_encode", "group_ids", "group_ids_words",
            "sorted_search", "window_bounds", "window_scan", "frame_bounds",
            "frame_eval", "distinct_pairs", "rollup_tile", "gather_columns",
            "delta_merge", "civil_date", "dict_lut", "member_compact",
            "hash_partition", "rank_exchange", "rank_gather", "hash_dest")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_U = ctypes.c_ulonglong
_D = ctypes.c_double
_SIGNATURES = {
    "tt_segment_plan": [_I, _I, _I, _L, _I, _P],
    "tt_segment_reduce": [_P, _P, _P, _P, _P, _P],
    "tt_segment_plan_bytes": [],
    "tt_segment_small_cap": [],
    "tt_segment_mid_cap": [],
    "tt_error_string": [_I],
    "tt_unpack_decode": [_P, _P, _L, _P],
    "tt_unpack_max_cols": [],
    "tt_unpack_args_bytes": [],
    "tt_perfect_group_ids": [_I, _P, _P, _P, _P, _P, _P, _P, _L, _I, _P,
                             _P],
    "tt_remap_group_ids": [_P, _P, _L, _I, _P, _P],
    "tt_lut_build": [_P, _P],
    "tt_lut_probe": [_P, _P],
    "tt_lut_order": [_P, _P, _L, _L, _I, _P, _P, _P, _P, _P, _P],
    "tt_join_expand": [_P, _P, _P, _P, _L, _L, _I, _L, _P, _P, _P, _P, _P,
                       _P, _P, _L, _P],
    "tt_join_expand_scratch_bytes": [_L, _L],
    "tt_radix_tile": [],
    "tt_sort_encode": [_P, _I, _L, _P, _P, _I, _U, _I, _P, _I, _P, _P],
    "tt_radix_scratch_words": [_L],
    "tt_radix_sort": [_P, _P, _L, _I, _P, _P, _P, _P, _P, _P],
    "tt_group_ids": [_P, _P, _I, _I, _P, _I, _P, _P, _L, _I, _P, _P, _P,
                     _P, _P],
    "tt_group_ids_words": [_P, _P, _L, _U, _I, _U, _U, _I, _I, _P, _P, _P,
                           _P, _P, _P],
    "tt_group_words_scratch": [_L],
    "tt_sorted_search": [_P, _L, _P, _L, _I, _I, _P, _P, _P],
    "tt_sorted_probe_unique": [_P, _P, _L, _P, _P, _L, _I, _P, _P, _P, _P,
                               _P],
    "tt_sorted_probe_multi": [_P, _L, _P, _P, _L, _I, _P, _P, _P, _P],
    "tt_sorted_dir_bytes": [_I],
    "tt_window_tile": [],
    "tt_window_scratch_bytes": [_L, _I],
    "tt_window_positions": [_P, _P, _L, _P, _P, _P, _P, _P, _P, _P],
    "tt_window_bounds_flags": [_P, _I, _P, _P, _P, _P, _P, _I, _I, _L, _I,
                               _P, _P, _P],
    "tt_window_prefix": [_P, _I, _P, _L, _P, _P, _P, _P],
    "tt_window_segscan": [_P, _I, _P, _P, _L, _I, _I, _L, _D, _P, _P, _P],
    "tt_frame_direct_width": [],
    "tt_frame_bounds": [_P, _P, _P, _P, _L, _P, _I, _P, _I, _I, _L, _D, _I,
                        _L, _D, _I, _I, _P, _P, _P],
    "tt_frame_rank": [_P, _P, _P, _P, _P, _L, _I, _L, _P, _P],
    "tt_frame_agg": [_P, _I, _P, _P, _P, _L, _I, _P, _P, _P],
    "tt_frame_gather": [_P, _I, _P, _P, _L, _P, _P, _L, _P, _L, _P, _L, _P,
                        _P, _P],
    "tt_frame_minmax": [_P, _I, _P, _I, _L, _D, _P, _P, _L, _L, _P, _P, _P],
    "tt_pair_word": [_P, _P, _P, _L, _L, _I, _P, _P],
    "tt_rollup_tile": [_I, _P, _P, _P, _P, _L, _I, _P],
    "tt_rollup_levels": [_I, _P, _P, _L, _P, _P],
    "tt_gather_columns": [_P, _P],
    "tt_gather_args_bytes": [_I],
    "tt_inverse_permutation": [_P, _I, _L, _L, _P, _P],
    "tt_delta_perm": [_P, _L, _P, _P, _P],
    "tt_delta_repack": [_P, _L, _I, _P, _L, _L, _P, _L, _P],
    "tt_civil_part": [_P, _P, _L, _I, _P],
    "tt_date_add_months": [_P, _P, _L, _P, _L, _I, _P],
    "tt_dict_lut": [_P, _P, _L, _L, _P, _L, _I, _P],
    "tt_dict_lut_smem_bytes": [],
    "tt_member_tile": [],
    "tt_member_scratch_bytes": [_I, _L],
    "tt_member_count": [_P, _I, _L, _P, _P, _P, _P, _P],
    "tt_member_scatter": [_P, _I, _L, _P, _P, _P],
    "tt_hash_partition": [_I, _P, _P, _P, _P, _L, _I, _L, _I, _P, _P, _P,
                          _P, _P, _P, _P, _P, _P, _P],
    "tt_rank_exchange": [_P, _P, _L, _I, _L, _L, _I, _P, _P, _P, _P, _P,
                         _P, _P, _P, _P],
    "tt_hash_dest": [_I, _P, _P, _P, _P, _L, _I, _P, _P, _P],
    "tt_rank_gather": [_I, _P, _P, _P, _P],
    "tt_rank_gather_chunk": [],
    "tt_rank_gather_max_segs": [],
}
#: entries that return other than an int error code
_RESTYPES = {"tt_error_string": ctypes.c_char_p,
             "tt_member_scratch_bytes": ctypes.c_longlong,
             "tt_join_expand_scratch_bytes": ctypes.c_longlong,
             "tt_sorted_dir_bytes": ctypes.c_longlong}

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}
_LAUNCHES: Dict[str, int] = {name: 0 for name in COUNTERS}
BUILD_SECONDS: Dict[str, float] = {}


class KernelError(RuntimeError):
    """A kernel failed to build, to load or to launch."""


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise KernelError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                          "build on the machine with the GPU")
    return found


def _lib_path(name: str) -> str:
    """The library's path, named by the digest of its source and of the
    shared headers (csrc/*.cuh) it may include."""
    h = hashlib.sha1()
    for src in [name + ".cu"] + sorted(f for f in os.listdir(CSRC)
                                       if f.endswith(".cuh")):
        with open(os.path.join(CSRC, src), "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{name}_{h.hexdigest()[:12]}.so")


def build_all() -> Dict[str, float]:
    """Compile every source whose library is missing, all in parallel.
    → {name: seconds} for the sources this call compiled."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    todo = {n: _lib_path(n) for n in SOURCES if not os.path.exists(_lib_path(n))}
    if not todo:
        return {}
    exe = nvcc()
    procs = {}
    t0 = time.perf_counter()
    for name, out in todo.items():
        cmd = [exe, *NVCC_FLAGS, "-o", out + ".tmp",
               os.path.join(CSRC, name + ".cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT)
    done: Dict[str, float] = {}
    errors = []
    for name, p in procs.items():
        out_b, _ = p.communicate()
        if p.returncode != 0:
            errors.append(f"{name}.cu:\n{out_b.decode(errors='replace')}")
            continue
        os.replace(todo[name] + ".tmp", todo[name])
        done[name] = time.perf_counter() - t0
    if errors:
        raise KernelError("nvcc failed:\n" + "\n".join(errors))
    BUILD_SECONDS.update(done)
    return done


def library(name: str) -> ctypes.CDLL:
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build_all()
            lib = ctypes.CDLL(_lib_path(name))
            for fn, args in _SIGNATURES.items():
                f = getattr(lib, fn, None)
                if f is None:
                    continue
                f.argtypes = args
                f.restype = _RESTYPES.get(fn, ctypes.c_int)
            _LIBS[name] = lib
    return lib


def check(rc: int, what: str) -> None:
    if rc != 0:
        msg = library("segment_reduce").tt_error_string(rc)
        raise KernelError(f"{what}: CUDA error {rc} "
                          f"({msg.decode() if msg else 'unknown'})")


def stream_ptr(device) -> int:
    """The raw handle of the device's current stream (torch's own
    accessor: a few µs cheaper a launch than current_stream())."""
    import torch
    index = device.index
    return torch._C._cuda_getCurrentRawStream(
        torch.cuda.current_device() if index is None else index)


class StreamScratch:
    """One kernel's scratch buffer on one stream, grown to fit, and the
    lock a call holds from taking the buffer to its last launch on it: a
    grow would otherwise free the buffer that a call on the same stream
    is about to launch on, and two threads on one stream could interleave
    one call's zeroing or count pass with another's launches."""
    __slots__ = ("buf", "lock")

    def __init__(self):
        self.buf = None
        self.lock = threading.Lock()

    def ensure(self, nbytes: int, device, zeroed: bool = False) -> int:
        """With the lock held: the buffer grown to at least `nbytes`
        (a new one zero-filled when `zeroed`) → its data pointer."""
        if self.buf is None or self.buf.numel() < nbytes:
            import torch
            make = torch.zeros if zeroed else torch.empty
            self.buf = make(nbytes, dtype=torch.uint8, device=device)
        return self.buf.data_ptr()


#: (kernel, device index, stream) → that stream's StreamScratch
_SCRATCH: Dict[tuple, StreamScratch] = {}
_SCRATCH_LOCK = threading.Lock()


def stream_scratch(kernel: str, device, stream: int) -> StreamScratch:
    """The scratch of `kernel` on `stream` (its raw handle on `device`)."""
    key = (kernel, device.index, stream)
    ent = _SCRATCH.get(key)
    if ent is None:
        with _SCRATCH_LOCK:
            ent = _SCRATCH.setdefault(key, StreamScratch())
    return ent


def count(name: str) -> None:
    with _LOCK:
        _LAUNCHES[name] += 1


def launches() -> Dict[str, int]:
    with _LOCK:
        return dict(_LAUNCHES)


def reset_launches() -> None:
    with _LOCK:
        for k in _LAUNCHES:
            _LAUNCHES[k] = 0


def require_cuda(*tensors, what: str) -> None:
    """Raise unless every tensor is a contiguous CUDA tensor."""
    for t in tensors:
        if not t.is_cuda:
            raise KernelError(f"{what}: expected a CUDA tensor, got "
                              f"{t.device}")
        if not t.is_contiguous():
            raise KernelError(f"{what}: expected a contiguous tensor")

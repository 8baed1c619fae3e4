"""Device-resident table cache — the device engine's columnar replica.

The reference never re-ships table data per query: TiFlash keeps a columnar
replica synced from the row store and MPP queries read it in place. The
device analog is this cache: the first device query against a table
dictionary-encodes its string columns, pads rows into power-of-two slabs,
compresses integer columns (chunk/compress.py) and uploads each used column
to the engine's device ONCE. Subsequent queries reuse the device tensors
directly, and the device copy is invalidated precisely when the table
changes.

Invalidation rides the storage engine's immutability discipline
(tidb_tpu_torch/storage): every committed write replaces the table's
`TableData` tuple, so identity (`is`) of the snapshot's TableData is an
exact freshness token. A write does not throw the cached table away: the
next device read first tries to EXTEND it into a new generation
(executor/delta.py — one delta slab for the appended rows, tombstoned
base slabs rewritten on the device by K19, every untouched base tensor
shared) and rebuilds only when the extension declines. Reads inside an
open transaction bypass the cache (staged rows are session-private, the
UnionScan view).

One device: every entry lives on the device of the statement's execution
context (`ctx.device`, carried from the Engine), and the cache key holds
it. Uploads go from pinned host memory with `non_blocking=True` on CUDA, so
the encode of slab k+1 overlaps the copy of slab k. The byte budget is
`tidb_tpu_hbm_budget` when set, else half the device memory that
`torch.cuda.mem_get_info` reports (8 GiB for a CPU device).

Ref: TiFlash replica selection (planner/core/find_best_task.go reads
TiFlash availability per table); coprocessor cache
(store/copr/coprocessor_cache.go) is the reference's other read-cache
precedent.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from contextlib import contextmanager
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from tidb_tpu_torch.util import timeline

MAX_CACHED_TABLES = 4
# device byte budget for a CPU device (and the fallback when no CUDA
# memory figure exists); CUDA devices default to half their memory
DEFAULT_HBM_BUDGET_BYTES = 8 << 30


def default_budget(device) -> int:
    dev = torch.device(device)
    if dev.type == "cuda":
        _free, total = torch.cuda.mem_get_info(dev)
        return int(total) // 2
    return DEFAULT_HBM_BUDGET_BYTES


def _budget(ctx) -> int:
    v = ctx.vars.get("tidb_tpu_hbm_budget")
    if v is not None:
        return int(v)
    return default_budget(ctx.device)


class CachedTable:
    """Per-table device payload: per-column slab lists + dictionaries.

    With compression on, a column's slabs may be PACKED tuples
    (words, mask_words[, dictvals | delta base]) per chunk/compress.py —
    `layouts` records the per-column descriptor (None = raw), and the
    dictvals tensor of a dict-layout column is the SAME object in every
    slab tuple, so byte accounting dedupes it by identity. hbm_bytes()
    therefore charges PHYSICAL (compressed) bytes."""

    __slots__ = ("td", "max_slab", "total", "slab_cap", "n_slabs",
                 "parts", "dicts", "dev", "bounds", "n_cols", "layouts",
                 "compressed", "zmaps", "holes", "device", "base_slabs",
                 "delta_version", "rows_override", "is_delta", "cov",
                 "max_rid", "tomb", "delta_rows", "dictvals_host")

    def __init__(self, td, max_slab: int, total: int, slab_cap: int,
                 n_slabs: int, parts, n_cols: int, compressed: bool = False,
                 device=None):
        self.td = td                    # TableData identity token (or None)
        self.n_cols = n_cols            # schema width at build (DDL guard)
        self.max_slab = max_slab
        self.total = total
        self.slab_cap = slab_cap
        self.n_slabs = n_slabs
        self.parts = parts              # [(aligned chunk, alive or None)]
        self.compressed = compressed    # tidb_tpu_compression at build
        self.device = device            # torch.device the tensors live on
        # -- delta-generation state (executor/delta.py) ------------------
        # base_slabs: slab count of the immutable committed base; equals
        # n_slabs until a delta extension appends the delta slab at index
        # base_slabs. delta_version: the store's monotonic commit version
        # this generation serves (the specialization keys pin it).
        # rows_override: per-slab LIVE row counts once tombstones or the
        # delta slab make the uniform slab_cap arithmetic wrong.
        # cov/max_rid: the base build's region coverage — what the next
        # extension diffs the current TableData against. tomb: per-slab
        # sorted arrays of ORIGINAL base-local row positions removed so
        # far (fresh tombstones map through them into current slab
        # coordinates). delta_rows: live rows in the delta slab.
        # dictvals_host: memoized host copies of dict-layout dictionaries.
        self.base_slabs = n_slabs
        self.delta_version = 0
        self.rows_override: Optional[Dict[int, int]] = None
        self.is_delta = False
        self.cov = None           # [(rid, n_rows, alive mask, base_off)]
        self.max_rid = -1         # max region id across the WHOLE td
        self.tomb: Dict[int, np.ndarray] = {}
        self.delta_rows = 0
        self.dictvals_host: Dict[int, np.ndarray] = {}
        self.dicts: Dict[int, Optional[np.ndarray]] = {}
        self.dev: Dict[int, List[Tuple]] = {}  # col → [(vals, valid)] slabs
        # col → ColLayout for packed columns; None/absent = raw layout
        self.layouts: Dict[int, Optional[object]] = {}
        # col → (lo, hi) over valid values; None for floats/empty — feeds
        # the perfect-hash group-by domain gate (fragment._agg_key_bounds)
        self.bounds: Dict[int, Optional[Tuple[int, int]]] = {}
        # col → zonemap.ColumnZoneMap (compressed tables only): the
        # per-slab min/max/null-count ledger the host-side slab pruner
        # consults before any upload or dispatch
        self.zmaps: Dict[int, object] = {}
        # col → frozenset of slab ids whose device slabs are HOLES
        # (pruned away on cold first touch — dev[col][s] is None there);
        # a later statement whose prune set does not cover a column's
        # holes re-streams that column in full
        self.holes: Dict[int, frozenset] = {}

    def resident(self, col: int, skip=frozenset()) -> bool:
        """Column `col` is usable for a statement skipping `skip`: its
        device slabs exist and any holes fall inside the skip set."""
        if col not in self.dev:
            return False
        return self.holes.get(col, frozenset()) <= skip

    def slab_rows(self, s: int) -> int:
        if self.rows_override is not None and s in self.rows_override:
            return self.rows_override[s]
        return min(self.slab_cap, self.total - s * self.slab_cap)

    def hbm_bytes(self) -> int:
        total = 0
        seen = set()
        for slabs in self.dev.values():
            for t in slabs:
                if t is None:
                    continue            # pruned-away cold slab (hole)
                for a in t:
                    if id(a) in seen:
                        continue        # shared dictvals counted once
                    seen.add(id(a))
                    total += a.nbytes
        return total

    def logical_bytes(self, cols=None) -> int:
        """Bytes the selected columns WOULD occupy uncompressed (raw
        columns: physical == logical)."""
        from tidb_tpu_torch.chunk import compress
        total = 0
        for i, slabs in self.dev.items():
            if cols is not None and i not in cols:
                continue
            lay = self.layouts.get(i)
            if lay is None:
                total += sum(a.nbytes for t in slabs if t is not None
                             for a in t)
            else:
                total += compress.raw_slab_bytes(lay, self.slab_cap) \
                    * sum(1 for t in slabs if t is not None)
        return total

    def delete(self) -> None:
        """Drop the entry's references to its device tensors NOW: torch
        frees a tensor when its last reference goes, so an evicted entry
        stops pinning device memory unless a running statement still
        holds its slabs — or another generation of the same table shares
        them (a delta generation shares every untouched base tensor with
        its predecessor, so dropping one generation frees only what no
        other holds)."""
        self.dev.clear()


def _entry_delete(ent) -> None:
    """Free an evicted entry's device tensors."""
    if timeline.ENABLED:
        from tidb_tpu_torch.util import phases as _ph
        cur = _ph.current()
        timeline.instant("evict", "cache",
                         pid=cur.conn_id if cur is not None else 0,
                         args={"bytes": int(ent.hbm_bytes())})
    ent.delete()


_CACHE: "OrderedDict[tuple, CachedTable]" = OrderedDict()
# FK-aligned join structures (see AlignedJoin below); keyed by join path
_ALIGNED: "OrderedDict[tuple, AlignedJoin]" = OrderedDict()

# ONE lock for all shared device-cache state (_CACHE, _ALIGNED, the
# protection registry, eviction). RLock because eviction helpers are reachable from
# paths that already hold it. Expensive work — host scans, encoding,
# uploads — happens OUTSIDE the lock; only dict lookups/insertions/
# evictions are serialized, so concurrent first touches of DIFFERENT
# tables still overlap.
_LOCK = threading.RLock()

# thread ident → frozenset of (store_id, table_id) pairs that thread's
# in-flight statement is actively computing on. Sibling sessions consult
# the union, so their evictions never drop tensors another statement is
# mid-compute on.
_PROTECT: Dict[int, frozenset] = {}


def _all_protected() -> frozenset:
    with _LOCK:
        if not _PROTECT:
            return frozenset()
        out = set()
        for pairs in _PROTECT.values():
            out |= pairs
        return frozenset(out)


@contextmanager
def protect_tables(pairs):
    """Mark (store_id, table_id) pairs in active use by THIS thread for
    the duration — every device executor wraps its compute in this, so a
    sibling thread's budget/LRU eviction skips the entries and a stale-
    entry pop defers the buffer free to refcounting (below)."""
    tid = threading.get_ident()
    pairs = frozenset(pairs)
    with _LOCK:
        prev = _PROTECT.get(tid)
        _PROTECT[tid] = pairs if prev is None else (prev | pairs)
    try:
        yield
    finally:
        with _LOCK:
            if prev is None:
                _PROTECT.pop(tid, None)
            else:
                _PROTECT[tid] = prev


def _safe_delete(ent, pair=None) -> None:
    """Free an evicted entry's device tensors — unless a concurrent
    statement may still be computing on them, in which case refcounting
    reclaims them when the last in-flight reference drops."""
    if pair is not None:
        if pair in _all_protected():
            return
    elif _PROTECT:
        # derived entries (aligned joins) aren't tracked pair-wise: with
        # ANY statement in flight, defer to refcount reclamation
        return
    _entry_delete(ent)


def clear():
    with _LOCK:
        cache = list(_CACHE.items())
        aligned = list(_ALIGNED.values())
        _CACHE.clear()
        _ALIGNED.clear()
    for k, e in cache:
        _safe_delete(e, k[1:3])
    for e in aligned:
        _safe_delete(e)


def invalidate(table_id: int):
    dead_c, dead_a = [], []
    with _LOCK:
        for key in [k for k in _CACHE if k[2] == table_id]:
            ent = _CACHE.pop(key, None)
            if ent is not None:
                dead_c.append((key, ent))
        for key in [k for k, e in _ALIGNED.items() if table_id in e.tds]:
            ent = _ALIGNED.pop(key, None)
            if ent is not None:
                dead_a.append(ent)
    for key, ent in dead_c:
        _safe_delete(ent, key[1:3])
    for ent in dead_a:
        _safe_delete(ent)


_STORE_FINALIZERS: Dict[int, object] = {}


_STORE_FINALIZERS: Dict[int, object] = {}


def _evict_store(store_id: int):
    with _LOCK:
        dead_c = [(k, _CACHE.pop(k)) for k in list(_CACHE)
                  if k[1] == store_id]
        dead_a = [_ALIGNED.pop(k) for k in list(_ALIGNED)
                  if k[0] == store_id]
        _STORE_FINALIZERS.pop(store_id, None)
    for key, ent in dead_c:
        _safe_delete(ent, key[1:3])
    for ent in dead_a:
        _safe_delete(ent)


def _pow2(n: int, lo: int = 1024) -> int:
    cap = lo
    while cap < n:
        cap <<= 1
    return cap


def _collect_parts(ctx, scan, coverage: bool = False):
    """Materialize the scan's region stream host-side (no column copies:
    alignment reuses region arrays; only partially-deleted regions filter).

    With `coverage`, also return the region-level ledger a later delta
    extension diffs against: per enumerated region its (id, row count,
    alive mask, live-row base offset) — regions are immutable (every
    write builds new Region objects), so holding the build-time alive
    masks is safe — plus the max region id across the WHOLE TableData
    (a region that later re-enters partition scope via the part-reset on
    delete must force a rebuild, and only an id ceiling can tell it
    apart from a genuinely appended region)."""
    from tidb_tpu_torch.executor.scan import align_chunk_to_schema
    parts = []
    cov = []
    total = 0
    pruned = getattr(scan, "partitions", None)
    for region, chunk, alive in ctx.scan_table(
            scan.table.id, None if pruned is None else set(pruned)):
        chunk = align_chunk_to_schema(chunk, scan.table)
        mask = None if alive.all() else alive
        n = chunk.num_rows if mask is None else int(mask.sum())
        if coverage and region is not None:
            cov.append((region.id, region.num_rows, np.asarray(alive),
                        total))
        if n:
            parts.append((chunk, mask))
            total += n
    if not coverage:
        return parts, total
    td = ctx.snapshot.table_data(scan.table.id) \
        if getattr(ctx, "txn", None) is None else None
    max_rid = max((r.id for r in td.regions), default=-1) \
        if td is not None else -1
    return parts, total, cov, max_rid


def _materialize_col(ent: CachedTable, col_idx: int):
    vals_list, valid_list = [], []
    for chunk, mask in ent.parts:
        col = chunk.columns[col_idx]
        v = col.values
        m = col.valid_mask()
        if mask is not None:
            v = v[mask]
            m = m[mask]
        vals_list.append(v)
        valid_list.append(m)
    if len(vals_list) == 1:
        return vals_list[0], valid_list[0]
    return np.concatenate(vals_list), np.concatenate(valid_list)


def _encode_col(ftype, vals: np.ndarray, valid: np.ndarray):
    """→ (device-ready values, dictionary or None). Strings become sorted-
    dictionary rank codes (order-preserving, so comparisons work on codes);
    DOUBLE stays float64 (the device float dtype)."""
    from tidb_tpu_torch.chunk import Column
    from tidb_tpu_torch.chunk.device import encode_strings
    if ftype.is_varlen:
        return encode_strings(Column(ftype, vals, None))
    return vals, None


def _col_bounds(vals: np.ndarray, valid: np.ndarray,
                dictionary) -> Optional[Tuple[int, int]]:
    if dictionary is not None:
        return (0, len(dictionary) - 1) if len(dictionary) else None
    if vals.dtype.kind not in "iu":
        return None
    vv = vals if valid.all() else vals[valid]
    if not len(vv):
        return None
    return int(vv.min()), int(vv.max())


WIDE_LIMB_BITS = 30
WIDE_LIMB_BASE = 1 << WIDE_LIMB_BITS


def wide_decimal_limbs(vals, n_limbs: int) -> np.ndarray:
    """Arbitrary-precision scaled ints (object array) → (n_limbs, N) int64
    base-2³⁰ limb planes via shift/mask, so only the TOP limb is signed —
    value == Σ limbs[k]·2^(30k) exactly. The device-side layout of
    MyDecimal's word vector (types/mydecimal.go:236-246) as
    struct-of-arrays; ONE base everywhere (storage planes, on-device
    splits of narrow inputs, host recombination) so every producer/
    consumer pair agrees by construction."""
    out = np.empty((n_limbs, len(vals)), dtype=np.int64)
    cur = np.asarray(vals, dtype=object)
    mask = WIDE_LIMB_BASE - 1
    for k in range(n_limbs - 1):
        out[k] = (cur & mask).astype(np.int64)
        cur = cur >> WIDE_LIMB_BITS           # python ints: floor shift
    out[n_limbs - 1] = cur.astype(np.int64)   # top: small, carries sign
    return out


def wide_decimal_unlimb(limbs: np.ndarray) -> np.ndarray:
    """(n_limbs, G) int64 limb sums → object array of exact Python ints.
    Works on UNNORMALIZED limb sums (planes may exceed the base)."""
    n_limbs, g = limbs.shape
    out = np.zeros(g, dtype=object)
    for k in range(n_limbs - 1, -1, -1):
        out = out * WIDE_LIMB_BASE + limbs[k].astype(object)
    return out


def _col_prep(ent: CachedTable, col_idx: int, ftype) -> dict:
    """Once-per-column host prep for the streamed first-touch: materialize
    the column and build the GLOBAL dictionary/bounds. Per-slab encoding
    then reduces to a searchsorted against the sorted keys (strings), an
    astype (DOUBLE) or a limb split (wide decimals) of the slab's slice —
    byte-identical to encoding the whole column at once, because the
    dictionary is global and searchsorted on the sorted unique keys IS
    np.unique's return_inverse."""
    from tidb_tpu_torch.chunk import compress
    vals, valid = _materialize_col(ent, col_idx)
    if ftype.is_wide_decimal:
        return {"kind": "wide", "vals": vals, "valid": valid,
                "n_limbs": ftype.wide_limb_count,
                "dict": None, "bounds": None, "layout": None}
    if ftype.is_varlen:
        str_vals = np.array([str(v) for v in vals], dtype=object)
        if ftype.is_ci:
            from tidb_tpu_torch.types import fold_ci_array
            folded = fold_ci_array(str_vals)
            keys, first = np.unique(folded, return_index=True)
            dictionary = str_vals[first]    # representative per fold class
            prep = {"kind": "str", "vals": folded, "valid": valid,
                    "keys": keys}
        else:
            dictionary = np.unique(str_vals)
            prep = {"kind": "str", "vals": str_vals, "valid": valid,
                    "keys": dictionary}
        prep["dict"] = dictionary
        prep["bounds"] = (0, len(dictionary) - 1) if len(dictionary) else None
        prep["layout"] = None
        if ent.compressed:
            # string columns already carry global dictionary codes
            # (int32, 0..card-1) — bit-pack the CODES at the observed
            # width (FoR with ref 0; a second dict layer would be noise)
            card = len(dictionary)
            pw = compress._round_width(max(card - 1, 0).bit_length())
            if pw is not None and pw <= 16:
                prep["layout"] = compress.ColLayout("pack", pw, 0, "int32")
        return prep
    if vals.dtype == np.dtype(np.float64):
        return {"kind": "float", "vals": vals, "valid": valid,
                "dtype": np.dtype(np.float64),
                "dict": None, "bounds": None, "layout": None}
    prep = {"kind": "num", "vals": vals, "valid": valid,
            "dict": None, "bounds": _col_bounds(vals, valid, None),
            "layout": None}
    if ent.compressed:
        layout, dictvals = compress.choose_layout(vals, valid,
                                                  hints=workload_hints())
        prep["layout"] = layout
        prep["dictvals"] = dictvals
    return prep


def workload_hints() -> Optional[dict]:
    """Distill the Registry's per-digest statement profiles into layout
    hints for compress.choose_layout — the workload-adaptive half of
    the encoder. The one robust signal the profiles carry about the
    read side is result cardinality: a device workload that returns few
    rows per execution is dominated by aggregation/selective scans, so
    dictionary layouts earn their keep (dict codes feed group
    factorization directly) and the cardinality cap loosens."""
    try:
        from tidb_tpu_torch.util.observability import REGISTRY
        profs = REGISTRY.summary_profiles()
    except Exception:  # noqa: BLE001 — hints are advisory, never fatal
        return None
    dev = [p for p in profs
           if p.get("engine") == "device" and p.get("count")]
    if not dev:
        return None
    calls = sum(p["count"] for p in dev)
    rows = sum(p["rows"] for p in dev)
    return {"group_heavy": rows <= 1024 * calls}


def _col_zone_stats(ent: CachedTable, prep: dict):
    """Per-slab zone map for one prepped column, in the space the
    pruner compares in (see executor/zonemap.py). Wide decimals carry
    none — their limb planes have no totally-ordered slab stats."""
    from tidb_tpu_torch.executor import zonemap
    k = prep["kind"]
    if k == "wide":
        return None
    if k == "str":
        codes = np.searchsorted(prep["keys"],
                                prep["vals"]).astype(np.int32)
        return zonemap.column_stats(codes, prep["valid"], ent.slab_cap,
                                    ent.total, "code")
    kind = "float" if k == "float" else "num"
    return zonemap.column_stats(prep["vals"], prep["valid"],
                                ent.slab_cap, ent.total, kind)


def _est_slab_phys(prep: dict, slab_cap: int) -> int:
    """Physical bytes ONE slab of a prepped column would upload —
    computable without encoding it (the h2d_skipped ledger for slabs
    that never encode)."""
    from tidb_tpu_torch.chunk import compress
    lay = prep.get("layout")
    if lay is not None:
        return compress.packed_slab_bytes(lay, slab_cap)
    k = prep["kind"]
    if k == "wide":
        return prep["n_limbs"] * slab_cap * 8 + slab_cap
    if k == "float":
        return slab_cap * np.dtype(prep["dtype"]).itemsize + slab_cap
    if k == "str":
        return slab_cap * 4 + slab_cap
    return slab_cap * prep["vals"].dtype.itemsize + slab_cap


def _slab_logical_est(ent: CachedTable, i: int, preps=None) -> int:
    """Logical (raw-equivalent) bytes ONE slab of column `i` answers
    for — resolvable even when the device tuple is a pruned hole."""
    from tidb_tpu_torch.chunk import compress
    lay = ent.layouts.get(i)
    if lay is not None:
        return compress.raw_slab_bytes(lay, ent.slab_cap)
    if preps and i in preps:
        # raw layout: physical == logical
        return _est_slab_phys(preps[i], ent.slab_cap)
    t = next((t for t in ent.dev.get(i, ()) if t is not None), None)
    return _tuple_nbytes(t) if t is not None else 0


def _slab_host(prep: dict, start: int, stop: int, slab_cap: int):
    """Encode + pad ONE slab of a prepped column → (host vals, host mask)."""
    n = stop - start
    valid = prep["valid"][start:stop]
    kind = prep["kind"]
    if kind == "wide":
        v = wide_decimal_limbs(prep["vals"][start:stop], prep["n_limbs"])
        if n < slab_cap:
            pv = np.zeros((v.shape[0], slab_cap), dtype=np.int64)
            pv[:, :n] = v
            v = pv
    else:
        if kind == "str":
            v = np.searchsorted(prep["keys"],
                                prep["vals"][start:stop]).astype(np.int32)
        elif kind == "float":
            v = prep["vals"][start:stop].astype(prep["dtype"])
        else:
            v = prep["vals"][start:stop]
        if n < slab_cap:
            pv = np.zeros(slab_cap, dtype=v.dtype)
            pv[:n] = v
            v = pv
    m = valid
    if n < slab_cap:
        pm = np.zeros(slab_cap, dtype=bool)
        pm[:n] = m
        m = pm
    layout = prep.get("layout")
    if layout is not None:
        from tidb_tpu_torch.chunk import compress
        return compress.pack_slab(layout, v, m, prep.get("dictvals"))
    return v, m


def _tuple_nbytes(t) -> int:
    """Physical bytes of one slab tuple (raw or packed)."""
    return sum(a.nbytes for a in t)


def _logical_tuple_bytes(ent: CachedTable, i: int, t) -> int:
    """Logical (uncompressed-equivalent) bytes of one slab tuple."""
    lay = ent.layouts.get(i)
    if lay is None:
        return _tuple_nbytes(t)
    from tidb_tpu_torch.chunk import compress
    return compress.raw_slab_bytes(lay, ent.slab_cap)


def _note_storage_metrics(ent: CachedTable, key) -> None:
    if key is None:
        return
    from tidb_tpu_torch.util.observability import REGISTRY
    REGISTRY.observe("tidb_tpu_table_physical_bytes",
                     float(ent.hbm_bytes()), {"table": str(key[2])})
    REGISTRY.observe("tidb_tpu_table_logical_bytes",
                     float(ent.logical_bytes()), {"table": str(key[2])})


def _upload(a: np.ndarray, device) -> torch.Tensor:
    """One host array → a tensor on `device`. Packed uint32 words travel
    as their int32 view (the same bits; torch has no CUDA uint32 shifts).
    CUDA uploads go from pinned memory with non_blocking=True, so the
    host returns to encoding the next slab while the copy runs."""
    a = np.asarray(a)
    if a.dtype == np.dtype(np.uint32):
        from tidb_tpu_torch.chunk.compress import words_for_device
        a = words_for_device(a)
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.clone()        # own the bytes: never alias table storage


def _stream_slabs(ctx, ent: CachedTable, key, used_cols, preps, phases,
                  skip=frozenset()):
    """Generator behind open_table: per slab, encode the missing columns
    (host), issue their uploads (async on CUDA), and yield
    (slab_idx, {col: slab tuple}) covering EVERY used column so the
    caller can dispatch that slab's compute before the next encode —
    encode(k+1) ∥ upload(k) ∥ compute(k-1). Compressed columns encode to
    packed (words, mask_words[, dictvals | base]) tuples — only the
    PHYSICAL bytes cross PCIe; the PhaseTimer is charged both counts.
    Completed columns commit to the cache entry only after the LAST slab:
    a stream abandoned by an error never leaves a half-uploaded column
    behind.

    Slabs in `skip` were zone-map-pruned for the opening statement: they
    are never encoded, never uploaded, and never yielded — the committed
    column carries None holes there (ent.holes records them, so later
    statements with weaker predicates re-stream the column in full)."""
    from tidb_tpu_torch.errors import DeviceLost
    from tidb_tpu_torch.executor import zonemap
    from tidb_tpu_torch.util import failpoint
    new_slabs = {i: [] for i in preps}
    device = ent.device

    def _put(a):
        # a transfer failure at this boundary is a DEVICE fault, not a
        # statement fault: classify it typed
        try:
            failpoint.inject("device-lost-upload")
        except DeviceLost:
            raise
        except Exception as e:  # noqa: BLE001 — armed fault, classify
            raise DeviceLost(f"device upload failed: {e}", device=0) from e
        return _upload(a, device)

    # dict-layout columns upload their dictionary values ONCE; the same
    # tensor rides every slab tuple (deduped by identity in hbm_bytes)
    dict_cols = frozenset(
        i for i, p in preps.items()
        if p.get("layout") is not None and p["layout"].kind == "dict")
    dict_dev = {}

    def _dict_for(i):
        t = dict_dev.get(i)
        if t is None:
            t = dict_dev[i] = _put(preps[i]["dictvals"])
            phases.add_h2d(int(t.nbytes), logical=0)
        return t

    for s in range(ent.n_slabs):
        if s in skip:
            # pruned cold slab: no encode, no PCIe, no dispatch — the
            # statement still answered for its rows, so the logical
            # scan ledger (effective-roofline numerator) is charged
            for i in new_slabs:
                new_slabs[i].append(None)
            zonemap.note_h2d_skipped(
                phases, sum(_est_slab_phys(p, ent.slab_cap)
                            for p in preps.values()),
                table=str(key[2]) if key is not None else "")
            phases.add_scan(0, logical=sum(_slab_logical_est(ent, i, preps)
                                           for i in used_cols))
            continue
        start = s * ent.slab_cap
        stop = min(start + ent.slab_cap, ent.total)
        host = {}
        with phases.phase("encode"):
            for i, prep in preps.items():
                host[i] = _slab_host(prep, start, stop, ent.slab_cap)
        with phases.phase("upload"):
            for i, ht in host.items():
                dev_t = tuple(_put(a) for a in ht)
                if i in dict_cols:
                    dev_t = dev_t + (_dict_for(i),)
                new_slabs[i].append(dev_t)
        phases.add_h2d(sum(_tuple_nbytes(ht) for ht in host.values()),
                       logical=sum(_logical_tuple_bytes(ent, i, ht)
                                   for i, ht in host.items()))
        phases.mark_in_flight()
        cols = {i: (new_slabs[i][s] if i in new_slabs else ent.dev[i][s])
                for i in used_cols}
        # device bytes this slab's compute will read — warm columns
        # included, so roofline scan_bytes covers the whole program
        phases.add_scan(sum(_tuple_nbytes(t) for t in cols.values()),
                        logical=sum(_logical_tuple_bytes(ent, i, t)
                                    for i, t in cols.items()))
        yield s, cols
    with _LOCK:
        for i, slabs in new_slabs.items():
            # first-commit-wins: two threads cold-loading the same column
            # concurrently both stream byte-identical slabs; the loser's
            # tensors drop on the floor
            if i not in ent.dev:
                ent.dev[i] = slabs
                if skip:
                    ent.holes[i] = frozenset(skip)
                else:
                    ent.holes.pop(i, None)
    phases.clear_in_flight()
    _note_storage_metrics(ent, key)
    if key is not None:
        _evict_to_budget(_budget(ctx), keep=key,
                         keep_tables=_protected(ctx))


def _validate_layouts(ent: CachedTable, used_cols) -> None:
    """Validate the layout descriptor of every column the statement is
    about to decode — on the serving path, BEFORE any program is built,
    so a corrupted descriptor surfaces as a typed LayoutError (warned CPU
    fallback in the executor) and never as silently wrong rows. The
    failpoint models the corruption: any armed value stands in for a
    descriptor that no longer matches the packed data."""
    from tidb_tpu_torch.chunk import compress
    from tidb_tpu_torch.errors import LayoutError
    from tidb_tpu_torch.util import failpoint
    corrupted = failpoint.inject("compressed-decode-mismatch")
    if corrupted is not None:
        raise LayoutError(
            f"compressed column layout descriptor corrupted "
            f"(failpoint: {corrupted!r}) — refusing to decode")
    for i in used_cols:
        lay = ent.layouts.get(i)
        if lay is not None:
            compress.validate(lay)


def storage_stats(store_id: Optional[int] = None) -> List[dict]:
    """Per-(table, column) physical/logical residency of every cached
    entry — the information_schema.table_storage source. Snapshot under
    the lock; byte math (which touches device array metadata only)
    happens outside it. `store_id` scopes the report to one store: a
    dead engine's entries linger until its store finalizer runs, and
    table ids restart per engine, so an unscoped dump can attribute a
    stale entry to an unrelated live table."""
    with _LOCK:
        entries = [(k, e) for k, e in _CACHE.items()
                   if store_id is None or k[1] == store_id]
    rows = []
    for key, ent in entries:
        for i in sorted(ent.dev):
            lay = ent.layouts.get(i)
            seen = set()
            phys = 0
            for t in ent.dev[i]:
                if t is None:
                    continue            # pruned-away cold slab (hole)
                for a in t:
                    if id(a) in seen:
                        continue
                    seen.add(id(a))
                    phys += a.nbytes
            zm = ent.zmaps.get(i)
            zlo = zhi = None
            if zm is not None:
                known_lo = [v for v in zm.lo if v is not None]
                known_hi = [v for v in zm.hi if v is not None]
                if known_lo:
                    zlo, zhi = min(known_lo), max(known_hi)
            rows.append({
                "table_id": key[2],
                "column": i,
                "layout": "raw" if lay is None else lay.sig(),
                "physical_bytes": int(phys),
                "logical_bytes": int(ent.logical_bytes(cols={i})),
                "zone_map_slabs": 0 if zm is None else zm.n_slabs,
                "zone_map_min": zlo,
                "zone_map_max": zhi,
                "zone_map_nulls": None if zm is None
                else int(sum(zm.nulls)),
            })
    return rows


def _protected(ctx) -> frozenset:
    """(store_id, table_id) pairs ANY in-flight statement still needs:
    the per-thread protect_tables registrations of every live thread,
    plus the legacy per-ExecContext attribute (kept for callers that set
    it directly) — so a mid-query budget eviction (which DELETES buffers)
    can't free a sibling statement's arrays."""
    own = getattr(ctx, "_device_cache_protect", frozenset())
    return frozenset(own) | _all_protected()


def open_table(ctx, scan, used_cols, max_slab: int, phases=None,
               prune: bool = False):
    """→ (CachedTable, slab stream or None) — the streamed first-touch.

    Warm path (every used column already resident) returns stream=None.
    Cold/partial first touch returns a generator yielding
    (slab_idx, {col: slab tuple}) per slab; driving per-slab compute
    between yields pipelines host encode behind device transfers. The
    column dictionaries, bounds and layouts ARE committed eagerly
    (program construction needs key bounds before the first slab runs);
    the device tensors commit only when the stream completes.

    Cacheable only for snapshot reads (ctx.txn is None); transaction reads
    build a transient entry so staged rows are visible without poisoning
    the shared cache.

    `prune=True` consults the zone maps: cold first touch streams ONLY the
    slabs the scan's conjuncts cannot prove empty (pruned slabs commit as
    None holes), and warm accounting charges physical scan bytes only for
    surviving slabs while still charging the full logical bytes the
    statement answered for.
    """
    from tidb_tpu_torch.util import failpoint
    from tidb_tpu_torch.util.phases import PhaseTimer
    device = ctx.device
    table_id = scan.table.id
    tabs = getattr(phases, "tables", None)
    if tabs is not None:
        tabs.add(table_id)
    comp_on = str(ctx.vars.get("tidb_tpu_compression", "on")).lower() \
        not in ("off", "0", "false")
    cacheable = getattr(ctx, "txn", None) is None
    td = ctx.snapshot.table_data(table_id) if cacheable else None
    # key by owning store too: distinct engines may reuse table ids; a
    # finalizer evicts a dead engine's entries so its memory isn't pinned
    store = getattr(ctx.snapshot, "store", None) if cacheable else None
    parts = getattr(scan, "partitions", None)
    key = (str(device), id(store), table_id,
           None if parts is None else tuple(parts)) if cacheable else None
    with _LOCK:
        if store is not None and id(store) not in _STORE_FINALIZERS:
            import weakref
            _STORE_FINALIZERS[id(store)] = weakref.finalize(
                store, _evict_store, id(store))

    def _usable(e):
        # td identity = data freshness; n_cols = DDL (ADD/DROP COLUMN)
        # guard; compressed must match the session's tidb_tpu_compression
        return (e.td is td and e.max_slab == max_slab
                and e.n_cols == len(scan.schema)
                and e.compressed == comp_on)

    stale = None
    extend_from = None
    with _LOCK:
        ent = _CACHE.get(key) if cacheable else None
        if ent is not None and not _usable(ent):
            if (ent.td is not None and td is not None
                    and ent.max_slab == max_slab
                    and ent.n_cols == len(scan.schema)
                    and ent.compressed == comp_on
                    and ent.cov is not None):
                # stale ONLY because the data moved on (geometry, schema
                # width and compression all still match): try the
                # incremental delta extension before paying a rebuild
                extend_from = ent
            else:
                # DDL, a compression toggle or another slab size: drop
                # the stale generation and rebuild
                _CACHE.pop(key, None)
                stale = ent
            ent = None
        elif ent is not None:
            _CACHE.move_to_end(key)
    if stale is not None:
        _safe_delete(stale, key[1:3])
    if extend_from is not None:
        from tidb_tpu_torch.executor import delta as _delta
        new_ent = _delta.extend_entry(ctx, scan, extend_from, max_slab,
                                      phases)
        with _LOCK:
            cur = _CACHE.get(key)
            if new_ent is not None and cur is extend_from:
                # atomic generation swap: in-flight readers keep the old
                # object (their snapshot), new statements see
                # base∪delta−tombstones. The old generation is NOT
                # deleted — it shares the base tensors with the new one;
                # refcounting frees its delta-only tensors.
                _CACHE[key] = new_ent
                _CACHE.move_to_end(key)
                ent = new_ent
            elif cur is not None and _usable(cur):
                ent = cur       # raced another extension/rebuild: adopt
            elif cur is extend_from:
                # the extension declined: drop the stale generation and
                # rebuild. Only the entry WE pop is deleted — one another
                # thread installed may share its base tensors.
                _CACHE.pop(key, None)
                stale = extend_from
        if stale is not None:
            _safe_delete(stale, key[1:3])
    if ent is None:
        if cacheable:
            parts, total, cov, max_rid = _collect_parts(ctx, scan,
                                                        coverage=True)
        else:
            parts, total = _collect_parts(ctx, scan)
            cov, max_rid = None, -1
        slab_cap = _pow2(min(total, max_slab)) if total else 1024
        n_slabs = (total + slab_cap - 1) // slab_cap
        built = CachedTable(td, max_slab, total, slab_cap, n_slabs, parts,
                            len(scan.schema), compressed=comp_on,
                            device=device)
        built.cov = cov
        built.max_rid = max_rid
        built.delta_version = int(getattr(ctx.snapshot, "version", 0) or 0) \
            if cacheable else 0
        if cacheable:
            victims = []
            with _LOCK:
                cur = _CACHE.get(key)
                if cur is not None and _usable(cur):
                    # lost a cold-build race: adopt the winner, drop ours
                    ent = cur
                    _CACHE.move_to_end(key)
                else:
                    if cur is not None:
                        victims.append(_CACHE.pop(key))
                    ent = _CACHE[key] = built
                    prot = _all_protected()
                    over = len(_CACHE) - MAX_CACHED_TABLES
                    for k in list(_CACHE):
                        if over <= 0:
                            break
                        # LRU trim skips the new entry and any table a
                        # live statement protects
                        if k != key and k[1:3] not in prot:
                            victims.append(_CACHE.pop(k))
                            over -= 1
            for v in victims:
                _entry_delete(v)
        else:
            ent = built

    if not ent.total:
        return ent, None
    ph = phases if phases is not None else PhaseTimer()
    if ent.is_delta and ent.delta_rows:
        ph.note_delta_rows(ent.delta_rows, token=id(ent))
    from tidb_tpu_torch.executor import zonemap
    skip = zonemap.prune_slabs(ent, scan) if prune else frozenset()
    missing = []
    for i in used_cols:
        if i in ent.dev and ent.holes.get(i, frozenset()) <= skip:
            continue
        missing.append(i)
    if missing and ent.is_delta and cacheable:
        # a delta generation cannot cold-stream a column it never held:
        # its parts ledger predates the delta rows and tombstones, so an
        # encode from it would silently miss them — rebuild fresh
        with _LOCK:
            if _CACHE.get(key) is ent:
                _CACHE.pop(key, None)
        _safe_delete(ent, key[1:3])
        return open_table(ctx, scan, used_cols, max_slab, phases=phases,
                          prune=prune)
    if missing:
        with _LOCK:
            for i in missing:
                # this statement's predicates reach slabs an earlier,
                # more selective statement pruned away on cold touch:
                # drop the holey generation and re-stream the column
                ent.dev.pop(i, None)
                ent.holes.pop(i, None)
    if not missing:
        # fully warm: the program READS every surviving resident slab —
        # charge those bytes to the statement so roofline accounting
        # holds on hot re-runs; pruned slabs charge logical bytes only
        _validate_layouts(ent, used_cols)
        phys = 0
        logi = 0
        for i in used_cols:
            slabs = ent.dev[i]
            for s in range(ent.n_slabs):
                logi += _slab_logical_est(ent, i)
                if s in skip:
                    continue
                t = slabs[s] if s < len(slabs) else None
                if t is not None:
                    phys += _tuple_nbytes(t)
        ph.add_scan(phys, logical=logi)
        return ent, None
    failpoint.inject("device-transfer")
    ftypes = scan.schema.field_types
    preps = {}
    with ph.phase("encode"):
        for i in missing:
            preps[i] = _col_prep(ent, i, ftypes[i])
            ent.dicts[i] = preps[i]["dict"]
            ent.bounds[i] = preps[i]["bounds"]
            # layout commits eagerly with dicts/bounds: program
            # construction needs it before the first slab streams; zone
            # maps ride along so the prune decision below already sees
            # the new columns' statistics
            ent.layouts[i] = preps[i]["layout"]
            if ent.compressed:
                zm = _col_zone_stats(ent, preps[i])
                if zm is not None:
                    ent.zmaps[i] = zm
    _validate_layouts(ent, used_cols)
    if prune:
        # re-consult with the freshly prepped columns' statistics — the
        # skip set only ever grows, so warm columns' holes stay covered
        skip = zonemap.prune_slabs(ent, scan)
    return ent, _stream_slabs(ctx, ent, key, list(used_cols), preps, ph,
                              skip=skip)


def get_table(ctx, scan, used_cols, max_slab: int,
              phases=None) -> CachedTable:
    """→ CachedTable with every column in `used_cols` uploaded (open_table
    drained — callers that can't interleave compute, e.g. the join-tree
    path, still get the per-slab encode∥upload pipelining)."""
    ent, stream = open_table(ctx, scan, used_cols, max_slab, phases=phases)
    if stream is not None:
        for _ in stream:
            pass
    return ent


def _evict_to_budget(budget: int, keep, keep_aligned=frozenset(),
                     keep_tables=frozenset()) -> None:
    """Drop LRU cached entries until the resident bytes fit the device
    byte budget, never the entries in active use (the caller's keeps PLUS
    every live thread's protect_tables registration). Aligned join
    structures evict first — derived data, rebuildable from the tables."""
    dead_c, dead_a = [], []
    with _LOCK:
        keep_tables = frozenset(keep_tables) | _all_protected()
        usage = sum(int(e.hbm_bytes()) for e in _CACHE.values()) + \
            sum(int(e.hbm_bytes()) for e in _ALIGNED.values())
        while usage > budget:
            victim = next((k for k in _ALIGNED if k not in keep_aligned),
                          None)
            if victim is None:
                break
            ent = _ALIGNED.pop(victim)
            usage -= int(ent.hbm_bytes())
            dead_a.append(ent)
        while len(_CACHE) > 1 and usage > budget:
            victim = next((k for k in _CACHE
                           if k != keep and k[1:3] not in keep_tables),
                          None)
            if victim is None:
                break
            ent = _CACHE.pop(victim)
            usage -= int(ent.hbm_bytes())
            dead_c.append(ent)
    for ent in dead_c:
        _entry_delete(ent)
    for ent in dead_a:
        _safe_delete(ent)


def aligned_budget_check(ctx, keep_keys=frozenset(),
                         keep_tables=frozenset()) -> None:
    """Enforce the device byte budget after aligned planning, never
    evicting the entries the in-flight query is about to execute with."""
    _evict_to_budget(_budget(ctx), keep=None,
                     keep_aligned=frozenset(keep_keys),
                     keep_tables=frozenset(keep_tables))


def _decoded_slabs(ent: CachedTable, col: int):
    """Column slabs DECODED to raw (vals, valid) tuples (K2) — the one-off
    decode for aligned-join builds, whose outputs (midx/matched and
    gathered build columns) are cached raw in the fact slab layout, so the
    per-query consumers of aligned columns never decode them."""
    slabs = ent.dev[col]
    lay = ent.layouts.get(col)
    if lay is None:
        return slabs
    from tidb_tpu_torch.chunk import compress
    return compress.decode_slabs_torch([(lay, t) for t in slabs],
                                       ent.slab_cap)


# ---------------------------------------------------------------------------
# FK-aligned join cache (the join-index / coprocessor-cache analog)
# ---------------------------------------------------------------------------
#
# PK-FK equi joins dominate analytical plans (every TPC-H join), and the
# per-query cost of a LUT join is not the build (one scatter) but the
# probe-side gathers: every build column gathered pays a random gather
# over the fact rows again, every query.
#
# So gather ONCE and cache the result. For a join whose build side is
# unique on the key (verified at build time, not assumed), the per-fact-row
# match is a pure function of (fact key column, build key column) —
# independent of the query's filters and projections. Cached in the fact
# table's slab layout:
#   midx     int32 per fact row — matching build row (0 if none)
#   matched  bool  per fact row — a live, NULL-free key match exists
#   cols     build column c gathered through midx, masked by matched
# Filters on the build side evaluate per query AGAINST the aligned columns
# (they are per-fact-row now), so one cached structure serves every
# filter/projection combination — how the reference's coprocessor cache
# (store/copr/coprocessor_cache.go) serves filter-variant scans from one
# snapshot, and the bitmap-join-index idea done columnar. The LUT build is
# K4 and the per-slab probe K5 (ops/join.py).
#
# Chained joins compose: the probe key of a snowflake's second hop (Q5's
# o_custkey) is itself an aligned column of the first hop, so the second
# entry's key path nests the first's. Freshness: every entry records the
# TableData identity tokens of ALL tables on its path; any mismatch (or
# explicit invalidate) drops it.


class AlignedJoin:
    """Cached FK-aligned join structure for ONE (fact path, build) pair."""

    __slots__ = ("tds", "slab_cap", "n_slabs", "unique", "matched",
                 "midx", "cols", "build_nb", "key")

    def __init__(self, key, tds, slab_cap, n_slabs, build_nb):
        self.key = key
        self.tds = tds              # table_id → TableData token
        self.slab_cap = slab_cap    # fact slab layout at build
        self.n_slabs = n_slabs
        self.build_nb = build_nb    # build-side padded row count
        self.unique = True
        self.matched: List = []     # per fact slab: bool (slab_cap,)
        self.midx: List = []        # per fact slab: int32 (slab_cap,)
        self.cols: Dict[int, List[Tuple]] = {}   # build col → [(v, m)] slabs

    def hbm_bytes(self) -> int:
        total = sum(a.nbytes for arrs in (self.matched, self.midx)
                    for a in arrs)
        for slabs in self.cols.values():
            for v, m in slabs:
                total += v.nbytes + m.nbytes
        return total

    def delete(self) -> None:
        """Drop the references to the device tensors (see
        CachedTable.delete)."""
        self.matched = []
        self.midx = []
        self.cols.clear()


def _fresh(ctx, tds) -> bool:
    return all(ctx.snapshot.table_data(tid) is td for tid, td in tds.items())


def _build_cat(ent: CachedTable, col: int):
    """Build-side column slabs concatenated (build tables are usually one
    slab; concat is a no-op then). Wide decimals concat on the row axis.
    Compressed slabs decode here — the LUT/gather builds below run once
    per cached structure, so the decode is off the per-query path."""
    slabs = _decoded_slabs(ent, col)
    if len(slabs) == 1:
        return slabs[0]
    return (torch.cat([s[0] for s in slabs], dim=-1),
            torch.cat([s[1] for s in slabs]))


ALIGNED_DOMAIN_CAP = 1 << 26    # max build-key LUT size at cache build


def get_aligned(ctx, key, tds: Dict[int, object], fact_slabs,
                build_ent: CachedTable, build_key_col: int,
                bounds: Tuple[int, int], slab_cap: int, n_slabs: int):
    """→ AlignedJoin for `key`, building midx/matched on first use, or None
    when the build side turns out non-unique on the key (the negative
    result is cached too — one LUT build per key, not one per query).

    key: hashable path signature (store id, probe-source path, build table,
    build key col, device). tds: table_id → TableData token for EVERY table
    on the path — freshness is identity of all of them.
    fact_slabs: a callable → (per-fact-slab probe-key values, per-slab
    validity), called only when the entry is built, so a warm query never
    decodes the probe key. bounds: the build key column's (lo, hi) value
    domain."""
    from tidb_tpu_torch.ops import join as J
    if build_ent.is_delta:
        # delta generations break the LUT's prefix-liveness assumption
        # (row < total): tombstone-compacted slabs and the appended delta
        # slab make liveness per slab, not a global prefix — the regular
        # join path handles them; compaction restores alignment
        return None
    stale = None
    with _LOCK:
        ent = _ALIGNED.get(key)
        if ent is not None:
            if _fresh(ctx, ent.tds) and ent.slab_cap == slab_cap \
                    and ent.n_slabs == n_slabs:
                _ALIGNED.move_to_end(key)
                return ent if ent.unique else None
            _ALIGNED.pop(key, None)
            stale = ent
    if stale is not None:
        _safe_delete(stale)

    lo, hi = bounds
    domain = hi - lo + 1
    if domain > ALIGNED_DOMAIN_CAP:
        return None
    bk_v, bk_m = _build_cat(build_ent, build_key_col)
    nb = int(bk_v.shape[-1])
    ent = AlignedJoin(key, tds, slab_cap, n_slabs, nb)
    # K4 over the build key, rows past the table's live prefix dead
    cnt, lut, maxcnt, _ = J.lut_build([(bk_v, bk_m)], [(lo, hi)], domain,
                                      n_live=build_ent.total)
    if int(maxcnt) > 1:
        ent.unique = False          # negative result cached
        with _LOCK:
            if key not in _ALIGNED:
                _ALIGNED[key] = ent
        return None
    # K5 per fact slab: the matching build row and the match flag
    for pv, pm in zip(*fact_slabs()):
        midx, matched = J.lut_probe([(pv, pm)], [(lo, hi)], cnt, lut, None,
                                    nb, unique=True)
        ent.midx.append(midx)
        ent.matched.append(matched)
    with _LOCK:
        cur = _ALIGNED.get(key)
        if cur is not None and _fresh(ctx, cur.tds) \
                and cur.slab_cap == slab_cap and cur.n_slabs == n_slabs:
            # lost a concurrent build race: adopt the installed entry
            # (identical build), ours frees via refcount
            return cur if cur.unique else None
        _ALIGNED[key] = ent
    return ent


def aligned_col(ent: AlignedJoin, build_ent: CachedTable, col: int):
    """Ensure build column `col` is materialized in the fact row space;
    → per-fact-slab [(v, m)] (wide decimals keep their limb-plane axis):
    one K18 call a fact slab, `bm[midx] & matched`, into tensors that own
    their storage, since the entry caches them."""
    from tidb_tpu_torch.ops.gather import gather_slab
    cached = ent.cols.get(col)
    if cached is not None:
        return cached
    bv, bm = _build_cat(build_ent, col)
    slabs = [gather_slab(bv, bm, midx, keep=matched)
             for midx, matched in zip(ent.midx, ent.matched)]
    with _LOCK:
        # first-commit-wins against a concurrent identical gather
        return ent.cols.setdefault(col, slabs)

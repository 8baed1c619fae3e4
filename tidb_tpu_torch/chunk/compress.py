"""Compressed physical column layouts for the device cache.

Per-column layout chosen once at encode time ("Fine-Tuning Data
Structures for Analytical Query Processing" — the load-time layout
decision is the highest-leverage lever for scan-bound analytics):

  * pack — frame-of-reference bit-packing: codes are `value - ref`
    (ref = min over valid values, so negative ints need no zig-zag)
    packed at the observed bit width into uint32 words;
  * dict — low-cardinality int columns store sorted-dictionary rank
    codes (the string-dictionary idea extended to ints), packed at the
    code width, with ONE shared dictionary values array per column;
  * delta — monotonically non-decreasing, fully-valid int columns
    (sorted PKs, event timestamps) store successive differences packed
    at the max-gap width, with a per-slab base value; decode is one
    cumulative sum. Constant runs pack at the zero-diff width, so delta
    subsumes run-length encoding for sorted data.

The layout decision is workload-adaptive: `choose_layout` accepts
hints distilled from the Registry's per-digest profiles (group-by
heavy workloads raise the dictionary cardinality cap — dictionary
codes feed group factorization directly).

Width is rounded up to {0, 1, 2, 4, 8, 16, 32} so codes never straddle
a word boundary and the device decode is a gather-free broadcast
shift/mask. Width 0 means every valid value equals `ref` (single
distinct value, or an all-NULL column) — no words are stored at all.
Validity masks are themselves bit-packed at width 1 over the padded
slab, so a compressed slab is (words, mask_words[, dictvals]) and the
raw representation never crosses PCIe.

Decode runs on numpy (the host engine) or on torch tensors (the K2
kernel on a CUDA device, its plain torch version on the CPU; called from
executor/device_emit.emit_decode_many) and is byte-exact: packing
the PADDED slab preserves the False padding of the mask, and invalid
slots pack as code 0 — their decoded values are don't-care because
every consumer masks by validity.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import NamedTuple, Optional, Tuple

import numpy as np

from tidb_tpu_torch.errors import LayoutError

#: legal packed widths — each divides the 32-bit word exactly
WIDTHS = (0, 1, 2, 4, 8, 16, 32)
WORD_BITS = 32
#: dictionary layout only below this cardinality (TiFlash's low-card
#: dictionary threshold is the same order of magnitude)
DICT_CARD_CAP = 4096


@dataclass(frozen=True)
class ColLayout:
    """Static per-column layout descriptor — hashable and data-light so
    it keys program signatures (escalation recompiles stay exact-need)."""

    kind: str      # "pack" (FoR) | "dict" (dictionary) | "delta" (diffs)
    width: int     # bits per packed code — one of WIDTHS
    ref: int       # frame-of-reference base (pack); 0 for dict/delta
    dtype: str     # logical numpy dtype name the decode restores
    card: int = 0  # dictionary cardinality (dict kind only)

    def sig(self) -> str:
        return (f"{self.kind}:w{self.width}:r{self.ref}:"
                f"c{self.card}:{self.dtype}")

    @property
    def np_dtype(self) -> np.dtype:
        return np.dtype(self.dtype)


def validate(layout) -> None:
    """Reject a corrupted/inconsistent descriptor with a typed error —
    consumers call this BEFORE decoding, so a bad descriptor can never
    reach the traced decode and produce silently wrong rows."""
    if not isinstance(layout, ColLayout):
        raise LayoutError(
            f"column layout descriptor is not a ColLayout: {layout!r}")
    if layout.kind not in ("pack", "dict", "delta"):
        raise LayoutError(f"unknown layout kind {layout.kind!r}")
    if layout.kind == "delta" and layout.width == 0:
        raise LayoutError("delta layout with width 0 (constant columns "
                          "must use pack width 0)")
    if layout.width not in WIDTHS:
        raise LayoutError(
            f"illegal packed width {layout.width} (legal: {WIDTHS})")
    try:
        dt = np.dtype(layout.dtype)
    except TypeError as e:
        raise LayoutError(
            f"layout dtype {layout.dtype!r} is not a dtype") from e
    if dt.kind not in "iu":
        raise LayoutError(
            f"layout dtype {layout.dtype!r} is not an integer type")
    if layout.kind == "dict" and layout.card <= 0:
        raise LayoutError(
            f"dict layout with non-positive cardinality {layout.card}")


def _round_width(bits: int) -> Optional[int]:
    for w in WIDTHS:
        if bits <= w:
            return w
    return None


def choose_layout(vals: np.ndarray, valid: np.ndarray,
                  allow_dict: bool = True, hints: Optional[dict] = None
                  ) -> Tuple[Optional[ColLayout], Optional[np.ndarray]]:
    """GLOBAL per-column layout decision → (layout or None, dictvals).

    Over the FULL column so every slab shares one layout (and one
    program signature). Floats, wide decimals (never integer dtype
    here) and columns whose observed range needs more than half the
    logical width stay raw — compression must at least halve the value
    bytes to be worth a layout.

    `hints` carries workload evidence distilled from the per-digest
    statement profiles (device_cache.workload_hints): a group-by-heavy
    workload sets "group_heavy", which raises the dictionary
    cardinality cap 4× and lets dictionary win width ties — dict codes
    double as pre-factorized group ids, so the wider cap pays for
    itself on the agg side even when pack would be byte-equal."""
    hints = hints or {}
    dt = vals.dtype
    if dt.kind not in "iu" or dt.itemsize > 8:
        return None, None
    max_width = dt.itemsize * 8 // 2
    name = dt.name
    all_valid = bool(valid.all())
    vv = vals if all_valid else vals[valid]
    if vv.size == 0:
        # all-NULL column: width 0, nothing stored but the packed mask
        return ColLayout("pack", 0, 0, name), None
    lo, hi = int(vv.min()), int(vv.max())
    pw = _round_width((hi - lo).bit_length())
    pack = ColLayout("pack", pw, lo, name) \
        if pw is not None and pw <= max_width else None
    # sorted fully-valid columns (PKs, timestamps): successive diffs
    # need max-gap bits, not range bits — a dense sorted PK packs at
    # width 1-2 regardless of its absolute range
    if all_valid and vv.size >= 2:
        v64 = vv.astype(np.int64)
        diffs = np.diff(v64)
        if diffs.size and int(diffs.min()) >= 0 and int(diffs.max()) > 0:
            xw = _round_width(int(diffs.max()).bit_length())
            if xw is not None and 0 < xw <= max_width and \
                    (pack is None or xw < pack.width):
                pack = ColLayout("delta", xw, 0, name)
    if allow_dict and (pack is None or pack.width > 1):
        uniq = np.unique(vv)
        card = int(uniq.size)
        dict_cap = DICT_CARD_CAP * (4 if hints.get("group_heavy") else 1)
        if card <= dict_cap:
            dw = _round_width(max(card - 1, 0).bit_length())
            better = dw is not None and dw <= max_width and (
                pack is None or dw < pack.width or
                (hints.get("group_heavy") and dw == pack.width and
                 pack.kind == "pack"))
            if better:
                return ColLayout("dict", dw, 0, name, card), uniq
    return pack, None


def _pack_codes(codes: np.ndarray, width: int) -> np.ndarray:
    """Non-negative uint64 codes (< 2^width) → uint32 words, element j
    of word w at bits [j*width, (j+1)*width)."""
    per = WORD_BITS // width
    n = codes.shape[0]
    n_words = -(-n // per)
    if n_words * per != n:
        pad = np.zeros(n_words * per, dtype=np.uint64)
        pad[:n] = codes
        codes = pad
    codes = codes.reshape(n_words, per)
    shifts = np.arange(per, dtype=np.uint64) * np.uint64(width)
    words = np.bitwise_or.reduce(codes << shifts[None, :], axis=1)
    return words.astype(np.uint32)


def pack_slab(layout: ColLayout, vals: np.ndarray, mask: np.ndarray,
              dictvals: Optional[np.ndarray] = None):
    """Host-side encode of ONE padded slab → (words, mask_words) — plus
    a trailing per-slab base array for delta slabs. Invalid/padding
    slots pack as code 0 (decoded values there are don't-care —
    consumers mask by validity); the mask packs the padded slab
    exactly, so decode restores it byte-for-byte."""
    mask = np.asarray(mask, dtype=bool)
    mask_words = _pack_codes(mask.astype(np.uint64), 1)
    if layout.width == 0:
        # nothing to store: every valid value IS layout.ref
        return np.zeros(1, dtype=np.uint32), mask_words
    if layout.kind == "dict":
        safe = np.where(mask, vals, dictvals[0])
        codes = np.searchsorted(dictvals, safe).astype(np.uint64)
    elif layout.kind == "delta":
        # delta columns are fully valid, so the valid prefix IS the
        # slab's rows; padding diffs stay 0 (cumsum holds the last
        # value there, masked out by the packed validity)
        n = int(mask.sum())
        v64 = vals.astype(np.int64)
        codes = np.zeros(vals.shape[0], dtype=np.uint64)
        if n > 1:
            codes[1:n] = np.diff(v64[:n]).astype(np.uint64)
        base = np.asarray([v64[0] if n else 0], dtype=np.int64)
        return _pack_codes(codes, layout.width), mask_words, base
    else:
        codes = np.where(mask, vals.astype(np.int64) - np.int64(layout.ref),
                         0).astype(np.uint64)
    return _pack_codes(codes, layout.width), mask_words


def _unpack_codes(words, width: int, cap: int, xp):
    """numpy decode of packed codes (uint32 words → uint32 codes)."""
    per = WORD_BITS // width
    w = xp.asarray(words)
    shifts = (xp.arange(per) * width).astype(np.uint32)
    m = np.uint32(0xFFFFFFFF) if width == WORD_BITS \
        else np.uint32((1 << width) - 1)
    codes = (w[:, None] >> shifts[None, :]) & m
    return codes.reshape(-1)[:cap]


def decode_slab(layout: ColLayout, slab, cap: int, xp):
    """One packed slab → (vals, mask) in the logical dtype. xp is numpy
    (host arrays) or a torch namespace (ops/xp.TorchXP): torch slabs go
    through `decode_slab_torch`, i.e. the K2 kernel on a CUDA device and
    its plain version on the CPU."""
    validate(layout)
    if xp is not np:
        return decode_slab_torch(layout, slab, cap)
    words, mask_words = slab[0], slab[1]
    mask = _unpack_codes(mask_words, 1, cap, xp) != 0
    dt = layout.np_dtype
    if layout.width == 0:
        return xp.full(cap, layout.ref, dtype=dt), mask
    codes = _unpack_codes(words, layout.width, cap, xp)
    if layout.kind == "dict":
        # dict codes are < DICT_CARD_CAP, so int32 indexing is exact
        idx = xp.clip(codes.astype(np.int32), 0, layout.card - 1)
        return xp.take(xp.asarray(slab[2]), idx).astype(dt), mask
    if layout.kind == "delta":
        base = xp.asarray(slab[2]).astype(np.int64)[0]
        return (base + xp.cumsum(codes.astype(np.int64))).astype(dt), mask
    return (codes.astype(np.int64) + np.int64(layout.ref)).astype(dt), mask


# ---------------------------------------------------------------------------
# torch decode: the K2 kernel and its plain version
# ---------------------------------------------------------------------------
# Device slabs hold the packed uint32 words as int32 tensors (the same
# bits; torch has no CUDA shifts on uint32), so unpacking computes in
# int64.

_K2_KINDS = {"pack": 0, "dict": 1, "delta": 2}


def words_for_device(words: np.ndarray) -> np.ndarray:
    """Host uint32 words → the int32 view device slabs store."""
    return np.ascontiguousarray(words, dtype=np.uint32).view(np.int32)


def _unpack_codes_torch(words, width: int, cap: int):
    import torch
    per = WORD_BITS // width
    w = words.to(torch.int64) & 0xFFFFFFFF
    shifts = torch.arange(per, dtype=torch.int64, device=w.device) * width
    m = 0xFFFFFFFF if width == WORD_BITS else (1 << width) - 1
    codes = (w[:, None] >> shifts[None, :]) & m
    return codes.reshape(-1)[:cap]


def decode_slab_plain(layout: ColLayout, slab, cap: int):
    """Plain torch version of K2 (int64 arithmetic throughout)."""
    from tidb_tpu_torch.ops.xp import torch_dtype
    dt = torch_dtype(layout.np_dtype)
    words, mask_words = slab[0], slab[1]
    mask = _unpack_codes_torch(mask_words, 1, cap) != 0
    if layout.width == 0:
        import torch
        return torch.full((cap,), layout.ref, dtype=dt,
                          device=mask.device), mask
    codes = _unpack_codes_torch(words, layout.width, cap)
    if layout.kind == "dict":
        idx = codes.clamp(0, layout.card - 1)
        return slab[2][idx].to(dt), mask
    if layout.kind == "delta":
        base = slab[2].to(codes.dtype)[0]
        return (base + codes.cumsum(0)).to(dt), mask
    return (codes + layout.ref).to(dt), mask


#: columns a K2 launch takes (csrc/unpack_decode.cu MAX_COLS)
K2_MAX_COLS = 16
#: rows a K2 tile (csrc/unpack_decode.cu TILE)
K2_TILE = 4096


class _DecodeArgs(ctypes.Structure):
    """K2's argument block (csrc/unpack_decode.cu `DecodeArgs`)."""
    _fields_ = [("words", ctypes.c_void_p * K2_MAX_COLS),
                ("mask_words", ctypes.c_void_p * K2_MAX_COLS),
                ("aux", ctypes.c_void_p * K2_MAX_COLS),
                ("vals", ctypes.c_void_p * K2_MAX_COLS),
                ("mask", ctypes.c_void_p * K2_MAX_COLS),
                ("ref", ctypes.c_longlong * K2_MAX_COLS),
                ("kind", ctypes.c_int * K2_MAX_COLS),
                ("width", ctypes.c_int * K2_MAX_COLS),
                ("dtype", ctypes.c_int * K2_MAX_COLS),
                ("card", ctypes.c_int * K2_MAX_COLS),
                ("cap", ctypes.c_longlong),
                ("n_cols", ctypes.c_int),
                ("reserved", ctypes.c_int)]


def decode_scratch_bytes(n_delta: int, cap: int) -> int:
    """Bytes of the stream scratch one K2 launch with `n_delta` delta
    columns takes (csrc/unpack_decode.cu `scratch_bytes`): the zeroed
    part (a 16-byte tile counter and a 4-byte look-back flag a delta tile,
    rounded up to 16 bytes), then each delta tile's aggregate and
    inclusive prefix, 8 bytes each. 0 without a delta column."""
    if not n_delta:
        return 0
    tiles = n_delta * -(-cap // K2_TILE)
    return 16 + -(-4 * tiles // 16) * 16 + 16 * tiles


class _ColPlan(NamedTuple):
    dtype: object          # torch dtype of the values
    n_words: int           # packed words the kernel reads
    n_mask_words: int
    aux: Optional[str]     # "dict" / "delta": slab[2] is read
    card: int


@functools.lru_cache(maxsize=256)
def decode_plan(layouts: Tuple[ColLayout, ...], cap: int):
    """K2's launches for one tuple of column layouts at one cap, a pure
    function: the layouts validated, then chunks of at most K2_MAX_COLS
    columns, each → (its argument block's bytes with kind, width, output
    type, ref, card, cap and the column count filled in and every pointer
    zero, its columns' _ColPlan, its scratch bytes)."""
    import torch
    from tidb_tpu_torch.ops import cuda_kernels as ck
    for lay in layouts:
        validate(lay)
    if not 0 <= cap < 2 ** 31 - K2_TILE:
        raise ck.KernelError(f"unpack_decode: cap {cap} out of range")
    chunks = []
    for c0 in range(0, len(layouts), K2_MAX_COLS):
        part = layouts[c0:c0 + K2_MAX_COLS]
        a = _DecodeArgs()
        a.cap = cap
        a.n_cols = len(part)
        cols = []
        n_delta = 0
        for q, lay in enumerate(part):
            dt = {"int64": torch.int64, "int32": torch.int32}.get(lay.dtype)
            if dt is None:
                raise ck.KernelError(f"unpack_decode: unsupported dtype "
                                     f"{lay.dtype}")
            a.kind[q] = _K2_KINDS[lay.kind]
            a.width[q] = lay.width
            a.dtype[q] = 0 if dt == torch.int64 else 1
            a.ref[q] = lay.ref
            a.card[q] = lay.card
            aux = None
            if lay.width and lay.kind in ("dict", "delta"):
                aux = lay.kind
                n_delta += lay.kind == "delta"
            n_words = -(-cap // (WORD_BITS // lay.width)) if lay.width else 0
            cols.append(_ColPlan(dt, n_words, -(-cap // WORD_BITS), aux,
                                 lay.card))
        chunks.append((bytes(a), tuple(cols),
                       decode_scratch_bytes(n_delta, cap)))
    return tuple(chunks)


def decode_slabs_torch(items, cap: int):
    """K2 over many column slabs of one cap: items [(layout, slab)] →
    [(vals, mask)], each equal to `decode_slab_plain` in every slot. CPU
    slabs take the plain version; CUDA slabs go to the kernel, one C call
    and one launch for every K2_MAX_COLS columns (or raise on anything it
    does not take). Every output tensor owns its storage (one allocation
    each), so a cached result pins nothing else."""
    items = list(items)
    if all(s[0].device.type == "cpu" for _, s in items):
        for lay, _ in items:
            validate(lay)
        return [decode_slab_plain(lay, slab, cap) for lay, slab in items]
    import torch
    from tidb_tpu_torch.ops import cuda_kernels as ck
    try:
        plan = decode_plan(tuple(lay for lay, _ in items), cap)
    except TypeError:           # an unhashable descriptor
        for lay, _ in items:
            validate(lay)
        raise
    dev = next(s[0].device for _, s in items if s[0].is_cuda)
    lib = ck.library("unpack_decode")
    stream = ck.stream_ptr(dev)
    out = []
    for blob, cols, need in plan:
        a = _DecodeArgs.from_buffer_copy(blob)
        for q, cp in enumerate(cols):
            slab = items[len(out)][1]
            words, mask_words = slab[0], slab[1]
            ck.require_cuda(words, mask_words, what="unpack_decode")
            if words.dtype != torch.int32 or mask_words.dtype != torch.int32:
                raise ck.KernelError("unpack_decode: words must be int32 "
                                     "tensors")
            if mask_words.numel() < cp.n_mask_words:
                raise ck.KernelError("unpack_decode: mask words shorter "
                                     "than cap")
            if words.numel() < cp.n_words:
                raise ck.KernelError("unpack_decode: words shorter than cap")
            if cp.aux is not None:
                aux = slab[2]
                ck.require_cuda(aux, what="unpack_decode")
                if cp.aux == "dict" and (aux.dtype != cp.dtype or
                                         aux.numel() < cp.card):
                    raise ck.KernelError("unpack_decode: bad dictionary "
                                         "values")
                if cp.aux == "delta" and (aux.dtype != torch.int64 or
                                          aux.numel() < 1):
                    raise ck.KernelError("unpack_decode: delta base must "
                                         "be int64")
                a.aux[q] = aux.data_ptr()
            vals = torch.empty(cap, dtype=cp.dtype, device=dev)
            mask = torch.empty(cap, dtype=torch.bool, device=dev)
            a.words[q] = words.data_ptr()
            a.mask_words[q] = mask_words.data_ptr()
            a.vals[q] = vals.data_ptr()
            a.mask[q] = mask.data_ptr()
            out.append((vals, mask))
        if need:
            ent = ck.stream_scratch("unpack_decode", dev, stream)
            with ent.lock:      # from the call's scratch memset to its launch
                rc = lib.tt_unpack_decode(ctypes.addressof(a),
                                          ent.ensure(need, dev), need,
                                          stream)
        else:
            rc = lib.tt_unpack_decode(ctypes.addressof(a), None, 0, stream)
        ck.count("unpack_decode")
        ck.check(rc, "unpack_decode")
    return out


def decode_slab_torch(layout: ColLayout, slab, cap: int):
    """K2 wrapper for one column: `decode_slabs_torch` with one item."""
    return decode_slabs_torch([(layout, slab)], cap)[0]


def raw_slab_bytes(layout: ColLayout, cap: int) -> int:
    """Logical bytes one slab WOULD occupy uncompressed: values at the
    logical dtype plus the 1-byte-per-row bool validity mask."""
    return cap * (layout.np_dtype.itemsize + 1)


def packed_slab_bytes(layout: ColLayout, cap: int) -> int:
    """Physical bytes one packed slab occupies (words + mask words +
    the delta base), computable WITHOUT encoding it — the upload-bytes
    figure for slabs that zone-map pruning never encodes. Excludes the
    dict-layout dictionary array (uploaded once per column, not per
    slab)."""
    mask_bytes = 4 * (-(-cap // WORD_BITS))
    if layout.width == 0:
        return 4 + mask_bytes                 # the 1-word stub
    per = WORD_BITS // layout.width
    word_bytes = 4 * (-(-cap // per))
    base_bytes = 8 if layout.kind == "delta" else 0
    return word_bytes + mask_bytes + base_bytes

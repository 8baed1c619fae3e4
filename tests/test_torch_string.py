"""The dictionary string functions on the port's device path (torch on
the CPU) against the JAX package's device branch (jax.numpy on the CPU),
through the same SQL on the same seeded table: LENGTH, CHAR_LENGTH,
ASCII, ORD, BIT_LENGTH, INSTR, LOCATE and FIND_IN_SET as filters, GROUP
BY keys and SUM/MAX arguments; UPPER, LOWER, REVERSE, the TRIMs, HEX,
SUBSTR, LEFT, RIGHT, REPEAT, REPLACE, the PADs, SUBSTRING_INDEX and
CONCAT under IS [NOT] NULL; ANY_VALUE. Both engines must run each op
inside a device fragment with no fallback; rows exactly equal. The
gathers go through ops/dict_lut (K21's plain version here), the string
equi-join's KeyRemap in its fill mode.

A string result under the result branches of IF / CASE whose own result
is the argument of IS [NOT] NULL runs on both devices. Shapes the device
branch cannot evaluate (the JAX package's device fails on them and reruns
on its CPU) and every string function over a ci column stay on the CPU at
plan time and equal the port's host engine. `dict_lut_plain` is held to `jnp.take(...,
mode="clip")` and to the JAX package's KeyRemap arithmetic."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tidb_tpu.executor.tree_fragment import KeyRemap as JKeyRemap
from tidb_tpu.expression import ColumnRef as JColumnRef
from tidb_tpu.expression import EvalContext as JEvalContext
from tidb_tpu.types import bigint as jbigint
from torch_diff import (assert_same, collect_jax_sessions,  # noqa: F401
                        fragment_ops, run_jax, run_port_frags,
                        run_port_tree, twin_sessions)
from tidb_tpu_torch.ops import dict_lut as DL

DDL = ["CREATE TABLE x (i BIGINT, j INT, s VARCHAR(24), "
       "c VARCHAR(24) COLLATE utf8mb4_general_ci)",
       "CREATE TABLE y (yj INT, k INT, name VARCHAR(24), w INT)"]
N = 3000
NY = 50

#: op → statements exercising it: integer results as a filter, a GROUP BY
#: key and SUM/MAX arguments; string results under IS [NOT] NULL
_INT_EXPRS = {
    "length": ["LENGTH(s)"],
    "char_length": ["CHAR_LENGTH(s)", "CHARACTER_LENGTH(s)"],
    "ascii": ["ASCII(s)"],
    "ord": ["ORD(s)"],
    "bit_length": ["BIT_LENGTH(s)"],
    "instr": ["INSTR(s, 'b')", "INSTR(s, 'ñ')"],
    "locate": ["LOCATE('b', s)", "LOCATE('a', s, 2)"],
    "find_in_set": ["FIND_IN_SET('bb', s)"],
}
_STR_EXPRS = {
    "upper": ["UPPER(s)"],
    "lower": ["LOWER(s)"],
    "reverse": ["REVERSE(s)"],
    "ltrim": ["LTRIM(s)"],
    "rtrim": ["RTRIM(s)"],
    "trim": ["TRIM(s)"],
    "hex": ["HEX(s)"],
    "substr": ["SUBSTR(s, 2, 3)", "SUBSTRING(s, 2)"],
    "left": ["LEFT(s, 2)"],
    "right": ["RIGHT(s, 3)"],
    "repeat": ["REPEAT(s, 2)"],
    "replace": ["REPLACE(s, 'a', 'xy')"],
    "lpad": ["LPAD(s, 6, '*')"],
    "rpad": ["RPAD(s, 6, '-')"],
    "substring_index": ["SUBSTRING_INDEX(s, ',', 1)"],
    "concat": ["CONCAT(s, '!')", "CONCAT('<', s, 3)"],
}


def _int_statements(x):
    return [f"SELECT i, COUNT(*) FROM x WHERE {x} > 0 GROUP BY i",
            f"SELECT {x}, COUNT(*), SUM(j) FROM x GROUP BY {x}",
            f"SELECT i, SUM({x}), MAX({x}) FROM x GROUP BY i"]


def _str_statements(x):
    return [f"SELECT i, COUNT(*) FROM x WHERE {x} IS NOT NULL GROUP BY i",
            f"SELECT COUNT(*), SUM(j) FROM x WHERE {x} IS NULL OR j > 30"]


OPS = {op: [q for x in xs for q in _int_statements(x)]
       for op, xs in _INT_EXPRS.items()}
OPS.update({op: [q for x in xs for q in _str_statements(x)]
            for op, xs in _STR_EXPRS.items()})
OPS["any_value"] = ["SELECT i, COUNT(*) FROM x WHERE ANY_VALUE(j) > 20 "
                    "GROUP BY i"]
CASES = [(op, k) for op in sorted(OPS) for k in range(len(OPS[op]))]


def _vocabulary(rng):
    """Distinct strings: ASCII syllables, commas (FIND_IN_SET, SUBSTRING_
    INDEX), spaces at either end (the TRIMs), non-ASCII text, ''."""
    syl = np.array(["a", "b", "c", "aa", "bb", "ab", "ba", "x", "ñ", "日",
                    "é", ",", " ", "Ä"], dtype=object)
    words = {"", "aa", "bb", "aa,bb", "bb,cc,dd", " pad ", "ñandú", "日本語"}
    while len(words) < 300:
        words.add("".join(syl[rng.integers(0, len(syl),
                                           rng.integers(1, 7))]))
    return np.array(sorted(words), dtype=object)


def _tables():
    rng = np.random.default_rng(31)
    vocab = _vocabulary(rng)
    s = vocab[rng.integers(0, len(vocab), N)]
    # the ci column: the same strings, each letter's case drawn anew, so a
    # fold class holds rows that differ from its representative
    c = np.array(["".join(ch.upper() if rng.random() < 0.5 else ch
                          for ch in v) for v in s], dtype=object)
    valid = {"i": rng.random(N) > 0.05, "s": rng.random(N) > 0.08,
             "c": rng.random(N) > 0.08}
    x = {"i": rng.integers(-9, 10, N), "j": rng.integers(0, 40, N),
         "s": np.where(valid["s"], s, ""), "c": np.where(valid["c"], c, "")}
    # y.name: one row per name, most of them in x's vocabulary, a few not
    names = np.concatenate([rng.choice(vocab, NY - 5, replace=False),
                            np.array(["zzz1", "zzz2", "zzz3", "zzz4",
                                      "zzz5"], dtype=object)])
    y = {"yj": np.arange(NY), "k": rng.integers(0, 6, NY),
         "name": names, "w": rng.integers(0, 4, NY)}
    return {"x": (x, valid), "y": (y, None)}


@pytest.fixture(scope="module")
def twins():
    return twin_sessions(DDL, _tables())


@pytest.mark.parametrize("op,k", CASES)
def test_string_op_matches_jax_device_branch(twins, op, k):
    """Both engines evaluate `op` inside a device fragment that ran with
    no fallback, and their rows are exactly equal."""
    js, ts = twins
    sql = OPS[op][k]
    jrows, jfrags = run_jax(js, sql)
    assert jfrags and all(f.used_device and f.fallback_code is None
                          for f in jfrags), \
        [(f.used_device, f.fallback_code) for f in jfrags]
    assert op in fragment_ops(jfrags)
    rows, frags = run_port_frags(ts, sql)
    assert op in fragment_ops(frags), fragment_ops(frags)
    assert_same(rows, jrows, rel=0)


@pytest.fixture
def lut_calls(monkeypatch):
    """Counts the port's dictionary-LUT gathers by mode (K21's plain
    version on CPU tensors)."""
    calls = {"clip": 0, "fill": 0}
    plain = DL.dict_lut_plain

    def counted(table, codes, mode="clip", fill=-1):
        calls[mode] += 1
        return plain(table, codes, mode, fill)

    monkeypatch.setattr(DL, "dict_lut_plain", counted)
    return calls


@pytest.mark.parametrize("sql,mode", [
    # the tree path: string functions over a join on integer keys
    ("SELECT k, COUNT(*), SUM(LENGTH(s)), MAX(LOCATE('b', s)) FROM x "
     "JOIN y ON j = yj WHERE INSTR(s, 'a') > 0 OR UPPER(s) IS NULL "
     "GROUP BY k", "clip"),
    # the string equi-join: probe codes remapped into y's dictionary
    ("SELECT w, COUNT(*) FROM x JOIN y ON s = name GROUP BY w", "fill"),
    ("SELECT w, COUNT(*), SUM(CHAR_LENGTH(s)) FROM x JOIN y ON s = name "
     "WHERE s LIKE '%b%' GROUP BY w", "fill"),
])
def test_join_matches_jax(twins, lut_calls, sql, mode):
    js, ts = twins
    jrows, jfrags = run_jax(js, sql)
    assert jfrags and all(f.used_device and f.fallback_code is None
                          for f in jfrags)
    rows, _frags = run_port_tree(ts, sql)
    assert_same(rows, jrows, rel=0)
    assert lut_calls[mode] > 0, lut_calls


@pytest.mark.parametrize("sql", [
    # a window's argument and its partition key (the window gate)
    "SELECT i, j, SUM(LENGTH(s)) OVER (PARTITION BY i ORDER BY j) FROM x "
    "WHERE i IS NOT NULL",
    "SELECT i, j, ROW_NUMBER() OVER (PARTITION BY LOCATE('b', s) "
    "ORDER BY j, i) FROM x",
    # TopN roots: over an aggregate, and keyed on a string function
    "SELECT i, MAX(INSTR(s, 'a')) FROM x WHERE UPPER(s) IS NOT NULL "
    "GROUP BY i ORDER BY i LIMIT 3",
    "SELECT i, LENGTH(s) FROM x WHERE j > 30 ORDER BY LENGTH(s), i "
    "LIMIT 5",
])
def test_window_and_order_roots_match_jax(twins, sql):
    js, ts = twins
    jrows, jfrags = run_jax(js, sql)
    assert jfrags and all(f.used_device and f.fallback_code is None
                          for f in jfrags)
    rows, _frags = run_port_frags(ts, sql)
    assert_same(rows, jrows, rel=0, ordered="LIMIT" in sql)


#: shapes refused at plan time: each fails on the JAX package's device
#: (a device error and a CPU rerun, or a plan-time refusal there too)
REFUSED = [
    "UPPER(s) = 'BB'",                      # string comparison, no prep
    "HEX(s) = '6161'",
    "COALESCE(UPPER(s), 'q') IS NULL",      # a string result's consumer
    "CONCAT(s, i) IS NULL",                 # a non-constant co-argument
    "SUBSTR(s, i, 1) IS NULL",
    "LOCATE(s, 'aabbcc') > 0",              # the constant as the column
    "LENGTH(UPPER(s)) > 2",                 # a computed string argument
    "UPPER(s) LIKE 'B%'",
    "SUBSTR(s, 1, 1) IN ('a')",
    "OCTET_LENGTH(s) > 1",                  # kept off DEVICE_OPS
    "RAND(1) > 0.5",
    "IS_IPV4(s)",
    "TIDB_SHARD(i) > 0",
    "IF(i > 0, UPPER(s), 'x') IS NULL",     # a string constant branch
    "IF(i > 0, UPPER(s), LOWER(s)) = 'X'",  # a branch read as a value
    "ASCII(c) > 70",                        # ci columns
    "LOCATE('b', c) > 0",
    "UPPER(c) IS NULL",
]


#: a string result carried to IS [NOT] NULL through the result branches
#: of IF / CASE: only its mask is read, so it runs on both devices
MASK_ONLY = [
    "IF(i > 0, UPPER(s), LOWER(s)) IS NULL",
    "CASE WHEN i > 0 THEN UPPER(s) END IS NULL",
    "IF(j > 20, REVERSE(s), IF(i < 0, LTRIM(s), HEX(s))) IS NOT NULL",
    "CASE WHEN i > 3 THEN LEFT(s, 2) WHEN j < 9 THEN CONCAT(s, '!') "
    "ELSE RPAD(s, 6, '-') END IS NULL",
]


@pytest.mark.parametrize("where", MASK_ONLY)
def test_string_result_under_if_case_matches_jax_device(twins, where):
    """Both engines run the statement inside a device fragment with no
    fallback, and their rows are exactly equal."""
    js, ts = twins
    sql = f"SELECT i, COUNT(*), SUM(j) FROM x WHERE {where} GROUP BY i"
    jrows, jfrags = run_jax(js, sql)
    assert jfrags and all(f.used_device and f.fallback_code is None
                          for f in jfrags)
    rows, frags = run_port_frags(ts, sql)
    assert {"if", "case"} & fragment_ops(frags)
    assert_same(rows, jrows, rel=0)


@pytest.mark.parametrize("where", REFUSED)
def test_refused_shape_stays_on_cpu_at_plan_time(twins, where):
    """No device fragment in EXPLAIN, and the rows are the host
    engine's."""
    _js, ts = twins
    sql = f"SELECT i, COUNT(*) FROM x WHERE {where} GROUP BY i"
    ts.vars["tidb_tpu_engine"] = "on"
    ts.vars["tidb_tpu_row_threshold"] = 1
    ts.vars["tidb_tpu_strict"] = 1
    try:
        plan = ts.query("EXPLAIN " + sql).rows
        dev = ts.query(sql).rows
    finally:
        ts.vars["tidb_tpu_engine"] = "off"
        ts.vars.pop("tidb_tpu_strict", None)
    assert not any("TpuFragment" in str(r) for r in plan), plan
    assert_same(dev, ts.query(sql).rows, rel=0)


@pytest.mark.parametrize("expr", ["ASCII(c)", "LOCATE('b', c)"])
def test_ci_column_reference_device_differs_from_its_host(twins, expr):
    """Why the port refuses a string function over a ci column: the JAX
    package's device table answers for the fold class's representative,
    not for the row's own string, and differs from its own host (which
    the port's CPU engine equals)."""
    js, ts = twins
    sql = f"SELECT SUM({expr}) FROM x"
    jrows, jfrags = run_jax(js, sql)
    assert jfrags and all(f.used_device for f in jfrags)
    host = js.query(sql).rows
    assert jrows != host
    assert ts.query(sql).rows == host


# -- dict_lut_plain against the reference's gathers ------------------------

_EDGE = {torch.bool: DL.SMEM_BYTES, torch.int32: DL.SMEM_BYTES // 4,
         torch.int64: DL.SMEM_BYTES // 8}


def _lut(rng, dtype, n_lut):
    if dtype == torch.bool:
        return rng.random(n_lut) < 0.3
    if dtype == torch.int32:
        return rng.integers(-1, 1 << 20, n_lut).astype(np.int32)
    return rng.integers(-(1 << 40), 1 << 40, n_lut)


def _codes(rng, n, n_lut, code_dtype):
    """Codes in range, negatives, codes at and past n_lut, the NULL code
    (0) and the int32 extremes (the reference's astype(int32) keeps
    them)."""
    special = np.array([0, -1, n_lut, n_lut + 1, -(1 << 31), (1 << 31) - 1,
                        max(n_lut - 1, 0)], dtype=np.int64)
    body = rng.integers(-3, n_lut + 3, n)
    body[:min(n, len(special))] = special[:n]
    return body.astype(np.int32 if code_dtype == torch.int32 else np.int64)


@pytest.mark.parametrize("code_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("dtype", [torch.bool, torch.int32, torch.int64])
@pytest.mark.parametrize("n_lut", ["0", "1", "7", "edge", "edge+1",
                                   "1500303"])
def test_dict_lut_plain_matches_reference(dtype, code_dtype, n_lut):
    size = {"edge": _EDGE[dtype], "edge+1": _EDGE[dtype] + 1}.get(n_lut) \
        or int(n_lut)
    rng = np.random.default_rng(size)
    table = _lut(rng, dtype, size)
    for n in (0, 1, 1001):
        codes = _codes(rng, n, size, code_dtype)
        t, c = torch.from_numpy(table), torch.from_numpy(codes)
        jt, jc = jnp.asarray(table), jnp.asarray(codes).astype(jnp.int32)
        # clip: the string functions', LIKE's and REGEXP's device gather
        if size == 0 and n > 0:
            with pytest.raises(IndexError):
                jnp.take(jt, jc, mode="clip")
            with pytest.raises(IndexError):
                DL.dict_lut_plain(t, c)
        else:
            got = DL.dict_lut_plain(t, c)
            assert got.dtype == dtype
            np.testing.assert_array_equal(
                got.numpy(), np.asarray(jnp.take(jt, jc, mode="clip")))
        # fill: KeyRemap.eval (the reference's remap table is int32, the
        # port's int64; the reference never prepares an empty one)
        got = DL.dict_lut_plain(t, c, mode="fill", fill=-1)
        assert got.dtype == dtype
        if size == 0:
            want = np.full(n, -1).astype(table.dtype)
        elif dtype == torch.bool:
            inside = (codes >= 0) & (codes < size)
            want = np.where(inside, table[np.clip(codes, 0, size - 1)],
                            True)
        else:
            want = _reference_remap(table.astype(np.int32)
                                    if dtype == torch.int32 else table,
                                    codes)
        np.testing.assert_array_equal(got.numpy(), want)


def _reference_remap(table, codes):
    """The JAX package's KeyRemap.eval over `codes`, with `table` as its
    prepared LUT."""
    kr = JKeyRemap(JColumnRef(0, jbigint()), 0, 1)
    ctx = JEvalContext(jnp, [(jnp.asarray(codes), jnp.ones(len(codes),
                                                            bool))],
                       prepared={id(kr): jnp.asarray(table)},
                       on_device=True)
    out, _m = kr.eval(ctx)
    return np.asarray(out)

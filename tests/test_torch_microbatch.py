"""Same-plan micro-batching on the port (torch on the CPU) against the
JAX package's (jax.numpy on the CPU).

N same-digest filter statements piled up behind a held device slot
coalesce into ONE launch per surviving slab: the leader queues on the
scheduler, the followers park on their events, and at grant time the
batched program runs once over each slab with the members' literals
stacked along a member axis. Every member's rows equal its solo run and
the JAX engine's rows for the same statements piled up the same way.
Also pinned: the solo leader and the flag-off paths (no batching), KILL
and deadline isolation while parked, the demux failpoint (warned
individual reruns), demotion of a member whose preparation differs, the
batch key's table version (a write changes it), the parametrization
(the reference's literals under logical ops; a comparison under any
other function keeps its literal, ROADMAP §3), DECIMAL and DATE
parameters, and the batched partial's live mask, the member compaction
(K22's plain version) and the demux against the reference's."""

import json
import threading
import time

import numpy as np
import pytest
import torch

from tidb_tpu.errors import TiDBTPUError as JError
from tidb_tpu.executor import fragment as jfragment
from tidb_tpu.executor import microbatch as jmb
from tidb_tpu.executor.scheduler import SCHEDULER as JSCHED
from tidb_tpu.util.observability import REGISTRY as JREGISTRY
from torch_diff import collect_jax_sessions, jax_session  # noqa: F401
from tidb_tpu_torch.errors import TiDBTPUError
from tidb_tpu_torch.executor import fragment
from tidb_tpu_torch.executor import microbatch as mb
from tidb_tpu_torch.executor.scheduler import SCHEDULER
from tidb_tpu_torch.ops.compact import TILE, member_compact_plain, \
    scratch_bytes
from tidb_tpu_torch.session import Engine
from tidb_tpu_torch.util import failpoint, timeline
from tidb_tpu_torch.util.observability import REGISTRY

N_MEMBERS = 8
MB_ROWS = 256
MBR_ROWS = 4096     # 4 slabs of the smallest slab capacity, 1024 rows
DDL = ["CREATE TABLE mb (k BIGINT, v BIGINT, d DECIMAL(10,2), t DATE, "
       "f DOUBLE)",
       # the same rows with k shuffled: every slab's zone map spans the
       # point reads' keys, so no slab is pruned
       "CREATE TABLE mbr (k BIGINT, v BIGINT)"]


def _rows_sql():
    rng = np.random.default_rng(9)
    perm = rng.permutation(MBR_ROWS)
    mb_rows = ", ".join(
        f"({i}, {i * i}, {i}.{i % 100:02d}, "
        f"'2020-{1 + i % 12:02d}-{1 + i % 28:02d}', {i / 8})"
        for i in range(MB_ROWS))
    mbr_rows = ", ".join(f"({int(perm[i])}, {i})" for i in range(MBR_ROWS))
    return [f"INSERT INTO mb VALUES {mb_rows}",
            f"INSERT INTO mbr VALUES {mbr_rows}"]


def _point(i: int) -> str:
    # mid-range literals: inside the single slab's zone-map range, so all
    # members share one survivor set (one batch key)
    return f"SELECT v FROM mb WHERE k = {40 + i}"


@pytest.fixture(scope="module")
def engines():
    """(port engine, JAX engine), each holding mb and mbr."""
    eng = Engine(device="cpu")
    eng.global_vars["tidb_enable_auto_analyze"] = False
    js = jax_session(lambda e: e.global_vars.__setitem__(
        "tidb_enable_auto_analyze", False))
    ts = eng.new_session()
    for stmt in DDL + _rows_sql():
        ts.execute(stmt)
        js.execute(stmt)
    yield eng, js.engine
    eng.close()


class _Tier:
    """One package's side of a pile-up: its scheduler, micro-batcher and
    counter registry, and a session factory."""

    def __init__(self, eng, sched, mbmod, registry, err):
        self.eng, self.sched, self.mb = eng, sched, mbmod
        self.registry, self.err = registry, err

    def session(self, mb_max=N_MEMBERS, **extra):
        s = self.eng.new_session()
        s.vars["tidb_tpu_engine"] = "on"
        s.vars["tidb_tpu_row_threshold"] = 1
        s.vars["tidb_tpu_strict"] = 1
        s.vars["tidb_tpu_microbatch_max"] = mb_max
        s.vars.update(extra)
        return s

    def counter(self, name):
        return self.registry.counters.get((name, ()), 0)


@pytest.fixture(scope="module")
def port(engines):
    return _Tier(engines[0], SCHEDULER, mb, REGISTRY, TiDBTPUError)


@pytest.fixture(scope="module")
def ref(engines):
    return _Tier(engines[1], JSCHED, jmb, JREGISTRY, JError)


def _wait(cond, what, timeout=10.0):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, what
        time.sleep(0.005)


class _Pile:
    """Statements dispatched concurrently behind a held device slot:
    member 0 queues first (the leader), then each follower parks before
    the next starts, so member k is lane k of the batch."""

    def __init__(self, tier, sqls, mb_max=N_MEMBERS, park=True,
                 sessions=None, **extra):
        self.tier = tier
        self.sqls = sqls
        self.sessions = sessions or [tier.session(mb_max, **extra)
                                     for _ in sqls]
        # solo runs warm the program and the resident table, and are the
        # exactness oracle
        self.oracle = [s.query(q).rows for s, q in zip(self.sessions, sqls)]
        self.results = {}
        self.threads = [threading.Thread(target=self._worker, args=(i,),
                                         daemon=True)
                        for i in range(len(sqls))]
        self._released = False
        tier.sched.acquire(conn_id=-1)
        try:
            base = tier.mb.queued_members()
            self.threads[0].start()
            _wait(lambda: tier.sched.queue_depth() >= 2, "leader never "
                  "queued")
            for i in range(1, len(sqls)):
                self.threads[i].start()
                if park:
                    _wait(lambda: tier.mb.queued_members() >= base + i,
                          f"follower {i} never parked")
                else:
                    _wait(lambda: tier.sched.queue_depth() >= i + 2,
                          f"statement {i} never queued")
        except BaseException:
            self.release()
            raise

    def _worker(self, i):
        try:
            self.results[i] = self.sessions[i].query(self.sqls[i]).rows
        except self.tier.err as e:
            self.results[i] = ("error", getattr(e, "code", None))

    def release(self):
        if not self._released:
            self._released = True
            self.tier.sched.release()

    def join(self):
        self.release()
        for t in self.threads:
            t.join(timeout=60.0)
        assert not any(t.is_alive() for t in self.threads)
        return [self.results[i] for i in range(len(self.sqls))]

    def launches(self, members=None):
        idx = range(len(self.sqls)) if members is None else members
        return sum(self.sessions[i].last_guard.phases.programs_launched
                   for i in idx)


def _batched(tier, sqls, **kw):
    """→ (rows per member, solo oracle, summed launches, batches and
    members counter deltas)."""
    b0 = tier.counter("tidb_tpu_microbatch_batches_total")
    m0 = tier.counter("tidb_tpu_microbatch_members_total")
    pile = _Pile(tier, sqls, **kw)
    rows = pile.join()
    return (rows, pile.oracle, pile.launches(),
            tier.counter("tidb_tpu_microbatch_batches_total") - b0,
            tier.counter("tidb_tpu_microbatch_members_total") - m0)


def _same(a, b):
    assert sorted(a, key=str) == sorted(b, key=str), (a, b)


def test_eight_point_reads_one_launch_match_jax(port, ref, tmp_path):
    """8 queued same-digest point reads → ONE launch summed, one
    `batched:` compute span in the trace; every member equals its solo
    run and the JAX engine's rows for the same batch, whose own batch
    counter rises."""
    sqls = [_point(i) for i in range(N_MEMBERS)]
    timeline.start_global(str(tmp_path))
    try:
        rows, oracle, launches, batches, members = _batched(port, sqls)
        path = timeline.flush()
    finally:
        timeline.stop_global()
    assert rows == oracle
    assert launches == 1, f"8 coalesced point reads launched {launches}"
    assert (batches, members) == (1, N_MEMBERS)
    doc = json.loads(open(path).read())
    spans = [e for e in doc["traceEvents"]
             if e.get("ph") != "M" and e.get("cat") == "compute"
             and str((e.get("args") or {}).get("sig", ""))
             .startswith("batched:")]
    assert len(spans) == 1, f"batched spans: {len(spans)}"
    jrows, joracle, jlaunches, jbatches, _ = _batched(ref, sqls)
    assert jbatches == 1 and jlaunches == 1
    assert jrows == joracle == rows


def test_multi_slab_one_launch_per_surviving_slab(port, ref):
    """1024-row slabs over the shuffled table: all four survive every
    point read, and the batch launches once per slab."""
    sqls = [f"SELECT v FROM mbr WHERE k = {40 + i}" for i in range(5)]
    rows, oracle, launches, batches, members = _batched(
        port, sqls, tidb_tpu_max_slab_rows=1024)
    assert rows == oracle
    assert launches == 4 and (batches, members) == (1, 5)
    jrows, _, jlaunches, jbatches, _ = _batched(
        ref, sqls, tidb_tpu_max_slab_rows=1024)
    assert jbatches == 1 and jlaunches == 4
    assert jrows == rows


def test_solo_leader_takes_the_individual_path(port):
    b0 = port.counter("tidb_tpu_microbatch_batches_total")
    m0 = port.counter("tidb_tpu_microbatch_members_total")
    s = port.session()
    assert s.query(_point(3)).rows == [(43 * 43,)]
    assert s.last_guard.phases.programs_launched == 1
    assert port.counter("tidb_tpu_microbatch_batches_total") == b0
    assert port.counter("tidb_tpu_microbatch_members_total") == m0


@pytest.mark.parametrize("mb_max", [0, 1])
def test_flag_off_runs_each_statement_alone(port, mb_max):
    """tidb_tpu_microbatch_max 0 (literal-baked programs) and 1
    (parametrized, never batched): every queued statement launches its
    own program and the counters stay."""
    cols = ["v, k", "k, v, v"][mb_max]
    sqls = [f"SELECT {cols} FROM mb WHERE k = {60 + i}" for i in range(4)]
    rows, oracle, launches, batches, members = _batched(
        port, sqls, mb_max=mb_max, park=False)
    assert rows == oracle
    assert launches == 4 and (batches, members) == (0, 0)
    proj = ["Proj([col#1(v), col#0(k)])",
            "Proj([col#0(k), col#1(v), col#1(v)])"][mb_max]
    sigs = [k for k in fragment._COMPILE_CACHE if proj in k]
    want = "lit(" if mb_max == 0 else "param("
    assert any(want in k for k in sigs), sigs


def test_kill_and_deadline_isolation_inside_microbatch(port):
    """One parked member KILLed and one deadline-expired: each surfaces
    its own typed error (1317 / 3024) and leaves the batch; the six
    survivors still coalesce into one launch, exactly."""
    m0 = port.counter("tidb_tpu_microbatch_members_total")
    pile = _Pile(port, [_point(i) for i in range(N_MEMBERS)])
    try:
        killer = port.session()
        pile.sessions[5].last_guard.deadline = time.monotonic()
        killer.execute(f"KILL QUERY {pile.sessions[3].conn_id}")
        _wait(lambda: isinstance(pile.results.get(3), tuple)
              and isinstance(pile.results.get(5), tuple),
              f"victims never errored: {pile.results}")
    finally:
        pile.release()
    rows = pile.join()
    assert rows[3] == ("error", 1317), rows[3]
    assert rows[5] == ("error", 3024), rows[5]
    survivors = [i for i in range(N_MEMBERS) if i not in (3, 5)]
    for i in survivors:
        assert rows[i] == pile.oracle[i], f"member {i}: {rows[i]}"
    assert pile.launches(survivors) == 1
    assert port.counter("tidb_tpu_microbatch_members_total") \
        == m0 + len(survivors)
    # the victims' sessions still serve afterwards
    assert pile.sessions[3].query(_point(3)).rows == pile.oracle[3]


def test_demux_fault_degrades_to_warned_individual(port):
    """The microbatch-demux failpoint: every member still gets exactly
    its own rows through its individual rerun, the leader alone carries
    a 1105 warning, and the fallbacks counter advances."""
    f0 = port.counter("tidb_tpu_microbatch_fallbacks_total")
    pile = _Pile(port, [_point(i) for i in range(N_MEMBERS)])
    try:
        failpoint.enable("microbatch-demux",
                         raise_=RuntimeError("test: demux fault"), times=1)
        rows = pile.join()
        assert failpoint.hits("microbatch-demux") > 0, \
            "batch never reached demux"
    finally:
        pile.release()
        failpoint.disable("microbatch-demux")
    assert rows == pile.oracle
    assert port.counter("tidb_tpu_microbatch_fallbacks_total") == f0 + 1
    warned = [s for s in pile.sessions
              if any(w[1] == 1105 and "micro-batch" in w[2]
                     for w in s.warnings)]
    assert len(warned) == 1, f"exactly the leader warns: {len(warned)}"


def test_member_with_mismatched_preps_is_demoted(port, monkeypatch):
    """A member whose host preparation differs in structure is demoted:
    it reruns alone (exact), the other seven coalesce."""
    real = fragment.collect_chain_preps
    odd = threading.local()

    def preps(chain, dicts):
        vals = real(chain, dicts)
        if getattr(odd, "on", False):
            vals = vals + [np.int64(0)]     # ignored by the program
        return vals

    sqls = [_point(i) for i in range(N_MEMBERS)]
    monkeypatch.setattr(fragment, "collect_chain_preps", preps)
    sessions = [port.session() for _ in sqls]
    m0 = port.counter("tidb_tpu_microbatch_members_total")
    orig_query = sessions[4].query

    def marked(sql):
        odd.on = True
        try:
            return orig_query(sql)
        finally:
            odd.on = False

    sessions[4].query = marked
    pile = _Pile(port, sqls, sessions=sessions)
    rows = pile.join()
    assert rows == pile.oracle
    assert pile.launches() == 2      # the batch, and member 4 alone
    assert port.counter("tidb_tpu_microbatch_members_total") == m0 + 7


def test_structure_match_rule():
    stacked = {0}
    a = [np.asarray(5, np.int64), (np.int32(1), np.int32(2), np.bool_(1))]
    assert mb._structure_matches(a, [np.asarray(9, np.int64), a[1]],
                                 stacked)
    # a stacked value of another dtype, an unstacked value that differs,
    # and another structure do not batch
    assert not mb._structure_matches(a, [np.asarray(9, np.int32), a[1]],
                                     stacked)
    assert not mb._structure_matches(
        a, [a[0], (np.int32(1), np.int32(3), np.bool_(1))], stacked)
    assert not mb._structure_matches(a, [a[0], a[1][:2]], stacked)
    assert not mb._structure_matches(a, a + [None], stacked)


def test_a_write_changes_the_batch_key(port, monkeypatch):
    """The batch key carries the table version: a statement after an
    INSERT never joins a batch keyed on the rows before it."""
    keys = []
    real = mb.batch_key

    def spy(guard, sig, ent, slab_ids):
        keys.append(real(guard, sig, ent, slab_ids))
        return keys[-1]

    monkeypatch.setattr(mb, "batch_key", spy)
    s = port.session()
    s.execute("CREATE TABLE mbw (k BIGINT, v BIGINT)")
    s.execute("INSERT INTO mbw VALUES " +
              ", ".join(f"({i}, {i})" for i in range(64)))
    # a cold first touch streams its upload and never batches: the warm
    # run takes the rendezvous
    for _ in range(2):
        assert s.query("SELECT v FROM mbw WHERE k = 7").rows == [(7,)]
    before = list(keys)
    s.execute("INSERT INTO mbw VALUES (7, 700)")
    for _ in range(2):
        assert sorted(s.query("SELECT v FROM mbw WHERE k = 7").rows) == \
            [(7,), (700,)]
    assert before and len(keys) > len(before)
    assert before[-1][0] == keys[-1][0]         # one digest
    # (id of the TableData, delta version): the table version moved
    assert before[-1][2:4] != keys[-1][2:4]


#: (WHERE, what the port's parametrizer does): "all" lifts every literal
#: as the reference does; "none" lifts nothing; otherwise the literal the
#: port keeps, where the reference lifts it too (a comparison under a
#: function that is not a logical op)
PARAM_SHAPES = [
    ("k = 41", "all"),
    ("k >= 40 AND k < 44", "all"),
    ("k < 3 OR k > 250", "all"),
    ("NOT (k <> 45)", "all"),
    ("(k > 100) XOR (v > 10000)", "all"),
    ("k BETWEEN 40 AND 43 AND NOT (v = 1681)", "all"),
    ("f > 5.5 AND d < 60.5", "all"),
    ("k IN (40, 41)", "none"),
    ("IF(k = 41, v, 0) > 0", "lit(41)"),
    ("CASE WHEN k < 45 THEN v ELSE 0 END > 1700 AND k > 40", "lit(45)"),
]


def _chain(s, parse, linearize, sql):
    """The linear chain of the statement's device fragment."""
    node = s._plan(parse(sql)[0])
    while type(node).__name__ != "PhysTpuFragment":
        node = node.children[0]
    return linearize(node.root)


def _filters(chain):
    return [repr(f) for node in chain
            for f in (getattr(node, "filters", None) or
                      getattr(node, "conditions", None) or [])]


@pytest.mark.parametrize("where,lifted", PARAM_SHAPES)
def test_parametrization_matches_reference(engines, port, where, lifted):
    """The port lifts the reference's literals under logical ops (the
    parametrized filters print alike), and keeps a comparison's literal
    under any other function, where the reference lifts it; the rows
    of the parametrized statement equal the literal-baked ones."""
    from tidb_tpu.parser import parse as jparse
    from tidb_tpu_torch.parser import parse as tparse
    sql = f"SELECT k, v FROM mb WHERE {where}"
    ts = port.session()
    js = engines[1].new_session()
    js.vars["tidb_tpu_engine"] = "on"
    js.vars["tidb_tpu_row_threshold"] = 1
    tchain = _chain(ts, tparse, fragment._linearize, sql)
    jchain = _chain(js, jparse, jfragment._linearize, sql)
    tp = fragment._parametrize_chain(tchain)
    jp = jfragment._parametrize_chain(jchain)
    if lifted == "all":
        assert tp is not None and jp is not None
        assert _filters(tp) == _filters(jp)
        assert "lit(" not in "".join(_filters(tp))
    elif lifted == "none":
        assert tp is None and jp is None
    else:
        assert tp is not None and "param(" in "".join(_filters(tp))
        assert lifted in "".join(_filters(tp))
        assert lifted not in "".join(_filters(jp))
    rows = ts.query(sql).rows
    assert ts.last_guard.phases.programs_launched >= 1
    off = port.session(mb_max=0)
    _same(rows, off.query(sql).rows)
    host = port.session(tidb_tpu_engine="off")
    _same(rows, host.query(sql).rows)


#: every admitted logical op over a batched parameter, 3 members each
LOGIC_BATCHES = {
    "and": "k >= {a} AND k < {b}",
    "or": "k = {a} OR k = {b}",
    "not": "NOT (k <> {a})",
    "xor": "(k < {b}) XOR (k < {a})",
    "nested": "(k = {a} OR NOT (k <> {b})) AND v >= 0",
}


@pytest.mark.parametrize("shape", sorted(LOGIC_BATCHES))
def test_every_logical_op_batches(port, ref, shape):
    sqls = [f"SELECT k, v FROM mb WHERE " +
            LOGIC_BATCHES[shape].format(a=40 + 7 * i, b=43 + 7 * i)
            for i in range(3)]
    rows, oracle, launches, batches, members = _batched(port, sqls)
    assert rows == oracle and all(rows)
    assert launches == 1 and (batches, members) == (1, 3)
    jrows, _, _, jbatches, _ = _batched(ref, sqls)
    assert jbatches == 1
    for r, j in zip(rows, jrows):
        _same(r, j)


@pytest.mark.parametrize("sql", [
    "SELECT k, d FROM mb WHERE d = {i}.{i:02d}",
    "SELECT k, t FROM mb WHERE t = '2020-{m:02d}-{day:02d}'",
    "SELECT k FROM mb WHERE d >= {i}.5 AND t < '2020-{m:02d}-15'",
])
def test_decimal_and_date_parameters(port, ref, sql):
    """DECIMAL and DATE literals ride as parameters encoded with the
    constant's own type (scale, days): the batched comparison sees what
    the literal would."""
    sqls = [sql.format(i=40 + i, m=1 + (40 + i) % 12, day=1 + (40 + i) % 28)
            for i in range(4)]
    rows, oracle, launches, batches, members = _batched(port, sqls)
    assert rows == oracle and all(rows)
    assert launches == 1 and (batches, members) == (1, 4)
    jrows, _, _, jbatches, _ = _batched(ref, sqls)
    assert jbatches == 1
    for r, j in zip(rows, jrows):
        _same(r, j)


def _capture(monkeypatch, module, frag_module, store):
    """Record the batched partial's outputs and the demux's chunks of one
    package's next batch."""
    real_get = frag_module.get_batched_program
    real_demux = module._demux

    def get(*a, **k):
        prog = real_get(*a, **k)

        class Spy:
            def partial(self, *pa, **pk):
                out = prog.partial(*pa, **pk)
                store.setdefault("partials", []).append(out)
                return out
        return Spy()

    def demux(*a, **k):
        out = real_demux(*a, **k)
        store["chunks"] = out
        return out

    monkeypatch.setattr(frag_module, "get_batched_program", get)
    monkeypatch.setattr(module, "_demux", demux)


@pytest.mark.parametrize("b", [2, 3, 8])
def test_batched_partial_and_demux_match_reference(port, ref, monkeypatch,
                                                   b):
    """The port's batched partial gives the reference's live mask lane
    by lane (the reference pads to a power of two: its real lanes are
    compared); member_compact_plain equals np.nonzero of each of the
    reference's lanes; the demuxed Chunks are the reference's."""
    sqls = [f"SELECT v, d, t FROM mb WHERE k >= {40 + 3 * i} AND "
            f"k < {44 + 3 * i}" for i in range(b)]
    got, want = {}, {}
    _capture(monkeypatch, mb, fragment, got)
    _capture(monkeypatch, jmb, jfragment, want)
    _batched(port, sqls)
    _batched(ref, sqls)
    (pout,), (jout,) = got["partials"], want["partials"]
    jlive = np.asarray(jout["live"])[:b]
    plive = pout["live"].numpy()
    assert plive.shape == jlive.shape and (plive == jlive).all()
    counts, offsets, ids = member_compact_plain(torch.from_numpy(jlive.copy()))
    for k in range(b):
        nz = np.nonzero(jlive[k])[0]
        assert int(counts[k]) == len(nz)
        assert (ids[offsets[k]:offsets[k + 1]].numpy() == nz).all()
    assert len(got["chunks"]) == b
    for pc, jc in zip(got["chunks"], want["chunks"][:b]):
        assert pc.rows() == jc.rows()


@pytest.mark.parametrize("b,cap", [(1, 0), (1, 1), (3, 1000), (16, 257),
                                   (2, 4096)])
def test_member_compact_plain_matches_nonzero(b, cap):
    rng = np.random.default_rng(b * 1000 + cap)
    for p in (0.0, 1.0, 0.3, 0.01):
        live = rng.random((b, cap)) < p
        counts, offsets, ids = member_compact_plain(torch.from_numpy(live))
        want = [np.nonzero(live[k])[0] for k in range(b)]
        assert counts.dtype == torch.int64 and ids.dtype == torch.int32
        assert counts.tolist() == [len(w) for w in want]
        assert offsets.tolist() == [0] + np.cumsum(
            [len(w) for w in want]).tolist()
        assert ids.tolist() == np.concatenate(
            want + [np.zeros(0, np.int64)]).tolist()


@pytest.mark.parametrize("b", [2, 5, 16])
def test_member_compact_plain_uneven_members(b):
    """Members of unequal fill (empty, full, dense, sparse, one live row
    at the last member's last row) against np.nonzero of each."""
    rng = np.random.default_rng(500 + b)
    cap = 1027 + b
    fills = [0.0, 1.0, 0.5, 0.002, 0.9, 0.0, 0.03]
    live = np.stack([rng.random(cap) < fills[k % len(fills)]
                     for k in range(b)])
    live[-1] = False
    live[-1, cap - 1] = True
    counts, offsets, ids = member_compact_plain(torch.from_numpy(live))
    want = [np.nonzero(live[k])[0] for k in range(b)]
    assert counts.tolist() == [len(w) for w in want]
    assert offsets.tolist() == [0] + np.cumsum([len(w) for w in want]).tolist()
    assert ids.tolist() == np.concatenate(want).tolist()
    assert ids[-1] == cap - 1


def test_member_compact_scratch_bytes():
    """K22's scratch: a 16-byte counter and a 4-byte flag a tile (rounded
    to 16 bytes), then three int64 slots a tile and two a round, for
    ceil((cap + 15) / TILE) tiles a member (at least one tile)."""
    assert TILE == 131_072
    for b in (1, 3, 16):
        for cap in (0, 1, TILE - 16, TILE - 15, TILE, TILE + 1,
                    8_388_608, 8_388_609):
            tiles = max(1, b * -(-(cap + 15) // TILE))
            assert scratch_bytes(b, cap) == \
                16 + -(-4 * tiles // 16) * 16 + 152 * tiles, (b, cap)
    assert scratch_bytes(1, 0) == 184
    assert scratch_bytes(1, TILE - 15) == 184
    assert scratch_bytes(1, TILE - 14) == 336
    assert scratch_bytes(16, 8_388_608) == 162_256

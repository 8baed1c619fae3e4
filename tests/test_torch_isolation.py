"""The port stands alone: tidb_tpu_torch and chip_smoke.py import neither
JAX nor anything of the JAX package, and the Engine never picks a device
quietly."""

import os
import re
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT = re.compile(r"^\s*(?:from|import)\s+(?:jax|jaxlib|tidb_tpu)\b",
                     re.M)
_DYNAMIC = re.compile(r"(?:import_module|__import__)\(\s*['\"]"
                      r"(?:jax|jaxlib|tidb_tpu)\b")


def _port_sources():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _dirs, files in os.walk(os.path.join(ROOT, "tidb_tpu_torch")):
        out.extend(os.path.join(d, f) for f in files if f.endswith(".py"))
    return out


def test_sources_import_no_jax_and_no_jax_package():
    srcs = _port_sources()
    assert len(srcs) > 50
    for path in srcs:
        with open(path) as f:
            text = f.read()
        assert not _IMPORT.search(text), path
        assert not _DYNAMIC.search(text), path


def test_import_and_query_load_no_jax_module():
    code = (
        "import sys\n"
        "import tidb_tpu_torch\n"
        "from tidb_tpu_torch.session import Engine\n"
        "s = Engine(device='cpu').new_session()\n"
        "s.execute('CREATE TABLE t (a BIGINT, b DECIMAL(10,2), c CHAR(2))')\n"
        "s.execute('INSERT INTO t VALUES ' + ','.join(\n"
        "    f'({i % 5}, {i}.25, \\'{\"xy\"[i % 2]}\\')' for i in range(300)))\n"
        "s.vars['tidb_tpu_engine'] = 'on'\n"
        "s.vars['tidb_tpu_row_threshold'] = 1\n"
        "s.vars['tidb_tpu_strict'] = 1\n"
        "rows = s.query('SELECT c, COUNT(*), SUM(b) FROM t WHERE a < 4 '\n"
        "               'GROUP BY c ORDER BY c').rows\n"
        "assert len(rows) == 2, rows\n"
        "s.execute('CREATE TABLE u (a BIGINT PRIMARY KEY, d CHAR(3))')\n"
        "s.execute('INSERT INTO u VALUES (0, \\'p\\'), (1, \\'q\\'), '\n"
        "          '(2, \\'p\\'), (3, \\'r\\')')\n"
        "rows = s.query('SELECT d, COUNT(*), SUM(b) FROM t JOIN u '\n"
        "               'ON t.a = u.a GROUP BY d ORDER BY d').rows\n"
        "assert len(rows) == 3, rows\n"
        "s.execute('CREATE TABLE v (k DOUBLE, e BIGINT)')\n"
        "s.execute('INSERT INTO v VALUES (0.5, 1), (1.5, 2), (3.5, 3)')\n"
        "rows = s.query('SELECT e, COUNT(*) FROM t JOIN v '\n"
        "               'ON t.a + 0.5 = v.k GROUP BY e ORDER BY e').rows\n"
        "assert len(rows) == 3, rows\n"
        "rows = s.query('SELECT t.a, d FROM t JOIN u ON t.a = u.a '\n"
        "               'ORDER BY b DESC, t.a LIMIT 4').rows\n"
        "assert len(rows) == 4, rows\n"
        "rows = s.query('SELECT t.a, d FROM t JOIN u ON t.a = u.a '\n"
        "               'LIMIT 7').rows\n"
        "assert len(rows) == 7, rows\n"
        "rows = s.query('SELECT a, c, ROW_NUMBER() OVER (PARTITION BY c '\n"
        "               'ORDER BY b), SUM(b) OVER (PARTITION BY a ORDER BY '\n"
        "               'b ROWS BETWEEN 2 PRECEDING AND CURRENT ROW) '\n"
        "               'FROM t').rows\n"
        "assert len(rows) == 300, len(rows)\n"
        "rows = s.query('SELECT d, n, RANK() OVER (ORDER BY n DESC) FROM '\n"
        "               '(SELECT d, COUNT(*) AS n FROM t JOIN u ON '\n"
        "               't.a = u.a GROUP BY d) x').rows\n"
        "assert len(rows) == 3, rows\n"
        "s.execute('INSERT INTO t VALUES (1, 2.25, \\'x\\')')\n"
        "rows = s.query('SELECT c, COUNT(*), SUM(b) FROM t WHERE a < 4 '\n"
        "               'GROUP BY c ORDER BY c').rows\n"
        "assert len(rows) == 2, rows\n"
        "import tidb_tpu_torch.executor.delta as D\n"
        "from tidb_tpu_torch.executor import device_cache as DC\n"
        "assert any(e.is_delta for e in DC._CACHE.values())\n"
        "s.execute('CREATE TABLE w (e DATE, t DATETIME)')\n"
        "s.execute('INSERT INTO w VALUES ' + ','.join(\n"
        "    f'(\\'2021-{1 + i % 12:02d}-{1 + i % 28:02d}\\', '\n"
        "    f'\\'2020-02-29 {i % 24:02d}:30:00\\')' for i in range(300)))\n"
        "q = ('SELECT QUARTER(e), COUNT(*), MAX(LAST_DAY(e)), SUM(HOUR(t)) '\n"
        "     'FROM w WHERE DATE_ADD(e, INTERVAL 1 MONTH) > \\'2021-03-01\\' '\n"
        "     'GROUP BY QUARTER(e) ORDER BY QUARTER(e)')\n"
        "assert 'TpuFragment' in str(s.query('EXPLAIN ' + q).rows)\n"
        "rows = s.query(q).rows\n"
        "assert len(rows) == 4, rows\n"
        "import tidb_tpu_torch.executor.tree_fragment\n"
        "import tidb_tpu_torch.executor.window\n"
        "import tidb_tpu_torch.ops.factorize\n"
        "import tidb_tpu_torch.ops.gather\n"
        "import tidb_tpu_torch.ops.join\n"
        "import tidb_tpu_torch.ops.window\n"
        "import tidb_tpu_torch.ops.calendar\n"
        "import tidb_tpu_torch.ops.compact\n"
        "import tidb_tpu_torch.executor.microbatch\n"
        "s.vars['tidb_tpu_dist_devices'] = 4\n"
        "for q in ('SELECT c, COUNT(*), SUM(b) FROM t GROUP BY c',\n"
        "          'SELECT d, COUNT(*) FROM t JOIN u ON t.a = u.a '\n"
        "          'GROUP BY d', 'SELECT c, COUNT(DISTINCT a) FROM t '\n"
        "          'GROUP BY c'):\n"
        "    assert 'shards:4' in str(s.query('EXPLAIN ' + q).rows), q\n"
        "    assert s.query(q).rows\n"
        "s.vars['tidb_tpu_dist_staged'] = 'off'\n"
        "s.vars['tidb_tpu_dist_staged_exchange'] = 'off'\n"
        "q = ('SELECT d, COUNT(*), SUM(b) FROM t JOIN u ON t.a = u.a '\n"
        "     'GROUP BY d ORDER BY d')\n"
        "assert 'shards:4' in str(s.query('EXPLAIN ' + q).rows), q\n"
        "assert len(s.query(q).rows) == 3\n"
        "import tidb_tpu_torch.executor.dist_fragment\n"
        "import tidb_tpu_torch.parallel.collective\n"
        "import tidb_tpu_torch.parallel.dist_query\n"
        "import tidb_tpu_torch.ops.partition\n"
        "import tidb_tpu_torch.ops.rank_gather\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'tidb_tpu' or m.startswith('tidb_tpu.')]\n"
        "print('BAD', bad)\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert "BAD []" in res.stdout, res.stdout


def test_every_kernel_source_is_built_and_counted():
    """Every csrc/*.cu is in cuda_kernels.SOURCES (so build_all compiles
    it), and the kernels of this slice have launch counters."""
    from tidb_tpu_torch.ops import cuda_kernels as ck
    srcs = {f[:-3] for f in os.listdir(ck.CSRC) if f.endswith(".cu")}
    assert srcs == set(ck.SOURCES)
    assert len(ck.COUNTERS) == 27 and len(set(ck.COUNTERS)) == 27
    for name in ("distinct_pairs", "rollup_tile", "gather_columns",
                 "delta_merge", "civil_date", "dict_lut", "member_compact",
                 "hash_partition", "rank_gather"):
        assert name in ck.SOURCES and name in ck.COUNTERS
    # hash_partition.cu also holds K24 and K26
    for name in ("rank_exchange", "hash_dest"):
        assert name in ck.COUNTERS
    # sorted_groups.cu's K10 has two entries, each with its counter
    for name in ("group_ids", "group_ids_words"):
        assert name in ck.COUNTERS
    for fn in ("tt_pair_word", "tt_rollup_tile",
               "tt_rollup_levels", "tt_gather_columns", "tt_delta_perm",
               "tt_delta_repack", "tt_civil_part", "tt_date_add_months",
               "tt_dict_lut", "tt_dict_lut_smem_bytes", "tt_member_count",
               "tt_member_scatter", "tt_hash_partition", "tt_rank_exchange",
               "tt_rank_gather", "tt_hash_dest", "tt_radix_scratch_words",
               "tt_group_ids_words", "tt_group_words_scratch"):
        assert fn in ck._SIGNATURES


def test_default_engine_without_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: Engine() rightly succeeds")
    from tidb_tpu_torch.ops.torch_env import DeviceUnavailable
    from tidb_tpu_torch.session import Engine
    with pytest.raises(DeviceUnavailable, match="cuda"):
        Engine()


def test_cpu_engine_names_its_device():
    from tidb_tpu_torch.session import Engine
    eng = Engine(device="cpu")
    assert eng.device == torch.device("cpu")
    rows = eng.new_session().query(
        "SELECT * FROM information_schema.engines").rows
    assert any("torch fragments (cpu" in str(r) for r in rows), rows


def test_unknown_device_kind_raises():
    from tidb_tpu_torch.ops.torch_env import DeviceUnavailable
    from tidb_tpu_torch.session import Engine
    with pytest.raises(DeviceUnavailable):
        Engine(device="mps")

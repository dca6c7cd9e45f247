"""The port's main path on the CPU: all 22 TPC-H queries through
``repro_torch`` at SF 0.002, held to the row-at-a-time reference and to
the JAX engine on the same tables; the string queries with the packed
device-string path on and off; frames carried across from the JAX
package; no kernel launch on CPU tensors; and the port's import purity
(no ``jax``, nothing of ``repro``)."""
import ast
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import jax

from repro.core import oracle as orc
from repro.core.config import CONFIG as J_CONFIG
from repro.queries import tpch_frames as j_queries
from repro.queries import tpch_numpy
from repro_torch.core import TensorFrame
from repro_torch.core.config import CONFIG
from repro_torch.data import tpch
from repro_torch.kernels import ops
from repro_torch.queries import tpch_frames as QF

SF = 0.002  # must match the shared tpch_small fixture (conftest.py)
ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
# the JAX suite's fast subset (tests/test_tpch_queries.py) plus q16
JAX_ENGINE_QUERIES = ["q1", "q4", "q6", "q13", "q16", "q22"]


@pytest.fixture(autouse=True, scope="module")
def _x64_on(_x64_policy):
    # the conftest policy turns x64 off for this file's prefix; the
    # reference engine needs exact int64 keys
    jax.config.update("jax_enable_x64", True)
    yield


@pytest.fixture(scope="module")
def data(tpch_small):
    tables, jax_frames = tpch_small
    return tables, jax_frames, tpch.as_frames(tables, device="cpu")


def _rows_to_odf(rows):
    if not rows:
        return {}
    return {k: [r[k] for r in rows] for k in rows[0]}


def _assert_matches_reference(qname, got, expect):
    """The comparison of tests/test_tpch_queries.py: rel 1e-9 for
    scalar results, rtol 1e-8 for frames compared as sorted rows."""
    if qname in QF.SCALAR_QUERIES:
        assert set(got) == set(expect)
        for k in got:
            assert got[k] == pytest.approx(expect[k], rel=1e-9), (k, got, expect)
        return
    godf = orc.frame_to_odf(got)
    eodf = _rows_to_odf(expect)
    if not eodf:
        assert all(len(v) == 0 for v in godf.values()), f"{qname}: expected empty"
        return
    orc.assert_odf_equal(godf, eodf, sort=True, rtol=1e-8)


@pytest.mark.parametrize("qname", sorted(QF.ALL, key=lambda s: int(s[1:])))
def test_port_query_matches_reference(data, qname):
    tables, _, frames = data
    got = QF.ALL[qname](frames, sf=SF, apply_limit=False)
    _assert_matches_reference(qname, got, tpch_numpy.ALL[qname](tables, sf=SF))


@pytest.mark.parametrize("qname", JAX_ENGINE_QUERIES)
def test_port_query_matches_jax_engine(data, qname):
    """Same tables, same plans: the port gives the JAX engine's rows in
    the JAX engine's order (floats to rtol 1e-12: both add in row order
    on the CPU)."""
    _, jax_frames, frames = data
    got = QF.ALL[qname](frames, sf=SF, apply_limit=False)
    want = j_queries.ALL[qname](jax_frames, sf=SF, apply_limit=False)
    if qname in QF.SCALAR_QUERIES:
        assert got.keys() == want.keys()
        for k in got:
            assert got[k] == pytest.approx(want[k], rel=1e-12)
        return
    assert got.column_names == want.column_names
    orc.assert_odf_equal(orc.frame_to_odf(got), orc.frame_to_odf(want), sort=False, rtol=1e-12)


@pytest.mark.parametrize("device_strings", [False, True], ids=["dict-lut", "device-path"])
@pytest.mark.parametrize("qname", ["q9", "q13", "q16"])
def test_string_queries_with_device_strings(data, qname, device_strings):
    tables, _, frames = data
    saved = CONFIG.use_device_strings
    CONFIG.use_device_strings = device_strings
    try:
        got = QF.ALL[qname](frames, sf=SF, apply_limit=False)
    finally:
        CONFIG.use_device_strings = saved
    _assert_matches_reference(qname, got, tpch_numpy.ALL[qname](tables, sf=SF))


def test_cpu_main_path_launches_no_kernel(data):
    _, _, frames = data
    ops.reset_launches()
    for qname in ("q1", "q13", "q18"):
        QF.ALL[qname](frames, sf=SF, apply_limit=False)
    assert ops.LAUNCHES == {name: 0 for name in (
        "segment_sum", "substr_find", "wkv6", "wkv6_chunked", "flash_attention_sm90",
        "flash_attention_f32_sm90", "hash32x2", "flash_attention_bwd_sm90",
        "flash_attention_bwd_f32_sm90", "wkv6_bwd")}


def _jax_state(frame):
    """The eager host representation of a (materialized) JAX frame."""
    frame.materialize()
    return {
        "nrows": frame.nrows,
        "itensor": np.asarray(frame.itensor),
        "ftensor": np.asarray(frame.ftensor),
        "columns": [(m.name, m.kind, m.slot, m.dictionary) for m in frame.columns.values()],
        "offloaded": {
            name: (oc.values, np.asarray(oc.idx)) for name, oc in frame.offloaded.items()
        },
        "stats": {k: dataclasses.asdict(v) for k, v in frame._stats.items()},
    }


def test_frames_carried_across_from_jax_give_the_same_results(data):
    tables, jax_frames, _ = data
    assert J_CONFIG.late_materialization  # the JAX fixture frames are eager
    carried = {
        name: TensorFrame.from_state(_jax_state(f), device="cpu") for name, f in jax_frames.items()
    }
    for name, f in jax_frames.items():
        got, want = carried[name].to_dict(), f.to_dict()
        assert list(got) == list(want), name
        for c in want:
            np.testing.assert_array_equal(got[c], want[c], err_msg=f"{name}.{c}")
    for qname in ("q1", "q13", "q16", "q22"):
        got = QF.ALL[qname](carried, sf=SF, apply_limit=False)
        _assert_matches_reference(qname, got, tpch_numpy.ALL[qname](tables, sf=SF))


# ----------------------------------------------------------------------
# import purity
# ----------------------------------------------------------------------
def _forbidden(module: str) -> bool:
    return module.split(".")[0] in ("jax", "jaxlib", "repro")


#: modules the scans below must reach by name (out of core, SQL serving
#: and the capped runner among them)
NAMED_MODULES = (
    "queries/tpch_frames.py", "queries/tpch_sql.py", "sql/lower.py",
    "sql/analyze.py", "sql/udf.py", "sql/compile.py", "serve/engine.py",
    "core/pipeline.py", "sql/stream.py", "serve/sql.py",
    "serve/admission.py", "serve/stats.py", "launch/run_capped.py",
    "dist/dframe.py", "dist/compression.py", "dist/pipeline.py", "launch/mesh.py",
    "models/partition.py", "launch/shapes.py", "launch/dryrun.py", "launch/hlo_analysis.py",
    "kernels/sharded.py",
    # the row-at-a-time references and the example twins
    "queries/tpch_numpy.py", "queries/tpcds_numpy.py", "examples/__init__.py",
    "examples/quickstart.py", "examples/sql_quickstart.py", "examples/tpch_analytics.py",
    "examples/serve_lm.py", "examples/train_lm.py", "examples/distributed_groupby.py",
)


def test_port_and_chip_smoke_import_no_jax_and_nothing_of_repro():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 15
    for rel in NAMED_MODULES:
        assert PORT / rel in files, rel
    bad = []
    for path in files:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                bad += [(path.name, a.name) for a in node.names if _forbidden(a.name)]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                if _forbidden(node.module or ""):
                    bad.append((path.name, node.module))
    assert not bad, bad


def test_importing_the_port_loads_neither_jax_nor_repro():
    names = ["repro_torch." + rel[:-3].replace("/", ".").removesuffix(".__init__")
             for rel in NAMED_MODULES]
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "loaded = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro')]\n"
        "assert not loaded, loaded\n"
        "import torch.distributed as dist\n"
        "assert not dist.is_initialized(), 'importing the port made a process group'\n"
        f"for name in {names!r}:\n"
        "    assert name in sys.modules, name\n"
        "print('clean')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-c", code], env=env, capture_output=True, text=True, timeout=300
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"

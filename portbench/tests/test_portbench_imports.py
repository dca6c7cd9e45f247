"""Nothing the benchmark runs imports JAX, the JAX package (``repro``,
compared by whole top-level name: the port's ``repro_torch`` begins with
it), ``chip_smoke.py`` or the JAX package's harness under ``benchmarks/``."""
import ast
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
BANNED = {"jax", "jaxlib", "flax", "repro", "chip_smoke", "benchmarks"}


def test_no_source_imports_a_banned_module():
    for path in (ROOT / "portbench").rglob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            for n in names:
                assert n.split(".")[0] not in BANNED, (path, n)


def test_a_run_loads_no_banned_module():
    code = (
        "import sys; sys.path[:0] = [%r, %r]\n"
        "from portbench import run\n"
        "r = run.run(['--workload', 'tpch-sf1.compiled', '--seed', '3', '--seconds', '1',"
        " '--trace', '1'], device='cpu', scale=0.01)\n"
        "import portbench.control\n"
        "print(sorted({m.split('.')[0] for m in sys.modules} & %r))\n"
    ) % (str(ROOT / "src"), str(ROOT), BANNED)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_a_directory_without_the_port_gives_no_result(tmp_path):
    import shutil

    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", "tpch-sf1.compiled",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=600, cwd=tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""

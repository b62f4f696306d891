"""Nothing the benchmark runs loads JAX or the JAX package, and the
reference loads nothing of the port: module names are compared by their
whole top-level name, so ``repro_torch`` is not ``repro``."""
import ast
import subprocess
import sys

from bench.tests.cells import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module.split(".")[0]


def test_no_bench_module_imports_jax_or_the_jax_package():
    for path in sorted((ROOT / "bench").rglob("*.py")):
        assert not set(_imports(path)) & FORBIDDEN, path


def test_reference_imports_nothing_of_the_port():
    for path in sorted((ROOT / "bench" / "reference").rglob("*.py")):
        assert "repro_torch" not in set(_imports(path)), path


def test_dry_import_loads_no_jax():
    code = (
        "import sys; sys.path[:0] = [%r, %r]\n"
        "import bench.lib.harness, bench.reference.hota, bench.reference.lm\n"
        "import bench.reference.compare, bench.reference.radcom\n"
        "from bench.lib import registry\n"
        "import json\n"
        "b = registry.load_benchmark()\n"
        "for w in b['workloads']:\n"
        "    c = registry.Cell(b, w['name']); c.driver(); c.cost(); "
        "c.metric_readers()\n"
        "tops = {m.split('.')[0] for m in sys.modules}\n"
        "print(sorted(tops & set(%r)))\n" % (str(ROOT / "src"), str(ROOT),
                                         sorted(FORBIDDEN)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"

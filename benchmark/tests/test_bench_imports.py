"""What the harness and the reference import, by the top-level name of each
module compared whole: nothing is ``jax``, ``jaxlib``, ``flax`` or the JAX
package (whose name the port's begins with), and the reference imports
nothing of the port."""

from __future__ import annotations

import ast
import subprocess
import sys

from bench_tiny import BENCH, ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "rich_text_to_image_tpu"}


def _imports(path):
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
    return tops


def test_no_file_of_the_benchmark_imports_jax():
    files = [p for p in BENCH.rglob("*.py") if "tests" not in p.parts]
    assert len(files) > 10
    for p in files:
        assert not _imports(p) & FORBIDDEN, p


def test_the_reference_imports_nothing_of_the_program():
    # every file under reference/, a family's copy in a folder of its own
    # too; a relative import stays inside reference/
    ref = BENCH / "reference"
    for p in ref.rglob("*.py"):
        assert not _imports(p) & (FORBIDDEN | {"rich_text_to_image_tpu_torch",
                                               "benchmark"}), p
        depth = len(p.relative_to(ref).parts)
        assert all(n.level <= depth for n in ast.walk(ast.parse(p.read_text()))
                   if isinstance(n, ast.ImportFrom)), p


def test_a_run_loads_no_jax(tmp_path):
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from benchmark import harness, control\n"
        "from benchmark.reference import check\n"
        "import rich_text_to_image_tpu_torch.cli.sample\n"
        "import rich_text_to_image_tpu_torch.pipelines.region_sdxl\n"
        "print(harness.forbidden_modules())\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=tmp_path, timeout=300)
    assert out.returncode == 0, out.stderr
    first, tops = out.stdout.splitlines()[:2]
    assert first == "[]"
    assert "rich_text_to_image_tpu_torch" in tops
    assert "'rich_text_to_image_tpu'" not in tops


def test_forbidden_modules_compares_whole_names(monkeypatch):
    from benchmark import harness

    monkeypatch.setitem(sys.modules, "rich_text_to_image_tpu_torchx", sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jaxlib.xla", sys)
    assert harness.forbidden_modules() == ["jaxlib"]

"""Nothing under slambench/ imports JAX, jaxlib, flax or the JAX package
(top-level module names compared whole: the program's own name begins with
the JAX package's), the reference and the yardstick import nothing of the
program, nothing reads bench.py, and a run without a card prints no result."""

import ast
import json
import subprocess
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "orb_line_slam_tpu"}
PROGRAM = "orb_line_slam_tpu_torch"
# Modules that drive the program (and the drivers/ folder); everything else
# (the reference, the renderer, the checks, the metric arithmetic and
# readers) imports none of it.
DRIVERS = {"harness.py", "calibrate.py"}


def imported_top_levels(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and isinstance(node.args[0], ast.Constant):
            names.add(str(node.args[0].value).split(".")[0])
    return names


def sources():
    return sorted(p for p in BENCH.rglob("*.py") if "__pycache__" not in p.parts)


def test_no_module_imports_jax_or_the_jax_package():
    for path in sources():
        bad = imported_top_levels(path) & FORBIDDEN
        assert not bad, f"{path.relative_to(ROOT)} imports {bad}"
    assert "orb_line_slam_tpu_torch".split(".")[0] not in FORBIDDEN


def test_reference_and_yardstick_import_nothing_of_the_program():
    for path in sources():
        rel = path.relative_to(BENCH)
        if rel.name in DRIVERS or rel.parts[0] in ("tests", "drivers"):
            continue
        assert PROGRAM not in imported_top_levels(path), f"{rel} imports the program"


def test_nothing_reads_bench_py():
    for path in sources():
        if path.name == Path(__file__).name:
            continue
        assert "bench.py" not in path.read_text().replace("chip_smoke.py", ""), path


def test_loaded_modules_after_importing_the_harness():
    code = ("import sys; sys.path.insert(0, %r); import slambench.harness, slambench.check, slambench.need, "
            "slambench.render, slambench.devtrace; from slambench.harness import forbidden_modules; "
            "print(forbidden_modules())" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_a_run_without_a_card_fails_and_prints_no_result():
    """This sandbox has no card: the run must not fall back to the CPU."""
    import torch

    if torch.cuda.is_available():
        return
    out = subprocess.run([sys.executable, "slambench/run.py", "--workload", "kitti_stereo.seq", "--seed",
                          "2147483999", "--seconds", "1", "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    for line in out.stdout.splitlines():
        try:
            json.loads(line)
        except ValueError:
            continue
        raise AssertionError(f"a result was printed: {line}")

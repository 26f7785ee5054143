"""Nothing the benchmark runs imports JAX or the JAX package: no module
under ``perfbench/`` names one, compared by the whole top-level name (the
port's name begins with the JAX package's), and a run's process holds none
once its window has closed."""

import ast
import subprocess
import sys

from perfbench import harness, spec

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_no_module_imports_jax_or_the_jax_package():
    found = []
    for path in spec.BENCH_DIR.rglob("*.py"):
        for name in _imports(path):
            if name.split(".")[0] in FORBIDDEN:
                found.append((str(path.relative_to(spec.ROOT)), name))
    assert not found, found


def test_forbidden_names_are_whole_top_level_names():
    assert harness.FORBIDDEN == ("jax", "jaxlib", "flax", "repro")
    assert "repro_torch".split(".")[0] not in FORBIDDEN


def test_a_run_loads_no_jax():
    """A tiny run in a fresh process, then its sys.modules by top-level name."""
    code = (
        "import sys, time, torch\n"
        "from perfbench import harness\n"
        "from perfbench.tests import tiny\n"
        "limits = dict.fromkeys(('loss_gap', 'grad_gap', 'change_gap', 'bytes_gap'), 1.0)\n"
        "harness.run_cell(tiny.LM, tiny.lm_workload(), 5, 0.2, False, torch.device('cpu'), [], time.perf_counter(),\n"
        "                 limits=limits)\n"
        "print(sorted({n.split('.')[0] for n in sys.modules}))\n"
    )
    run = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=spec.ROOT, timeout=600,
                         env={"PYTHONPATH": f"{spec.ROOT}:{spec.ROOT / 'src'}", "PATH": "/usr/bin:/bin"})
    assert run.returncode == 0, run.stderr[-2000:]
    loaded = set(eval(run.stdout.strip().splitlines()[-1]))
    assert "repro_torch" in loaded
    assert not loaded & FORBIDDEN, loaded & FORBIDDEN

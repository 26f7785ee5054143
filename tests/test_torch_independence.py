"""The PyTorch port stands alone: importing it (or chip_smoke.py, or an
example's twin, ``examples/*_torch.py``) loads neither jax nor any module
of the JAX package, no source of them imports them, and its entry points
refuse to fall back to the CPU silently."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "src" / "repro_torch"
TWINS = sorted((ROOT / "examples").glob("*_torch.py"))
FORBIDDEN = ("jax", "jaxlib", "repro")


def _port_modules():
    mods = []
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(PORT.parent).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        mods.append(".".join(parts))
    return mods


def test_importing_the_port_loads_no_jax_and_no_reference():
    code = (
        "import importlib, sys\n"
        f"for name in {_port_modules()!r}:\n"
        "    importlib.import_module(name)\n"
        "import chip_smoke\n"
        "import importlib.util\n"
        f"for path in {[str(p) for p in TWINS]!r}:\n"
        "    spec = importlib.util.spec_from_file_location('twin', path)\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "print('BAD', bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(ROOT / "src"), str(ROOT)]))
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize(
    "path",
    sorted(str(p.relative_to(ROOT)) for p in PORT.rglob("*.py")) + ["chip_smoke.py"]
    + [str(p.relative_to(ROOT)) for p in TWINS],
)
def test_no_source_imports_jax_or_the_reference(path):
    tree = ast.parse((ROOT / path).read_text(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, f"{path}:{node.lineno} imports {name}"


def _no_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device; the check is for hosts without one")


def test_task_builders_need_an_explicit_cpu_device():
    from repro_torch.data.bilevel_tasks import (
        coefficient_tuning_task,
        hyper_representation_task,
    )

    _no_card()
    with pytest.raises(RuntimeError, match="device=\"cpu\""):
        coefficient_tuning_task(m=2, n=40, p=8, c=2)
    with pytest.raises(RuntimeError, match="device=\"cpu\""):
        hyper_representation_task(m=2, n=40, side=3, hidden=4, c=2)
    bundle = coefficient_tuning_task(m=2, n=40, p=8, c=2, device="cpu")
    assert bundle.x0.device.type == "cpu"


def test_run_needs_an_explicit_cpu_device():
    from repro_torch.core.c2dfb import C2DFBConfig, run
    from repro_torch.core.topology import ring
    from repro_torch.data.bilevel_tasks import coefficient_tuning_task

    _no_card()
    b = coefficient_tuning_task(m=3, n=60, p=8, c=2, device="cpu")
    cfg = C2DFBConfig(K=1)
    with pytest.raises(RuntimeError, match="device=\"cpu\""):
        run(b.problem, ring(3), cfg, b.x0, b.y0, T=1)
    state, mets = run(b.problem, ring(3), cfg, b.x0, b.y0, T=1, device="cpu")
    assert mets["hypergrad_norm"].shape == (1,)


def test_unsupported_devices_raise():
    from repro_torch import resolve_device
    from repro_torch.kernels.pack_residuals import pack_sparse_blocks
    from repro_torch.kernels.topk_compress import block_topk_kernel

    with pytest.raises(ValueError):
        resolve_device("meta")
    x = torch.zeros((2, 128), device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        block_topk_kernel(x, 8)
    with pytest.raises(ValueError, match="cpu or cuda"):
        pack_sparse_blocks(x, 8, 128)


def test_init_caches_needs_an_explicit_cpu_device():
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import init_caches

    _no_card()
    cfg = get_config("gemma2-27b", smoke=True)
    with pytest.raises(RuntimeError, match="device=\"cpu\""):
        init_caches(cfg, 2, 8)
    assert init_caches(cfg, 2, 8, device="cpu")[0]["k"].device.type == "cpu"
    assert init_caches(cfg, 2, 8, device="meta")[0]["k"].device.type == "meta"

"""Boundaries of the PyTorch/CUDA port.

(d) `solve()` with no device runs on the card, so on a host without
    CUDA it raises instead of moving to the CPU.
(e) importing `karpenter_tpu_torch` and one CPU solve load neither
    `jax` nor `karpenter_tpu` (checked in a fresh interpreter).
(f) no file of the port, and not `chip_smoke.py`, imports `jax` or
    `karpenter_tpu` (AST check).
"""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from karpenter_tpu_torch.solver.solver import solve
from karpenter_tpu_torch.workloads import build_problem

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "karpenter_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_default_device_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    pods, pools = build_problem(20, 5, seed=0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        solve(pods, pools)


def test_import_and_cpu_solve_load_no_jax():
    code = (
        "import sys, json\n"
        "import karpenter_tpu_torch\n"
        "from karpenter_tpu_torch.workloads import build_problem\n"
        "from karpenter_tpu_torch.solver.solver import solve\n"
        "pods, pools = build_problem(200, 10, seed=1)\n"
        "sol = solve(pods, pools, device='cpu')\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'jaxlib' or m == 'karpenter_tpu'"
        " or m.startswith('karpenter_tpu.')]\n"
        "print(json.dumps({'bad': bad, 'nodes': len(sol.new_nodes)}))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    report = json.loads(out.stdout.strip().splitlines()[-1])
    assert report["bad"] == []
    assert report["nodes"] > 0


def _imports(path: Path) -> list[str]:
    tree = ast.parse(path.read_text(), filename=str(path))
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.extend(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.append(node.module)
    return names


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_file_imports_no_jax(path):
    assert path.exists(), path
    for name in _imports(path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "karpenter_tpu", "bench"), (path, name)


def test_sharded_solve_loads_no_jax():
    """(e) for the split path: a virtual mesh, a split ffd solve with
    streamed staging, the split ascent and the dryrun's module load
    neither `jax` nor `karpenter_tpu`."""
    code = (
        "import os, sys, json\n"
        "os.environ['KARPENTER_LP_SHARDS'] = '2'\n"
        "from karpenter_tpu_torch.utils.platform import force_virtual_mesh\n"
        "from karpenter_tpu_torch import graft_entry\n"
        "from karpenter_tpu_torch.solver import stream\n"
        "from karpenter_tpu_torch.workloads import build_problem\n"
        "from karpenter_tpu_torch.solver.solver import solve\n"
        "force_virtual_mesh(4)\n"
        "pods, pools = build_problem(200, 10, seed=1)\n"
        "sol = solve(pods, pools, device='cpu', shards=4)\n"
        "cost = solve(pods, pools, device='cpu', shards=2, objective='cost')\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'jaxlib' or m == 'karpenter_tpu'"
        " or m.startswith('karpenter_tpu.')]\n"
        "print(json.dumps({'bad': bad, 'nodes': len(sol.new_nodes),"
        " 'blocks': stream.last_stats().get('blocks', 0)}))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    report = json.loads(out.stdout.strip().splitlines()[-1])
    assert report["bad"] == []
    assert report["nodes"] > 0 and report["blocks"] > 0

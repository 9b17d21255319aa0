"""The port stands alone: it imports neither JAX nor the reference package.

Walks the AST of every file under ``src/repro_torch/`` and of
``chip_smoke.py``, and imports the port's packages in a fresh interpreter
to check that importing builds nothing and pulls in no JAX.
"""

import ast
import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"
]


def _banned(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


def _violations(path: pathlib.Path) -> list[str]:
    out = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            out += [f"{path.name}:{node.lineno} import {a.name}"
                    for a in node.names if _banned(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if node.module and _banned(node.module):
                out.append(f"{path.name}:{node.lineno} from {node.module}")
    return out


def test_scanner_catches_what_it_should():
    assert _banned("jax") and _banned("jax.numpy") and _banned("repro.configs")
    assert not _banned("repro_torch.kernels") and not _banned("numpy")


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    assert _violations(path) == []


def test_packages_import_without_building_or_jax():
    code = (
        "import sys\n"
        "import repro_torch, repro_torch.kernels.ops, repro_torch.serve\n"
        "import repro_torch.launch.serve, repro_torch.convert\n"
        "import repro_torch.launch.train, repro_torch.optim, repro_torch.train\n"
        "import repro_torch.data, repro_torch.runtime, repro_torch.checkpoint\n"
        "import repro_torch.models.ssm, repro_torch.kernels.ssd_scan\n"
        "import repro_torch.models.moe\n"
        "import repro_torch.core, repro_torch.core.calibration\n"
        "import repro_torch.benchmarks, repro_torch.benchmarks.run\n"
        "import repro_torch.benchmarks.bench_gemm, repro_torch.benchmarks.bench_membw\n"
        "import repro_torch.benchmarks.bench_copy, repro_torch.benchmarks.bench_latency\n"
        "import repro_torch.benchmarks.bench_managed_vs_system\n"
        "import repro_torch.launch.calibrate, repro_torch.kernels.blocked_matmul\n"
        "import repro_torch.kernels.membench\n"
        "import repro_torch.core.placement, repro_torch.core.planner\n"
        "import repro_torch.benchmarks.bench_llm_inference\n"
        "import repro_torch.benchmarks.bench_datapath_bounds\n"
        "import repro_torch.examples.quickstart, repro_torch.serve.engine\n"
        "import repro_torch.api, repro_torch.kernels.kv_stream\n"
        "import repro_torch.core.faults, repro_torch.examples.serve_llm\n"
        "import repro_torch.tools.serve_soak, repro_torch.tools.serve_chaos\n"
        "import repro_torch.tools.policy_smoke\n"
        "import repro_torch.launch.mesh, repro_torch.optim.compression\n"
        "import repro_torch.train.pipeline_parallel, repro_torch.examples.train_e2e\n"
        "import repro_torch.benchmarks.bench_pingpong, repro_torch.benchmarks.bench_internode\n"
        "import repro_torch.benchmarks.bench_collectives, repro_torch.tools.whatif_scale\n"
        "from repro_torch.kernels import _build\n"
        "assert not _build._LIBS and not _build.BUILD_LOG\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'repro')]\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr

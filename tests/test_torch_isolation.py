"""The PyTorch port stands alone: no module of ``friedrich_tpu_torch`` (its
example twins included), nor ``chip_smoke.py``, nor the multi-rank tests'
rank helper (which spawned ranks import) imports JAX, its libraries, or the
JAX package."""

import ast
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "friedrich_tpu", "ml_dtypes")
SOURCES = sorted((ROOT / "friedrich_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "tests" / "torch_parallel_ranks.py"]


def _imported_modules(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_source_imports_nothing_of_jax(path):
    bad = [m for m in _imported_modules(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_package_imports_with_jax_blocked():
    code = (
        "import sys\n"
        "for name in ('jax', 'jaxlib', 'flax', 'optax', 'friedrich_tpu', 'ml_dtypes'):\n"
        "    sys.modules[name] = None\n"
        "import friedrich_tpu_torch, friedrich_tpu_torch.demo, friedrich_tpu_torch.interop\n"
        "import friedrich_tpu_torch.ops.cuda.covariance_cuda\n"
        "import friedrich_tpu_torch.mcmc, friedrich_tpu_torch.models.map_fit\n"
        "import friedrich_tpu_torch.models.large_fit, friedrich_tpu_torch.utils.serialization\n"
        "import friedrich_tpu_torch.mcmc.nuts, friedrich_tpu_torch.mcmc.hmc\n"
        "import friedrich_tpu_torch.mcmc.predictive, friedrich_tpu_torch.mcmc.diagnostics\n"
        "import friedrich_tpu_torch.utils.fitlog\n"
        "import friedrich_tpu_torch.ops.blocked_solve, friedrich_tpu_torch.ops.outofcore\n"
        "import friedrich_tpu_torch.models.outofcore_gp\n"
        "import friedrich_tpu_torch.ops.tiled, friedrich_tpu_torch.ops.hybrid\n"
        "import friedrich_tpu_torch.serving, friedrich_tpu_torch.native\n"
        "import friedrich_tpu_torch.utils.profiling, friedrich_tpu_torch.utils.debugging\n"
        "from friedrich_tpu_torch import OutOfCoreGP\n"
        "from friedrich_tpu_torch.mcmc import sample_hyperparameters\n"
        "import friedrich_tpu_torch.parallel, friedrich_tpu_torch.entry\n"
        "import friedrich_tpu_torch.mcmc.sharded, friedrich_tpu_torch.mcmc.distributed_logprob\n"
        "from friedrich_tpu_torch.examples import bayesian_hyperparameters, bayesian_optimization\n"
        "from friedrich_tpu_torch.examples import distributed_gp, large_scale_fit, outofcore_gp\n"
        "from friedrich_tpu_torch.examples import precision_modes, serving_deployment\n"
        "sys.path.insert(0, 'tests')\n"
        "import torch_parallel_ranks\n"
        "print('ok')\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"

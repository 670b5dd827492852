"""The port stands alone: `repro_torch` and `chip_smoke.py` import neither
JAX nor anything of the JAX package `repro`, so they run on a host that
has only PyTorch."""
import ast
import os
import pathlib
import subprocess
import sys

import pytest

pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) \
    + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_modules(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    bad = [m for m in _imported_modules(path)
           if m.split(".")[0] in FORBIDDEN]
    assert bad == [], f"{path.name} imports {bad}"


def test_import_leaves_no_jax_or_reference_in_sys_modules():
    """Importing the port's modules, the dry run's included, loads neither
    JAX nor the reference, nor torch's internal fake process group (the
    dry run imports it when it builds a mesh)."""
    code = (
        "import sys\n"
        "import repro_torch, repro_torch.api, repro_torch.smoke\n"
        "import repro_torch.kernels.fedavg_stream, repro_torch.convert\n"
        "import repro_torch.kernels.ops, repro_torch.core.wire_codec\n"
        "import repro_torch.kernels.fused_sgd, repro_torch.kernels.rmsnorm\n"
        "import repro_torch.models, repro_torch.models.transformer\n"
        "import repro_torch.core.fedavg, repro_torch.optim, repro_torch.data\n"
        "import repro_torch.configs, repro_torch.launch.train\n"
        "import repro_torch.launch.federated_lm\n"
        "import repro_torch.core.sharded_tree, repro_torch.core.geo_tiered\n"
        "import repro_torch.serverless.population\n"
        "import repro_torch.launch.serve, repro_torch.launch.hostenv\n"
        "import repro_torch.checkpoint.manager\n"
        "import repro_torch.checkpoint.reshard, repro_torch.data.partition\n"
        "import repro_torch.models.moe, repro_torch.models.ssm\n"
        "import repro_torch.models.encdec, repro_torch.models.cnn\n"
        "import repro_torch.configs.whisper_tiny, repro_torch.configs.dbrx\n"
        "import repro_torch.configs.phi35_moe, repro_torch.configs.zamba2\n"
        "import repro_torch.configs.falcon_mamba\n"
        "import repro_torch.configs.chameleon\n"
        "import repro_torch.core.device_agg, repro_torch.launch.mesh\n"
        "import repro_torch.launch.partitioning, repro_torch.models.meshctx\n"
        "import repro_torch.launch.dryrun\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro')\n"
        "             or m.endswith('distributed.fake_pg'))\n"
        "print(','.join(bad))\n")
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        check=True, env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert out.stdout.strip() == ""

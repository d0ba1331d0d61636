"""The port stands alone: no module of ``src/repro_torch`` and not
``chip_smoke.py`` imports JAX or the reference package ``repro``."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _forbidden(name: str) -> bool:
    return any(name == m or name.startswith(m + ".") for m in ("jax", "jaxlib", "repro"))


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            if _forbidden(node.module):
                bad.append(node.module)
    assert not bad, f"{path.name} imports {bad}"


def test_importing_the_port_loads_no_jax():
    code = (
        "import sys\n"
        "import repro_torch, repro_torch.core, repro_torch.core.convert\n"
        "import repro_torch.configs.synfire4, repro_torch.kernels.ops\n"
        "import repro_torch.core.rng, repro_torch.core.backend\n"
        "import repro_torch.kernels.fused_tick, repro_torch.kernels.ref\n"
        "import repro_torch.kernels.flash_attn, repro_torch.configs.base\n"
        "import repro_torch.configs.smollm_360m, repro_torch.configs.qwen2_5_14b\n"
        "import repro_torch.configs.minitron_8b, repro_torch.configs.stablelm_12b\n"
        "import repro_torch.models.layers, repro_torch.models.attention\n"
        "import repro_torch.models.transformer, repro_torch.models.tasks\n"
        "import repro_torch.launch.serve\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro')]\n"
        "assert not bad, bad\n"
    )
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    subprocess.run([sys.executable, "-c", code], check=True, env=env, timeout=120)

"""Import hygiene of the PyTorch port: ``src/repro_torch`` and
``chip_smoke.py`` run where JAX and the ``repro`` package are absent, so
they import neither, and importing them builds no kernel."""
import ast
import os
from pathlib import Path
import subprocess
import sys

import pytest

REPO = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((REPO / "src" / "repro_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]


def _forbidden(name: str) -> bool:
    root = name.split(".")[0]
    return root in ("jax", "jaxlib", "repro")


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_port_file_imports_no_jax_and_no_repro(path):
    bad = []
    for node in ast.walk(ast.parse(path.read_text(encoding="utf-8"))):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            if _forbidden(node.module):
                bad.append(node.module)
    assert not bad, f"{path.name} imports {bad}"


def test_port_imports_with_jax_and_repro_blocked():
    """With ``jax`` and ``repro`` made unimportable, the port's modules
    import, and no kernel build (nvcc) is started."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "import repro_torch.serve.engine, repro_torch.models\n"
        "import repro_torch.kernels.flash_attention.ops\n"
        "import repro_torch.kernels.flash_attention.kernel_bwd\n"
        "import repro_torch.kernels.paged_attention.ops\n"
        "import repro_torch.kernels.ssm_scan.ops, repro_torch.models.ssm\n"
        "import repro_torch.kernels.mlstm.ops, repro_torch.kernels.mlstm.kernel\n"
        "import repro_torch.models.xlstm, repro_torch.configs.xlstm_350m\n"
        "import repro_torch.launch.serve\n"
        "import repro_torch.train.loop, repro_torch.train.steps, repro_torch.launch.train\n"
        "import repro_torch.optim, repro_torch.data, repro_torch.ckpt\n"
        "import repro_torch.models.convert\n"
        "import repro_torch.core, repro_torch.core.orchestrator, repro_torch.dist\n"
        "import repro_torch.obs.export, repro_torch.obs.replay, repro_torch.obs.log\n"
        "import repro_torch.serve.router, repro_torch.serve.autoscale\n"
        "import repro_torch.serve.fleet, repro_torch.serve.migrate, repro_torch.serve\n"
        "from repro_torch.kernels import _build\n"
        "assert _build._lib is None and not _build.last_build\n"
        "assert not any(m == 'jax' or m.startswith(('jax.', 'repro.')) for m in sys.modules\n"
        "               if sys.modules[m] is not None)\n"
        "print('ok')\n"
    )
    env = {**os.environ, "PYTHONPATH": str(REPO / "src"), "PATH": "/nonexistent"}
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"

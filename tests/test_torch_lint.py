"""repro-lint over the port: the static-analysis suite scopes its passes
to ``src/repro/{core,serve,dist,launch}``, so this test runs it on a copy of
``src/repro_torch/`` placed at ``src/repro`` under a temporary root. The
port must be as clean as the reference (``test_static_analysis.py::
test_repo_tree_is_clean``); each suppression in it names its invariant."""
from pathlib import Path
import shutil
import sys

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from tools.analysis.core import render, run_analysis  # noqa: E402


def test_port_tree_is_clean_under_repro_lint(tmp_path):
    shutil.copytree(REPO / "src" / "repro_torch", tmp_path / "src" / "repro",
                    ignore=shutil.ignore_patterns("__pycache__"))
    diags = run_analysis(paths=[tmp_path / "src"], root=tmp_path)
    assert diags == [], render(diags, tmp_path)

"""No module of the benchmark imports JAX or the JAX package; the generator
and the reference import nothing of the port either.  Top-level names are
compared whole: ``uav_airvision_tpu_torch`` is not ``uav_airvision_tpu``."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "uav_airvision_tpu"}
PORT = "uav_airvision_tpu_torch"


def imported_top_levels(path: Path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "id", None) == "__import__"
              and node.args and isinstance(node.args[0], ast.Constant)):
            names.add(str(node.args[0].value).split(".")[0])
    return names


MODULES = sorted(ROOT.rglob("*.py"))


def test_modules_found():
    assert len(MODULES) > 40
    assert (ROOT / "reference" / "vio_plain" / "models" / "msckf" / "step.py") in MODULES


@pytest.mark.parametrize("path", MODULES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax(path):
    assert not imported_top_levels(path) & FORBIDDEN


@pytest.mark.parametrize("path", [p for p in MODULES
                                  if p.relative_to(ROOT).parts[0] in ("gen", "reference")],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_generator_and_reference_stand_alone(path):
    assert PORT not in imported_top_levels(path)


def test_names_compared_whole(tmp_path):
    p = tmp_path / "probe.py"
    p.write_text("import uav_airvision_tpu_torch.models\nfrom jaxlib import xla\n")
    names = imported_top_levels(p)
    assert names == {"uav_airvision_tpu_torch", "jaxlib"}
    assert not {"uav_airvision_tpu_torch"} & FORBIDDEN

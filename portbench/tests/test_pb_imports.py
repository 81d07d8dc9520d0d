"""No module of the benchmark imports JAX or the JAX package, comparing
the top-level name of every import whole (the port's own name,
x264dsp_tpu_torch, begins with the JAX package's)."""

import ast
from pathlib import Path

from portbench import harness

PKG = Path(__file__).resolve().parents[1]


def imported_top_levels(path: Path) -> set[str]:
    tree = ast.parse(path.read_text(encoding="utf-8"))
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", "") == "import_module" and node.args \
                and isinstance(node.args[0], ast.Constant):
            names.add(str(node.args[0].value).split(".")[0])
    return names


def test_no_module_imports_jax_or_the_jax_package():
    files = sorted(PKG.rglob("*.py"))
    assert len(files) > 20
    for f in files:
        bad = imported_top_levels(f) & set(harness.FORBIDDEN)
        assert not bad, f"{f.relative_to(PKG)} imports {bad}"


def test_whole_name_comparison(tmp_path):
    f = tmp_path / "probe.py"
    f.write_text("import x264dsp_tpu_torch.encoder\n"
                 "from x264dsp_tpu_torch import api\n"
                 "import jaxtyping\n")
    assert imported_top_levels(f) == {"x264dsp_tpu_torch", "jaxtyping"}
    assert not imported_top_levels(f) & set(harness.FORBIDDEN)
    f.write_text("from x264dsp_tpu.ops import golden\n")
    assert imported_top_levels(f) & set(harness.FORBIDDEN) == {"x264dsp_tpu"}


def test_the_runtime_check_names_loaded_modules(monkeypatch):
    import sys
    import types
    assert "x264dsp_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "x264dsp_tpu.ops",
                        types.ModuleType("x264dsp_tpu.ops"))
    assert harness.forbidden_modules() == ["x264dsp_tpu"]

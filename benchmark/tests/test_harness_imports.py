"""No module of the benchmark imports jax or the JAX package, and the
reference names nothing of the port: a static scan of every module under
benchmark/, comparing each imported module's top-level name (the part
before the first dot) whole, those handed to importlib as strings too."""

import ast
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "nk_ocn_tracer_jacobian_precond_tpu"}
PORT = "nk_ocn_tracer_jacobian_precond_tpu_torch"


def names(path: Path):
    """Top-level names of the modules a file imports, by statement or by
    importlib.import_module / __import__ of a string."""
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call) and node.args
              and isinstance(node.args[0], ast.Constant)
              and isinstance(node.args[0].value, str)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__")):
            yield node.args[0].value.split(".")[0]


def modules():
    found = sorted(BENCH.rglob("*.py"))
    assert len(found) >= 20, found
    return found


def test_no_module_imports_jax_or_the_jax_package():
    bad = {str(p.relative_to(BENCH)): sorted(set(names(p)) & FORBIDDEN)
           for p in modules()}
    assert not {k: v for k, v in bad.items() if v}


def test_the_scan_compares_top_level_names_whole(tmp_path):
    p = tmp_path / "m.py"
    p.write_text("import nk_ocn_tracer_jacobian_precond_tpu_torch.solver\n"
                 "from jax.numpy import ones\nimport jaxfoo\n"
                 "import importlib\nimportlib.import_module('flax.core')\n")
    assert set(names(p)) & FORBIDDEN == {"jax", "flax"}


def test_the_reference_names_nothing_of_the_port():
    for p in sorted((BENCH / "reference").rglob("*.py")):
        text = p.read_text()
        assert PORT not in text, p
        assert not set(names(p)) & (FORBIDDEN | {PORT}), p

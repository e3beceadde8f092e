"""The torch package imports and runs with jax and the JAX package
unavailable.

A fresh interpreter installs a meta-path finder that raises on any import
of jax or of the JAX package ``nk_ocn_tracer_jacobian_precond_tpu`` (the
reference, not the port), then imports every module of the port and makes,
factors and solves the coupled 12x10x4 case on the CPU with the port's own
gen_A and synthetic test data.
"""

import ast
import os
import subprocess
import sys
import textwrap
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
PKG = "nk_ocn_tracer_jacobian_precond_tpu_torch"
REF = "nk_ocn_tracer_jacobian_precond_tpu"

SCRIPT = textwrap.dedent("""
    import importlib, pkgutil, sys

    def blocked(name):
        return (name in ("jax", "{ref}")
                or name.startswith(("jax.", "jaxlib", "{ref}.")))

    class NoJax:
        def find_spec(self, name, path=None, target=None):
            if blocked(name):
                raise ImportError(f"blocked: {name}")
            return None

    sys.meta_path.insert(0, NoJax())
    import numpy as np
    import torch
    torch.set_num_threads(1)    # the suite runs several workers at once
    import {pkg}
    mods = [m.name for m in pkgutil.walk_packages({pkg}.__path__,
                                                  "{pkg}.")]
    for m in mods:
        importlib.import_module(m)
    assert len(mods) >= 30, mods

    from {pkg}.drivers.gen_a import run_gen_a
    from {pkg}.grid.indmap import load_ind_maps
    from {pkg}.io.matrixfile import read_matrix_file
    from {pkg}.ops import AssemblyOptions, PerTracerOptions
    from {pkg}.testdata import make_circ_file
    from {pkg}.solver.api import factor

    make_circ_file("circ.nc", imt=12, jmt=10, km=4, seed=35)
    pts = [PerTracerOptions(sink_type="const", sink_rate=2e-4),
           PerTracerOptions(sink_type="const", sink_rate=1e-4)]
    run_gen_a("m.nc", opts=AssemblyOptions(
        circ_fname="circ.nc", hmix_type="const", vmix_type="const",
        coupled_tracer_cnt=2, per_tracer=pts,
        coupled_tracer_type="OCMIP_BGC_PO4_DOP"))
    matrix = read_matrix_file("m.nc")
    fac = factor(matrix, maps=load_ind_maps("m.nc"), leaf_size=6,
                 device="cpu")
    b = np.random.default_rng(5).standard_normal(matrix.flat_len)
    x = fac.solve(b)
    A = matrix.to_scipy()
    res = np.linalg.norm(A @ x - b) / np.linalg.norm(b)
    assert res < 1e-10, res
    assert not [m for m in sys.modules if blocked(m)]
    print("NOJAX_OK", len(mods), res)
""").replace("{pkg}", PKG).replace("{ref}", REF)


def test_port_runs_without_jax(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run([sys.executable, "-c", SCRIPT], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "NOJAX_OK" in res.stdout


def _imported_modules(path: Path, package: list[str]):
    """(line, absolute module name) of every import statement in ``path``,
    a module of ``package`` (its dotted name as a list); a relative import
    is resolved against it."""
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield node.lineno, a.name
        elif isinstance(node, ast.ImportFrom):
            mod = node.module or ""
            if node.level:
                base = package[:len(package) - (node.level - 1)]
                mod = ".".join(base + ([mod] if mod else []))
            yield node.lineno, mod
            for a in node.names:
                yield node.lineno, f"{mod}.{a.name}"


def _package_of(path: Path) -> list[str]:
    return list(path.relative_to(REPO).parent.parts)


def test_no_module_imports_the_jax_package():
    """Static check over every module of the port and chip_smoke.py: no
    import statement names jax or the JAX package (at any depth, relative
    imports resolved)."""
    files = sorted((REPO / PKG).rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) >= 30
    bad = []
    for f in files:
        for line, mod in _imported_modules(f, _package_of(f)):
            if mod.split(".")[0] in (REF, "jax", "jaxlib"):
                bad.append(f"{f.relative_to(REPO)}:{line}: {mod}")
    assert not bad, "\n".join(bad)


def test_import_scan_sees_relative_and_nested_imports(tmp_path):
    """The scan above resolves relative imports and catches an import of
    the JAX package inside a function."""
    plan = REPO / PKG / "solver" / "plan.py"
    found = {m for _, m in _imported_modules(plan, _package_of(plan))}
    assert f"{PKG}.native.plan_entries" in found
    assert f"{PKG}.solver.symbolic" in found
    probe = tmp_path / "probe.py"
    probe.write_text(f"def f():\n    from {REF}.solver import mf_jax\n"
                     f"    from .. import x\n")
    found = {m for _, m in _imported_modules(probe, [PKG, "solver"])}
    assert f"{REF}.solver.mf_jax" in found and f"{PKG}.x" in found

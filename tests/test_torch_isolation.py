"""The PyTorch port stands alone: it imports neither JAX nor the reference.

A fresh interpreter imports every module of ``repro_torch`` and must end with
no ``jax*`` module and no ``repro``/``repro.*`` module loaded; an AST scan
of the package's sources refuses any ``import jax`` or ``repro`` import, so a
lazy import inside a function cannot slip past the first check.
"""
import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

SRC = Path(__file__).resolve().parents[1] / "src"
PKG = SRC / "repro_torch"
MODULES = sorted(
    ".".join(p.relative_to(SRC).with_suffix("").parts).removesuffix(".__init__")
    for p in PKG.rglob("*.py")
)


def test_package_has_the_slice_modules():
    for name in ("state", "netplane", "ref", "scenario", "kernel", "_build",
                 "ops", "engine", "trace", "carry"):
        assert f"repro_torch.lease_array.{name}" in MODULES
    for name in ("_nvcc", "device", "configs", "configs.base", "configs.archs",
                 "models", "models.schema", "models.layers", "models.attention",
                 "models.transformer", "models.carry", "models.moe", "models.ssm",
                 "models.frontends",
                 "kernels",
                 "kernels.flash_attention", "kernels.flash_attention.ref",
                 "kernels.flash_attention.kernel", "kernels.flash_attention.ops",
                 "kernels.flash_attention._build", "models.rwkv6", "kernels.rwkv6",
                 "kernels.rwkv6.ref", "kernels.rwkv6.kernel", "kernels.rwkv6.ops",
                 "kernels.rwkv6._build", "launch", "launch.steps",
                 "launch.serve", "train", "train.serve",
                 "configs.paxoslease_cell", "sim", "sim.events", "sim.network",
                 "sim.env", "core", "core.ballot", "core.messages",
                 "core.invariant", "core.acceptor", "core.proposer",
                 "core.cell", "lease_array.directory", "lease_array.falsify",
                 "lease_array.falsify.search", "lease_array.falsify.mutate",
                 "lease_array.falsify.shrink", "lease_array.falsify.corpus",
                 "lease_array.falsify.__main__", "cluster", "cluster.shards",
                 "core.naive", "cluster.coordinator", "cluster.membership",
                 "cluster.autoscale", "analysis", "analysis.staticcheck",
                 "analysis.staticcheck.findings", "analysis.staticcheck.launch",
                 "analysis.staticcheck.purity",
                 "analysis.staticcheck.intervals",
                 "analysis.staticcheck.conventions",
                 "analysis.staticcheck.fixtures", "analysis.staticcheck.cli",
                 "analysis.staticcheck.__main__", "optim", "optim.adamw",
                 "optim.schedule", "data", "data.synthetic", "data.loader",
                 "checkpoint", "checkpoint.io", "checkpoint.manager",
                 "train.loop", "launch.train"):
        assert f"repro_torch.{name}" in MODULES


def test_importing_every_module_loads_no_jax_and_no_reference():
    code = (
        "import importlib, json, sys\n"
        f"for m in {MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro')\n"
        "       or m.startswith('jax')]\n"
        "print(json.dumps(bad))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300, check=True)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def _forbidden(path: Path) -> list[str]:
    found = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [] if node.level else [node.module or ""]
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            if top.startswith("jax") or top == "repro":
                found.append(f"{path.name}:{node.lineno} imports {name}")
    return found


@pytest.mark.parametrize("module", MODULES)
def test_source_imports_no_jax_and_no_reference(module):
    path = SRC.joinpath(*module.split("."))
    # a package's __init__.py, else the module file (falsify/corpus.py sits
    # beside its corpus/ directory of JSON fixtures, as import finds it)
    init = path / "__init__.py"
    path = init if init.exists() else path.with_suffix(".py")
    assert _forbidden(path) == []


def test_ast_scan_catches_forbidden_imports(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text("def f():\n    import jax.numpy as jnp\n"
                   "from repro.lease_array import ops\nimport repro\n"
                   "from .ok import x\nimport reprox\n")
    assert len(_forbidden(bad)) == 3


def test_chip_smoke_imports_no_jax_and_no_reference():
    assert _forbidden(SRC.parent / "chip_smoke.py") == []

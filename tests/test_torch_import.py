"""The port stands alone: it imports neither jax nor tomatis_tpu, and its
entry points default to the card."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from tomatis_tpu_torch.models import standard

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CHECK = """
import importlib, pkgutil, sys
sys.path.insert(0, {repo!r})
import tomatis_tpu_torch
names = [m.name for m in pkgutil.walk_packages(tomatis_tpu_torch.__path__,
                                               "tomatis_tpu_torch.")]
for n in names:
    importlib.import_module(n)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.")
             or m == "tomatis_tpu" or m.startswith("tomatis_tpu."))
assert not bad, bad
print("IMPORTED", len(names))
"""


def test_port_imports_no_jax_and_no_reference():
    env = dict(os.environ)
    r = subprocess.run([sys.executable, "-c", _CHECK.format(repo=REPO)],
                       capture_output=True, text=True, timeout=120, env=env)
    assert r.returncode == 0, r.stderr[-2000:]
    n = int(r.stdout.split("IMPORTED")[1])
    assert n >= 69   # every module of every sub-package was imported


def test_new_modules_import_no_jax_and_no_reference():
    """The crossfade model, the FLAC codec's binding and the checkpoint
    manager, imported on their own in a fresh interpreter."""
    code = ("import sys; sys.path.insert(0, %r); "
            "import tomatis_tpu_torch.models.xfade, "
            "tomatis_tpu_torch.io.flac, tomatis_tpu_torch.io.flac_py, "
            "tomatis_tpu_torch.engine.checkpoint, "
            "tomatis_tpu_torch.cli.process_xfade, "
            "tomatis_tpu_torch.cli.convert; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'tomatis_tpu')); assert not bad, bad" % REPO)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]


def test_eq_adaptive_analysis_modules_import_no_jax_no_pandas():
    """The adaptive processor, the EQ appliers, the repair tools, the
    analysis stage, the match workflow and their commands, imported on
    their own in a fresh interpreter: no jax, nothing of the JAX package,
    no pandas (the EQ CSV readers use the csv module)."""
    mods = ["models.eq", "models.adaptive", "models.repair",
            "models.workflow", "analysis.align", "analysis.spectra",
            "analysis.compare", "analysis.analyze_eq", "analysis.features",
            "analysis.gridgate", "analysis.calibrate", "cli.apply_eq",
            "cli.apply_residual_eq", "cli.process_adaptive", "cli.repair",
            "cli.cut", "cli.compare", "cli.analyze_eq", "cli.calibrate",
            "cli.calibrate_v2", "cli.match", "cli.main", "convert"]
    code = ("import sys; sys.path.insert(0, %r); import importlib; "
            "[importlib.import_module('tomatis_tpu_torch.' + m) "
            "for m in %r]; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'tomatis_tpu', 'pandas')); "
            "assert not bad, bad" % (REPO, mods))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]


def test_verifier_and_analyzer_modules_import_no_jax_no_pandas():
    """The verifiers, the level and segment analyzers, doctor and their
    commands, imported on their own in a fresh interpreter: no jax,
    nothing of the JAX package, no pandas, and no matplotlib until a plot
    is drawn."""
    mods = ["verify.validate_layer1", "verify.verify_15db",
            "verify.verify_15db_v2", "verify.tilt_amplitude",
            "verify.case_study", "analysis.levels", "analysis.segments",
            "cli._sidecar", "cli.validate", "cli.verify_15db",
            "cli.verify_15db_v2", "cli.verify_tilt", "cli.doctor",
            "cli.analyzers", "cli.main"]
    code = ("import sys; sys.path.insert(0, %r); import importlib; "
            "[importlib.import_module('tomatis_tpu_torch.' + m) "
            "for m in %r]; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'tomatis_tpu', 'pandas', 'matplotlib')); "
            "assert not bad, bad" % (REPO, mods))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("this checks the behaviour of a host without a card")
    x = np.zeros((4800, 2), np.float32)
    with pytest.raises(RuntimeError, match="CUDA"):
        standard.process_array(x, 48000)
    with pytest.raises(RuntimeError, match="CUDA"):
        standard.build_controller(standard.StandardParams(), 48000)


@pytest.mark.parametrize("path", ["chip_smoke.py",
                                  "tests/test_torch_cuda_kernels.py"])
def test_card_scripts_import_no_jax(path):
    """chip_smoke.py and the card's pytest file run on a machine without
    jax: no import statement anywhere in them names jax or the JAX
    package, and importing the module pulls in neither."""
    import ast
    full = os.path.join(REPO, path)
    tree = ast.parse(open(full).read())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names]
    names += [n.module for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) and n.module]
    bad = [m for m in names if m.split(".")[0] in ("jax", "jaxlib",
                                                   "tomatis_tpu")]
    assert not bad, bad
    code = ("import sys, importlib.util; sys.path.insert(0, %r); "
            "spec = importlib.util.spec_from_file_location('m', %r); "
            "mod = importlib.util.module_from_spec(spec); "
            "spec.loader.exec_module(mod); "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'tomatis_tpu')); assert not bad, bad"
            % (REPO, full))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]


def test_sharded_and_comparison_modules_import_no_jax_no_pandas():
    """The sharded processor and its stream driver, the comparison suite,
    reverse-engineer and their commands, imported on their own in a fresh
    interpreter: no jax, nothing of the JAX package, no pandas (plot-diff
    reads its CSV with the csv module), and no matplotlib until a plot is
    drawn."""
    mods = ["parallel.sharded", "parallel.stream", "parallel.batch",
            "analysis.compare_suite", "analysis.reverse",
            "cli.process_sharded", "cli.compare_suite", "cli.reverse",
            "cli.process_batch", "cli.main"]
    code = ("import sys; sys.path.insert(0, %r); import importlib; "
            "[importlib.import_module('tomatis_tpu_torch.' + m) "
            "for m in %r]; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'tomatis_tpu', 'pandas', 'matplotlib')); "
            "assert not bad, bad" % (REPO, mods))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]


def test_port_uses_no_process_group_and_no_compiler():
    """The mesh is one process over a device list: no module of the port
    (nor chip_smoke.py) uses torch.distributed, torch.compile or dynamo."""
    import ast
    paths = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(os.path.join(REPO, "tomatis_tpu_torch")):
        paths += [os.path.join(root, f) for f in files if f.endswith(".py")]
    banned = ("distributed", "compile", "_dynamo")
    bad = []
    for path in paths:
        tree = ast.parse(open(path).read())
        for n in ast.walk(tree):
            if isinstance(n, ast.Attribute) and n.attr in banned \
                    and isinstance(n.value, ast.Name) \
                    and n.value.id == "torch":
                bad.append((path, f"torch.{n.attr}"))
            mods = ([a.name for a in n.names] if isinstance(n, ast.Import)
                    else [n.module] if isinstance(n, ast.ImportFrom)
                    and n.module else [])
            bad += [(path, m) for m in mods
                    if m.split(".")[:2] in (["torch", b] for b in banned)]
    assert not bad, bad

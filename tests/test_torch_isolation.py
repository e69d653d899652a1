"""The port stands alone: ``repro_torch`` imports neither ``jax`` nor the
reference package, its copied host-side modules stay byte-identical to the
reference's, and its comm layer stays deterministic (DET001)."""

import filecmp
import os
import subprocess
import sys
import textwrap

import pytest

from repro.analysis import astlint

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "src")
PORT = os.path.join(SRC, "repro_torch")
REF = os.path.join(SRC, "repro")


def _copied_files():
    out = []
    for sub in ("configs", "core", "data", "serving"):
        out += [os.path.join(sub, n)
                for n in sorted(os.listdir(os.path.join(REF, sub)))
                if n.endswith(".py")]
    return out + [os.path.join("analysis", n)
                  for n in ("corpus.py", "locks.py", "planlint.py")]


def test_every_module_imports_without_jax_or_repro():
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        import repro_torch
        names = [m.name for m in pkgutil.walk_packages(
            repro_torch.__path__, "repro_torch.")]
        for name in names:
            importlib.import_module(name)
        bad = sorted(m for m in sys.modules
                     if m == "jax" or m.startswith(("jax.", "jaxlib"))
                     or m == "repro" or m.startswith("repro."))
        assert not bad, bad
        print("IMPORTED", len(names))
    """)
    env = dict(os.environ, PYTHONPATH=SRC)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert int(proc.stdout.split()[-1]) >= 20


@pytest.mark.parametrize("rel", _copied_files())
def test_copied_host_file_is_identical(rel):
    assert filecmp.cmp(os.path.join(REF, rel), os.path.join(PORT, rel),
                       shallow=False), f"{rel} drifted from the reference"


def test_no_copy_beyond_the_listed_ones():
    """configs/, core/, data/ and serving/ hold exactly the reference's
    files; analysis/ holds the copies corpus.py, locks.py and planlint.py
    and the port's own guards.py (its registry names the port's modules),
    astlint.py (it walks the port's tree) and __main__.py."""
    for sub in ("configs", "core", "data", "serving"):
        ours = {n for n in os.listdir(os.path.join(PORT, sub))
                if n.endswith(".py")}
        theirs = {n for n in os.listdir(os.path.join(REF, sub))
                  if n.endswith(".py")}
        assert ours == theirs, sub
    assert {n for n in os.listdir(os.path.join(PORT, "analysis"))
            if n.endswith(".py")} == {"__init__.py", "__main__.py",
                                      "astlint.py", "corpus.py", "guards.py",
                                      "locks.py", "planlint.py"}


def test_comm_layer_has_no_det001_finding():
    """Plan lowering stays deterministic per fingerprint: no wall clock and
    no unseeded global RNG in the port's comm layer or its mesh."""
    comm = os.path.join(PORT, "comm")
    paths = [os.path.join(comm, n) for n in sorted(os.listdir(comm))
             if n.endswith(".py")]
    findings = astlint.lint_paths(paths, SRC)
    mesh = os.path.join(PORT, "launch", "mesh.py")
    with open(mesh) as f:
        findings += astlint.lint_source(f.read(), mesh, check_det001=True)
    assert not [f for f in findings if f.rule == "DET001"], findings
    assert len(paths) >= 3


def test_det001_would_catch_a_wall_clock():
    """The lint reaches the port's comm modules (their package path holds
    ``comm``)."""
    path = os.path.join(PORT, "comm", "plan_exec.py")
    with open(path) as f:
        src = f.read() + "\nimport time\n_T = time.time()\n"
    found = astlint.lint_source(src, path, module="repro_torch.comm.x",
                                check_det001=True)
    assert [f.rule for f in found] == ["DET001"]
    assert astlint._module_name(path, SRC).split(".")[1] == "comm"

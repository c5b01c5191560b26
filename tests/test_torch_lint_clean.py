"""The port's tree is lint-clean: the contract linter
(``nmfx_torch.analysis``) over ``nmfx_torch/`` reports no active error and
no active warning with an empty baseline (the counterpart of
``tests/test_lint_clean.py``). A config field that misses a key, a fault
site without a flight category, an unregistered metric, a broad handler
that swallows, a lock taken outside its declaration or in two orders,
a stranded future or an unowned thread turns this test red."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "nmfx_torch")


def test_nmfx_torch_tree_lint_clean():
    from nmfx_torch.analysis import active, run

    findings = run([PKG])
    errors = active(findings, "error")
    warnings = active(findings, "warning")
    assert not errors, "\n".join(f.render() for f in errors)
    assert not warnings, "\n".join(f.render() for f in warnings)
    # every suppression carries its reason (a reasonless one is an
    # NMFX000 error above and suppresses nothing)
    assert all(f.rule_id != "NMFX000" for f in findings)


def test_cli_entrypoint_exits_zero():
    """``python -m nmfx_torch.analysis nmfx_torch/`` exits 0 on the tree,
    prints "0 error(s)", and imports no JAX (``-X importtime`` lists every
    module the run imports)."""
    proc = subprocess.run(
        [sys.executable, "-X", "importtime", "-m", "nmfx_torch.analysis",
         "nmfx_torch/"], capture_output=True, text=True, timeout=240,
        cwd=REPO, env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert "0 error(s)" in proc.stdout
    imported = {line.rsplit("|", 1)[-1].strip()
                for line in proc.stderr.splitlines() if "|" in line}
    assert "nmfx_torch.analysis" in imported
    assert not {m for m in imported
                if m.split(".")[0] in ("jax", "jaxlib", "nmfx")}

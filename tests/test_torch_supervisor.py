"""The port's training supervisor (leibnizgym_tpu_torch/scripts/supervise_train.sh)
with a mocked trainer: twins of tests/test_supervisor.py.

The supervisor runs ``python -m leibnizgym_tpu_torch.scripts.train`` with
the repository root (two levels above the script) first on PYTHONPATH. The
tests copy it into a temporary tree whose ``leibnizgym_tpu_torch.scripts.train``
is a stub that records its arguments and exits with scripted codes.
"""

import os
import stat
import subprocess
import textwrap

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SUPERVISOR = os.path.join(_REPO, "leibnizgym_tpu_torch", "scripts", "supervise_train.sh")


def _run_supervisor(tmp_path, train_body: str, max_restarts: int = 3, timeout: int = 60):
    """Run the supervisor against a stub trainer; returns (returncode,
    stdout, recorded argument lines, logdir)."""
    pkg = tmp_path / "leibnizgym_tpu_torch"
    scripts = pkg / "scripts"
    scripts.mkdir(parents=True)
    (pkg / "__init__.py").write_text("")
    (scripts / "__init__.py").write_text("")
    sup = scripts / "supervise_train.sh"
    sup.write_text(open(_SUPERVISOR).read())
    sup.chmod(sup.stat().st_mode | stat.S_IEXEC)
    calls = tmp_path / "calls.txt"
    (scripts / "train.py").write_text(textwrap.dedent(train_body).format(calls=str(calls)))
    logdir = tmp_path / "run"
    env = dict(os.environ, MAX_RESTARTS=str(max_restarts))
    env.pop("PYTHONPATH", None)
    p = subprocess.run(["bash", str(sup), str(logdir)], capture_output=True, text=True,
                       timeout=timeout, env=env, cwd=str(tmp_path))
    lines = calls.read_text().splitlines() if calls.exists() else []
    return p.returncode, p.stdout, lines, logdir


def test_success_exits_zero(tmp_path):
    code, out, calls, _ = _run_supervisor(tmp_path, """
        import sys
        open({calls!r}, "a").write(" ".join(sys.argv[1:]) + "\\n")
        sys.exit(0)
    """)
    assert code == 0
    assert "training completed" in out
    assert len(calls) == 1 and calls[0].startswith("args.logdir=")


def test_gives_up_after_max_restarts_with_backoff(tmp_path):
    # always fail, one restart allowed: two runs, one 10 s back-off
    code, out, calls, _ = _run_supervisor(tmp_path, """
        import sys
        open({calls!r}, "a").write(" ".join(sys.argv[1:]) + "\\n")
        sys.exit(42)
    """, max_restarts=1, timeout=120)
    assert code == 42
    assert "giving up" in out
    assert len(calls) == 2
    assert "restart 1/1 in 10s" in out


def test_resumes_from_checkpoint_and_resets_budget(tmp_path):
    # run 1: fails before saving -> restart 1 (no resume argument)
    # run 2: saves nn/last (a file, as the port's runner writes it), fails
    #        -> the budget resets to restart 1
    # run 3: resumed with args.checkpoint=...; exits 0
    code, out, calls, logdir = _run_supervisor(tmp_path, """
        import os, sys
        calls = {calls!r}
        n = sum(1 for _ in open(calls)) if os.path.exists(calls) else 0
        open(calls, "a").write(" ".join(sys.argv[1:]) + "\\n")
        logdir = sys.argv[1].split("=", 1)[1]
        if n == 0:
            sys.exit(42)
        if n == 1:
            os.makedirs(os.path.join(logdir, "stamp2", "nn"))
            open(os.path.join(logdir, "stamp2", "nn", "last"), "w").close()
            sys.exit(1)
        sys.exit(0)
    """, max_restarts=5, timeout=120)
    assert code == 0, out
    assert len(calls) == 3
    assert "args.checkpoint=" not in calls[0]
    assert "args.checkpoint=" not in calls[1]
    assert "stamp2/nn/last" in calls[2]
    assert out.count("restart 1/5") == 2

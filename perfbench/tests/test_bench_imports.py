"""What a chip run imports holds no JAX and nothing of the JAX package, and
the plain reference imports nothing of the port."""

import ast
import os
import subprocess
import sys

from perfbench import harness

REFERENCE = os.path.join(harness.ROOT, "perfbench", "reference")


def _loaded_after(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys\nprint(' '.join(sorted("
                          "{m.split('.')[0] for m in sys.modules})))"],
                         cwd=harness.ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    return set(out.stdout.split())


def test_a_run_loads_no_jax():
    """Everything a run of each cell imports, the drivers' program modules
    included, compared by the whole top-level name."""
    code = "\n".join([
        "from perfbench import harness, readings",
        "bench = harness.load_json('BENCHMARK.json')",
        "[harness.resolve(bench, c['name']) for c in bench['workloads']]",
        "from leibnizgym_tpu_torch.learning.runner import Runner",
        "from leibnizgym_tpu_torch.learning.graphs import GraphedEpoch",
    ])
    loaded = _loaded_after(code)
    assert not loaded & set(harness.FORBIDDEN), loaded & set(harness.FORBIDDEN)
    assert "leibnizgym_tpu_torch" in loaded


def test_forbidden_names_are_compared_whole():
    assert "leibnizgym_tpu_torch" not in harness.FORBIDDEN
    before = dict(sys.modules)
    try:
        sys.modules["leibnizgym_tpu_torch_fake"] = sys
        assert harness.forbidden_modules() == [m for m in harness.forbidden_modules()
                                               if m != "leibnizgym_tpu_torch_fake"]
        sys.modules["jaxlib.fake"] = sys
        assert "jaxlib" in harness.forbidden_modules()
    finally:
        for k in set(sys.modules) - set(before):
            del sys.modules[k]


def test_reference_imports_nothing_of_the_port():
    for f in sorted(os.listdir(REFERENCE)):
        if not f.endswith(".py"):
            continue
        tree = ast.parse(open(os.path.join(REFERENCE, f)).read())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            for name in names:
                assert name.split(".")[0] in ("__future__", "perfbench", "torch", "numpy",
                                              "math", "dataclasses", "typing", "enum",
                                              "functools", "types"), (f, name)
    loaded = _loaded_after("import perfbench.reference.ppo, perfbench.reference.task, "
                           "perfbench.checks.train")
    assert "leibnizgym_tpu_torch" not in loaded and "leibnizgym_tpu" not in loaded

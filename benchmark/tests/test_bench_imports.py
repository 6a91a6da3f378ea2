"""Nothing the benchmark runs imports JAX or the JAX package: every
module of ``benchmark/`` by its imports, and a whole run's processes by
``sys.modules``, each name compared by its top-level part, whole (so
``qsvc_tpu_torch`` passes and ``qsvc_tpu`` does not)."""

import ast
import os
import subprocess
import sys

import pytest

from benchmark import spec as specs

FORBIDDEN = {"jax", "jaxlib", "flax", "qsvc_tpu"}


def _sources():
    for dirpath, _, files in os.walk(specs.HERE):
        if os.sep + "tests" in dirpath[len(specs.HERE):]:
            continue
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


@pytest.mark.parametrize("path", sorted(_sources()))
def test_module_imports(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    tops = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
    assert not tops & FORBIDDEN


def test_reference_imports_nothing_of_the_program():
    for path in _sources():
        if os.sep + "reference" + os.sep not in path:
            continue
        with open(path) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            if isinstance(node, ast.ImportFrom) and node.level == 0:
                assert node.module.split(".")[0] in (
                    "__future__", "typing", "dataclasses", "math", "numpy",
                    "torch", "struct"), (path, node.module)
            elif isinstance(node, ast.Import):
                for a in node.names:
                    assert a.name.split(".")[0] in (
                        "math", "numpy", "torch", "struct",
                        "dataclasses"), (path, a.name)


def test_run_processes_load_no_forbidden_module(tiny_root):
    code = (
        "import sys\n"
        "from benchmark import run, rank\n"
        "rc = run.main(['--workload', 'hd1080-lossy.encode', '--seed', '5',"
        " '--seconds', '2'], device='cpu', root=sys.argv[1])\n"
        "found = rank.forbidden_modules()\n"
        "print('FOUND', found)\n"
        "sys.exit(rc or bool(found))\n")
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    proc = subprocess.run([sys.executable, "-c", code, tiny_root],
                          cwd=specs.ROOT, capture_output=True, text=True,
                          timeout=300, env=env)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "FOUND []" in proc.stdout
    # the rank reports its own modules; a forbidden one stops the result
    assert '"correct": true' in proc.stdout


def test_forbidden_names_are_compared_whole(monkeypatch):
    from benchmark import rank
    monkeypatch.setitem(sys.modules, "qsvc_tpu_torch_like", sys)
    monkeypatch.setitem(sys.modules, "jaxish", sys)
    assert rank.forbidden_modules() == sorted(
        {m.split(".")[0] for m in sys.modules} & FORBIDDEN)
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert "jax" in rank.forbidden_modules()

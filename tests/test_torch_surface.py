"""The port's module surface: every public top-level function, class and
name bound by assignment (``analyze_jit = jax.jit(analyze, ...)``) of the
JAX package has a counterpart of the same name in the same module of
``qsvc_tpu_torch``, apart from the TPU/XLA scaffolding listed below.

Both packages are read with ``ast``, so nothing is imported."""

import ast
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_PKG = os.path.join(ROOT, "qsvc_tpu")
PORT_PKG = os.path.join(ROOT, "qsvc_tpu_torch")

#: names with no counterpart, each with why; a whole module is "module/*"
NOT_PORTED = {
    "api.py/prewarm": "XLA compile-cache prewarm; the port compiles nothing",
    "api.py/prewarm_decode": "XLA compile-cache prewarm of the decode",
    "utils/cachedir.py/*": "XLA persistent compilation cache directory",
    "ops/pallas_me.py/*": "the Pallas kernel K1; its port is csrc/",
    "ops/pallas_mc.py/*": "the Pallas kernels K2-K4; their port is csrc/",
    "parallel/mesh.py/put_sharded": "jax.Array placement on a device mesh; "
                                    "distributed.shard_video_gops takes "
                                    "its place",
}


def _bound_names(node):
    """Module-level names a statement binds: a def or class, or the
    plain-name targets of an assignment (``analyze_jit = jax.jit(...)``;
    tuple targets unpacked)."""
    if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
        return [node.name]
    if isinstance(node, ast.Assign):
        targets = node.targets
    elif isinstance(node, ast.AnnAssign):
        targets = [node.target]
    else:
        return []
    names = []
    for t in targets:
        elts = t.elts if isinstance(t, (ast.Tuple, ast.List)) else [t]
        names += [e.id for e in elts if isinstance(e, ast.Name)]
    return names


def _public_names(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    return [name for n in tree.body for name in _bound_names(n)
            if not name.startswith("_")]


def _jax_modules():
    out = []
    for dirpath, _, files in os.walk(JAX_PKG):
        for name in files:
            if name.endswith(".py"):
                out.append(os.path.relpath(os.path.join(dirpath, name),
                                           JAX_PKG))
    return sorted(out)


def _missing():
    missing = []
    for rel in _jax_modules():
        port = os.path.join(PORT_PKG, rel)
        have = set(_public_names(port)) if os.path.exists(port) else set()
        missing += [f"{rel}/{n}" for n in _public_names(
            os.path.join(JAX_PKG, rel)) if n not in have]
    return missing


def _allowed(entry):
    module = entry.rsplit("/", 1)[0]
    return entry in NOT_PORTED or f"{module}/*" in NOT_PORTED


def test_every_public_name_has_a_counterpart():
    left = [m for m in _missing() if not _allowed(m)]
    assert not left, f"not in the port: {left}"


@pytest.mark.parametrize("entry", sorted(NOT_PORTED))
def test_allow_list_names_only_what_is_missing(entry):
    """Each allow-list entry is still missing in the port and still in
    the JAX package (a stale entry would hide nothing)."""
    missing = _missing()
    if entry.endswith("/*"):
        module = entry[:-2]
        assert os.path.exists(os.path.join(JAX_PKG, module))
        assert not os.path.exists(os.path.join(PORT_PKG, module))
        assert any(m.startswith(module + "/") for m in missing)
    else:
        assert entry in missing

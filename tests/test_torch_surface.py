"""The port's module surface: every public top-level function, class and
name bound by assignment (``analyze_jit = jax.jit(analyze, ...)``) of the
JAX package has a counterpart of the same name in the same module of
``qsvc_tpu_torch``, apart from the TPU/XLA scaffolding listed below; and
every same-named public function and method takes the JAX one's
parameters (its positional parameters start with the JAX function's,
with the same names, order and default-ness, and whatever the port adds
has a default), apart from the adaptations listed below.

Both packages are read with ``ast``, so nothing is imported."""

import ast
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_PKG = os.path.join(ROOT, "qsvc_tpu")
PORT_PKG = os.path.join(ROOT, "qsvc_tpu_torch")

#: names with no counterpart, each with why; a whole module is "module/*"
NOT_PORTED = {
    "utils/cachedir.py/*": "XLA persistent compilation cache directory",
    "ops/pallas_me.py/*": "the Pallas kernel K1; its port is csrc/",
    "ops/pallas_mc.py/*": "the Pallas kernels K2-K4; their port is csrc/",
    "parallel/mesh.py/put_sharded": "jax.Array placement on a device mesh; "
                                    "distributed.shard_video_gops takes "
                                    "its place",
}


#: same-named functions whose parameters deliberately differ from the JAX
#: function's, each with why
ADAPTED = {
    "parallel/distributed.py/initialize":
        "joins a torch.distributed process group (device, init_method, "
        "world_size, rank), not jax.distributed's coordinator",
    "parallel/distributed.py/make_gop_mesh":
        "the mesh of a process group on a device, not of n jax devices",
    "parallel/mesh.py/make_mesh":
        "the mesh of a process group on a device, not of n jax devices",
    "parallel/transform.py/analyze_sharded":
        "no axis: a jax mesh axis name; the port's mesh is one group",
    "parallel/transform.py/synthesize_sharded":
        "no axis: a jax mesh axis name; the port's mesh is one group",
    "parallel/transform.py/encode_step_sharded":
        "no axis: a jax mesh axis name; the port's mesh is one group",
}

#: the functions whose contract was repaired to the JAX one's; none may
#: be adapted
JAX_CONTRACT = (
    "ops/entropy.py/histogram_entropy", "mctf/predict.py/predict_frame",
    "mctf/predict.py/refs_to_444", "mctf/predict.py/predict_frames_subpixel",
    "mctf/predict.py/decorrelate_from_pred",
    "mctf/predict.py/correlate_from_pred", "mctf/update.py/residue_to_444",
    "ops/blocks.py/gather_block_patches", "ops/blocks.py/blocks_to_image",
    "codec/frame_codec.py/encode_frames_select_sparse",
    "codec/frame_codec.py/decode_frames")


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


def _functions(path):
    """{name: ast.arguments} of the public top-level functions and the
    public methods (``Class.method``) of the public classes."""
    with open(path) as f:
        tree = ast.parse(f.read())
    out = {}
    for n in tree.body:
        if isinstance(n, ast.FunctionDef) and not n.name.startswith("_"):
            out[n.name] = n.args
        if isinstance(n, ast.ClassDef) and not n.name.startswith("_"):
            out.update((f"{n.name}.{m.name}", m.args) for m in n.body
                       if isinstance(m, ast.FunctionDef)
                       and not m.name.startswith("_"))
    return out


def _positional(args):
    """[(name, has a default)] of the positional parameters."""
    ps = args.posonlyargs + args.args
    first_default = len(ps) - len(args.defaults)
    return [(p.arg, i >= first_default) for i, p in enumerate(ps)]


def _keyword_only(args):
    return {a.arg: d is not None
            for a, d in zip(args.kwonlyargs, args.kw_defaults)}


def _parameter_faults(jax_args, port_args):
    """Why the port's parameters break the JAX function's calls, or []."""
    faults = []
    jp, tp = _positional(jax_args), _positional(port_args)
    if tp[:len(jp)] != jp:
        faults.append(f"positional {jp} != {tp[:len(jp)]}")
    faults += [f"added without a default: {n}" for n, d in tp[len(jp):]
               if not d]
    jk, tk = _keyword_only(jax_args), _keyword_only(port_args)
    faults += [f"keyword {n}" for n in jk if tk.get(n) != jk[n]]
    faults += [f"keyword added without a default: {n}" for n in tk
               if n not in jk and not tk[n]]
    return faults


def _shared_modules():
    return [rel for rel in _jax_modules()
            if os.path.exists(os.path.join(PORT_PKG, rel))]


def _module_parameter_faults(rel):
    """{"module/function": faults} of one module's same-named functions."""
    jax_fns = _functions(os.path.join(JAX_PKG, rel))
    port_fns = _functions(os.path.join(PORT_PKG, rel))
    out = {}
    for name, args in jax_fns.items():
        if name in port_fns:
            faults = _parameter_faults(args, port_fns[name])
            if faults:
                out[f"{rel}/{name}"] = faults
    return out


@pytest.mark.parametrize("rel", _shared_modules())
def test_same_named_functions_take_the_jax_parameters(rel):
    """A call written for the JAX function binds the same parameters in
    the port's."""
    left = {k: v for k, v in _module_parameter_faults(rel).items()
            if k not in ADAPTED}
    assert not left, left


@pytest.mark.parametrize("entry", sorted(ADAPTED))
def test_adapted_list_names_only_what_differs(entry):
    """Each adaptation still differs from the JAX function (a stale entry
    would hide nothing)."""
    rel = entry.rsplit("/", 1)[0]
    assert entry in _module_parameter_faults(rel)


def test_no_repaired_contract_is_adapted():
    assert not set(JAX_CONTRACT) & set(ADAPTED)
    for entry in JAX_CONTRACT:
        rel, name = entry.rsplit("/", 1)
        assert name in _functions(os.path.join(PORT_PKG, rel)), entry

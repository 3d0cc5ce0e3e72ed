"""The port's public API against the JAX package's.

The JAX package is read with ``ast`` and never imported, so this needs no
JAX and no TPU; the port is imported on the CPU.

(a) Every name that a package ``__init__.py`` of the JAX package binds is
    bound by the port's counterpart, which binds it itself; ``__all__`` and
    ``__version__`` are equal. (test_torch_isolation.py imports each port
    package alone in an interpreter that refuses the JAX package and finds
    the names on it.)
(b) For every module pair (``ops/pallas/<m>.py`` maps to
    ``ops/kernels/<m>.py``), every public module-level function, class and
    assignment of the JAX module, and every public method and constructor
    of its classes, exists in the port. Each JAX parameter exists in the
    port under the same name, at the same index wherever JAX's is
    positional, and the port requires no parameter that JAX does not.
(c) ``DIVERGENCES`` lists what the port changed on purpose, one line of
    reason each, as ROADMAP.md's divergences do. Every entry is still
    needed, and ROADMAP.md names it.
"""

import ast
import importlib
import inspect
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
JAX_PKG = ROOT / "taichislam_tpu"
PORT = "taichislam_tpu_torch"

# TPU tiling and Pallas interpret mode: the port's kernel wrappers take none
_KERNEL = ("ops/kernels/<m>.py is the CUDA counterpart; TPU tiling (rows, "
           "chunk) and Pallas interpret mode are not accepted")
_DRONE = "the drone axis is the rank: one state per process"
# key "jax/module.py::qualname" -> (reason, JAX parameters the port drops,
# the port's name where it differs). Past a dropped positional parameter the
# port takes keywords only, so that a call in JAX's positional form raises
# there instead of binding anew.
DIVERGENCES = {
    "ops/pallas/seg_accum.py::segmented_block_reduce":
        (_KERNEL, ("rows", "interpret"), None),
    "ops/pallas/seg_accum.py::segmented_block_accumulate":
        (_KERNEL, ("chunk", "interpret"), None),
    "ops/pallas/esdf_sweep.py::esdf_sweep_pallas":
        (_KERNEL, ("interpret",), "esdf_sweep"),
    "ops/pallas/esdf_sweep.py::esdf_sweep_loop_pallas":
        (_KERNEL, ("interpret",), "esdf_sweep_loop"),
    "parallel/multi_drone.py::make_drone_states":
        (_DRONE, ("n_drones",), None),
    "parallel/multi_drone.py::make_lifecycle_states":
        (_DRONE, ("n_drones",), None),
}

JAX_MODULES = sorted(p.relative_to(JAX_PKG).as_posix()
                     for p in JAX_PKG.rglob("*.py")
                     if "__pycache__" not in p.parts)
JAX_INITS = [m for m in JAX_MODULES if m.endswith("__init__.py")]


def port_module_name(rel):
    """``ops/pallas/seg_accum.py`` -> ``taichislam_tpu_torch.ops.kernels.
    seg_accum`` (``__init__.py`` names its package)."""
    parts = rel[:-3].split("/")
    if parts[:2] == ["ops", "pallas"]:
        parts[1] = "kernels"
    if parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join([PORT, *parts])


def port_path(rel):
    mod = port_module_name(rel).split(".")
    path = ROOT.joinpath(*mod)
    return path / "__init__.py" if rel.endswith("__init__.py") \
        else path.with_suffix(".py")


def _top_statements(body):
    """Module-level statements, including those under ``if`` / ``try``."""
    for node in body:
        if isinstance(node, ast.If):
            yield from _top_statements(node.body + node.orelse)
        elif isinstance(node, ast.Try):
            yield from _top_statements(
                node.body + node.orelse + node.finalbody
                + [s for h in node.handlers for s in h.body])
        else:
            yield node


def _assigned(node):
    targets = node.targets if isinstance(node, ast.Assign) else [node.target]
    for t in targets:
        for n in ast.walk(t):
            if isinstance(n, ast.Name):
                yield n.id


def bound_names(tree):
    """Names a module binds at top level: its definitions, and the names it
    imports from the package (``taichislam_tpu*`` or relative imports; not
    the standard library's)."""
    names = set()
    for node in _top_statements(tree.body):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            names.update(_assigned(node))
        elif isinstance(node, ast.ImportFrom):
            if node.level or (node.module or "").startswith("taichislam_tpu"):
                names.update(a.asname or a.name for a in node.names)
        elif isinstance(node, ast.Import):
            names.update(a.asname or a.name.split(".")[0] for a in node.names
                         if a.name.startswith("taichislam_tpu"))
    return names


def _parse(path):
    return ast.parse(path.read_text(), filename=str(path))


def _decorators(fn):
    out = set()
    for d in fn.decorator_list:
        while isinstance(d, ast.Call):
            d = d.func
        out.add(d.attr if isinstance(d, ast.Attribute) else
                getattr(d, "id", ""))
    return out


# ---- JAX signatures from the ast -------------------------------------------

POS, KW = "positional", "keyword"


def _jax_params(args: ast.arguments, drop_first=False):
    """[(name, kind, required)] with kind POS / KW, plus the var flags."""
    pos = args.posonlyargs + args.args
    pdef = [None] * (len(pos) - len(args.defaults)) + list(args.defaults)
    out = [(a.arg, POS, d is None) for a, d in zip(pos, pdef)]
    out += [(a.arg, KW, d is None)
            for a, d in zip(args.kwonlyargs, args.kw_defaults)]
    if drop_first:
        out = out[1:]
    return out, args.vararg is not None, args.kwarg is not None


def _field_params(cls: ast.ClassDef):
    """Constructor of a dataclass / NamedTuple: its annotated fields."""
    out = []
    for node in cls.body:
        if not isinstance(node, ast.AnnAssign) \
                or not isinstance(node.target, ast.Name):
            continue
        if "ClassVar" in ast.unparse(node.annotation):
            continue
        v = node.value
        if isinstance(v, ast.Call) and ast.unparse(v.func).endswith("field"):
            kws = {k.arg: k.value for k in v.keywords}
            if "init" in kws and ast.unparse(kws["init"]) == "False":
                continue
            req = "default" not in kws and "default_factory" not in kws
        else:
            req = v is None
        out.append((node.target.id, POS, req))
    return out, False, False


def _is_record(cls: ast.ClassDef):
    bases = {ast.unparse(b) for b in cls.bases}
    return "NamedTuple" in bases or "dataclass" in _decorators(cls)


def jax_api(rel):
    """{qualname: ("function" | "class" | "value" | "property", sig)} of
    the JAX module's public names; sig is (params, varargs, varkw) or None.
    A class's constructor is under ``Class.__init__``, its methods under
    ``Class.method``."""
    api = {}
    for node in _top_statements(_parse(JAX_PKG / rel).body):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            if not node.name.startswith("_"):
                api[node.name] = ("function", _jax_params(node.args))
        elif isinstance(node, ast.ClassDef):
            if node.name.startswith("_"):
                continue
            api[node.name] = ("class", None)
            if _is_record(node):
                api[f"{node.name}.__init__"] = ("function",
                                                _field_params(node))
            for fn in node.body:
                if not isinstance(fn, (ast.FunctionDef,
                                       ast.AsyncFunctionDef)):
                    continue
                if fn.name.startswith("_") and fn.name != "__init__":
                    continue
                deco = _decorators(fn)
                q = f"{node.name}.{fn.name}"
                if "property" in deco or "setter" in deco:
                    api[q] = ("property", None)
                elif "staticmethod" in deco:
                    api[q] = ("function", _jax_params(fn.args))
                else:  # methods and classmethods, compared without self/cls
                    api[q] = ("function", _jax_params(fn.args,
                                                      drop_first=True))
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            for name in _assigned(node):
                if not name.startswith("_"):
                    api[name] = ("value", None)
    return api


# ---- the port's signatures from inspect ------------------------------------

def _port_params(obj, drop_first):
    sig = inspect.signature(obj)
    ps = list(sig.parameters.values())
    if drop_first:
        ps = ps[1:]
    P = inspect.Parameter
    out = [(p.name, POS if p.kind in (P.POSITIONAL_ONLY,
                                      P.POSITIONAL_OR_KEYWORD) else KW,
            p.default is P.empty)
           for p in ps if p.kind not in (P.VAR_POSITIONAL, P.VAR_KEYWORD)]
    return (out, any(p.kind == P.VAR_POSITIONAL for p in ps),
            any(p.kind == P.VAR_KEYWORD for p in ps))


def port_object(mod, qual):
    """(kind, obj, drop_first) of ``qual`` in the port module: kind
    "missing", "attribute" (a property or a value) or "object". A
    constructor resolves to the class (signature without self); a method to
    its function, whose self / cls ``drop_first`` drops."""
    head, _, meth = qual.partition(".")
    if not hasattr(mod, head):
        return "missing", None, False
    obj = getattr(mod, head)
    if meth in ("", "__init__"):
        return "object", obj, False
    try:
        raw = inspect.getattr_static(obj, meth)
    except AttributeError:
        return "missing", None, False
    if isinstance(raw, staticmethod):
        return "object", raw.__func__, False
    if isinstance(raw, classmethod):
        return "object", raw.__func__, True
    if isinstance(raw, property) or not callable(raw):
        return "attribute", raw, False
    return "object", raw, True


def compare_signature(jax_sig, port_sig, dropped=()):
    """Differences between a JAX signature and the port's, as strings."""
    jparams, jvar, jkw = jax_sig
    pparams, pvar, pkw = port_sig
    errs = []
    pidx = {name: (i, kind) for i, (name, kind, _) in enumerate(pparams)}
    drop_at = next((i for i, (name, kind, _) in enumerate(jparams)
                    if name in dropped and kind == POS), None)
    for i, (name, kind, _) in enumerate(jparams):
        if name in dropped:
            continue
        if name not in pidx:
            errs.append(f"lacks parameter {name!r}")
            continue
        pi, pkind = pidx[name]
        if kind == POS and (drop_at is None or i < drop_at) \
                and (pi != i or pkind != POS):
            where = f"positional {pi}" if pkind == POS else "keyword-only"
            errs.append(f"{name!r} is positional {i} in JAX, {where} in "
                        "the port")
    late = [name for name, kind, _ in pparams[drop_at:] if kind == POS]
    if drop_at is not None and late:
        errs.append(f"{late} must be keyword-only: they follow a JAX "
                    "positional parameter the port drops")
    jreq = {name for name, _, req in jparams if req}
    for name, _, req in pparams:
        if req and name not in jreq:
            errs.append(f"requires {name!r}, which JAX does not")
    if jvar and not pvar:
        errs.append("lacks *args")
    if jkw and not pkw:
        errs.append("lacks **kwargs")
    return errs


def module_differences(rel):
    mod = importlib.import_module(port_module_name(rel))
    errs = []
    for qual, (kind, jsig) in jax_api(rel).items():
        _, dropped, name = DIVERGENCES.get(f"{rel}::{qual}", (None, (), None))
        pkind, obj, drop_first = port_object(mod, name or qual)
        if pkind == "missing":
            errs.append(f"{qual}: missing")
        elif kind == "function" and pkind != "object":
            errs.append(f"{qual}: not callable in the port")
        elif kind == "function":
            errs += [f"{qual}: {e}" for e in compare_signature(
                jsig, _port_params(obj, drop_first), dropped)]
    return errs


# ---- (a) package __init__ files --------------------------------------------

@pytest.mark.parametrize("rel", JAX_INITS)
def test_init_binds_jax_names(rel):
    want = {n for n in bound_names(_parse(JAX_PKG / rel))
            if not n.startswith("_") or n in ("__version__", "__all__")}
    have = bound_names(_parse(port_path(rel)))
    assert sorted(want - have) == [], \
        f"{port_path(rel).relative_to(ROOT)} does not bind them"
    pkg = importlib.import_module(port_module_name(rel))
    jtree = {node.targets[0].id: node.value
             for node in _parse(JAX_PKG / rel).body
             if isinstance(node, ast.Assign)
             and isinstance(node.targets[0], ast.Name)}
    if "__all__" in jtree:
        assert list(pkg.__all__) == ast.literal_eval(jtree["__all__"])
    if "__version__" in jtree:
        assert pkg.__version__ == ast.literal_eval(jtree["__version__"])


# ---- (b) module pairs -------------------------------------------------------

@pytest.mark.parametrize("rel", JAX_MODULES)
def test_module_api_matches_jax(rel):
    assert port_path(rel).exists(), f"no counterpart of {rel}"
    assert module_differences(rel) == []


# ---- (c) the divergences ----------------------------------------------------

@pytest.mark.parametrize("key", sorted(DIVERGENCES))
def test_divergence_is_needed_and_documented(key):
    rel, qual = key.split("::")
    reason, dropped, name = DIVERGENCES[key]
    assert reason
    _, jsig = jax_api(rel)[qual]
    assert set(dropped) <= {n for n, _, _ in jsig[0]}, \
        f"{key}: JAX has no {dropped}"
    # without the entry the port would differ: the entry is still needed
    mod = importlib.import_module(port_module_name(rel))
    _, obj, drop_first = port_object(mod, name or qual)
    assert name or compare_signature(jsig,
                                     _port_params(obj, drop_first)) != []
    assert f"`{key}`" in (ROOT / "ROADMAP.md").read_text(), \
        f"ROADMAP.md's divergences do not name {key}"


def test_signature_check_catches_misbinding():
    """A check of the check: the forms C2 repaired differ under it."""
    # JAX (spec, state, active_submap, rows=None) against (spec, state, rows)
    j = ([("spec", POS, True), ("state", POS, True),
          ("active_submap", POS, True), ("rows", POS, False)], False, False)
    p = ([("spec", POS, True), ("state", POS, True), ("rows", POS, True)],
         False, False)
    errs = compare_signature(j, p)
    assert any("active_submap" in e for e in errs)
    assert any("requires 'rows'" in e for e in errs)
    # a kernel wrapper whose lane_cap stays positional after dropped rows
    j = ([("bkey", POS, True), ("rows", POS, False),
          ("lane_cap", POS, False)], False, False)
    p = ([("bkey", POS, True), ("lane_cap", POS, False)], False, False)
    assert compare_signature(j, p, ("rows",)) != []
    assert compare_signature(j, ([("bkey", POS, True),
                                  ("lane_cap", KW, False)], False, False),
                             ("rows",)) == []

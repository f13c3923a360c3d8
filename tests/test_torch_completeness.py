"""The port is complete: every module of ``src/repro/`` has its
counterpart under ``src/repro_torch/`` holding the same public names.

For each reference module the scan (source only, with ``ast``; neither
package is imported) requires of the counterpart at the same path:

* every public top-level function, class and constant, and every name
  of the module's ``__all__``;
* every public method of each class (inherited ones count), and each
  class's constructor parameters (``__init__``'s, or a dataclass's
  annotated fields);
* every parameter name of each function and method the module defines
  (a name it only re-exports is checked where it is defined).

What the port leaves out on purpose is on :data:`EXCLUDED`, one reason an
entry.  An entry that no longer names a gap fails too, so the list stays
exact.  Private names (``_x``) are out of scope.

Run it alone with
``PYTHONPATH=src python -m pytest -q tests/test_torch_completeness.py``.
"""
from __future__ import annotations

import ast
import functools
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
REF = ROOT / "src" / "repro"
PORT = ROOT / "src" / "repro_torch"

_JIT = ("counts retraces of a jax.jit forward; the port runs eagerly and "
        "has no trace (nor the reference's whole-chain jit of "
        "TiledBackend.run_model)")
_TILES = "the Hopper kernels pick their own tiles"
_INTERPRET = "Pallas interpret mode; a CPU tensor runs the plain version"
_KEY = ("draws from a torch.Generator (its first parameter, gen) in place "
        "of a JAX PRNG key")
_AXIS = ("the port's tile mesh is a tuple of devices with no axis names, "
         "so an axis name would mean nothing")

# (reference module, item) -> why the port leaves it out.  An item is
# "<module>", "name", "Class.method", "name(param)" or
# "Class.method(param)".
EXCLUDED: dict[tuple[str, str], str] = {
    ("kernels/smm_conv/kernel.py", "<module>"):
        "the Pallas kernel; replaced by kernels/smm_conv/csrc/",
    ("kernels/codr_matmul/kernel.py", "<module>"):
        "the Pallas kernel; replaced by kernels/codr_matmul/csrc/",
    ("kernels/flash_attention/kernel.py", "<module>"):
        "the Pallas kernel; replaced by kernels/flash_attention/csrc/",
    ("launch/hlo_analysis.py", "<module>"):
        "parses XLA HLO text, which the port does not produce",
    ("launch/reanalyze.py", "<module>"):
        "re-runs hlo_analysis over saved XLA HLO text",
    ("core/api.py", "CompiledModel.trace_count"): _JIT,
    ("core/engine.py", "CodrConv2D.trace_count"): _JIT,
    ("core/engine.py", "CodrLinear.trace_count"): _JIT,
    ("core/engine.py", "CodrModel.trace_count"): _JIT,
    ("models/cache.py", "PagedKV.tree_flatten"):
        "JAX pytree registration",
    ("models/cache.py", "PagedKV.tree_unflatten"):
        "JAX pytree registration",
    ("runtime/loop.py", "TrainLoop.__init__(jit_kwargs)"):
        "arguments of jax.jit; the port's step is eager",
    ("kernels/smm_conv/ops.py", "smm_conv(interpret)"): _INTERPRET,
    ("kernels/smm_conv/ops.py", "smm_conv_batched(interpret)"): _INTERPRET,
    ("kernels/codr_matmul/ops.py", "codr_matmul(interpret)"): _INTERPRET,
    ("kernels/codr_matmul/ops.py", "codr_matmul(bm)"): _TILES,
    ("kernels/codr_matmul/ops.py", "codr_matmul(bn)"): _TILES,
    ("kernels/codr_matmul/ops.py", "codr_matmul(bk)"): _TILES,
    ("kernels/flash_attention/ops.py", "flash_attention_kernel(interpret)"):
        _INTERPRET,
    ("kernels/flash_attention/ops.py", "flash_attention_kernel(bq)"): _TILES,
    ("kernels/flash_attention/ops.py", "flash_attention_kernel(bk)"): _TILES,
    ("launch/dryrun.py", "run_cell(out_dir)"):
        "the directory the reference writes HLO text into; the port's "
        "records go to the CLI's --out",
    ("core/serving.py", "codr_compress_params(sample_cols)"):
        "deprecated alias of sample_rows (ROADMAP C)",
    ("models/common.py", "dense_init(key)"): _KEY,
    ("models/common.py", "embed_init(key)"): _KEY,
    ("models/attention.py", "gqa_init(key)"): _KEY,
    ("models/attention.py", "mla_init(key)"): _KEY,
    ("models/moe.py", "mlp_init(key)"): _KEY,
    ("models/moe.py", "moe_init(key)"): _KEY,
    ("models/ssm.py", "mamba_init(key)"): _KEY,
    ("models/ssm.py", "mlstm_init(key)"): _KEY,
    ("models/ssm.py", "slstm_init(key)"): _KEY,
    ("models/lm.py", "init_params(key)"): _KEY,
    ("models/encdec.py", "init_params(key)"): _KEY,
    ("data/pipeline.py", "make_batch_specs(dtype)"):
        "the reference accepts it and ignores it (tokens are int32 "
        "always); the port takes no argument that means nothing",
    ("sharding/rules.py", "tile_mesh(axis)"): _AXIS,
    ("sharding/rules.py", "shard_leading(axis)"): _AXIS,
    ("sharding/rules.py", "named_sharding_tree(paths_and_shapes)"):
        "the reference accepts it and ignores it; the port takes no "
        "argument that means nothing",
}


# ---------------------------------------------------------------------------
# the scan
# ---------------------------------------------------------------------------

@functools.cache
def _parse_text(text: str) -> ast.Module:
    return ast.parse(text)


def _parse(path: pathlib.Path) -> ast.Module:
    return _parse_text(path.read_text())


def _public(name: str) -> bool:
    return not name.startswith("_")


def _bindings(tree: ast.Module) -> dict:
    """Top-level name -> its def / class node, ``"const"``, or
    ``("import", module, name, level)``; through top-level ``if`` /
    ``try`` blocks too."""
    out: dict = {}

    def visit(body):
        for n in body:
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.ClassDef)):
                out[n.name] = n
            elif isinstance(n, ast.Assign):
                for t in n.targets:
                    for e in ast.walk(t):
                        if isinstance(e, ast.Name):
                            out.setdefault(e.id, "const")
            elif isinstance(n, ast.AnnAssign) and isinstance(n.target,
                                                             ast.Name):
                out.setdefault(n.target.id, "const")
            elif isinstance(n, (ast.Import, ast.ImportFrom)):
                for al in n.names:
                    name = al.asname or al.name.split(".")[0]
                    out.setdefault(name, ("import", getattr(n, "module", None),
                                          al.name, getattr(n, "level", 0)))
            elif isinstance(n, (ast.If, ast.Try)):
                visit(n.body)
                visit(n.orelse)
                for h in getattr(n, "handlers", []):
                    visit(h.body)
                visit(getattr(n, "finalbody", []))

    visit(tree.body)
    return out


def _dunder_all(tree: ast.Module) -> list[str]:
    for n in tree.body:
        if isinstance(n, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "__all__"
                for t in n.targets):
            return list(ast.literal_eval(n.value))
    return []


def _resolve(pkg: pathlib.Path, path: pathlib.Path, name: str, depth=0):
    """The node bound to ``name`` in module ``path``, following the
    package's own imports; ``None`` when it leaves the package."""
    if depth > 8 or not path.exists():
        return None
    v = _bindings(_parse(path)).get(name)
    if not isinstance(v, tuple):
        return v
    _, module, orig, level = v
    if level:
        base = path.parent
        for _ in range(level - 1):
            base = base.parent
        target = base.joinpath(*(module.split(".") if module else []))
    elif module and module.split(".")[0] == pkg.name:
        target = pkg.joinpath(*module.split(".")[1:])
    else:
        return None
    for cand in (target.with_suffix(".py"), target / "__init__.py"):
        if cand.exists():
            return _resolve(pkg, cand, orig, depth + 1)
    return None


def _params(fn) -> list[str]:
    a = fn.args
    names = [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs]
    if a.vararg:
        names.append("*" + a.vararg.arg)
    if a.kwarg:
        names.append("**" + a.kwarg.arg)
    return [n for n in names if n not in ("self", "cls")]


def _methods(pkg, path, cls: ast.ClassDef, depth=0) -> dict:
    """Methods of ``cls``, inherited ones from the package's own bases
    first."""
    out: dict = {}
    if depth < 6:
        for b in cls.bases:
            if isinstance(b, ast.Name):
                base = _resolve(pkg, path, b.id)
                if isinstance(base, ast.ClassDef):
                    out.update(_methods(pkg, path, base, depth + 1))
    for n in cls.body:
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out[n.name] = n
    return out


def _fields(cls: ast.ClassDef) -> list[str]:
    return [n.target.id for n in cls.body
            if isinstance(n, ast.AnnAssign) and isinstance(n.target, ast.Name)]


def _ctor_params(pkg, path, cls) -> list[str]:
    init = _methods(pkg, path, cls).get("__init__")
    return _params(init) if init is not None else _fields(cls)


def _fn_gaps(label: str, ref_fn, port_fn) -> list[str]:
    have = set(_params(port_fn))
    return [f"{label}({p})" for p in _params(ref_fn) if p not in have]


def gaps(ref_pkg: pathlib.Path, port_pkg: pathlib.Path, rel: str
         ) -> list[str]:
    """What module ``rel`` of ``ref_pkg`` has and its counterpart in
    ``port_pkg`` lacks, as items (see :data:`EXCLUDED`)."""
    rpath, ppath = ref_pkg / rel, port_pkg / rel
    if not ppath.exists():
        return ["<module>"]
    rtree = _parse(rpath)
    rb, pb = _bindings(rtree), _bindings(_parse(ppath))
    names = {n for n, v in rb.items() if _public(n) and not isinstance(v, tuple)}
    names |= set(_dunder_all(rtree))
    out = []
    for name in sorted(names):
        if name not in pb:
            out.append(name)
            continue
        if isinstance(rb.get(name), tuple):
            continue                     # a re-export: checked where defined
        rnode, pnode = rb[name], _resolve(port_pkg, ppath, name)
        if isinstance(rnode, (ast.FunctionDef, ast.AsyncFunctionDef)):
            if isinstance(pnode, (ast.FunctionDef, ast.AsyncFunctionDef)):
                out += _fn_gaps(name, rnode, pnode)
            elif not isinstance(pnode, ast.ClassDef):
                out.append(f"{name} (not a function)")
        elif isinstance(rnode, ast.ClassDef):
            if not isinstance(pnode, ast.ClassDef):
                out.append(f"{name} (not a class)")
                continue
            rm = _methods(ref_pkg, rpath, rnode)
            pm = _methods(port_pkg, ppath, pnode)
            have = set(_ctor_params(port_pkg, ppath, pnode))
            out += [f"{name}.__init__({p})"
                    for p in _ctor_params(ref_pkg, rpath, rnode)
                    if p not in have]
            for m, node in rm.items():
                if m == "__init__" or not (_public(m) or m == "__call__"):
                    continue
                if m not in pm:
                    out.append(f"{name}.{m}")
                else:
                    out += _fn_gaps(f"{name}.{m}", node, pm[m])
    return out


def _ref_modules() -> list[str]:
    return [str(p.relative_to(REF)) for p in sorted(REF.rglob("*.py"))]


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rel", _ref_modules())
def test_module_has_its_counterpart(rel):
    found = set(gaps(REF, PORT, rel))
    excluded = {item for (mod, item) in EXCLUDED if mod == rel}
    missing = sorted(found - excluded)
    assert not missing, (f"src/repro_torch/{rel} lacks {missing}: port "
                         f"them or add them to EXCLUDED with a reason")
    stale = sorted(excluded - found)
    assert not stale, f"EXCLUDED names {stale} of {rel}, which the port has"


def test_every_exclusion_names_a_reference_module_and_a_reason():
    modules = set(_ref_modules())
    for (mod, item), reason in EXCLUDED.items():
        assert mod in modules, (mod, item)
        assert reason.strip() and "\n" not in reason, (mod, item)


def test_scan_reports_what_a_port_lacks(tmp_path):
    """The scan on a made-up package pair: a missing function, method,
    constant, parameter and module each show as a gap."""
    ref, port = tmp_path / "refpkg", tmp_path / "portpkg"
    for pkg in (ref, port):
        (pkg / "sub").mkdir(parents=True)
        (pkg / "__init__.py").write_text("")
        (pkg / "sub" / "__init__.py").write_text("")
    (ref / "sub" / "m.py").write_text(
        "import dataclasses\n"
        "LIMIT = 3\n"
        "def f(a, *, b=1): ...\n"
        "def g(x): ...\n"
        "def _private(y): ...\n"
        "class Base:\n"
        "    def shared(self, k): ...\n"
        "class C(Base):\n"
        "    def __init__(self, w, *, t_m=4): ...\n"
        "    def run(self, x, *, kernel=False): ...\n"
        "    def tag(self): ...\n"
        "@dataclasses.dataclass\n"
        "class D:\n"
        "    a: int\n"
        "    b: int = 0\n")
    (ref / "sub" / "gone.py").write_text("def h(): ...\n")
    (ref / "sub" / "__init__.py").write_text(
        "from refpkg.sub.m import f, g\n__all__ = ['f', 'g']\n")
    (port / "sub" / "m.py").write_text(
        "import dataclasses\n"
        "def f(a): ...\n"
        "class Base:\n"
        "    def shared(self, k): ...\n"
        "class C(Base):\n"
        "    def __init__(self, w): ...\n"
        "    def run(self, x, *, kernel=False, device=None): ...\n"
        "@dataclasses.dataclass\n"
        "class D:\n"
        "    a: int\n")
    (port / "sub" / "__init__.py").write_text(
        "from portpkg.sub.m import f\n")
    assert gaps(ref, port, "sub/m.py") == [
        "C.__init__(t_m)", "C.tag", "D.__init__(b)", "LIMIT", "f(b)", "g"]
    assert gaps(ref, port, "sub/gone.py") == ["<module>"]
    assert gaps(ref, port, "sub/__init__.py") == ["g"]
    (port / "sub" / "m.py").write_text(
        (ref / "sub" / "m.py").read_text() + "def extra(z): ...\n")
    assert gaps(ref, port, "sub/m.py") == []

"""Run the JAX package's flowlint tests against both packages' rules.

A reference test (``tests/test_flowlint*.py``) lints synthetic sources
through ``flowlint.lint_source``, ``flowlint.build_tree_model`` +
``lint_model``, ``build_model`` + a rule module's functions, or
``flowlint.main`` on a fixture tree. ``run_twin(module, name)`` runs
that test with those names in its module swapped for shims: each call
runs the JAX package's function (whose result the test asserts on, as
it always does) and the port's on the same input, and records both
results. The caller then holds every recorded pair equal, with only the
package's name mapped: the port's site ids carry the package path
(``foundationdb_tpu_torch.server.foo:top:1037``) where the reference's
carry the path inside its package (``server.foo:top:1037``).

A fixture tree with its own tables (``package_root=tmp``) is mirrored
for the port into ``tmp + "-torch"``, its ``faultsites.txt`` ids mapped,
before every port call that reads it.
"""

import contextlib
import inspect
import io
import os
import re
import shutil
import types

from foundationdb_tpu.analysis import flowlint as jflowlint
from foundationdb_tpu.analysis import model as jmodel
from foundationdb_tpu.analysis.base import Finding as JFinding
from foundationdb_tpu.analysis.rules import BY_ID as JBY_ID
from foundationdb_tpu_torch.analysis import flowlint as tflowlint
from foundationdb_tpu_torch.analysis import model as tmodel
from foundationdb_tpu_torch.analysis.base import Finding as TFinding
from foundationdb_tpu_torch.analysis.rules import BY_ID as TBY_ID

PORT_PKG = "foundationdb_tpu_torch"

_TOP = ("analysis", "core", "layers", "native", "ops", "parallel",
        "resolver", "rpc", "server", "sim", "tools", "txn", "utils")
# a site id inside a package: module.dotted:qualname:code
_SITE = re.compile(r"(?<![\w./])((?:%s)(?:\.\w+)*:[\w.<>]+:(?:\d+|\*))"
                   % "|".join(_TOP))
_PKG = re.compile(r"\bfoundationdb_tpu\b(?!_torch)")

# the reference tests that lint no synthetic source: the JAX package's
# own tree, its checked-in tables or its runtime witnesses (the port's
# counterparts are the port's own tests)
_TREE_WORDS = ("package_dir", "_package_model", "default_lockorder_path",
               "default_baseline_path", "run_probe", "iter_py_files",
               "_thread_sites", "lockdep.", "faultcov.")
_LINT_WORDS = ("lint(", "lint_tree(", "lint_source(", "_fixture_tree(",
               "build_model(", "flowlint.main(")


def port_text(text):
    """The reference's text in the port's names: site ids prefixed with
    the port's package, the package name replaced."""
    return _PKG.sub(PORT_PKG, _SITE.sub(PORT_PKG + r".\1", text))


def port_value(v):
    """A reference result in the port's terms, for comparison."""
    if isinstance(v, JFinding):
        return TFinding(v.rule, v.path, v.line, port_text(v.message))
    if isinstance(v, str):
        return port_text(v)
    if isinstance(v, dict):
        return {port_value(k): port_value(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)) and not hasattr(v, "_fields"):
        return type(v)(port_value(x) for x in v)
    if isinstance(v, (set, frozenset)):
        return type(v)(port_value(x) for x in v)
    return v


def twin_cases(module):
    """Names of ``module``'s tests that lint a synthetic source."""
    out = []
    for name, fn in sorted(vars(module).items()):
        if not (name.startswith("test_") and inspect.isfunction(fn)):
            continue
        src = inspect.getsource(fn)
        if any(w in src for w in _LINT_WORDS) and not any(
                w in src for w in _TREE_WORDS):
            out.append(name)
    return out


def _port_rules(rules):
    if rules is None:
        return None
    return [TBY_ID[r.RULE] for r in rules]


def _unwrap(rules):
    if rules is None:
        return None
    return [getattr(r, "_ref", r) for r in rules]


class _Twin:
    """The state of one twin run: the recorded pairs and the port's
    model of each reference model."""

    def __init__(self):
        self.pairs = []        # (label, reference result, port result)
        self.models = {}       # id(reference model) -> (ref, port, root)

    def record(self, label, ref, port):
        self.pairs.append((label, ref, port))

    def mirror(self, root):
        """The port's copy of a fixture tree's table directory."""
        if root is None:
            return None
        dst = root.rstrip(os.sep) + "-torch"
        src_dir = os.path.join(root, "analysis")
        dst_dir = os.path.join(dst, "analysis")
        os.makedirs(dst_dir, exist_ok=True)
        if os.path.isdir(src_dir):
            for fn in os.listdir(src_dir):
                with open(os.path.join(src_dir, fn), encoding="utf-8") as f:
                    text = f.read()
                if fn == "faultsites.txt":
                    text = "\n".join(
                        port_text(line) if not line.lstrip().startswith("#")
                        else line for line in text.split("\n"))
                with open(os.path.join(dst_dir, fn), "w",
                          encoding="utf-8") as f:
                    f.write(text)
        return dst

    def port_model(self, ref_model):
        ref, port, root = self.models[id(ref_model)]
        if root is not None:
            self.mirror(root)
        return port

    # ── the shims ──
    def build_model(self, items, full_tree=False, package_root=None,
                    test_texts=None):
        ref = jmodel.build_model(items, full_tree=full_tree,
                                 package_root=package_root,
                                 test_texts=test_texts)
        port = tmodel.build_model(items, full_tree=full_tree,
                                  package_root=self.mirror(package_root),
                                  test_texts=test_texts)
        self.models[id(ref)] = (ref, port, package_root)
        return ref

    def flowlint(self):
        twin = self

        class Shim(types.ModuleType):
            def __getattr__(self, name):
                return getattr(jflowlint, name)

        shim = Shim("flowlint")

        def lint_source(relpath, text, rules=None):
            ref = jflowlint.lint_source(relpath, text, _unwrap(rules))
            port = tflowlint.lint_source(relpath, text,
                                         _port_rules(_unwrap(rules)))
            twin.record(f"lint_source {relpath}", ref, port)
            return ref

        def build_tree_model(items, abspaths=None):
            ref = jflowlint.build_tree_model(items, abspaths)
            port = tflowlint.build_tree_model(items, abspaths)
            twin.models[id(ref)] = (ref, port, None)
            return ref

        def lint_model(model, rules=None, timings=None):
            ref = jflowlint.lint_model(model, _unwrap(rules), timings)
            port = tflowlint.lint_model(twin.port_model(model),
                                        _port_rules(_unwrap(rules)))
            twin.record("lint_model", ref, port)
            return ref

        def main(argv=None):
            ref = jflowlint.main(argv)
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                port = tflowlint.main(argv)
            twin.record(f"main {argv[1:]}", ref, port)
            return ref

        shim.lint_source = lint_source
        shim.build_tree_model = build_tree_model
        shim.lint_model = lint_model
        shim.main = main
        return shim

    def rule(self, ref_mod):
        """A rule module whose model-taking functions run both rules."""
        twin = self
        port_mod = TBY_ID[ref_mod.RULE]

        class RuleShim(types.ModuleType):
            _ref = ref_mod

            def __getattr__(self, name):
                attr = getattr(ref_mod, name)
                if not callable(attr) or name not in (
                        "check_model", "enumerate_sites", "server_side_codes",
                        "rewrite_errortable", "rewrite_faultsites",
                        "rewrite_lockorder"):
                    return attr

                def both(model, *a, **kw):
                    ref = attr(model, *a, **kw)
                    if inspect.isgenerator(ref):
                        ref = list(ref)
                    port = getattr(port_mod, name)(
                        twin.port_model(model), *a, **kw)
                    if inspect.isgenerator(port):
                        port = list(port)
                    if name.startswith("rewrite_"):
                        # the two tables' paths: the fixture root and
                        # its mirror
                        twin.record(f"{ref_mod.RULE}.{name}",
                                    os.path.basename(ref),
                                    os.path.basename(port))
                    else:
                        twin.record(f"{ref_mod.RULE}.{name}", ref, port)
                    return ref
                return both

        return RuleShim(ref_mod.__name__)


def run_twin(module, name, request):
    """Run reference test ``name`` of ``module`` with the shims; returns
    the recorded (label, reference, port) pairs. ``request`` (pytest's)
    supplies the test's fixtures."""
    twin = _Twin()
    fn = getattr(module, name)
    patches = {"flowlint": twin.flowlint()}
    if "build_model" in vars(module):
        patches["build_model"] = twin.build_model
    for attr, val in vars(module).items():
        if isinstance(val, types.ModuleType) and val in JBY_ID.values():
            patches[attr] = twin.rule(val)
    saved = {k: vars(module)[k] for k in patches}
    kwargs = {p: request.getfixturevalue(p)
              for p in inspect.signature(fn).parameters}
    try:
        vars(module).update(patches)
        fn(**kwargs)
    finally:
        vars(module).update(saved)
        for v in kwargs.values():
            if isinstance(v, os.PathLike):
                shutil.rmtree(str(v) + "-torch", ignore_errors=True)
    return twin.pairs


def assert_twin(pairs):
    """Every recorded pair equal once the reference's is mapped."""
    assert pairs, "the reference test linted nothing"
    for label, ref, port in pairs:
        assert port == port_value(ref), (label, ref, port)


def port_tree_items():
    """``(items, abspaths)`` of the port's whole tree, as the CLI reads
    it."""
    pkg = tflowlint.package_dir()
    root = os.path.dirname(pkg)
    items, abspaths = [], {}
    for p in tflowlint.iter_py_files([pkg]):
        with open(p, encoding="utf-8") as f:
            rp = tflowlint.module_relpath(p, root)
            items.append((rp, f.read()))
            abspaths[rp] = os.path.abspath(p)
    return items, abspaths


def port_tree_model():
    """The port's full-tree model (tables, test texts and all)."""
    return tflowlint.build_tree_model(*port_tree_items())

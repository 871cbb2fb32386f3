"""FL011: fault-site coverage — the tree's coded-error fabrication
sites, enumerated and checked in.

Ref rationale: the reference's simulation swarm is only as good as the
error paths it reaches — ``flow/Error.h`` codes are fabricated at
known sites (``throw commit_unknown_result()``), and a chaos campaign
that never drives a site has not tested it. This rule statically
enumerates every fabrication site — ``err("name")``,
``FDBError.from_name("name")``, ``FDBError(<int literal>)`` — into the
checked-in witness ``analysis/faultsites.txt``, one site per line:

    foundationdb_tpu_torch.module.dotted:qualname:code    # error_name
    foundationdb_tpu_torch.module.dotted:qualname:*       # dynamic site

The module part carries the package path, exactly as the runtime
witness names a fired site (``utils/faultcov.py`` keys a frame by its
module under the package), so the table and a witness snapshot diff
with no mapping. The JAX package's table keys the same sites by the
path inside its package (``server.proxy:...``): the two tables compare
once that prefix is mapped.

``qualname`` is the dotted owner chain (``ClassName.method``,
``outer.inner``, ``<module>``) — derived by the same
:func:`~foundationdb_tpu_torch.utils.faultcov.qualname_index` logic the
runtime witness uses for frame attribution, so static and dynamic site
ids agree by construction. A call whose name/code argument is not a
constant (``FDBError.from_name(bad)``) enumerates as a ``*`` wildcard:
the site is known, the codes are not. An ``IfExp`` of two constant
names (``err("a" if c else "b")``) enumerates both codes.

On a FULL-TREE scan the computed site set must match the checked-in
file exactly — a new fabrication site fails until it is recorded
(``--fix-faultsites`` regenerates), and a recorded site the tree no
longer produces is stale, exactly like a stale baseline entry. Subset
and fixture scans skip the table compare (purely structural scans stay
self-contained).

Excluded from enumeration (mirrors the runtime witness's skip set):
``core/errors.py`` (constructor plumbing), ``rpc/wire.py``
(deserializes coded errors arriving off the wire — propagation, not
fabrication), and ``analysis/`` itself.

The runtime twin is ``utils/faultcov.py``; the coverage report tool
(``python -m foundationdb_tpu_torch.tools.faultcov``) diffs its fired set
against this table, and ``tests/test_flowlint_v3.py`` pins the
contract that the dynamic fired set is a subset of this enumeration.
"""

import ast
import os

from foundationdb_tpu_torch.analysis.base import Finding, dotted_name
from foundationdb_tpu_torch.utils.faultcov import PACKAGE, qualname_index

RULE = "FL011"
TITLE = "fault-site coverage: fabrication sites enumerated + checked in"
PROGRAM = True

FAULTSITES_RELPATH = "analysis/faultsites.txt"

EXCLUDED_FILES = frozenset({"core/errors.py", "rpc/wire.py"})
EXCLUDED_DIRS = ("analysis/",)

WILDCARD = "*"


def applies(relpath):
    return True


def _excluded(relpath):
    return relpath in EXCLUDED_FILES or relpath.startswith(EXCLUDED_DIRS)


def module_dotted(relpath):
    """``foundationdb_tpu_torch.server.proxy`` for ``server/proxy.py``:
    the module id the runtime witness gives a frame of that file."""
    base = relpath.replace("\\", "/")
    if base.endswith(".py"):
        base = base[:-3]
    if base.endswith("/__init__"):
        base = base[: -len("/__init__")]
    return PACKAGE + "." + base.replace("/", ".")


def _constant_names(arg):
    """The constant string names an argument expression may take:
    a Constant gives one, an IfExp over constants gives both, anything
    else gives None (dynamic)."""
    if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
        return [arg.value]
    if isinstance(arg, ast.IfExp):
        body = _constant_names(arg.body)
        orelse = _constant_names(arg.orelse)
        if body is not None and orelse is not None:
            return body + orelse
    return None


def fabrication_calls(fm):
    """Every fabrication call in one file:
    ``(call_node, kind, payload, qualname)`` where kind is

    * ``"name"``  — err()/from_name() with constant name(s); payload is
      the list of name strings,
    * ``"code"``  — FDBError(<int literal>); payload is the int code,
    * ``"dynamic"`` — a fabrication call whose name/code cannot be
      resolved statically; payload is None.

    ``FDBError(<non-constant>)`` outside the excluded files is treated
    as dynamic fabrication too (the tree's only dynamic-code
    constructor, wire.py's decoder, is excluded as propagation).

    Results are cached on the file model — FL009 and FL011 both walk
    the same sites, and the shared-model engine promises one pass per
    file."""
    cached = getattr(fm, "_fabrication_calls", None)
    if cached is not None:
        yield from cached
        return
    if fm.tree is None or _excluded(fm.relpath):
        fm._fabrication_calls = ()
        return
    qn_index = qualname_index(fm.tree)
    # a call's owner is the nearest enclosing def; walk with a stack
    out = []

    def owner_of(stack):
        return stack[-1] if stack else "<module>"

    def visit(node, stack):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                visit(child, stack + [qn_index.get(child.lineno,
                                                  child.name)])
                continue
            if isinstance(child, ast.Call):
                rec = _classify(child, owner_of(stack))
                if rec is not None:
                    out.append(rec)
            visit(child, stack)

    def _classify(call, owner):
        fn = call.func
        term = None
        if isinstance(fn, ast.Name):
            term = fn.id
        elif isinstance(fn, ast.Attribute):
            term = fn.attr
        if term == "err" or term == "from_name":
            # from_name must hang off an FDBError chain or be the
            # imported classmethod; err must be the bare binding — a
            # different object's .err()/.from_name() is not ours
            if term == "from_name":
                base = dotted_name(fn.value) if isinstance(
                    fn, ast.Attribute) else None
                if base is None or base.rsplit(".", 1)[-1] != "FDBError":
                    return None
            elif isinstance(fn, ast.Attribute):
                # dotted module form (errors.err(...)); anything else
                # dotted (self.err, obj.err) is not our factory
                base = dotted_name(fn.value)
                if base is None or base.rsplit(".", 1)[-1] != "errors":
                    return None
            if not call.args:
                return None
            names = _constant_names(call.args[0])
            if names is None:
                return (call, "dynamic", None, owner)
            return (call, "name", names, owner)
        if term == "FDBError" and not isinstance(fn, ast.Attribute):
            if not call.args:
                return None
            arg = call.args[0]
            if isinstance(arg, ast.Constant) and isinstance(
                    arg.value, int):
                return (call, "code", arg.value, owner)
            return (call, "dynamic", None, owner)
        return None

    visit(fm.tree, [])
    fm._fabrication_calls = tuple(out)
    yield from out


def enumerate_sites(model):
    """``{site_id: (relpath, line)}`` over the scanned tree — wildcard
    ids for dynamic sites, one id per (site, code) otherwise. Unknown
    names enumerate nothing here (FL009 owns that finding)."""
    from foundationdb_tpu_torch.core import errors as _errors

    sites = {}
    for relpath in sorted(model.files):
        fm = model.files[relpath]
        mod = module_dotted(relpath)
        for call, kind, payload, owner in fabrication_calls(fm):
            if kind == "dynamic":
                key = f"{mod}:{owner}:{WILDCARD}"
                sites.setdefault(key, (relpath, call.lineno))
                continue
            if kind == "code":
                codes = [payload]
            else:
                codes = []
                for name in payload:
                    try:
                        codes.append(_errors.code_for(name))
                    except ValueError:
                        continue  # FL009 reports the unknown name
            for code in codes:
                key = f"{mod}:{owner}:{code}"
                sites.setdefault(key, (relpath, call.lineno))
    return sites


# ── faultsites.txt ──
def load_faultsites(text):
    """``{site_id: file_line_number}`` — comments and blanks ignored."""
    out = {}
    for i, line in enumerate(text.splitlines(), 1):
        body = line.split("#", 1)[0].strip()
        if not body:
            continue
        out.setdefault(body, i)
    return out


def _faultsites_path(model):
    if model.package_root:
        return os.path.join(model.package_root, "analysis",
                            "faultsites.txt")
    return None


def _read_faultsites(model):
    path = _faultsites_path(model)
    if path and os.path.exists(path):
        with open(path, encoding="utf-8") as f:
            return f.read()
    return ""


def format_faultsites(sites):
    from foundationdb_tpu_torch.core import errors as _errors

    header = (
        "# flowlint FL011 fault-site witness — every coded-error\n"
        "# fabrication site in the tree, one per line:\n"
        "#   package.module.dotted:qualname:code    # error_name\n"
        "#   package.module.dotted:qualname:*       dynamic-name site\n"
        "# Regenerate: python -m foundationdb_tpu_torch.analysis.flowlint "
        "--fix-faultsites\n"
        "# A site here the tree no longer produces is STALE and fails\n"
        "# the lint; a new fabrication site fails until recorded here.\n"
        "# The runtime twin (utils/faultcov.py) fires these same ids;\n"
        "# python -m foundationdb_tpu_torch.tools.faultcov diffs the sets.\n"
    )
    lines = [header]
    for site in sorted(sites):
        code = site.rsplit(":", 1)[1]
        if code == WILDCARD:
            lines.append(f"{site}\n")
        else:
            lines.append(
                f"{site}    # {_errors.error_name(int(code))}\n")
    return "".join(lines)


def rewrite_faultsites(model):
    path = _faultsites_path(model)
    if path is None:
        raise RuntimeError("faultsites path requires a full-tree scan")
    sites = enumerate_sites(model)
    with open(path, "w", encoding="utf-8") as f:
        f.write(format_faultsites(sites))
    return path


def check_model(model):
    sites = enumerate_sites(model)
    if not model.full_tree:
        return
    declared = load_faultsites(_read_faultsites(model))
    for site in sorted(set(sites) - set(declared)):
        relpath, line = sites[site]
        yield Finding(
            RULE, relpath, line,
            f"unenumerated fault site: {site} — a new coded-error "
            f"fabrication site must be recorded in "
            f"{FAULTSITES_RELPATH} (--fix-faultsites) so chaos "
            f"coverage can be measured against it")
    for site in sorted(set(declared) - set(sites)):
        yield Finding(
            RULE, FAULTSITES_RELPATH, declared[site],
            f"stale fault site: {site} no longer occurs in the tree "
            f"— remove it (or --fix-faultsites)")


def check(tree, relpath):  # pragma: no cover - program rule
    return iter(())

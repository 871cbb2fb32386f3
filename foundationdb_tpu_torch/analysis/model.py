"""Shared whole-program model for flowlint v2.

flowlint's first five rules are per-function: each walks one file's
AST and never looks across a call. The tree has since grown eight
thread entry points and a v7 wire protocol, and the rules that police
them (FL006 lock-order, FL007 thread-escape, FL008 protocol/knob
drift) are inherently *cross-module*: a lock-order cycle is two
acquisition sites in two files, a thread-escape is a write site plus a
``threading.Thread(target=...)`` site somewhere else entirely.

This module parses the scanned tree ONCE into a :class:`ProgramModel`
— per-file ASTs, comment tables (via ``tokenize``, so a suppression
pattern quoted inside a docstring is not a suppression), class/method
indexes, lock-attribute declarations with Condition aliasing, and the
thread-root table — and every rule (old per-file and new program-wide)
reads from it. The engine builds one model per ``lint_paths`` run;
``lint_source`` builds a one-file model so fixtures keep working.

Lock identity is CLASS-based, like the kernel's lockdep: every
``self._lock = threading.Lock()`` declares the lock id
``"ClassName._lock"`` (or the string literal when constructed through
``utils.lockdep`` — ``lockdep.lock("ClassName._lock")`` — so the
static graph and the runtime witness agree on names by construction).
``threading.Condition(self._lock)`` ALIASES the wrapped lock: waiting
on a condition carved from the mutex is one lock, not two.
"""

import ast
import io
import re
import tokenize

from foundationdb_tpu_torch.analysis.base import dotted_name

_SUPPRESS_RE = re.compile(r"#\s*flowlint:\s*disable=([A-Z0-9,\s]+)")
_SUPPRESS_FILE_RE = re.compile(
    r"#\s*flowlint:\s*disable-file=([A-Z0-9,\s]+)"
)
_SHARED_RE = re.compile(r"#\s*flowlint:\s*shared\(([^)]*)\)")

# threading constructors (id derived from the attribute) and the
# lockdep factories (id taken from the name literal — static and
# runtime agree by construction)
_THREADING_CTORS = {"Lock": "lock", "RLock": "rlock",
                    "Condition": "condition"}
_LOCKDEP_CTORS = {"lock": "lock", "rlock": "rlock",
                  "condition": "condition"}


def parse_rule_list(text):
    return {r.strip() for r in text.replace(",", " ").split() if r.strip()}


def _comment_table(text):
    """[(lineno, comment_text)] for every REAL comment token — a
    ``# flowlint:`` pattern inside a docstring or string literal is
    documentation, not a directive."""
    out = []
    try:
        for tok in tokenize.generate_tokens(io.StringIO(text).readline):
            if tok.type == tokenize.COMMENT:
                out.append((tok.start[0], tok.string))
    except (tokenize.TokenError, IndentationError, SyntaxError):
        # tokenizer choked (the AST may still parse): degrade to the
        # historical line scan rather than dropping suppressions
        for i, line in enumerate(text.splitlines(), 1):
            if "#" in line:
                out.append((i, line[line.index("#"):]))
    return out


def _lock_ctor(node):
    """If ``node`` is a Call constructing a lock/condition, return
    ``(kind, name_literal_or_None, wrapped_expr_or_None)``; else None.

    Recognizes ``threading.Lock/RLock/Condition`` (bare imports too)
    and the ``lockdep.lock/rlock/condition`` factories.
    """
    if not isinstance(node, ast.Call):
        return None
    fn = dotted_name(node.func)
    if fn is None:
        return None
    terminal = fn.rsplit(".", 1)[-1]
    kind = None
    name = None
    wrapped = None
    if terminal in _THREADING_CTORS:
        kind = _THREADING_CTORS[terminal]
        if kind == "condition":
            if node.args:
                wrapped = node.args[0]
            for kw in node.keywords:
                if kw.arg == "lock":
                    wrapped = kw.value
    elif terminal in _LOCKDEP_CTORS and "lockdep" in fn.split("."):
        kind = _LOCKDEP_CTORS[terminal]
        args = list(node.args)
        if args and isinstance(args[0], ast.Constant) and \
                isinstance(args[0].value, str):
            name = args[0].value
        if kind == "condition" and len(args) > 1:
            wrapped = args[1]
        for kw in node.keywords:
            if kw.arg == "name" and isinstance(kw.value, ast.Constant):
                name = kw.value.value
            elif kw.arg == "lock":
                wrapped = kw.value
    else:
        return None
    return kind, name, wrapped


class ClassModel:
    """One class: methods, declared lock attributes (with Condition
    aliasing), field types from ``self.f = KnownClass(...)``, and
    thread targets (``threading.Thread(target=self.m)`` sites)."""

    __slots__ = ("name", "relpath", "node", "base_names", "methods",
                 "lock_attrs", "lock_kinds", "field_types",
                 "thread_targets")

    def __init__(self, name, relpath, node):
        self.name = name
        self.relpath = relpath
        self.node = node
        self.base_names = [dotted_name(b) for b in node.bases]
        self.methods = {}
        self.lock_attrs = {}     # attr -> lock id
        self.lock_kinds = {}     # lock id -> "lock"|"rlock"|"condition"
        self.field_types = {}    # attr -> class name
        self.thread_targets = {}  # method name -> thread name literal

    def _scan(self, known_classes):
        for item in self.node.body:
            if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self.methods[item.name] = item
        for meth in self.methods.values():
            local_locks = {}
            for sub in ast.walk(meth):
                if isinstance(sub, ast.Assign) and len(sub.targets) == 1:
                    tgt = sub.targets[0]
                    ctor = _lock_ctor(sub.value)
                    if ctor is not None:
                        kind, literal, wrapped = ctor
                        lock_id = literal
                        if lock_id is None and wrapped is not None:
                            lock_id = self._resolve_wrapped(
                                wrapped, local_locks)
                        if isinstance(tgt, ast.Attribute) and \
                                isinstance(tgt.value, ast.Name) and \
                                tgt.value.id == "self":
                            if lock_id is None:
                                lock_id = f"{self.name}.{tgt.attr}"
                            self.lock_attrs[tgt.attr] = lock_id
                            self.lock_kinds.setdefault(lock_id, kind)
                        elif isinstance(tgt, ast.Name):
                            if lock_id is None:
                                lock_id = (f"{self.name}.{meth.name}"
                                           f".{tgt.id}")
                            local_locks[tgt.id] = lock_id
                        continue
                    # field types: self.f = KnownClass(...)
                    if isinstance(tgt, ast.Attribute) and \
                            isinstance(tgt.value, ast.Name) and \
                            tgt.value.id == "self" and \
                            isinstance(sub.value, ast.Call):
                        fn = dotted_name(sub.value.func)
                        if fn is not None:
                            term = fn.rsplit(".", 1)[-1]
                            if term in known_classes:
                                self.field_types[tgt.attr] = term
                            elif term[:1].isupper():
                                # constructed from a class OUTSIDE the
                                # tree (threading.Thread, Event, ...):
                                # mark external so name-based method
                                # lookup never guesses at its methods
                                self.field_types.setdefault(
                                    tgt.attr, None)
                elif isinstance(sub, ast.Call):
                    fn = dotted_name(sub.func)
                    if fn is not None and \
                            fn.rsplit(".", 1)[-1] == "Thread":
                        target = None
                        tname = None
                        for kw in sub.keywords:
                            if kw.arg == "target":
                                target = kw.value
                            elif kw.arg == "name" and \
                                    isinstance(kw.value, ast.Constant):
                                tname = kw.value.value
                        if isinstance(target, ast.Attribute) and \
                                isinstance(target.value, ast.Name) and \
                                target.value.id == "self":
                            self.thread_targets.setdefault(
                                target.attr, tname)

    def _resolve_wrapped(self, expr, local_locks):
        """Condition(<expr>) aliasing: the condition IS the wrapped
        lock for ordering purposes."""
        if isinstance(expr, ast.Attribute) and \
                isinstance(expr.value, ast.Name) and \
                expr.value.id == "self":
            return self.lock_attrs.get(expr.attr)
        if isinstance(expr, ast.Name):
            return local_locks.get(expr.id)
        return None


class FileModel:
    """One parsed file: AST, comments, suppression tables, classes,
    module functions, module-level locks."""

    __slots__ = ("relpath", "text", "tree", "syntax_error", "comments",
                 "file_disabled", "line_disabled", "shared_annotations",
                 "classes", "module_funcs", "module_locks",
                 "imports", "import_files", "_fabrication_calls")

    def __init__(self, relpath, text):
        self.relpath = relpath
        self.text = text
        self.syntax_error = None
        self._fabrication_calls = None  # FL009/FL011 shared site cache
        try:
            self.tree = ast.parse(text)
        except SyntaxError as e:
            self.tree = None
            self.syntax_error = e
        self.comments = _comment_table(text) if self.tree is not None \
            else []
        self.file_disabled = set()
        self.line_disabled = {}
        self.shared_annotations = {}   # line -> reason
        for line, comment in self.comments:
            m = _SUPPRESS_FILE_RE.search(comment)
            if m:
                self.file_disabled |= parse_rule_list(m.group(1))
                continue
            m = _SUPPRESS_RE.search(comment)
            if m:
                self.line_disabled.setdefault(line, set()).update(
                    parse_rule_list(m.group(1)))
            m = _SHARED_RE.search(comment)
            if m:
                self.shared_annotations[line] = m.group(1).strip()
        self.classes = {}
        self.module_funcs = {}
        self.module_locks = {}
        self.imports = {}       # bound name -> dotted module path
        self.import_files = {}  # bound name -> relpath or None=external
        if self.tree is None:
            return
        for sub in ast.walk(self.tree):
            # lazy function-local imports included: a bound module name
            # is a module name wherever the binding happens
            if isinstance(sub, ast.Import):
                for alias in sub.names:
                    bound = alias.asname or alias.name.split(".")[0]
                    dotted = alias.name if alias.asname \
                        else alias.name.split(".")[0]
                    self.imports.setdefault(bound, dotted)
            elif isinstance(sub, ast.ImportFrom):
                for alias in sub.names:
                    if alias.name == "*":
                        continue
                    bound = alias.asname or alias.name
                    if sub.module:
                        dotted = ("." * sub.level + sub.module
                                  + "." + alias.name)
                    else:
                        dotted = "." * sub.level + alias.name
                    self.imports.setdefault(bound, dotted)
        for item in self.tree.body:
            if isinstance(item, ast.ClassDef):
                self.classes[item.name] = ClassModel(
                    item.name, relpath, item)
            elif isinstance(item, (ast.FunctionDef,
                                   ast.AsyncFunctionDef)):
                self.module_funcs[item.name] = item
            elif isinstance(item, ast.Assign) and \
                    len(item.targets) == 1 and \
                    isinstance(item.targets[0], ast.Name):
                ctor = _lock_ctor(item.value)
                if ctor is not None:
                    kind, literal, _ = ctor
                    var = item.targets[0].id
                    lock_id = literal or f"{self.module_stem()}.{var}"
                    self.module_locks[var] = lock_id

    def module_stem(self):
        parts = self.relpath.replace("\\", "/").split("/")
        stem = parts[-1]
        if stem == "__init__.py" and len(parts) > 1:
            return parts[-2]
        return stem[:-3] if stem.endswith(".py") else stem


class ProgramModel:
    """The whole scanned tree, parsed once and indexed for the
    program-wide rules.

    ``full_tree`` is True when the scan covers the real package (the
    anchor files ``rpc/wire.py`` and ``core/options.py`` are both
    present): only then do the tree-contract checks run (lockorder.txt
    comparison, dead-knob sweep, version-gate test references) —
    single-file fixture lints get pure structural checks (cycles,
    unlocked cross-thread writes, unpaired encode/decode arms).
    """

    def __init__(self, items, full_tree=False, package_root=None,
                 test_texts=None):
        self.files = {}
        for relpath, text in items:
            self.files[relpath] = FileModel(relpath, text)
        self.full_tree = full_tree
        self.package_root = package_root
        self.test_texts = test_texts  # {filename: text} or None
        # indexes
        self.classes = {}       # class name -> (FileModel, ClassModel)
        self.method_index = {}  # method name -> [(fm, cm, funcnode)]
        self.func_index = {}    # module fn name -> [(fm, funcnode)]
        self.lock_attr_index = {}  # attr -> sorted set of lock ids
        known = set()
        for fm in self.files.values():
            known |= set(fm.classes)
        for fm in self.files.values():
            for cm in fm.classes.values():
                cm._scan(known)
                self.classes.setdefault(cm.name, (fm, cm))
                for mname, mnode in cm.methods.items():
                    self.method_index.setdefault(mname, []).append(
                        (fm, cm, mnode))
                for attr, lock_id in cm.lock_attrs.items():
                    self.lock_attr_index.setdefault(attr, set()).add(
                        lock_id)
            for fname, fnode in fm.module_funcs.items():
                self.func_index.setdefault(fname, []).append(
                    (fm, fnode))
        # resolve import bindings to tree files: a bound name that maps
        # to a scanned module resolves precisely; one that maps nowhere
        # is EXTERNAL (os, threading, ...) and name-based method lookup
        # must never guess at its attributes
        dotted_map = {}
        for rp in self.files:
            base = rp.replace("\\", "/")
            if base.endswith(".py"):
                base = base[:-3]
            if base.endswith("/__init__"):
                base = base[: -len("/__init__")]
            dotted_map[base.replace("/", ".")] = rp
        for fm in self.files.values():
            for bound, dotted in fm.imports.items():
                fm.import_files[bound] = self._module_for(
                    dotted, fm.relpath, dotted_map)

    @staticmethod
    def _module_for(dotted, from_relpath, dotted_map):
        """Relpath of the tree module a dotted import names, or None
        for external modules. Absolute imports match on any dotted
        suffix (the scan roots at the package dir, so the package
        prefix is not part of relpath dotted forms); relative imports
        resolve against the importing file's directory."""
        if dotted.startswith("."):
            level = len(dotted) - len(dotted.lstrip("."))
            rest = [p for p in dotted.lstrip(".").split(".") if p]
            dirparts = from_relpath.replace("\\", "/").split("/")[:-1]
            if level > 1:
                dirparts = dirparts[: len(dirparts) - (level - 1)]
            parts = dirparts + rest
            key = ".".join(parts)
            return dotted_map.get(key)
        parts = dotted.split(".")
        for i in range(len(parts)):
            key = ".".join(parts[i:])
            if key in dotted_map:
                return dotted_map[key]
        return None

    def resolve_class(self, name):
        hit = self.classes.get(name)
        return hit[1] if hit else None

    def class_and_bases(self, cm):
        """cm plus every resolvable base class (single level of the
        tree's actual use; no MRO subtleties needed)."""
        out = [cm]
        seen = {cm.name}
        frontier = list(cm.base_names)
        while frontier:
            b = frontier.pop()
            if not b:
                continue
            b = b.rsplit(".", 1)[-1]
            if b in seen:
                continue
            seen.add(b)
            base = self.resolve_class(b)
            if base is not None:
                out.append(base)
                frontier.extend(base.base_names)
        return out

    def lookup_method(self, cm, name):
        """Resolve ``self.name()`` against cm and its bases."""
        for c in self.class_and_bases(cm):
            if name in c.methods:
                return c, c.methods[name]
        return None

    def lock_attr(self, cm, attr):
        """Resolve ``self.<attr>`` as a lock against cm and bases."""
        for c in self.class_and_bases(cm):
            if attr in c.lock_attrs:
                return c.lock_attrs[attr]
        return None


def build_model(items, full_tree=False, package_root=None,
                test_texts=None):
    return ProgramModel(items, full_tree=full_tree,
                        package_root=package_root,
                        test_texts=test_texts)

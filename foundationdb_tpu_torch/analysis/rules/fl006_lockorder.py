"""FL006: whole-program lock-order discipline.

The reference's flow runtime never deadlocks on mutexes because actors
do not hold them across waits; the Python port holds real
``threading`` locks across real calls, so the classic failure mode is
ABBA — thread 1 acquires ``A`` then ``B``, thread 2 acquires ``B``
then ``A``. This rule extracts every lock/Condition acquisition site
from the shared :class:`~foundationdb_tpu_torch.analysis.model.ProgramModel`,
builds the inter-procedural acquisition graph (lexical ``with``
nesting plus locks transitively acquired by resolvable callees), and:

* on ANY scan: fails on a potential cycle in the graph (an ABBA pair
  or longer ring), unless the participating edges are sanctioned as a
  reviewed ``A <> B`` pair in ``analysis/lockorder.txt``;
* on a FULL-TREE scan: additionally requires the computed edge set to
  match the checked-in ``lockorder.txt`` witness exactly — an edge the
  file does not declare is an undeclared ordering (review it, then
  ``--fix-lockorder``), and a declared edge the tree no longer
  produces is stale, exactly like a stale baseline entry.

Lock identity is class-based (``"BatchingCommitProxy._lock"``), the
same names the runtime lockdep witness (``utils/lockdep.py``) records,
so the static graph and the dynamic witness cross-check byte-for-byte.
``threading.Condition(self._lock)`` aliases the wrapped lock: the
condition and its mutex are ONE node, which is what makes the
``with self._wake: ... with self._lock:`` re-entry idiom clean rather
than a self-edge.

Call resolution is deliberately conservative: ``self.m()`` resolves
through the class and its bases; bare names resolve to same-file (or
globally unique) module functions; ``obj.m()`` resolves through a
global method-name index only when at most ``_METHOD_CAP`` classes
define ``m`` — ubiquitous names (``close``, ``get``) resolve nowhere
rather than everywhere, which keeps the graph honest enough that the
runtime witness's observed edges stay a subset of this rule's edges
(pinned by ``tests/test_flowlint_v2.py``).

lockorder.txt format::

    # comments and blanks ignored
    LockA -> LockB          # LockB acquired while LockA held
    LockA <> LockB          # reviewed pair: cycles through A/B sanctioned

Format of the lines is exact (one edge per line, names as emitted);
``python -m foundationdb_tpu_torch.analysis.flowlint --fix-lockorder``
regenerates the ``->`` section and preserves still-live ``<>`` lines.
"""

import ast
import os

from foundationdb_tpu_torch.analysis.base import Finding, dotted_name

RULE = "FL006"
TITLE = "lock-order"
PROGRAM = True

LOCKORDER_RELPATH = "analysis/lockorder.txt"

# obj.m() resolves through the global method index only when <= this
# many classes define m — generic names resolve nowhere, not everywhere
_METHOD_CAP = 5
# x.attr resolves to a lock via the attr-name index only when <= this
# many classes declare a lock under that attribute name
_ATTR_CAP = 3

# a bare builtin name is the builtin unless the SAME file shadows it —
# the package's top-level ``open()`` (the fdb API entry point) must not
# swallow every ``open(path)`` file call in the tree
import builtins as _builtins

_BUILTIN_NAMES = frozenset(dir(_builtins))

# dict/list/set method names never resolve through the method index:
# ``self._queue.pop()`` is a container op, not ``SomeClass.pop`` —
# matching it cross-class would wire container calls into the call
# graph of whichever classes happen to define the name
_CONTAINER_METHODS = frozenset({
    "append", "extend", "insert", "remove", "pop", "clear", "copy",
    "sort", "reverse", "index", "count", "add", "discard", "update",
    "get", "setdefault", "keys", "values", "items", "popitem",
    "join", "split", "strip", "encode", "decode", "format",
    "startswith", "endswith", "read", "write", "flush", "seek",
    "tell", "readline", "readlines",
})


def applies(relpath):
    return True


class _FuncInfo:
    __slots__ = ("fm", "cm", "node", "name", "locks", "entry_locks",
                 "calls", "edges")

    def __init__(self, fm, cm, node):
        self.fm = fm
        self.cm = cm
        self.node = node
        self.name = (f"{cm.name}.{node.name}" if cm else node.name)
        self.locks = set()        # every lock id acquired lexically
        self.entry_locks = set()  # ids acquired while holding NOTHING
        self.calls = []           # (call, top_ids, outer_ids, line)
        self.edges = {}       # (a, b) -> (relpath, line) lexical edges


def _iter_functions(model):
    for fm in model.files.values():
        if fm.tree is None:
            continue
        for cm in fm.classes.values():
            for node in cm.methods.values():
                yield _FuncInfo(fm, cm, node)
        for node in fm.module_funcs.values():
            yield _FuncInfo(fm, None, node)


class _Analyzer:
    def __init__(self, model, info):
        self.model = model
        self.info = info
        self.aliases = {}      # local name -> frozenset of lock ids
        self.local_locks = {}  # local name -> lock id (constructed here)
        self._collect_locals()

    def _collect_locals(self):
        from foundationdb_tpu_torch.analysis.model import _lock_ctor

        cm = self.info.cm
        fname = self.info.node.name
        owner = cm.name if cm else self.info.fm.module_stem()
        for sub in ast.walk(self.info.node):
            if isinstance(sub, ast.Assign) and len(sub.targets) == 1 \
                    and isinstance(sub.targets[0], ast.Name):
                ctor = _lock_ctor(sub.value)
                if ctor is not None:
                    kind, literal, wrapped = ctor
                    lock_id = literal
                    if lock_id is None and wrapped is not None:
                        ids = self.resolve(wrapped)
                        lock_id = min(ids) if ids else None
                    if lock_id is None:
                        lock_id = f"{owner}.{fname}.{sub.targets[0].id}"
                    self.local_locks[sub.targets[0].id] = lock_id
        # two passes so alias-of-alias assignments settle regardless of
        # walk order (the tree only ever needs one hop)
        for _ in range(2):
            for sub in ast.walk(self.info.node):
                if isinstance(sub, ast.Assign) and \
                        len(sub.targets) == 1 and \
                        isinstance(sub.targets[0], ast.Name) and \
                        _lock_ctor(sub.value) is None:
                    ids = self.resolve(sub.value)
                    if ids:
                        self.aliases[sub.targets[0].id] = ids

    def resolve(self, expr):
        """Lock ids an expression may denote (frozenset, possibly
        empty). Conservative: unresolvable means no ids, not all."""
        model, cm = self.model, self.info.cm
        if isinstance(expr, ast.Name):
            if expr.id in self.local_locks:
                return frozenset((self.local_locks[expr.id],))
            if expr.id in self.aliases:
                return self.aliases[expr.id]
            if expr.id in self.info.fm.module_locks:
                return frozenset((self.info.fm.module_locks[expr.id],))
            return frozenset()
        if isinstance(expr, ast.Attribute):
            base = expr.value
            if isinstance(base, ast.Name) and base.id == "self" and \
                    cm is not None:
                lock_id = model.lock_attr(cm, expr.attr)
                return frozenset((lock_id,)) if lock_id else frozenset()
            # mod.X through an import binding: another tree module's
            # module-level lock, or nothing if the module is external
            if isinstance(base, ast.Name) and \
                    base.id in self.info.fm.import_files:
                rp = self.info.fm.import_files[base.id]
                f2 = model.files.get(rp) if rp else None
                if f2 is not None and expr.attr in f2.module_locks:
                    return frozenset((f2.module_locks[expr.attr],))
                return frozenset()
            # self.f.X through a known field type (None = external
            # class: typed, but definitely owns no tree lock)
            if isinstance(base, ast.Attribute) and \
                    isinstance(base.value, ast.Name) and \
                    base.value.id == "self" and cm is not None and \
                    base.attr in cm.field_types:
                ftype = cm.field_types[base.attr]
                if ftype:
                    c2 = model.resolve_class(ftype)
                    if c2 is not None:
                        lock_id = model.lock_attr(c2, expr.attr)
                        if lock_id:
                            return frozenset((lock_id,))
                return frozenset()
            # cross-object by attribute name, capped so ubiquitous
            # names ("_lock") resolve nowhere rather than everywhere
            ids = model.lock_attr_index.get(expr.attr)
            if ids and len(ids) <= _ATTR_CAP:
                return frozenset(ids)
        return frozenset()

    def resolve_call(self, call):
        """AST nodes of the callables this call may reach."""
        model, fm, cm = self.model, self.info.fm, self.info.cm
        fn = call.func
        if isinstance(fn, ast.Name):
            if fn.id in fm.module_funcs:
                return [fm.module_funcs[fn.id]]
            if fn.id in _BUILTIN_NAMES:
                return []
            hits = model.func_index.get(fn.id, [])
            if len(hits) == 1:
                return [hits[0][1]]
            # ClassName(...) runs __init__
            target_cm = model.resolve_class(fn.id)
            if target_cm is not None:
                hit = model.lookup_method(target_cm, "__init__")
                if hit is not None:
                    return [hit[1]]
            return []
        if not isinstance(fn, ast.Attribute):
            return []
        name = fn.attr
        base = fn.value
        if isinstance(base, ast.Name) and base.id == "self" and \
                cm is not None:
            hit = model.lookup_method(cm, name)
            if hit is not None:
                return [hit[1]]
            # self.<callable-field>() — untypable; fall through to the
            # capped index only if the field has a known class type
            return []
        if isinstance(base, ast.Name) and base.id in fm.import_files:
            # mod.f() / mod.Class() through an import binding: precise
            # for tree modules, nothing for external ones (os.path,
            # threading, ... must never hit the name index)
            rp = fm.import_files[base.id]
            f2 = model.files.get(rp) if rp else None
            if f2 is not None:
                if name in f2.module_funcs:
                    return [f2.module_funcs[name]]
                c2 = f2.classes.get(name)
                if c2 is not None:
                    hit = model.lookup_method(c2, "__init__")
                    if hit is not None:
                        return [hit[1]]
            return []
        if isinstance(base, ast.Attribute) and not (
                isinstance(base.value, ast.Name)
                and base.value.id == "self"):
            root = base
            while isinstance(root, ast.Attribute):
                root = root.value
            if isinstance(root, ast.Name) and \
                    root.id in fm.import_files:
                # dotted module chain (os.path.exists, pkg.mod.fn):
                # never a tree-object method call
                return []
        if isinstance(base, ast.Call) and \
                isinstance(base.func, ast.Name) and \
                base.func.id == "super" and cm is not None:
            for c in self.model.class_and_bases(cm)[1:]:
                if name in c.methods:
                    return [c.methods[name]]
            return []
        if isinstance(base, ast.Attribute) and \
                isinstance(base.value, ast.Name) and \
                base.value.id == "self" and cm is not None and \
                base.attr in cm.field_types:
            ftype = cm.field_types[base.attr]
            if ftype:
                c2 = model.resolve_class(ftype)
                if c2 is not None:
                    hit = model.lookup_method(c2, name)
                    if hit is not None:
                        return [hit[1]]
            # typed field (tree class without the method, or external
            # like threading.Thread): never guess via the name index
            return []
        if name in _CONTAINER_METHODS:
            return []
        hits = model.method_index.get(name, [])
        if 0 < len(hits) <= _METHOD_CAP:
            return [h[2] for h in hits]
        return []

    # ── the held-stack walk ──
    def run(self):
        self._stmts(self.info.node.body, [])

    def _stmts(self, stmts, held):
        for st in stmts:
            self._stmt(st, held)

    def _stmt(self, st, held):
        if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef,
                           ast.ClassDef)):
            return  # nested defs run later, not here
        if isinstance(st, (ast.With, ast.AsyncWith)):
            ids = frozenset()
            for item in st.items:
                self._expr(item.context_expr, held)
                ids |= self.resolve(item.context_expr)
                if item.optional_vars is not None and \
                        isinstance(item.optional_vars, ast.Name) and ids:
                    self.aliases[item.optional_vars.id] = ids
            outer = set().union(*held) if held else set()
            new = ids - outer
            if held and new:
                site = (self.info.fm.relpath, st.lineno)
                for a in sorted(held[-1]):
                    for b in sorted(new):
                        self.info.edges.setdefault((a, b), site)
            elif new:
                self.info.entry_locks |= new
            self._stmts(st.body, held + [new] if new else held)
            if ids:
                self.info.locks |= ids
            return
        for child in ast.iter_child_nodes(st):
            if isinstance(child, ast.stmt):
                self._stmt(child, held)
            elif isinstance(child, ast.expr):
                self._expr(child, held)
            elif isinstance(child, (ast.excepthandler,)):
                self._stmts(child.body, held)
            elif isinstance(child, ast.withitem):
                self._expr(child.context_expr, held)
        # orelse/finalbody/body lists reached via iter_child_nodes

    def _expr(self, expr, held):
        for sub in ast.walk(expr):
            if isinstance(sub, ast.Call):
                top = frozenset(held[-1]) if held else frozenset()
                outer = frozenset().union(*held) if held else frozenset()
                self.info.calls.append(
                    (sub, top, outer, getattr(sub, "lineno", 0)))


def compute_graph(model):
    """(edges, funcs): edges maps (a, b) -> first (relpath, line) site.

    Edges mirror the runtime witness's ADJACENCY semantics: lexical
    ``with`` nesting, plus — for a call made while holding a lock —
    the callee's ENTRY locks (locks it may acquire while its own held
    stack is empty, transitively through calls it makes unlocked).
    Deeper nesting inside the callee produces its own edges at its own
    sites, so transitive ordering shows as a path A -> B -> C, not a
    flattened closure — which keeps lockorder.txt reviewable and
    matches exactly what the dynamic lockdep records."""
    funcs = []
    for info in _iter_functions(model):
        an = _Analyzer(model, info)
        an.run()
        funcs.append((info, an))

    # entry summaries: locks a function may acquire with nothing held
    entry = {info.node: set(info.entry_locks) for info, _ in funcs}
    resolved_calls = {}
    for info, an in funcs:
        rc = []
        for call, top, outer, line in info.calls:
            callees = [c for c in an.resolve_call(call) if c in entry]
            if callees:
                rc.append((callees, top, outer, line))
        resolved_calls[info.node] = rc
    changed = True
    while changed:
        changed = False
        for info, _ in funcs:
            s = entry[info.node]
            before = len(s)
            for callees, top, _, _ in resolved_calls[info.node]:
                if top:
                    continue  # held-call acquisitions are not entry
                for c in callees:
                    s |= entry[c]
            if len(s) != before:
                changed = True

    edges = {}
    for info, _ in funcs:
        for key, site in sorted(info.edges.items()):
            edges.setdefault(key, site)
        for callees, top, outer, line in resolved_calls[info.node]:
            if not top:
                continue
            reach = set()
            for c in callees:
                reach |= entry[c]
            site = (info.fm.relpath, line)
            for a in sorted(top):
                for b in sorted(reach - set(outer)):
                    if a != b:
                        edges.setdefault((a, b), site)
    return edges, funcs


# ── lockorder.txt ──
def load_lockorder(text):
    """(declared_edges {(a,b): line}, sanctioned_pairs
    {frozenset({a,b}): line})."""
    declared, pairs = {}, {}
    for i, line in enumerate(text.splitlines(), 1):
        body = line.split("#", 1)[0].strip()
        if not body:
            continue
        if "<>" in body:
            a, _, b = body.partition("<>")
            pairs[frozenset((a.strip(), b.strip()))] = i
        elif "->" in body:
            a, _, b = body.partition("->")
            declared[(a.strip(), b.strip())] = i
    return declared, pairs


def _lockorder_path(model):
    if model.package_root:
        return os.path.join(model.package_root, "analysis",
                            "lockorder.txt")
    return None


def _read_lockorder(model):
    path = _lockorder_path(model)
    if path and os.path.exists(path):
        with open(path, encoding="utf-8") as f:
            return f.read()
    return ""


def format_lockorder(edges, pairs):
    """The witness file: preserved sanctioned pairs, then every
    computed edge not covered by a pair, sorted."""
    header = (
        "# flowlint FL006 lock-order witness — the tree's complete\n"
        "# inter-procedural lock-acquisition graph, one edge per "
        "line:\n"
        "#   A -> B    B is acquired while A is held\n"
        "#   A <> B    reviewed pair: cycles through A/B are "
        "sanctioned\n"
        "# Regenerate the '->' section: python -m "
        "foundationdb_tpu_torch.analysis.flowlint --fix-lockorder\n"
        "# An edge here the tree no longer produces is STALE and "
        "fails the\n"
        "# lint (like a stale baseline entry); a new edge fails until "
        "it is\n"
        "# reviewed and recorded here.\n"
    )
    lines = [header]
    for pair in sorted(pairs, key=sorted):
        a, b = sorted(pair)
        lines.append(f"{a} <> {b}\n")
    covered = {tuple(sorted(p)) for p in pairs}
    for a, b in sorted(edges):
        if tuple(sorted((a, b))) in covered:
            continue
        lines.append(f"{a} -> {b}\n")
    return "".join(lines)


def rewrite_lockorder(model):
    edges, _ = compute_graph(model)
    _, pairs = load_lockorder(_read_lockorder(model))
    live = {}
    for pair, line in pairs.items():
        a, b = sorted(pair)
        if (a, b) in edges or (b, a) in edges:
            live[pair] = line
    path = _lockorder_path(model)
    if path is None:
        raise RuntimeError("lockorder path requires a full-tree scan")
    with open(path, "w", encoding="utf-8") as f:
        f.write(format_lockorder(edges, live))
    return path


# ── cycles ──
def _sccs(nodes, adj):
    """Tarjan, iterative; yields SCCs with >= 2 nodes."""
    index = {}
    low = {}
    on_stack = set()
    stack = []
    counter = [0]
    out = []
    for root in sorted(nodes):
        if root in index:
            continue
        work = [(root, iter(sorted(adj.get(root, ()))))]
        index[root] = low[root] = counter[0]
        counter[0] += 1
        stack.append(root)
        on_stack.add(root)
        while work:
            v, it = work[-1]
            advanced = False
            for w in it:
                if w not in index:
                    index[w] = low[w] = counter[0]
                    counter[0] += 1
                    stack.append(w)
                    on_stack.add(w)
                    work.append((w, iter(sorted(adj.get(w, ())))))
                    advanced = True
                    break
                if w in on_stack:
                    low[v] = min(low[v], index[w])
            if advanced:
                continue
            work.pop()
            if work:
                u = work[-1][0]
                low[u] = min(low[u], low[v])
            if low[v] == index[v]:
                scc = []
                while True:
                    w = stack.pop()
                    on_stack.discard(w)
                    scc.append(w)
                    if w == v:
                        break
                if len(scc) > 1:
                    out.append(sorted(scc))
    return out


def _cycle_path(scc, adj):
    """A concrete cycle within the SCC, starting at its min node."""
    start = scc[0]
    members = set(scc)
    path = [start]
    seen = {start}
    node = start
    while True:
        nxt = None
        for w in sorted(adj.get(node, ())):
            if w == start and len(path) > 1:
                return path + [start]
            if w in members and w not in seen:
                nxt = w
                break
        if nxt is None:
            return path + [start]  # SCC guarantees an edge back
        path.append(nxt)
        seen.add(nxt)
        node = nxt


def find_cycles(edges, sanctioned_pairs):
    adj = {}
    for (a, b) in edges:
        if frozenset((a, b)) in sanctioned_pairs:
            continue
        adj.setdefault(a, set()).add(b)
    nodes = set(adj)
    for tos in adj.values():
        nodes |= tos
    return [( _cycle_path(scc, adj), scc) for scc in _sccs(nodes, adj)]


def check_model(model):
    edges, _ = compute_graph(model)
    declared, pairs = ({}, {})
    lockorder_text = _read_lockorder(model) if model.full_tree else ""
    if model.full_tree:
        declared, pairs = load_lockorder(lockorder_text)
    else:
        # fixture scans still honor sanctioned pairs when the source
        # set happens to include a lockorder file? No file: structural
        # cycle detection only.
        pass

    for cycle_path, scc in find_cycles(edges, pairs):
        arrows = " -> ".join(cycle_path)
        first = tuple(cycle_path[:2])
        site = edges.get(first)
        if site is None:
            site = edges[sorted(
                k for k in edges if k[0] in scc and k[1] in scc)[0]]
        yield Finding(
            RULE, site[0], site[1],
            f"potential lock-order cycle: {arrows} — break the "
            f"ordering, or sanction the reviewed pair with "
            f"'{scc[0]} <> {scc[1]}' in {LOCKORDER_RELPATH}")

    if not model.full_tree:
        return

    covered = {tuple(sorted(p)) for p in pairs}
    for (a, b), site in sorted(edges.items(), key=lambda kv: kv[1]):
        if (a, b) in declared or tuple(sorted((a, b))) in covered:
            continue
        yield Finding(
            RULE, site[0], site[1],
            f"undeclared lock-order edge: {a} -> {b} (acquires '{b}' "
            f"while holding '{a}') — review, then record it via "
            f"--fix-lockorder")
    for (a, b), line in sorted(declared.items()):
        if (a, b) not in edges:
            yield Finding(
                RULE, LOCKORDER_RELPATH, line,
                f"stale lockorder entry: {a} -> {b} no longer occurs "
                f"in the tree — remove it (or --fix-lockorder)")
    for pair, line in sorted(pairs.items(), key=lambda kv: kv[1]):
        a, b = sorted(pair)
        if (a, b) not in edges and (b, a) not in edges:
            yield Finding(
                RULE, LOCKORDER_RELPATH, line,
                f"stale lockorder sanction: {a} <> {b} matches no "
                f"remaining edge — remove it")


def check(tree, relpath):  # pragma: no cover - program rule
    return iter(())

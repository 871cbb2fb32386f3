"""FL007: thread-escape — cross-thread attribute writes need a lock.

The "added a field to the batcher, forgot the mutex" class: an
instance attribute written from two or more THREAD ROOTS of the same
class must be written with a common lock held at every write site, or
carry an explicit ``# flowlint: shared(reason)`` annotation (on the
write line, the line above, or the attribute's ``__init__``
assignment). Single-thread-confined state — attributes only ever
written from one root — needs nothing.

Thread roots of a class are its ``threading.Thread(target=self.m)``
target methods (from the shared model's thread-target table) plus one
EXTERNAL root covering every public method — the caller's thread.
Reachability is the intra-class ``self.m()`` call graph, including
bare ``self.m`` references (handed-off callbacks run where they are
called, which may be another thread). A private helper reachable from
only one root stays single-thread-confined; ``__init__`` writes are
construction-time (happens-before the thread starts) and exempt.

The "common lock" requirement is the real invariant: holding *some*
lock at each site individually is not enough — two sites under two
different locks still race. The intersection of held-lock sets across
all write sites must be non-empty (lock identity comes from the model,
with Condition-wrapping-the-mutex aliasing, so ``with self._wake:``
counts as holding ``self._lock`` when the condition wraps it).
"""

import ast

from foundationdb_tpu_torch.analysis.base import Finding

RULE = "FL007"
TITLE = "thread-escape"
PROGRAM = True

_EXTERNAL = "<external>"


def applies(relpath):
    return True


def _thread_target_refs(node):
    """id()s of ``self.m`` nodes passed as ``target=`` to a Thread
    construction — those do NOT run on the caller's thread (they define
    a thread root), so they must not count as caller reachability."""
    out = set()
    for sub in ast.walk(node):
        if isinstance(sub, ast.Call) and isinstance(
                sub.func, (ast.Name, ast.Attribute)):
            name = sub.func.id if isinstance(sub.func, ast.Name) \
                else sub.func.attr
            if name == "Thread":
                for kw in sub.keywords:
                    if kw.arg == "target":
                        out.add(id(kw.value))
    return out


def _method_refs(node):
    """Names of self.<m> references in a method body: calls AND bare
    references (callback handoff) — minus Thread targets, which run on
    the spawned thread, not the caller's."""
    skip = _thread_target_refs(node)
    out = set()
    for sub in ast.walk(node):
        if isinstance(sub, ast.Attribute) and \
                isinstance(sub.value, ast.Name) and \
                sub.value.id == "self" and id(sub) not in skip:
            out.add(sub.attr)
    return out


def _own_exprs(st):
    """Expression nodes belonging to statement ``st`` itself — nested
    statements (compound bodies) are visited separately at their own
    held level."""
    stack = [v for v in ast.iter_child_nodes(st)
             if not isinstance(v, (ast.stmt, ast.excepthandler))]
    while stack:
        n = stack.pop()
        yield n
        stack.extend(v for v in ast.iter_child_nodes(n)
                     if not isinstance(v, (ast.stmt, ast.excepthandler)))


def _method_sites(model, fm, cm, method):
    """Walk one method with the held-lock stack:

    * writes: ``(attr, line, held_lock_ids)`` for every ``self.X``
      assignment (nested defs excluded — they run elsewhere);
    * calls: ``(callee_name, held_lock_ids)`` for every intra-class
      ``self.m(...)`` call — plus bare ``self.m`` handoffs at held=∅
      (a stored callback may run anywhere), Thread targets excluded.
    """
    from foundationdb_tpu_torch.analysis.rules.fl006_lockorder import \
        _Analyzer, _FuncInfo

    info = _FuncInfo(fm, cm, method)
    an = _Analyzer(model, info)
    writes = []
    calls = []
    thread_targets = _thread_target_refs(method)

    def targets_of(st):
        if isinstance(st, ast.Assign):
            return st.targets
        if isinstance(st, (ast.AugAssign, ast.AnnAssign)):
            return [st.target]
        return []

    def record_calls(st, held):
        nodes = list(_own_exprs(st))
        callfuncs = {id(n.func) for n in nodes
                     if isinstance(n, ast.Call)}
        for n in nodes:
            if isinstance(n, ast.Attribute) and \
                    isinstance(n.value, ast.Name) and \
                    n.value.id == "self" and \
                    id(n) not in thread_targets:
                if id(n) in callfuncs:
                    calls.append((n.attr, frozenset(held)))
                elif isinstance(n.ctx, ast.Load):
                    # bare handoff: assume it runs with nothing held
                    calls.append((n.attr, frozenset()))

    def visit(stmts, held):
        for st in stmts:
            if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef,
                               ast.ClassDef)):
                continue
            if isinstance(st, (ast.With, ast.AsyncWith)):
                record_calls(st, held)  # context exprs, at outer held
                ids = frozenset()
                for item in st.items:
                    ids |= an.resolve(item.context_expr)
                visit(st.body, held | ids)
                continue
            record_calls(st, held)
            for tgt in targets_of(st):
                for t in ast.walk(tgt):
                    if isinstance(t, ast.Attribute) and \
                            isinstance(t.value, ast.Name) and \
                            t.value.id == "self":
                        writes.append((t.attr, st.lineno,
                                       frozenset(held)))
            for child in ast.iter_child_nodes(st):
                if isinstance(child, ast.stmt):
                    visit([child], held)
                elif isinstance(child, ast.excepthandler):
                    visit(child.body, held)

    visit(method.body, frozenset())
    return writes, calls


def _annotated_attrs(fm, cm):
    """Attributes blessed ``# flowlint: shared(reason)`` — the comment
    sits on (or right above) a line assigning self.X anywhere in the
    class, most naturally the __init__ declaration."""
    lines = set(fm.shared_annotations)
    if not lines:
        return set()
    out = set()
    for meth in cm.methods.values():
        for sub in ast.walk(meth):
            tgts = []
            if isinstance(sub, ast.Assign):
                tgts = sub.targets
            elif isinstance(sub, (ast.AugAssign, ast.AnnAssign)):
                tgts = [sub.target]
            for tgt in tgts:
                for t in ast.walk(tgt):
                    if isinstance(t, ast.Attribute) and \
                            isinstance(t.value, ast.Name) and \
                            t.value.id == "self" and (
                                sub.lineno in lines or
                                sub.lineno - 1 in lines or
                                sub.lineno + 1 in lines):
                        out.add(t.attr)
    return out


def check_model(model):
    for fm in model.files.values():
        if fm.tree is None:
            continue
        for cm in fm.classes.values():
            if not cm.thread_targets:
                continue
            yield from _check_class(model, fm, cm)


def _check_class(model, fm, cm):
    methods = {}
    for c in model.class_and_bases(cm):
        for name, node in c.methods.items():
            methods.setdefault(name, node)
    refs = {name: _method_refs(node) & set(methods)
            for name, node in methods.items()}

    # roots: each thread target, plus EXTERNAL for public methods
    roots = {}  # method name -> root label
    for target, tname in sorted(cm.thread_targets.items()):
        if target in methods:
            roots[target] = f"thread:{tname or target}"
    reach = {}  # method name -> set of root labels

    def flood(start, label):
        frontier = [start]
        while frontier:
            m = frontier.pop()
            if label in reach.setdefault(m, set()):
                continue
            reach[m].add(label)
            for callee in refs.get(m, ()):
                frontier.append(callee)

    for target, label in roots.items():
        flood(target, label)
    for name in methods:
        if not name.startswith("_") and name not in roots:
            flood(name, _EXTERNAL)

    annotated = _annotated_attrs(fm, cm)

    sites_by_method = {name: _method_sites(model, fm, cm, node)
                       for name, node in methods.items()}

    # Must-hold entry sets: a private helper only ever called with a
    # lock held analyzes as holding it at entry (greatest fixpoint —
    # entry(m) = ⋂ over call sites of (site_held ∪ entry(caller));
    # roots and public methods enter with nothing held). None is TOP.
    call_sites = {}  # callee -> [(caller, held)]
    for caller, (_, calls) in sites_by_method.items():
        for callee, held in calls:
            if callee in methods:
                call_sites.setdefault(callee, []).append((caller, held))
    entry = {}
    entry_roots = set(roots) | {
        m for m in methods if not m.startswith("_")}
    for name in methods:
        entry[name] = frozenset() if name in entry_roots else None
    changed = True
    while changed:
        changed = False
        for name in methods:
            if name in entry_roots:
                continue
            new = None
            for caller, held in call_sites.get(name, ()):
                e = entry.get(caller)
                eff = None if e is None else (held | e)
                if eff is not None:
                    new = eff if new is None else (new & eff)
            if new != entry[name] and new is not None:
                entry[name] = new
                changed = True

    writes = {}  # attr -> [(root_labels, line, held, method)]
    for name, node in methods.items():
        if name == "__init__":
            continue
        labels = reach.get(name, set())
        if not labels:
            continue
        at_entry = entry.get(name) or frozenset()
        for attr, line, held in sites_by_method[name][0]:
            writes.setdefault(attr, []).append(
                (labels, line, held | at_entry, name))

    for attr in sorted(writes):
        if attr in annotated or attr in cm.lock_attrs:
            continue
        sites = writes[attr]
        all_roots = set()
        for labels, _, _, _ in sites:
            all_roots |= labels
        if len(all_roots) < 2:
            continue
        common = None
        for _, _, held, _ in sites:
            common = held if common is None else (common & held)
        if common:
            continue
        # anchor at the first unlocked site if any, else first site
        unlocked = [s for s in sites if not s[2]]
        anchor = min(unlocked or sites, key=lambda s: s[1])
        rootlist = ", ".join(sorted(all_roots))
        yield Finding(
            RULE, fm.relpath, anchor[1],
            f"attribute '{attr}' of {cm.name} is written from "
            f"{len(all_roots)} thread roots ({rootlist}) with no "
            f"common lock held at every write site — guard every "
            f"write with one lock, or annotate the write with "
            f"'# flowlint: shared(reason)'")


def check(tree, relpath):  # pragma: no cover - program rule
    return iter(())

"""FL004 — capture purity: a captured step must stay on the device.

Ref rationale (accelerator side, not FDB): the JAX package's rule
guards functions traced by ``jax.jit`` / ``shard_map`` /
``pallas_call``, which run ONCE at trace time. The port has no tracer:
its counterpart of a traced body is the step that an
``ops/conflict.StaticStep`` captures into a CUDA graph
(``torch.cuda.graph``). On a card the step runs once for the capture
(after one warm-up on a scratch state) and every later dispatch
REPLAYS the recorded kernels: host-side effects inside it (``np.*``
materialization, I/O, ``TraceEvent``, mutating ``self``) happen at
capture only and never on replay — the same "it worked in eager mode"
bug class, and on the CPU, where the step runs eagerly, the tests
cannot see it. A host round trip inside the step would also break the
no-copy contract of the graph's fixed input and state buffers.

The rule (modules under ``ops/``, ``resolver/``, ``parallel/``): find
roots and every module-local function reachable from a root through
bare-name calls. The port's roots:

- functions handed to ``StaticStep(...)`` (``ck.StaticStep``), through
  a lambda, a local or ``self.<attr>`` binding of a lambda, or a
  ``scan_of(...)`` / ``partial(...)`` wrapper;
- functions called inside a ``with torch.cuda.graph(...):`` body.

The JAX package's roots (``jit``, ``shard_map``, ``pallas_call``, as
calls, decorators or ``partial(jax.jit, ...)``) are kept, so a source
of the JAX package's shape reads the same under both rules; the port
itself has none. In reachable functions, flag:

- ``np.<attr>`` — host numpy inside the step (keep host packing
  OUTSIDE it, in convert.BatchStager);
- ``print(...)`` / ``open(...)`` — I/O that fires at capture only;
- ``TraceEvent(...)`` — the observability spine is host-side;
- assignments to ``self.<attr>`` — the mutation happens once, at
  capture, not per step.

A finding under a JAX root keeps the JAX package's wording
("jit-reachable"); one under a port root says "capture-reachable".

This rule may carry a baseline: pre-existing findings are grandfathered
in ``analysis/baseline.txt`` and burned down over time rather than
suppressed inline.
"""

import ast

from foundationdb_tpu_torch.analysis.base import (
    Finding,
    dotted_name,
    terminal_name,
)

RULE = "FL004"
TITLE = "capture purity: no host effects in captured-step-reachable code"

SCOPES = ("ops/", "resolver/", "parallel/")
TRACERS = {"jit", "shard_map", "pallas_call"}
# the port's own: a StaticStep captures the function it is handed
CAPTURERS = {"StaticStep"}
IO_CALLS = {"print", "open", "input"}


def applies(relpath):
    return relpath.startswith(SCOPES)


def _callable_names(node):
    """Function names statically extractable from an expression handed
    to a tracer: a bare name, the functions a lambda body calls, or the
    target inside a ``functools.partial(...)`` wrapper. Attribute
    targets (``ck.resolve_batch``) contribute their terminal name —
    module-local resolution decides whether it binds."""
    if isinstance(node, ast.Name):
        return [node.id]
    if isinstance(node, ast.Attribute):
        return [node.attr]
    if isinstance(node, ast.Lambda):
        return [
            name
            for call in ast.walk(node.body) if isinstance(call, ast.Call)
            for name in [terminal_name(call.func)] if name
        ]
    if isinstance(node, ast.Call) and terminal_name(node.func) in (
        "partial", "scan_of"
    ):
        return [
            name for arg in node.args for name in _callable_names(arg)
        ]
    return []


def _traced_args(call):
    """Function names handed to a tracer call, if statically nameable:
    jit(f), shard_map(lambda …: g(…), ...), jit(partial(f, …))."""
    t = terminal_name(call.func)
    d = dotted_name(call.func) or ""
    if t in TRACERS or d.endswith(".jit") or (
        t == "partial" and call.args
        and (dotted_name(call.args[0]) or "").endswith("jit")
    ):
        return [
            name for arg in call.args for name in _callable_names(arg)
        ]
    return []


def _captured_args(call):
    """Function names handed to a StaticStep: StaticStep(lambda s, b:
    step(s, b)[0], state, layout), ck.StaticStep(fn, ...)."""
    if terminal_name(call.func) in CAPTURERS and call.args:
        return _callable_names(call.args[0])
    return []


def _is_graph_capture(expr):
    """``torch.cuda.graph(...)`` (any ``<...>.cuda.graph(...)`` call)."""
    return isinstance(expr, ast.Call) and (
        dotted_name(expr.func) or "").endswith("cuda.graph")


def _graph_body_calls(node):
    """Function names called inside a ``with torch.cuda.graph(...):``
    body: every call there is recorded into the graph."""
    if not isinstance(node, (ast.With, ast.AsyncWith)) or not any(
            _is_graph_capture(item.context_expr) for item in node.items):
        return []
    names = []
    for stmt in node.body:
        for call in ast.walk(stmt):
            if isinstance(call, ast.Call):
                names.extend(_callable_names(call.func))
                for arg in call.args:
                    if isinstance(arg, ast.Lambda):
                        names.extend(_callable_names(arg))
    return names


def _decorator_roots(func):
    """Whether the function's decorators trace it."""
    for dec in func.decorator_list:
        d = dotted_name(dec) or ""
        if terminal_name(dec) in TRACERS or d.endswith(".jit"):
            return True
        if isinstance(dec, ast.Call):
            dd = dotted_name(dec.func) or ""
            if terminal_name(dec.func) in TRACERS or dd.endswith(".jit"):
                return True
            if terminal_name(dec.func) == "partial" and dec.args and (
                dotted_name(dec.args[0]) or ""
            ).endswith("jit"):
                return True
    return False


# an effect's wording under each kind of root: the JAX package's under
# its tracers, the port's under a capture
WORDING = {
    "jit": {
        "np": "np.{attr} in jit-reachable function {name!r} — host numpy "
              "materializes at trace time; use jnp or move it out of the "
              "step",
        "io": "{call}() in jit-reachable function {name!r} fires at trace "
              "time only",
        "trace": "TraceEvent in jit-reachable function {name!r} — tracing "
                 "is host-side observability, it cannot run per step",
        "self": "jit-reachable function {name!r} mutates self.{attr} — the "
                "write happens at trace time, not per step",
    },
    "capture": {
        "np": "np.{attr} in capture-reachable function {name!r} — host "
              "numpy runs once, at capture, and every replay reuses its "
              "value; move it out of the captured step",
        "io": "{call}() in capture-reachable function {name!r} fires at "
              "capture only, never on replay",
        "trace": "TraceEvent in capture-reachable function {name!r} — "
                 "tracing is host-side observability, it cannot run per "
                 "replay",
        "self": "capture-reachable function {name!r} mutates self.{attr} "
                "— the write happens at capture, not per replay",
    },
}


def reachable_functions(tree):
    """``(defs, traced, captured)``: the module's functions by name, and
    the names reachable from a JAX root and from a capture root."""
    defs = {}
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            defs.setdefault(node.name, node)

    # local bindings of names to lambdas/partials — the idiomatic
    # ``fn = lambda s, b: resolve_batch(s, b, params); jax.jit(fn)``
    # shape must still root resolve_batch; ``self._scan = scan_of(f)``
    # binds the attribute name the same way
    env = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.value, (ast.Lambda, ast.Call)):
            tgt = node.targets[0]
            if isinstance(tgt, ast.Name):
                env.setdefault(tgt.id, node.value)
            elif isinstance(tgt, ast.Attribute) and isinstance(
                    tgt.value, ast.Name) and tgt.value.id == "self":
                env.setdefault(tgt.attr, node.value)

    def expand(names):
        out, expanded, frontier = set(), set(), list(names)
        while frontier:
            name = frontier.pop()
            if name in expanded:
                continue
            expanded.add(name)
            if name in defs:
                out.add(name)
            elif name in env:
                frontier.extend(_callable_names(env[name]))
        return out

    roots, capture_roots = set(), set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            roots |= expand(_traced_args(node))
            capture_roots |= expand(_captured_args(node))
        elif isinstance(node, (ast.With, ast.AsyncWith)):
            capture_roots |= expand(_graph_body_calls(node))
    for name, fn in defs.items():
        if _decorator_roots(fn):
            roots.add(name)

    def reach(start):
        """Bare-name call-graph reachability, module-local."""
        reachable, frontier = set(), list(start)
        while frontier:
            name = frontier.pop()
            if name in reachable:
                continue
            reachable.add(name)
            for node in ast.walk(defs[name]):
                if isinstance(node, ast.Call) and isinstance(
                    node.func, ast.Name
                ) and node.func.id in defs and \
                        node.func.id not in reachable:
                    frontier.append(node.func.id)
        return reachable

    return defs, reach(roots), reach(capture_roots)


def check(tree, relpath):
    defs, traced, captured = reachable_functions(tree)
    seen = set()
    for name in sorted(traced | captured):
        words = WORDING["capture" if name in captured else "jit"]
        for node in ast.walk(defs[name]):
            msg = None
            if isinstance(node, ast.Attribute) and isinstance(
                node.value, ast.Name
            ) and node.value.id == "np":
                msg = words["np"].format(attr=node.attr, name=name)
            elif isinstance(node, ast.Call):
                t = terminal_name(node.func)
                if isinstance(node.func, ast.Name) and t in IO_CALLS:
                    msg = words["io"].format(call=t, name=name)
                elif t == "TraceEvent":
                    msg = words["trace"].format(name=name)
            elif isinstance(node, (ast.Assign, ast.AugAssign)):
                targets = node.targets if isinstance(
                    node, ast.Assign
                ) else [node.target]
                for tgt in targets:
                    if isinstance(tgt, ast.Attribute) and isinstance(
                        tgt.value, ast.Name
                    ) and tgt.value.id == "self":
                        msg = words["self"].format(name=name,
                                                   attr=tgt.attr)
            if msg is None:
                continue
            key = (node.lineno, msg)
            if key not in seen:
                seen.add(key)
                yield Finding(RULE, relpath, node.lineno, msg)

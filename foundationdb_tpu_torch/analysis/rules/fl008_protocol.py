"""FL008: protocol/knob drift.

Two slow-rot failure modes the version history already survived once
each, now machine-checked:

**Optional wire frames.** Every optional trailing frame the protocol
grew (v4 columnar ``flat_conflicts``, v5 ``span_context``, v6
``conflict_version``, v7 ``tags``) is declared in the
``OPTIONAL_FRAMES`` table in ``rpc/wire.py``. Each declared frame must
be *mentioned* (attribute, keyword argument, name, or string literal)
in BOTH the ``_enc`` and ``_dec`` bodies of the declaring module — a
decode-only frame is a frame nobody sends, an encode-only frame is a
frame peers cannot read, and either way the next version bump ships
skew. On a full-tree scan each frame additionally needs a version-gate
test reference (its name appears somewhere under ``tests/``).

**Knobs.** Every field of the ``Knobs`` dataclass in
``core/options.py`` must be READ somewhere in the tree (an attribute
access ``<...knobs...>.field`` or ``getattr(knobs, "field", ...)``) —
a dead knob is configuration surface that silently does nothing.
Conversely, a knob-shaped read of a name the dataclass does not
declare (``knobs.typo_limit``) fails: it evaluates to AttributeError
at runtime on the one code path nobody tested.
"""

import ast

from foundationdb_tpu_torch.analysis.base import Finding, dotted_name

RULE = "FL008"
TITLE = "protocol/knob drift"
PROGRAM = True


def applies(relpath):
    return True


def _mentions(node, name):
    for sub in ast.walk(node):
        if isinstance(sub, ast.Attribute) and sub.attr == name:
            return True
        if isinstance(sub, ast.Name) and sub.id == name:
            return True
        if isinstance(sub, ast.Constant) and sub.value == name:
            return True
        if isinstance(sub, ast.keyword) and sub.arg == name:
            return True
    return False


def _optional_frames(fm):
    """The OPTIONAL_FRAMES table ({frame_name: version}) and its line,
    if this file declares one."""
    if fm.tree is None:
        return None, 0
    for item in fm.tree.body:
        if isinstance(item, ast.Assign) and len(item.targets) == 1 and \
                isinstance(item.targets[0], ast.Name) and \
                item.targets[0].id == "OPTIONAL_FRAMES" and \
                isinstance(item.value, ast.Dict):
            frames = {}
            for k, v in zip(item.value.keys, item.value.values):
                if isinstance(k, ast.Constant) and \
                        isinstance(k.value, str) and \
                        isinstance(v, ast.Constant) and \
                        isinstance(v.value, int):
                    frames[k.value] = v.value
            return frames, item.lineno
    return None, 0


def _check_frames(model, fm):
    frames, table_line = _optional_frames(fm)
    if frames is None:
        return
    enc = fm.module_funcs.get("_enc")
    dec = fm.module_funcs.get("_dec")
    for name in sorted(frames):
        version = frames[name]
        if enc is None or not _mentions(enc, name):
            yield Finding(
                RULE, fm.relpath, table_line,
                f"optional frame '{name}' (v{version}) has no encode "
                f"arm: _enc never mentions it — peers would never "
                f"send the frame the decoder expects")
        if dec is None or not _mentions(dec, name):
            yield Finding(
                RULE, fm.relpath, table_line,
                f"optional frame '{name}' (v{version}) has no decode "
                f"arm: _dec never mentions it — encoded frames would "
                f"be unreadable on the wire")
        if model.test_texts is not None and not any(
                name in text for text in model.test_texts.values()):
            yield Finding(
                RULE, fm.relpath, table_line,
                f"optional frame '{name}' (v{version}) has no "
                f"version-gate test reference: no file under tests/ "
                f"mentions it")


def _knobs_class(fm):
    return fm.classes.get("Knobs")


def _knob_fields(cm):
    fields = {}
    for item in cm.node.body:
        if isinstance(item, ast.AnnAssign) and \
                isinstance(item.target, ast.Name):
            fields[item.target.id] = item.lineno
    return fields


def _is_knobs_receiver(expr):
    """Whether an attribute-access base looks like a Knobs instance:
    its dotted chain's terminal segment contains "knob" ("knobs",
    "self.knobs", "self._knobs", "cluster.knobs", ...), is the
    conventional local alias ``kn``, or is a direct ``Knobs(...)``
    construction."""
    if isinstance(expr, ast.Call):
        fn = dotted_name(expr.func)
        return fn is not None and fn.rsplit(".", 1)[-1] == "Knobs"
    dn = dotted_name(expr)
    if dn is None:
        return False
    tail = dn.rsplit(".", 1)[-1].lower()
    return "knob" in tail or tail == "kn"


def _knob_reads(model, skip_relpath):
    """{field_name: (relpath, line)} for every knob-shaped attribute
    read (or getattr) in the tree, excluding the declaring file."""
    reads = {}
    for fm in model.files.values():
        if fm.tree is None or fm.relpath == skip_relpath:
            continue
        for sub in ast.walk(fm.tree):
            if isinstance(sub, ast.Attribute) and \
                    isinstance(sub.ctx, ast.Load) and \
                    _is_knobs_receiver(sub.value):
                reads.setdefault(sub.attr,
                                 (fm.relpath, sub.lineno))
            elif isinstance(sub, ast.Call) and \
                    isinstance(sub.func, ast.Name) and \
                    sub.func.id == "getattr" and len(sub.args) >= 2 \
                    and isinstance(sub.args[1], ast.Constant) and \
                    isinstance(sub.args[1].value, str) and \
                    _is_knobs_receiver(sub.args[0]):
                reads.setdefault(sub.args[1].value,
                                 (fm.relpath, sub.lineno))
    return reads


def _check_knobs(model):
    decl = None
    for fm in model.files.values():
        cm = _knobs_class(fm)
        if cm is not None:
            decl = (fm, cm)
            break
    if decl is None:
        return
    fm, cm = decl
    fields = _knob_fields(cm)
    if not fields:
        return
    reads = _knob_reads(model, fm.relpath)
    for name in sorted(fields):
        if name not in reads:
            yield Finding(
                RULE, fm.relpath, fields[name],
                f"dead knob: '{name}' is declared in Knobs but never "
                f"read anywhere in the tree — wire it up or delete it")
    for name in sorted(reads):
        if name in fields or name.startswith("__"):
            continue
        relpath, line = reads[name]
        yield Finding(
            RULE, relpath, line,
            f"undeclared knob read: '{name}' is not a Knobs field — "
            f"declare it in core/options.py or fix the name")


def check_model(model):
    for fm in model.files.values():
        yield from _check_frames(model, fm)
    # the dead-knob sweep needs the whole tree to prove "never read";
    # it runs on full scans AND on fixture models that declare their
    # own Knobs class (the fixture IS the whole tree then)
    if model.full_tree or any(
            _knobs_class(fm) is not None
            for fm in model.files.values()):
        yield from _check_knobs(model)


def check(tree, relpath):  # pragma: no cover - program rule
    return iter(())

"""FL009: error taxonomy — every fabricated error is registered and
classified.

Ref rationale: ``flow/Error.h`` makes error identity a closed taxonomy
— every ``Error`` carries a code from the generated list, and the
retry machinery's behavior (``fdb_error_predicate``: RETRYABLE,
MAYBE_COMMITTED) is a function of that code alone. A raw numeric
literal (``FDBError(1037, ...)``) bypasses the registry: rename the
code there and the literal silently diverges; add a new one and
nothing forces a retryability decision. Three checks on the shared
ProgramModel:

* **Raw numeric literals** — ``FDBError(<int literal>)`` outside
  ``core/errors.py`` fails; fabricate by symbolic name
  (``err("process_behind")``) so the registry is the single source of
  truth. Codes the registry does not know fail even there.
* **Unknown names** — ``err("name")`` / ``FDBError.from_name("name")``
  with a constant name the registry does not carry fails (at runtime
  it would now raise ValueError; the lint catches it before then).
* **Server-side classification** (full-tree scans only) — a code
  fabricated under ``server/`` or ``rpc/`` crosses the wire into a
  client's retry loop, so its retryability must be a RECORDED
  decision: membership in ``RETRYABLE``/``MAYBE_COMMITTED``
  (core/errors.py) counts, and every other code needs an explicit
  ``non-retryable`` entry in the checked-in ``analysis/errortable.txt``
  (``--fix-errortable`` regenerates). An entry for a code no longer
  fabricated server-side is stale and fails, exactly like a stale
  baseline entry. Dynamic-name sites (``FDBError.from_name(bad)``)
  carry no static code; they ride ``faultsites.txt`` as wildcard
  sites (FL011) and are exempt here.

errortable.txt format::

    # comments and blanks ignored
    2000 client_invalid_operation non-retryable

``rpc/wire.py`` is exempt (its decoder re-materializes codes arriving
off the wire — propagation, not fabrication), as is ``analysis/``.
"""

import os

from foundationdb_tpu_torch.analysis.base import Finding
from foundationdb_tpu_torch.analysis.rules.fl011_faultsites import (
    EXCLUDED_DIRS,
    EXCLUDED_FILES,
    fabrication_calls,
)

RULE = "FL009"
TITLE = "error taxonomy: registered codes, recorded retryability"
PROGRAM = True

ERRORTABLE_RELPATH = "analysis/errortable.txt"

# fabrication under these prefixes crosses the wire to clients: the
# code's retryability must be a recorded decision
SERVER_SIDE = ("server/", "rpc/")


def applies(relpath):
    return True


def _registry():
    from foundationdb_tpu_torch.core import errors as _errors

    return _errors


def _server_side(relpath):
    return relpath.startswith(SERVER_SIDE) and \
        relpath not in EXCLUDED_FILES


# ── errortable.txt ──
def load_errortable(text):
    """``{code: (name, line_number)}`` for explicit non-retryable
    classification entries; malformed lines are skipped (the exact
    check happens against the regenerated form)."""
    out = {}
    for i, line in enumerate(text.splitlines(), 1):
        body = line.split("#", 1)[0].strip()
        if not body:
            continue
        parts = body.split()
        if len(parts) != 3 or parts[2] != "non-retryable":
            continue
        try:
            code = int(parts[0])
        except ValueError:
            continue
        out.setdefault(code, (parts[1], i))
    return out


def _errortable_path(model):
    if model.package_root:
        return os.path.join(model.package_root, "analysis",
                            "errortable.txt")
    return None


def _read_errortable(model):
    path = _errortable_path(model)
    if path and os.path.exists(path):
        with open(path, encoding="utf-8") as f:
            return f.read()
    return ""


def server_side_codes(model):
    """``{code: (relpath, line)}`` — every statically-known code
    fabricated under server/ or rpc/ (first site wins)."""
    _errors = _registry()
    out = {}
    for relpath in sorted(model.files):
        if not _server_side(relpath):
            continue
        fm = model.files[relpath]
        for call, kind, payload, _owner in fabrication_calls(fm):
            codes = []
            if kind == "code":
                codes = [payload]
            elif kind == "name":
                for name in payload:
                    try:
                        codes.append(_errors.code_for(name))
                    except ValueError:
                        continue  # reported as unknown-name below
            for code in codes:
                out.setdefault(code, (relpath, call.lineno))
    return out


def format_errortable(codes):
    """codes: iterable of ints needing explicit non-retryable entries."""
    _errors = _registry()
    header = (
        "# flowlint FL009 error-classification table — every code\n"
        "# fabricated server-side (server/, rpc/) whose retryability\n"
        "# is NOT already recorded in core/errors.py's RETRYABLE /\n"
        "# MAYBE_COMMITTED frozensets gets an explicit entry here:\n"
        "#   code name non-retryable\n"
        "# Regenerate: python -m foundationdb_tpu_torch.analysis.flowlint "
        "--fix-errortable\n"
        "# A stale entry (code no longer fabricated server-side) fails\n"
        "# the lint; a new unclassified code fails until recorded.\n"
    )
    lines = [header]
    for code in sorted(codes):
        lines.append(f"{code} {_errors.error_name(code)} non-retryable\n")
    return "".join(lines)


def rewrite_errortable(model):
    path = _errortable_path(model)
    if path is None:
        raise RuntimeError("errortable path requires a full-tree scan")
    _errors = _registry()
    classified = _errors.RETRYABLE | _errors.MAYBE_COMMITTED
    need = [c for c in server_side_codes(model) if c not in classified]
    with open(path, "w", encoding="utf-8") as f:
        f.write(format_errortable(need))
    return path


def check_model(model):
    _errors = _registry()
    names = _errors.registered_names()
    codes = _errors.registered_codes()

    # structural checks, any scan
    for relpath in sorted(model.files):
        fm = model.files[relpath]
        for call, kind, payload, _owner in fabrication_calls(fm):
            if kind == "code":
                known = " (unregistered code)" if payload not in codes \
                    else ""
                name = _errors.error_name(payload)
                hint = f'err("{name}")' if not known else \
                    "register the code in core/errors.py, then " \
                    "fabricate by name"
                yield Finding(
                    RULE, relpath, call.lineno,
                    f"raw numeric error literal FDBError({payload})"
                    f"{known} — fabricate by symbolic name ({hint}) so "
                    f"core/errors.py stays the single source of truth")
            elif kind == "name":
                for bad in payload:
                    if bad not in names:
                        yield Finding(
                            RULE, relpath, call.lineno,
                            f"unknown error name '{bad}' — not in the "
                            f"core/errors.py registry (this raises "
                            f"ValueError at runtime); register it or "
                            f"fix the spelling")

    if not model.full_tree:
        return

    # classification contract, full tree only
    classified = _errors.RETRYABLE | _errors.MAYBE_COMMITTED
    fabricated = server_side_codes(model)
    table = load_errortable(_read_errortable(model))
    for code in sorted(fabricated):
        if code in classified or code in table:
            continue
        relpath, line = fabricated[code]
        yield Finding(
            RULE, relpath, line,
            f"unclassified server-side error code {code} "
            f"({_errors.error_name(code)}) — a code that crosses the "
            f"wire needs a recorded retryability decision: add it to "
            f"RETRYABLE/MAYBE_COMMITTED in core/errors.py, or record "
            f"it non-retryable in {ERRORTABLE_RELPATH} "
            f"(--fix-errortable)")
    for code in sorted(table):
        name, line = table[code]
        if code not in fabricated:
            yield Finding(
                RULE, ERRORTABLE_RELPATH, line,
                f"stale errortable entry: {code} ({name}) is no "
                f"longer fabricated server-side — remove it (or "
                f"--fix-errortable)")
        elif code in classified:
            yield Finding(
                RULE, ERRORTABLE_RELPATH, line,
                f"conflicting errortable entry: {code} ({name}) is "
                f"already classified retryable in core/errors.py — "
                f"remove the non-retryable line")
        elif name != _errors.error_name(code):
            yield Finding(
                RULE, ERRORTABLE_RELPATH, line,
                f"errortable name drift: {code} is registered as "
                f"'{_errors.error_name(code)}', not '{name}' — "
                f"--fix-errortable")


def check(tree, relpath):  # pragma: no cover - program rule
    return iter(())

"""FoundationDB-compatible error model.

Ref parity: flow/Error.h and the generated error list in
fdbclient/vexillographer/fdb.options. The codes equal the reference's
(and the JAX package's), so client code written against FDB's bindings
ports over unchanged.

The runtime fault-coverage witness (utils/faultcov.py) hooks
``FDBError.__init__``: one module-global read when it is off, a
per-site counter bump when it is on.
"""

from foundationdb_tpu_torch.utils import faultcov as _faultcov

_ERRORS = {
    0: "success",
    1000: "operation_failed",
    1004: "timed_out",
    1007: "transaction_too_old",
    1009: "future_version",
    1011: "version_invalid",
    1020: "not_committed",
    1021: "commit_unknown_result",
    1025: "transaction_cancelled",
    1031: "transaction_timed_out",
    1037: "process_behind",
    1038: "database_locked",
    1101: "operation_cancelled",
    1213: "tag_throttled",
    2000: "client_invalid_operation",
    2002: "commit_read_incomplete",
    2003: "test_specification_invalid",
    2004: "key_outside_legal_range",
    2005: "inverted_range",
    2006: "invalid_option_value",
    2009: "incompatible_protocol_version",
    2010: "transaction_invalid_version",
    2011: "no_commit_version",
    2017: "used_during_commit",
    2101: "transaction_too_large",
    2102: "key_too_large",
    2103: "value_too_large",
    2108: "tenant_not_found",
    2130: "tenant_name_required",
    2132: "tenant_already_exists",
    2133: "tenant_not_empty",
    2134: "tenants_disabled",
    2144: "tenant_locked",  # mid-move fence (ref: metacluster moves)
    2160: "invalid_metacluster_operation",
    2161: "cluster_already_registered",
    2165: "cluster_not_empty",
    2166: "metacluster_no_capacity",
    2200: "api_version_unset",
}

_BY_NAME = {v: k for k, v in _ERRORS.items()}

# Errors on which the standard retry loop (Transaction.on_error) retries.
# Ref: fdb_error_predicate(FDB_ERROR_PREDICATE_RETRYABLE, ...) in bindings/c.
RETRYABLE = frozenset({1007, 1009, 1020, 1021, 1037, 1213, 2144})
MAYBE_COMMITTED = frozenset({1021})


def code_for(name):
    """The registered code for a symbolic name; ValueError naming the
    symbol when it is not registered."""
    try:
        return _BY_NAME[name]
    except KeyError:
        raise ValueError(f"unknown FDB error name {name!r}") from None


def error_name(code):
    """The symbolic name for a code, or 'unknown_error'."""
    return _ERRORS.get(code, "unknown_error")


class FDBError(Exception):
    """An error with an FDB error code. Ref: class Error in flow/Error.h."""

    def __init__(self, code, message=None):
        self.code = int(code)
        self.description = _ERRORS.get(self.code, "unknown_error")
        super().__init__(message or f"{self.description} ({self.code})")
        if _faultcov._enabled:
            _faultcov.note(self.code)

    @classmethod
    def from_name(cls, name, message=None):
        return cls(code_for(name), message)

    @property
    def is_retryable(self):
        return self.code in RETRYABLE

    @property
    def is_maybe_committed(self):
        return self.code in MAYBE_COMMITTED


def err(name, message=None):
    """Raise-ready FDBError by symbolic name, e.g. err('not_committed')."""
    return FDBError.from_name(name, message)

"""flowlint rule registry — one module per rule id.

FL001–FL005 are per-file rules (``check(tree, relpath)``);
FL006–FL011 are program-wide (``PROGRAM = True`` +
``check_model(model)``) and read the shared
:class:`~foundationdb_tpu_torch.analysis.model.ProgramModel`.
"""

from foundationdb_tpu_torch.analysis.rules import (
    fl001_determinism,
    fl002_settlement,
    fl003_locks,
    fl004_jit,
    fl005_exceptions,
    fl006_lockorder,
    fl007_threadescape,
    fl008_protocol,
    fl009_errortaxonomy,
    fl010_retrydiscipline,
    fl011_faultsites,
)

ALL_RULES = [
    fl001_determinism,
    fl002_settlement,
    fl003_locks,
    fl004_jit,
    fl005_exceptions,
    fl006_lockorder,
    fl007_threadescape,
    fl008_protocol,
    fl009_errortaxonomy,
    fl010_retrydiscipline,
    fl011_faultsites,
]

BY_ID = {rule.RULE: rule for rule in ALL_RULES}

"""flowlint's error-propagation rules on the port (FL009 error taxonomy,
FL010 retry discipline, FL011 fault-site coverage): every
synthetic-source and fixture-tree case of the JAX package's
tests/test_flowlint_v3.py through both packages' rules, plus the port's
own tables: errortable.txt and faultsites.txt in sync with its tree,
and equal to the reference's with only the package prefix mapped."""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(__file__)))

from foundationdb_tpu.analysis import flowlint as jflowlint  # noqa: E402
from foundationdb_tpu.analysis.rules import (  # noqa: E402
    fl011_faultsites as jfl011,
)
from foundationdb_tpu_torch.analysis import flowlint  # noqa: E402
from foundationdb_tpu_torch.analysis.rules import (  # noqa: E402
    fl009_errortaxonomy,
    fl011_faultsites,
)
from tests import test_flowlint_v3 as ref  # noqa: E402
from tests.torch_flowlint_twin import (  # noqa: E402
    PORT_PKG, assert_twin, port_tree_model, run_twin, twin_cases)

# fault sites the reference enumerates and the port leaves out on
# purpose, each with its reason
DELIBERATE_ABSENCES = {
    # the reference's fallback for a storage tier without read_batch:
    # the port's Cluster.read_storage() always returns the storage
    # router, which has read_batch, so the port keeps the branch out
    "rpc.service:ClusterService.read_batch:2000":
        "read_storage() is always the router, which serves read_batch",
}


@pytest.mark.parametrize("case", twin_cases(ref))
def test_rule_case_matches_jax(case, request):
    assert_twin(run_twin(ref, case, request))


@pytest.fixture(scope="module")
def model():
    return port_tree_model()


def _table(name, package_dir):
    with open(os.path.join(package_dir, "analysis", name),
              encoding="utf-8") as f:
        return f.read()


def test_fl009_real_errortable_is_in_sync(model):
    """The port's errortable.txt is its tree's, byte for byte."""
    from foundationdb_tpu_torch.core import errors as _errors

    classified = _errors.RETRYABLE | _errors.MAYBE_COMMITTED
    need = sorted(c for c in fl009_errortaxonomy.server_side_codes(model)
                  if c not in classified)
    text = _table("errortable.txt", flowlint.package_dir())
    assert text == fl009_errortaxonomy.format_errortable(need)
    assert sorted(fl009_errortaxonomy.load_errortable(text)) == need


def test_fl009_errortable_equals_the_reference():
    """The same server-side codes classified non-retryable, with the
    same names, as the JAX package's table."""
    got = _table("errortable.txt", flowlint.package_dir())
    want = _table("errortable.txt", jflowlint.package_dir())
    assert fl009_errortaxonomy.load_errortable(got) == \
        fl009_errortaxonomy.load_errortable(want)
    body = [line for line in got.splitlines() if not line.startswith("#")]
    assert body == [line for line in want.splitlines()
                    if not line.startswith("#")]


def test_fl011_real_faultsites_table_is_in_sync(model):
    """The port's faultsites.txt is its tree's, byte for byte, in the
    witness's id form."""
    sites = fl011_faultsites.enumerate_sites(model)
    text = _table("faultsites.txt", flowlint.package_dir())
    assert text == fl011_faultsites.format_faultsites(sites)
    assert set(fl011_faultsites.load_faultsites(text)) == set(sites)
    assert len(sites) > 50
    assert all(s.startswith(PORT_PKG + ".") for s in sites)
    assert (f"{PORT_PKG}.server.proxy:CommitProxy._partition_rejects:*"
            in sites)


def test_fl011_faultsites_equal_the_reference_with_the_prefix_mapped():
    """The reference's table with its ids prefixed by the port's package
    is the port's, but for the listed deliberate absences; none of the
    port's own modules (convert, workloads, ops/accept, ops/ring,
    ops/_kernels) fabricates a coded error."""
    want = {f"{PORT_PKG}.{s}" for s in jfl011.load_faultsites(
        _table("faultsites.txt", jflowlint.package_dir()))}
    got = set(fl011_faultsites.load_faultsites(
        _table("faultsites.txt", flowlint.package_dir())))
    assert want - got == {f"{PORT_PKG}.{s}" for s in DELIBERATE_ABSENCES}
    assert got - want == set()


def test_fl011_module_ids_are_the_witness_ids():
    """FL011 names a module as the runtime witness names its frames."""
    from foundationdb_tpu_torch.utils import faultcov

    path = os.path.join(flowlint.package_dir(), "server", "proxy.py")
    assert fl011_faultsites.module_dotted("server/proxy.py") == \
        faultcov._module_id(path)
    assert fl011_faultsites.module_dotted("sim/__init__.py") == \
        f"{PORT_PKG}.sim"


def test_new_rules_run_in_tier1_with_empty_baselines():
    from foundationdb_tpu_torch.analysis.rules import ALL_RULES, BY_ID

    for rid in ("FL009", "FL010", "FL011"):
        assert rid in BY_ID
        assert getattr(BY_ID[rid], "PROGRAM", False)
        assert BY_ID[rid] in ALL_RULES
    baseline = flowlint.load_baseline(flowlint.default_baseline_path())
    v3 = [k for k in baseline
          if k.startswith(("FL009\t", "FL010\t", "FL011\t"))]
    assert v3 == [], f"v3 rules must stay un-baselined: {v3}"

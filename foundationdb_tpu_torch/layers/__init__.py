"""Layers over the database: the tuple encoding, subspaces, the
directory layer and tenants (copies of the JAX package's, over the
port's keys, versions and transactions)."""

from foundationdb_tpu_torch.layers import tuple as tuple_layer  # noqa: F401
from foundationdb_tpu_torch.layers.directory import (  # noqa: F401
    DirectoryLayer,
    directory,
)
from foundationdb_tpu_torch.layers.subspace import Subspace  # noqa: F401
from foundationdb_tpu_torch.layers.tenant import (  # noqa: F401
    Tenant,
    TenantManagement,
)

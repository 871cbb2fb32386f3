from foundationdb_tpu_torch.sim.buggify import BUGGIFY, Buggify  # noqa: F401
from foundationdb_tpu_torch.sim.simulation import Simulation  # noqa: F401

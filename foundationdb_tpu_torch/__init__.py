"""foundationdb_tpu_torch — FoundationDB's Resolver on PyTorch and CUDA.

The PyTorch port of ``foundationdb_tpu``'s conflict-detection step: the
same packed batches, the same device state, the same verdicts bit for
bit, with the two Pallas TPU kernels rewritten by hand in CUDA C++ for
Hopper (``csrc/``). The package imports ``torch`` and numpy only and
keeps its own copy of every module it needs.

Entry point: :class:`foundationdb_tpu_torch.resolver.resolver.Resolver`,
which runs on ``cuda:0`` unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"

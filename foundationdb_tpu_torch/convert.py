"""Carry resolver state and batches between numpy and the port's tensors.

numpy arrays come in the JAX package's dtypes (uint32 / int32 / bool,
what ``np.asarray`` gives of its state and what the packers emit); the
port holds uint32 quantities as zero-extended int64 tensors. With
:func:`state_from_numpy` a test can start the port from a JAX resolver's
mid-life history, and compare field by field with
:func:`state_to_numpy`.
"""

import numpy as np
import torch

from foundationdb_tpu_torch.ops.conflict import ResolveBatch, ResolverState

# numpy dtype → tensor dtype, and back (int64 holds uint32 only)
_TO_TORCH = {
    np.dtype(np.uint32): torch.int64,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.bool_): torch.bool,
}
_TO_NUMPY = {
    torch.int64: np.uint32,
    torch.int32: np.int32,
    torch.bool: np.bool_,
}
# the numpy dtype a tensor of each dtype is built from
_TO_NUMPY_WIDE = {
    torch.int64: np.int64,
    torch.int32: np.int32,
    torch.bool: np.bool_,
}


def tensor_from_numpy(a, device="cpu"):
    a = np.asarray(a)
    dtype = _TO_TORCH.get(a.dtype)
    if dtype is None:
        raise TypeError(f"no tensor dtype for numpy {a.dtype}")
    # np.array keeps 0-d scalars 0-d (ascontiguousarray would make them 1-d)
    t = torch.from_numpy(np.array(a, dtype=_TO_NUMPY_WIDE[dtype], order="C"))
    return t.to(device)


def tensor_to_numpy(t):
    t = t.detach().cpu()
    want = _TO_NUMPY[t.dtype]
    if t.dtype == torch.int64:
        a = t.numpy()
        if a.size and (a.min() < 0 or a.max() > 0xFFFFFFFF):
            raise ValueError("int64 tensor holds a value outside uint32")
        return a.astype(want)
    return t.numpy().astype(want, copy=True)


def state_from_numpy(fields, device="cpu"):
    """ResolverState of tensors from the 12 fields of a (JAX) state."""
    return ResolverState(*(tensor_from_numpy(f, device) for f in fields))


def state_to_numpy(state):
    """The 12 state fields as numpy arrays in the JAX state's dtypes."""
    return ResolverState(*(tensor_to_numpy(f) for f in state))


def batch_from_numpy(batch, device="cpu"):
    """ResolveBatch of tensors from a numpy (packer) ResolveBatch —
    single or stacked [B, ...]."""
    return ResolveBatch(*(tensor_from_numpy(f, device) for f in batch))

"""Carry resolver state and batches between numpy and the port's tensors.

numpy arrays come in the JAX package's dtypes (uint32 / int32 / bool,
what ``np.asarray`` gives of its state and what the packers emit); the
port holds uint32 quantities as zero-extended int64 tensors. With
:func:`state_from_numpy` a test can start the port from a JAX resolver's
mid-life history, and compare field by field with
:func:`state_to_numpy`. A JAX mesh resolver's state (the global arrays
of its ``shard_map`` fleet: ``ht`` of ``n << HB``, ring fields of
``n * KR``, ``ring_head`` of ``[n]``) is the port's lane-sharded state
array for array, so the same two functions carry it; a router's
``ShardBatch`` goes across with :func:`shard_batch_from_numpy`.

The resolver's compiled steps (ops/conflict.StaticStep) take their
batches through a :class:`BatchStager` instead: fixed device tensors
refilled in place, which a CUDA graph can hold, and statuses come back
through :func:`host_reader`.
"""

import numpy as np
import torch

from foundationdb_tpu_torch.ops import conflict as ck  # (which imports this module)

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


def tensor_from_numpy(a, device="cpu", non_blocking=False):
    """A tensor on ``device`` from a numpy array, through a fresh host
    copy in the tensor's dtype: the caller may refill ``a`` as soon as
    this returns. ``non_blocking`` leaves out PyTorch's stream
    synchronisation after a copy to a card. The fresh copy is pageable
    memory, which CUDA stages into its own pinned buffer before the
    call returns, so no host buffer is read afterwards either way
    (staging may still wait on the stream)."""
    a = np.asarray(a)
    dtype = _TO_TORCH.get(a.dtype)
    if dtype is None:
        raise TypeError(f"no tensor dtype for numpy {a.dtype}")
    # np.array keeps 0-d scalars 0-d (ascontiguousarray would make them 1-d)
    t = torch.from_numpy(np.array(a, dtype=_TO_NUMPY_WIDE[dtype], order="C"))
    return t.to(device, non_blocking=non_blocking)


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
    return ck.ResolverState(*(tensor_from_numpy(f, device) for f in fields))


def state_to_numpy(state):
    """The 12 state fields as numpy arrays in the JAX state's dtypes."""
    return ck.ResolverState(*(tensor_to_numpy(f) for f in state))


def batch_from_numpy(batch, device="cpu", non_blocking=False):
    """ResolveBatch of tensors from a numpy (packer) ResolveBatch —
    single or stacked [B, ...]."""
    return ck.ResolveBatch(*(tensor_from_numpy(f, device, non_blocking)
                          for f in batch))


def shard_batch_from_numpy(sb, device="cpu", non_blocking=False):
    """ShardBatch of tensors from a numpy (router) ShardBatch — single or
    stacked [B, ...]."""
    return ck.ShardBatch(*(tensor_from_numpy(f, device, non_blocking)
                        for f in sb))


def shard_batch_to_numpy(sb):
    """A ShardBatch's fields as numpy arrays in the router's dtypes."""
    return ck.ShardBatch(*(tensor_to_numpy(f) for f in sb))


_ALIGN = 8  # every field's offset in a stager's buffers: int64-aligned


class BatchStager:
    """Fixed device tensors for one batch layout (``inputs``), refilled
    from packed numpy batches of one signature.

    Every field is a view, in its tensor dtype, into one flat device
    buffer; :meth:`copy_in` widens a numpy batch into a host staging
    buffer of the same layout and sends it across in ONE copy. On a card
    the staging buffer comes from PyTorch's pinned-memory pool and the
    copy does not block: the pool records the copy's stream and hands
    the buffer out again only once the copy is done, so a copy still
    pending never sees its source refilled, and every step's stager
    draws on the same few buffers. On the CPU the same copy, from plain
    memory."""

    def __init__(self, layout, batch, device):
        self.device = torch.device(device)
        self._cuda = self.device.type == "cuda"
        self._fields = []
        total = 0
        for a in batch:
            a = np.asarray(a)
            dtype = _TO_TORCH.get(a.dtype)
            if dtype is None:
                raise TypeError(f"no tensor dtype for numpy {a.dtype}")
            nbytes = a.size * torch.empty((), dtype=dtype).element_size()
            self._fields.append((total, nbytes, a.shape, dtype))
            total += -(-nbytes // _ALIGN) * _ALIGN
        self.signature = signature(batch)
        self._flat = torch.empty((max(total, _ALIGN),), dtype=torch.uint8,
                                 device=self.device)
        self.inputs = layout(*(self._flat[o:o + n].view(dt).view(shape)
                               for o, n, shape, dt in self._fields))

    def copy_in(self, batch):
        """Fill ``inputs`` from a numpy batch of this stager's signature
        (the copy is enqueued on the current stream); returns them."""
        if signature(batch) != self.signature:
            raise ValueError("batch signature differs from the stager's: "
                             f"{signature(batch)} != {self.signature}")
        host = torch.empty(self._flat.shape, dtype=torch.uint8,
                           pin_memory=self._cuda)
        raw = host.numpy()
        for (o, n, shape, dt), a in zip(self._fields, batch):
            np.copyto(raw[o:o + n].view(_TO_NUMPY_WIDE[dt]).reshape(shape), a,
                      casting="safe")
        self._flat.copy_(host, non_blocking=self._cuda)
        return self.inputs


def signature(batch):
    """The shapes and dtypes of a numpy batch's fields: what fixes a
    compiled step (the reference's retrace signature)."""
    return tuple((np.shape(a), np.asarray(a).dtype.str) for a in batch)


def host_reader(t):
    """Copy a step's output out before a later step overwrites it; returns
    ``read()``, which gives it as numpy on any thread. On a card the copy
    goes into fresh pinned memory without blocking, with an event
    recorded behind it: ``read`` waits on that event alone, not on work
    enqueued after it."""
    if t.device.type != "cuda":
        a = t.numpy().copy()
        return lambda: a
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    done = torch.cuda.Event()
    done.record(torch.cuda.current_stream(t.device))

    def read():
        done.synchronize()
        return host.numpy()

    return read

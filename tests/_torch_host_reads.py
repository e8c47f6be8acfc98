"""`host_reads_trapped()`: the port's CPU tests of code that must never
wait on the card (the local-mapping step, the per-frame tracking step,
the scan's keyframe branch, their CUDA-graph runners) run it inside this
trap, where every way of reading a tensor on the host, or of making one
from host data, raises `HostRead`. `allowed` names functions whose own
reads pass (`device_cond`'s predicate read on the CPU): the trap counts
their calls."""

import contextlib

import torch


class HostRead(AssertionError):
    pass


@contextlib.contextmanager
def host_reads_trapped(allowed=()):
    """Inside, every way of reading a tensor on the host, or of making one
    from host data, raises `HostRead`, except inside a call of one of the
    `allowed` functions, given as (module, name). Yields {name: calls} of
    those."""
    T = torch.Tensor
    saved = []
    calls = {name: 0 for _, name in allowed}
    inside = [0]

    def patch(owner, name, fn):
        orig = getattr(owner, name)
        saved.append((owner, name, orig))

        def guarded(*args, **kwargs):
            return orig(*args, **kwargs) if inside[0] else fn(*args, **kwargs)
        setattr(owner, name, guarded)

    def opened(name, fn):
        def call(*args, **kwargs):
            calls[name] += 1
            inside[0] += 1
            try:
                return fn(*args, **kwargs)
            finally:
                inside[0] -= 1
        return call

    def refuse(name):
        def call(*args, **kwargs):
            raise HostRead(name)
        return call

    def host_index(idx):
        for i in idx if isinstance(idx, tuple) else (idx,):
            if isinstance(i, T) and (i.dtype == torch.bool or i.dim() == 0):
                return True
        return False

    get, set_, tensor, as_tensor = T.__getitem__, T.__setitem__, torch.tensor, torch.as_tensor

    def getitem(self, idx):
        if host_index(idx):
            raise HostRead("index by a mask or a 0-d tensor")
        return get(self, idx)

    def setitem(self, idx, value):
        if host_index(idx):
            raise HostRead("index assignment by a mask or a 0-d tensor")
        if not isinstance(value, T) and get(self, idx).dim() == 0:
            raise HostRead("a host number assigned to one element (copied over)")
        return set_(self, idx, value)

    def from_host(make, name):
        def call(data, *args, **kwargs):
            if not isinstance(data, T):
                raise HostRead(f"{name} of host data")
            return make(data, *args, **kwargs)
        return call

    for name in ("__bool__", "item", "__int__", "__float__", "__index__", "tolist", "cpu",
                 "numpy", "nonzero"):
        patch(T, name, refuse(name))
    patch(T, "__getitem__", getitem)
    patch(T, "__setitem__", setitem)
    patch(torch, "nonzero", refuse("torch.nonzero"))
    patch(torch, "tensor", from_host(tensor, "torch.tensor"))
    patch(torch, "as_tensor", from_host(as_tensor, "torch.as_tensor"))
    for module, name in allowed:
        fn = getattr(module, name)
        saved.append((module, name, fn))
        setattr(module, name, opened(name, fn))
    try:
        yield calls
    finally:
        for owner, name, fn in reversed(saved):
            setattr(owner, name, fn)

"""Local mapping as one CUDA graph: `LocalMappingRunner`.

JAX dispatches its compiled local-mapping step as one executable and the
frame loop tracks on (`TrackingConfig.async_mapping`). The port's
counterpart of that executable is a CUDA graph of `local_mapping_step`,
captured once and replayed with one launch a keyframe: dispatched
eagerly, the step's ~18,000 kernels cost the host about as long as the
card takes to run them, so the frame loop waited on its own launches.

The step can be captured because it never reads the card on the host,
branches only by selects on the device, has shapes fixed by the
configuration and draws no random numbers. The runner keeps a static
copy of every tensor of a `SlamState` (found through the dataclass
fields). A call copies the caller's state into it on the device, replays
the graph and returns a state that no later replay touches: a leaf the
step left as it was is the caller's own tensor, every other leaf a clone
of the graph's output. A state kept from one keyframe (the loop closer's,
a segment's snapshot, a host mirror's) so stays as it was.

One graph is captured per configuration (`tracking.async_mapping`
aside, which the step does not read), at its first call: a warm-up run
on a side stream first builds the kernels, fills the device-constant
tables and initialises cuBLAS and cuSOLVER, so that the capture records
no upload; capture and warm-up run inside `highest_precision()`, whose
flags the graph keeps. The graph's first replay, which also uploads it
to the card, maps the state the capture was made from: the `step` that
follows on that same state, unchanged, returns this replay's result and
replays nothing. A state whose leaves differ in shape, dtype or device
from the captured ones raises, and so does a failed capture or replay:
nothing falls back to the eager step.

B1 and B2 count the launches their wrappers make (`ops/cuda_build.py`);
those made during the capture are the graph's, which a replay runs
without calling a wrapper.

On the CPU (`device="cpu"`, the tests) the runner makes the same copies,
runs the step eagerly on its static inputs and copies the result into
output buffers of its own, which every call overwrites as a replay
does, so the buffer logic that the card replays is the one the CPU
tests check.
"""

from __future__ import annotations

import dataclasses
import time

import torch

from orb_slam2_ssd_semantic_tpu_torch import device as device_mod
from orb_slam2_ssd_semantic_tpu_torch.config import SlamConfig
from orb_slam2_ssd_semantic_tpu_torch.mapping import local_mapping
from orb_slam2_ssd_semantic_tpu_torch.mapping.map_state import SlamState
from orb_slam2_ssd_semantic_tpu_torch.utils import precision


def state_leaves(obj, path: str = "state", out=None) -> list:
    """[(path, tensor)] of a dataclass tree of tensors, in field order."""
    out = [] if out is None else out
    if dataclasses.is_dataclass(obj):
        for f in dataclasses.fields(obj):
            state_leaves(getattr(obj, f.name), f"{path}.{f.name}", out)
    elif isinstance(obj, torch.Tensor):
        out.append((path, obj))
    else:
        raise TypeError(f"{path}: {type(obj).__name__} is not a tensor")
    return out


def _rebuild(template, tensors):
    """`template` with its leaves replaced, in order, from the iterator
    `tensors`."""
    if dataclasses.is_dataclass(template):
        return dataclasses.replace(template, **{
            f.name: _rebuild(getattr(template, f.name), tensors)
            for f in dataclasses.fields(template)})
    return next(tensors)


def _config_key(cfg: SlamConfig) -> SlamConfig:
    """What the step reads of `cfg`: all of it but `tracking.async_mapping`."""
    return cfg.replace(tracking=dataclasses.replace(cfg.tracking, async_mapping=True))


@dataclasses.dataclass
class _Captured:
    spec: list  # [(path, shape, dtype)] of the state's leaves
    static_in: list  # the static input leaves
    static_state: SlamState  # a SlamState of those leaves
    graph: torch.cuda.CUDAGraph | None = None  # None on the CPU
    # The graph's output (on the CPU, buffers of the same role): every call
    # overwrites its leaves.
    out_state: SlamState | None = None
    # [(tensor, version)] of the state the capture's replay mapped, until the
    # next `step`: that step, on the same unchanged tensors, replays nothing.
    mapped: list | None = None
    capture_ms: float = 0.0  # warm-up, capture, instantiation and first replay (host clock)
    pool_bytes: int = 0  # device memory the graph's private pool reserved


class LocalMappingRunner:
    """`step(state, cfg)` is `local_mapping_step(state, cfg)`, replayed from
    one CUDA graph per configuration on the card. `device=None` is the
    card (raises without one)."""

    def __init__(self, device=None):
        self.device = device_mod.resolve(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self._captured: dict = {}

    def ready(self, cfg: SlamConfig) -> bool:
        """Whether the graph of `cfg` is captured (on the CPU: its buffers made)."""
        return _config_key(cfg) in self._captured

    def stats(self, cfg: SlamConfig) -> dict:
        """The capture's host ms and its private pool's bytes."""
        c = self._captured[_config_key(cfg)]
        return dict(capture_ms=c.capture_ms, pool_bytes=c.pool_bytes)

    @precision.scoped
    def capture(self, state: SlamState, cfg: SlamConfig) -> None:
        """Make `cfg`'s static buffers from `state` and, on the card, warm
        the step up, capture it and replay it once on `state`. Does
        nothing when already done."""
        key = _config_key(cfg)
        if key in self._captured:
            return
        t0 = time.perf_counter()
        leaves = state_leaves(state)
        for path, t in leaves:
            if t.device != self.device:
                raise ValueError(f"LocalMappingRunner on {self.device}: {path} is on {t.device}")
        static_in = [torch.empty(t.shape, dtype=t.dtype, device=self.device) for _, t in leaves]
        torch._foreach_copy_(static_in, [t for _, t in leaves])
        c = _Captured(spec=[(p, t.shape, t.dtype) for p, t in leaves], static_in=static_in,
                      static_state=_rebuild(state, iter(static_in)))
        if self.device.type == "cuda":
            main = torch.cuda.current_stream(self.device)
            side = torch.cuda.Stream(self.device)
            side.wait_stream(main)
            with torch.cuda.stream(side):
                local_mapping.local_mapping_step(c.static_state, cfg)
            main.wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                reserved = torch.cuda.memory_reserved(self.device)
                c.out_state = local_mapping.local_mapping_step(c.static_state, cfg)
            c.pool_bytes = torch.cuda.memory_reserved(self.device) - reserved
            c.graph = graph
            # A graph's first launch also uploads it to the card (~0.1 s of
            # host for the step's ~18,000 nodes): made here, on `state`, so
            # that every dispatch costs the same and the next `step` on
            # `state` finds its result made.
            torch._foreach_copy_(static_in, [t for _, t in leaves])
            graph.replay()
            c.mapped = [(t, t._version) for _, t in leaves]
        c.capture_ms = (time.perf_counter() - t0) * 1e3
        self._captured[key] = c

    @precision.scoped
    def step(self, state: SlamState, cfg: SlamConfig) -> SlamState:
        """Local mapping on `state`: copy in and replay (capturing first if
        `cfg` has no graph yet; neither when the capture's own replay
        mapped these very tensors), and a state of fresh or unchanged
        leaves."""
        self.capture(state, cfg)
        c = self._captured[_config_key(cfg)]
        leaves = state_leaves(state)
        if len(leaves) != len(c.spec):
            raise ValueError(f"LocalMappingRunner: the state has {len(leaves)} tensors, the "
                             f"captured one {len(c.spec)}")
        for (path, t), (cpath, shape, dtype) in zip(leaves, c.spec):
            if path != cpath or t.shape != shape or t.dtype != dtype or t.device != self.device:
                raise ValueError(f"LocalMappingRunner: {path} is {t.dtype} {tuple(t.shape)} on "
                                 f"{t.device}; the graph was captured for {cpath} {dtype} "
                                 f"{tuple(shape)} on {self.device}")
        src = [t for _, t in leaves]
        mapped, c.mapped = c.mapped, None
        if c.graph is None:
            torch._foreach_copy_(c.static_in, src)
            new = local_mapping.local_mapping_step(c.static_state, cfg)
            if c.out_state is None:
                c.out_state = new
            else:  # into the same output buffers every call, as a replay writes
                pairs = [(o, n) for (_, o), (_, n) in zip(state_leaves(c.out_state),
                                                          state_leaves(new)) if o is not n]
                torch._foreach_copy_([o for o, _ in pairs], [n for _, n in pairs])
        elif mapped is None or any(t is not m or t._version != v
                                   for t, (m, v) in zip(src, mapped)):
            torch._foreach_copy_(c.static_in, src)
            c.graph.replay()
        slot = {id(t): i for i, t in enumerate(c.static_in)}
        out = [src[slot[id(t)]] if id(t) in slot else t.clone()
               for _, t in state_leaves(c.out_state)]
        return _rebuild(c.out_state, iter(out))

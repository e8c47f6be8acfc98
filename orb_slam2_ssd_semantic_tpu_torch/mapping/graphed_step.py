"""Steps replayed from CUDA graphs: `GraphedStep`, the machinery, and
`LocalMappingRunner`, local mapping through it (the per-frame tracking
step's runner is `tracking/graphed_track.py::TrackStepRunner`).

JAX compiles its per-frame tracking step and its local-mapping step each
into one executable; the host dispatches it and goes on. The port's
counterpart of such an executable is a CUDA graph of the step, captured
once and replayed with one launch: dispatched eagerly, local mapping's
~18,000 kernels and a tracked frame's ~12,000 cost the host about as
long as the card takes to run them, or longer.

A step can be captured because it never reads the card on the host,
branches only on the device (by selects, or by
`mapping/graph_cond.py::device_cond`), has shapes fixed by the
configuration and draws no random numbers. `GraphedStep` keeps a static
copy of every tensor of its argument tree (dataclasses and tuples of
tensors; a Python int is a 0-d int64 tensor, filled on the device) that
the step reads; a leaf it does not read stands in as a tensor without
storage (`Unread`) on which every operation raises, naming the leaf. A
call copies every leaf the step reads into the static copies, on the
device (a frame's images and a handful of map tensors, where the whole
state is ~30 tensors), replays the graph and returns a tree that no
later replay touches: a leaf the step passed through is the caller's
own tensor, every other leaf a clone of the graph's output. So a state
or a frame kept from one call (the next frame's inputs, the loop
closer's state, a segment's snapshot, a host mirror) stays as it was,
and no output buffer is ever an input of the replay that writes it.

A graph is captured at its first call: a warm-up run on a side stream
first builds the kernels, fills the device-constant tables and
initialises cuBLAS and cuSOLVER, so that the capture records no upload;
the runners capture inside `highest_precision()`, whose flags the graph
keeps. The graph's first replay, which also uploads it to the card, maps
the arguments the capture was made from: the call that follows on those
same tensors, unchanged, returns this replay's result and replays
nothing. Arguments whose leaves differ in shape, dtype or device from the
captured ones raise, and so does a failed capture or replay, or a step
that writes into its input: nothing falls back to the eager step.

B1 and B2 count the launches their wrappers make (`ops/cuda_build.py`);
those made during the capture are the graph's (`GraphedStep.captured`),
which a replay runs without calling a wrapper (`GraphedStep.replays`
counts the replays), apart from those inside a conditional body
(`mapping/graph_cond.py::device_cond`; `GraphedStep.conditional`), which
a replay runs only where the body's predicate holds: `GraphedStep.bodies`
records each body's launches, and `GraphedStep.body_runs`, a counter on
the card that each body bumps, how often each ran. A step branches on
the device with `device_cond`: the warm-up runs both branches, the
capture puts each into a conditional node. `GraphedStep.pool_bytes`
reads the caching allocator's segments of the graph's pool and its
bodies' pool.

On the CPU (`device="cpu"`, the tests) the same copies are made, the step
runs eagerly on the static inputs and its result is copied into output
buffers of the graph's role, which every call overwrites as a replay
does, so the buffer logic that the card replays is the one the CPU tests
check.
"""

from __future__ import annotations

import dataclasses
import time
import weakref

import torch
from torch.utils import _pytree

from orb_slam2_ssd_semantic_tpu_torch import device as device_mod
from orb_slam2_ssd_semantic_tpu_torch.config import SlamConfig
from orb_slam2_ssd_semantic_tpu_torch.mapping import local_mapping
from orb_slam2_ssd_semantic_tpu_torch.mapping.graph_cond import _rebuild, capturing, state_leaves
from orb_slam2_ssd_semantic_tpu_torch.mapping.map_state import SlamState
from orb_slam2_ssd_semantic_tpu_torch.ops import cuda_build
from orb_slam2_ssd_semantic_tpu_torch.utils import precision


def _shape_dtype(x) -> tuple:
    return (tuple(x.shape), x.dtype) if isinstance(x, torch.Tensor) else ((), torch.int64)


class Unread(torch.Tensor):
    """The stand-in for a leaf at `path` that a step is declared not to
    read: its shape and dtype, no storage, and an error naming `path` from
    every operation on it (a kernel wrapper refuses it as a tensor on the
    "meta" device)."""

    @staticmethod
    def __new__(cls, path: str, shape, dtype):
        t = torch.Tensor._make_wrapper_subclass(cls, shape, dtype=dtype, device="meta")
        t.path = path
        return t

    __torch_function__ = torch._C._disabled_torch_function_impl

    @classmethod
    def __torch_dispatch__(cls, func, types, args=(), kwargs=None):
        paths = [a.path for a in _pytree.tree_leaves((args, kwargs)) if isinstance(a, Unread)]
        raise RuntimeError(f"{func} reads {paths}, which the step is declared not to read")


def config_key(cfg: SlamConfig) -> SlamConfig:
    """What a step reads of `cfg`: all of it but `tracking.async_mapping`."""
    return cfg.replace(tracking=dataclasses.replace(cfg.tracking, async_mapping=True))


class GraphedStep:
    """`fn(args)` replayed from one CUDA graph on `device` (on the CPU: run
    eagerly on the same static buffers), for arguments shaped as `args`.
    `reads(path)`: whether the step reads the leaf at `path` (all of
    them when None; any other leaf is an `Unread`); `root` names the tree
    in paths and `name` the owner in errors. Made from `args`; on the
    card it captures there and replays once on them."""

    def __init__(self, fn, args, device: torch.device, name: str, root: str, reads=None):
        t0 = time.perf_counter()
        self.fn, self.device, self.name, self.root = fn, device, name, root
        leaves = state_leaves(args, root)
        self.spec = [(path, *_shape_dtype(x)) for path, x in leaves]
        for path, x in leaves:
            if isinstance(x, torch.Tensor) and x.device != device:
                raise ValueError(f"{name} on {device}: {path} is on {x.device}")
        self.static_in: list = []  # the static inputs, one per leaf the step reads
        self._slot: list = []  # per leaf: its index in static_in, None if not read
        self._stand_in: list = []  # per leaf: what the step gets (static input or Unread)
        for path, shape, dtype in self.spec:
            read = reads is None or reads(path)
            t = torch.empty(shape, dtype=dtype, device=device) if read else Unread(path, shape,
                                                                                  dtype)
            self._slot.append(len(self.static_in) if read else None)
            if read:
                self.static_in.append(t)
            self._stand_in.append(t)
        self.static_args = _rebuild(args, iter(self._stand_in))
        self.graph: torch.cuda.CUDAGraph | None = None  # None on the CPU
        # The step's output tree (the graph's, or on the CPU buffers of the same
        # role): every call overwrites its leaves.
        self.out = None
        self.captured: dict = {}  # launches by kernel that the capture recorded
        # Launches by kernel that the capture recorded inside conditional bodies
        # (`mapping/graph_cond.py`), not in `captured`: a replay runs them only
        # where the body's predicate holds.
        self.conditional: dict = {}
        # Per conditional body, in capture order: its depth, the predicate's
        # value it runs on and its launches by kernel (`graph_cond.Bodies`).
        self.bodies: list = []
        # On the card with bodies: (MAX_BODIES,) int64, body i's runs in slot
        # i, counted on the device by every replay that runs it.
        self.body_runs: torch.Tensor | None = None
        self.replays = 0
        self._pools: list = []  # the private pools' ids: the graph's, its bodies'
        self.upload_ms = 0.0  # host ms of the first replay, which uploads the graph
        # What the capture's replay mapped (`_marks`), until the next call:
        # that call, on the same unchanged leaves, replays nothing.
        self._mapped: list | None = None
        self._copy_in(leaves)
        if device.type == "cuda":
            self._capture()
            self._mapped = self._marks(leaves)
        # Host ms of the copies, warm-up, capture, instantiation and first replay.
        self.capture_ms = (time.perf_counter() - t0) * 1e3

    def _versions(self) -> list:
        return [t._version for t in self.static_in]

    def _check_untouched(self, before: list) -> None:
        for (path, *_), slot in zip(self.spec, self._slot):
            if slot is not None and self.static_in[slot]._version != before[slot]:
                raise RuntimeError(f"{self.name}: the step wrote into its input {path}")

    def _capture(self) -> None:
        before = self._versions()
        main = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            self.fn(self.static_args)
        main.wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        launched = dict(cuda_build.captured)
        launched_if = dict(cuda_build.conditional)
        with capturing(self.device) as bodies, torch.cuda.graph(graph):
            self.out = self.fn(self.static_args)
        self._pools = [graph.pool()]
        if bodies.kernels:
            weakref.finalize(self, torch._C._cuda_releasePool, self.device.index, bodies.pool)
            self._pools.append(bodies.pool)
            self.bodies, self.body_runs = bodies.kernels, bodies.runs
        self.captured = {k: n - launched.get(k, 0) for k, n in cuda_build.captured.items()
                         if n > launched.get(k, 0)}
        self.conditional = {k: n - launched_if.get(k, 0) for k, n in
                            cuda_build.conditional.items() if n > launched_if.get(k, 0)}
        self._check_untouched(before)
        self.graph = graph
        # A graph's first launch also uploads it to the card (~0.1 s of host
        # for ~18,000 nodes): made here, on the capture's own arguments, so
        # that every later dispatch costs the same and the next call on
        # those arguments finds its result made.
        t0 = time.perf_counter()
        graph.replay()
        self.upload_ms = (time.perf_counter() - t0) * 1e3
        self.replays += 1

    @property
    def pool_bytes(self) -> int:
        """Device memory that the allocator holds in the graph's private
        pools: the sizes of their segments (`torch.cuda.memory_snapshot`);
        0 on the CPU."""
        pools = {tuple(p) for p in self._pools}
        return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                   if seg["device"] == self.device.index
                   and tuple(seg["segment_pool_id"]) in pools) if pools else 0

    def _marks(self, leaves) -> list:
        """[(leaf, version counter or None)] of the leaves the step reads."""
        return [(x, x._version if isinstance(x, torch.Tensor) else None)
                for (_, x), slot in zip(leaves, self._slot) if slot is not None]

    def _copy_in(self, leaves) -> None:
        """Copy every leaf the step reads into its static input."""
        dst, src = [], []
        for (_, x), slot in zip(leaves, self._slot):
            if slot is None:
                continue
            if isinstance(x, torch.Tensor):
                dst.append(self.static_in[slot])
                src.append(x)
            else:
                self.static_in[slot].fill_(x)
        if dst:
            torch._foreach_copy_(dst, src)

    def _check_spec(self, leaves) -> None:
        if len(leaves) != len(self.spec):
            raise ValueError(f"{self.name}: the arguments have {len(leaves)} tensors, the "
                             f"captured ones {len(self.spec)}")
        for (path, x), (cpath, shape, dtype) in zip(leaves, self.spec):
            got_shape, got_dtype = _shape_dtype(x)
            dev = x.device if isinstance(x, torch.Tensor) else self.device
            if path != cpath or got_shape != shape or got_dtype != dtype or dev != self.device:
                raise ValueError(f"{self.name}: {path} is {got_dtype} {got_shape} on {dev}; the "
                                 f"graph was captured for {cpath} {dtype} {shape} on "
                                 f"{self.device}")

    def __call__(self, args):
        """The step on `args`: copy in, replay (not when the capture's own
        replay mapped these very tensors), and a tree of fresh or
        passed-through leaves."""
        leaves = state_leaves(args, self.root)
        self._check_spec(leaves)
        mapped, self._mapped = self._mapped, None
        if self.graph is None:
            self._copy_in(leaves)
            before = self._versions()
            new = self.fn(self.static_args)
            self._check_untouched(before)
            if self.out is None:
                self.out = new
            else:  # into the same output buffers every call, as a replay writes
                pairs = [(o, n) for (_, o), (_, n) in zip(state_leaves(self.out, "out"),
                                                          state_leaves(new, "out")) if o is not n]
                torch._foreach_copy_([o for o, _ in pairs], [n for _, n in pairs])
        elif mapped is None or any(
                (x is not y if isinstance(x, torch.Tensor) else x != y) or v != w
                for (x, v), (y, w) in zip(self._marks(leaves), mapped)):
            self._copy_in(leaves)
            self.graph.replay()
            self.replays += 1
        given = {id(t): x for (_, x), t in zip(leaves, self._stand_in)
                 if isinstance(x, torch.Tensor)}
        out = [given[id(t)] if id(t) in given else t.clone()
               for _, t in state_leaves(self.out, "out")]
        return _rebuild(self.out, iter(out))


class GraphRunner:
    """One `GraphedStep` per key (a configuration, and what else a step
    holds static) on one device; `device=None` is the card (raises
    without one)."""

    def __init__(self, device=None):
        self.device = device_mod.resolve(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self._captured: dict = {}

    def _graph(self, key, make) -> GraphedStep:
        if key not in self._captured:
            self._captured[key] = make()
        return self._captured[key]

    def graphs(self) -> list:
        """The captured `GraphedStep`s, in capture order."""
        return list(self._captured.values())


class LocalMappingRunner(GraphRunner):
    """`step(state, cfg)` is `local_mapping_step(state, cfg)`, replayed from
    one CUDA graph per configuration (`tracking.async_mapping` aside,
    which the step does not read) on the card."""

    def ready(self, cfg: SlamConfig) -> bool:
        """Whether the graph of `cfg` is captured (on the CPU: its buffers made)."""
        return config_key(cfg) in self._captured

    def stats(self, cfg: SlamConfig) -> dict:
        """The capture's host ms and its private pool's bytes."""
        g = self._captured[config_key(cfg)]
        return dict(capture_ms=g.capture_ms, pool_bytes=g.pool_bytes)

    @precision.scoped
    def capture(self, state: SlamState, cfg: SlamConfig) -> GraphedStep:
        """Make `cfg`'s static buffers from `state` and, on the card, warm
        the step up, capture it and replay it once on `state`. Does
        nothing when already done."""
        return self._graph(config_key(cfg), lambda: GraphedStep(
            lambda s: local_mapping.local_mapping_step(s, cfg), state, self.device,
            "LocalMappingRunner", "state"))

    @precision.scoped
    def step(self, state: SlamState, cfg: SlamConfig) -> SlamState:
        """Local mapping on `state` (capturing first if `cfg` has no graph
        yet): a state of fresh or unchanged leaves."""
        return self.capture(state, cfg)(state)

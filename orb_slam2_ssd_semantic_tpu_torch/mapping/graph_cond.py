"""`device_cond`: the port's `lax.cond`, a branch taken on the device.

JAX's scan runs its keyframe branch under `lax.cond`, and its tracking
step the doubled-window retry and the reference-keyframe fallback: the
program holds both branches and the device picks one, so the host never
reads the predicate. The port's counterpart, while a CUDA graph is being
captured (`mapping/graphed_step.py::GraphedStep`, inside `capturing`), is a pair
of conditional graph nodes, one on `pred` and one on `not pred` (CUDA
12.4 nests them), each holding its branch's kernels as a body graph that
runs only when its predicate is true at replay. The nodes are made by
`csrc/graph_cond.cu` (built by `ops/cuda_build.py`; PyTorch 2.11 has no
binding for them): a conditional handle, a one-thread kernel that sets it
from `pred` on the device, the if-node, and a capture of a stream of
its own into the node's body, whose allocations go to a memory pool of the
capture's bodies (`Bodies`). This is the pattern of newer PyTorch's
`torch._higher_order_ops.cudagraph_conditional_nodes.if_else_node`: the
true branch's outputs are cloned into memory of their own inside its body
and the false branch copies its outputs into them, so the nodes after the
conditional read one fixed set of buffers whichever branch ran.

Elsewhere:
- on the card while no graph is captured (a `GraphedStep`'s warm-up),
  both branches run and each output is a `torch.where` of the two: every
  kernel, library handle, workspace and device-constant table of both
  branches exists before the capture, and nothing is read on the host;
- on the CPU (the tests) the predicate is read on the host, by
  `predicate_on_host`, and only the branch it names runs; its outputs are
  cloned, as the card's are.

Nothing falls back: a branch the capture cannot put into a body (a host
node, an event, a copy from pageable memory) fails the capture, which
raises.

B1's and B2's launches made inside a body are counted in
`cuda_build.conditional`, not in `cuda_build.captured`, and in the
capture's record of that body (`Bodies.kernels`): a replay runs them only
when the body's predicate holds. Each body's first node adds one to its
slot of a counter on the card (`Bodies.runs`), so how often each body ran
is read from the device, one small kernel per body run, without a trace.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses

import torch

from orb_slam2_ssd_semantic_tpu_torch.ops import cuda_build


def state_leaves(obj, path: str = "state", out=None) -> list:
    """[(path, leaf)] of a tree of dataclasses and tuples whose leaves are
    tensors or Python ints, in field order; None holds no leaf."""
    out = [] if out is None else out
    if dataclasses.is_dataclass(obj):
        for f in dataclasses.fields(obj):
            state_leaves(getattr(obj, f.name), f"{path}.{f.name}", out)
    elif isinstance(obj, tuple):
        for i, x in enumerate(obj):
            state_leaves(x, f"{path}[{i}]", out)
    elif isinstance(obj, (torch.Tensor, int)):
        out.append((path, obj))
    elif obj is not None:
        raise TypeError(f"{path}: {type(obj).__name__} is not a tensor")
    return out


def _rebuild(template, leaves):
    """`template` with its leaves replaced, in order, from the iterator
    `leaves`."""
    if dataclasses.is_dataclass(template):
        return dataclasses.replace(template, **{
            f.name: _rebuild(getattr(template, f.name), leaves)
            for f in dataclasses.fields(template)})
    if isinstance(template, tuple):
        return tuple(_rebuild(x, leaves) for x in template)
    return None if template is None else next(leaves)


# The most conditional bodies one capture may hold (two a `device_cond`).
MAX_BODIES = 16


@dataclasses.dataclass
class Bodies:
    """One capture's conditional bodies: their memory pool (a
    `torch.cuda.graph_pool_handle()`; the graph's own pool cannot take
    them: PyTorch routes to it only the capturing stream's allocations, and
    refuses a second route into it while the capture runs), what each
    body holds, and a counter of each body's runs on the card."""

    pool: tuple
    # (MAX_BODIES,) int64 on the card, made before the capture: slot i
    # counts the runs of body i, which adds one to it first thing.
    runs: torch.Tensor
    # Per body, in capture order: its `device_cond`'s name, its nesting
    # depth (0 outermost), whether it runs where `pred` holds (True) or
    # where it does not, and B1's and B2's launches recorded in it (a
    # nested body's not included).
    kernels: list = dataclasses.field(default_factory=list)
    depth: int = 0  # bodies open
    outermost: int = 0  # outermost bodies captured


# The captures under way, innermost last.
_captures: list = []


@contextlib.contextmanager
def capturing(device: torch.device):
    """Around a graph's capture on `device`: lets `device_cond` capture
    conditional nodes into it. Yields its `Bodies`; where it holds any
    (`kernels` not empty), the caller releases its pool when the graph
    goes (`torch._C._cuda_releasePool`)."""
    cap = Bodies(torch.cuda.graph_pool_handle(),
                 torch.zeros(MAX_BODIES, dtype=torch.int64, device=device))
    _captures.append(cap)
    try:
        yield cap
    finally:
        _captures.pop()


def predicate_on_host(pred: torch.Tensor) -> bool:
    """The one host read `device_cond` makes, and only on the CPU."""
    return bool(pred)


def _tensors(tree, name: str) -> list:
    leaves = [x for _, x in state_leaves(tree, name)]
    if not all(isinstance(x, torch.Tensor) for x in leaves):
        raise TypeError(f"device_cond: the {name} branch returned a leaf that is no tensor")
    return leaves


def _check_alike(t_leaves: list, f_leaves: list) -> None:
    if len(t_leaves) != len(f_leaves) or any(
            (a.shape, a.dtype) != (b.shape, b.dtype) for a, b in zip(t_leaves, f_leaves)):
        raise ValueError("device_cond: the branches return trees of other shapes or dtypes: "
                         f"{[(tuple(a.shape), a.dtype) for a in t_leaves]} and "
                         f"{[(tuple(b.shape), b.dtype) for b in f_leaves]}")


def _graph_cond(op: int, stream, pred, body) -> None:
    lib = cuda_build.load("graph_cond")
    rc = lib.graph_cond(op, stream, pred, body)
    if rc != 0:
        raise RuntimeError(f"graph_cond: CUDA error {rc}: {lib.kernel_error_string(rc).decode()}")


# The streams bodies are captured on, by (device, nesting depth): made by
# `csrc/graph_cond.cu`, never one of PyTorch's pooled streams, which it
# hands out in turn and so may give back one that is capturing.
_body_streams: dict = {}


def _body_stream(dev: torch.device, depth: int) -> torch.cuda.ExternalStream:
    key = (dev.index, depth)
    if key not in _body_streams:
        handle = ctypes.c_void_p()
        with torch.cuda.device(dev):
            _graph_cond(2, ctypes.addressof(handle), None, None)
        _body_streams[key] = torch.cuda.ExternalStream(handle.value, device=dev)
    return _body_streams[key]


@contextlib.contextmanager
def _if_body(pred: torch.Tensor, taken_on: bool, name: str):
    """Capture into the body of a conditional node on `pred` (the
    `taken_on` branch of a `device_cond`), counting its runs on the card
    and the kernels launched there as conditional."""
    if not _captures:
        raise RuntimeError("device_cond: a graph is being captured outside "
                           "`graph_cond.capturing`, which its conditional nodes need")
    dev, cap = pred.device, _captures[-1]
    index = len(cap.kernels)
    if index == MAX_BODIES:
        raise RuntimeError(f"device_cond: more than {MAX_BODIES} conditional bodies in one capture")
    record = dict(name=name, depth=cap.depth, taken_on=taken_on, kernels={})
    cap.kernels.append(record)
    outer, body = torch.cuda.current_stream(dev), _body_stream(dev, cap.depth)
    before = dict(cuda_build.captured)
    _graph_cond(0, outer.cuda_stream, pred.data_ptr(), body.cuda_stream)
    if cap.depth == 0:
        # Every stream's allocations to the body pool: the graph's own
        # capturing stream still goes to the graph's pool, which comes first.
        torch._C._cuda_beginAllocateToPool(dev.index, cap.pool)
    cap.depth += 1
    try:
        with torch.cuda.stream(body):
            cap.runs.narrow(0, index, 1).add_(1)
            yield
    finally:
        cap.depth -= 1
        if cap.depth == 0:
            torch._C._cuda_endAllocateToPool(dev.index, cap.pool)
            if cap.outermost:  # a later begin took one more hold on the pool
                torch._C._cuda_releasePool(dev.index, cap.pool)
            cap.outermost += 1
        _graph_cond(1, outer.cuda_stream, pred.data_ptr(), body.cuda_stream)
        for k, n in list(cuda_build.captured.items()):
            extra = n - before.get(k, 0)
            if extra:
                cuda_build.captured[k] = n - extra
                cuda_build.conditional[k] = cuda_build.conditional.get(k, 0) + extra
                record["kernels"][k] = extra


def device_cond(pred: torch.Tensor, true_fn, false_fn, operands, name: str = ""):
    """`true_fn(operands)` where the 0-d bool tensor `pred` holds, else
    `false_fn(operands)`. `operands` and both results are trees of
    dataclasses and tuples of tensors on `pred`'s device; both results
    have the same shapes and dtypes. The branches must not write into
    their operands. `name` labels the capture's records of its two
    bodies (`Bodies.kernels`)."""
    if pred.dim() != 0 or pred.dtype != torch.bool:
        raise ValueError(f"device_cond: pred is {pred.dtype} of shape {tuple(pred.shape)}, not a "
                         "0-d bool tensor")
    if pred.device.type != "cuda":
        out = true_fn(operands) if predicate_on_host(pred) else false_fn(operands)
        # Memory of its own for every output, as the card's conditional node
        # has: a `GraphedStep` then writes its output buffers whichever
        # branch ran first.
        return _rebuild(out, iter([x.clone() for x in _tensors(out, "taken")]))
    if not torch.cuda.is_current_stream_capturing():
        t_out, f_out = true_fn(operands), false_fn(operands)
        t_leaves, f_leaves = _tensors(t_out, "true"), _tensors(f_out, "false")
        _check_alike(t_leaves, f_leaves)
        return _rebuild(t_out, iter([a if a is b else torch.where(pred, a, b)
                                     for a, b in zip(t_leaves, f_leaves)]))
    not_pred = torch.logical_not(pred)
    with _if_body(pred, True, name):
        t_out = true_fn(operands)
        # Memory of its own for every output: a leaf the branch passed
        # through (an operand, a tensor made before the conditional) must
        # not take the false branch's copy.
        t_leaves = [x.clone() for x in _tensors(t_out, "true")]
    with _if_body(not_pred, False, name):
        f_leaves = _tensors(false_fn(operands), "false")
        _check_alike(t_leaves, f_leaves)
        for a, b in zip(t_leaves, f_leaves):
            a.copy_(b)
    return _rebuild(t_out, iter(t_leaves))

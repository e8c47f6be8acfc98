"""`mapping/graph_cond.py::device_cond`, the port's `lax.cond`, on the
CPU (no JAX): the branch the predicate names runs, nested conds too, and
the predicate is the one value read on the host (`predicate_on_host`,
which the host-read trap lets through and counts). Inside a
`GraphedStep` (`mapping/graphed_step.py`) the CPU path writes the same
output buffers whichever branch is taken, as a replay of the captured
conditional nodes does, with a nested cond and with two sibling conds
in one step (the tracking step's retry and fallback). The card's two
paths (both branches and a select during a graph's warm-up, conditional
nodes in its capture) run in `chip_smoke.py` phases 4, 4b and 8."""

import dataclasses

import pytest
import torch

from orb_slam2_ssd_semantic_tpu_torch.mapping import graph_cond
from orb_slam2_ssd_semantic_tpu_torch.mapping.graph_cond import device_cond
from orb_slam2_ssd_semantic_tpu_torch.mapping.graphed_step import GraphedStep, state_leaves
from _torch_host_reads import host_reads_trapped
from _torch_threads import _few_threads  # noqa: F401 (autouse)

CPU = torch.device("cpu")


@dataclasses.dataclass
class Pair:
    a: torch.Tensor
    b: torch.Tensor


def nested(outer: torch.Tensor, inner: torch.Tensor, op: Pair) -> Pair:
    """outer: inner ? (2a, b - 1) : (a + 1, b - 1); else (0, b)."""
    def taken(p: Pair) -> Pair:
        a = device_cond(inner, lambda x: x * 2, lambda x: x + 1, p.a)
        return Pair(a, p.b - 1)

    return device_cond(outer, taken, lambda p: Pair(torch.zeros_like(p.a), p.b), op)


@pytest.mark.parametrize("outer,inner", [(True, True), (True, False), (False, True),
                                         (False, False)])
def test_nested_cond_takes_the_named_branch(outer, inner):
    op = Pair(torch.arange(4, dtype=torch.float32), torch.tensor([5, 7]))
    want_a = (op.a * 2 if inner else op.a + 1) if outer else torch.zeros(4)
    want_b = op.b - 1 if outer else op.b
    preds = torch.tensor(outer), torch.tensor(inner)
    with host_reads_trapped(allowed=[(graph_cond, "predicate_on_host")]) as reads:
        got = nested(*preds, op)
    assert torch.equal(got.a, want_a) and torch.equal(got.b, want_b)
    assert reads == {"predicate_on_host": 2 if outer else 1}
    assert torch.equal(op.a, torch.arange(4, dtype=torch.float32))


def test_cond_refuses_a_predicate_that_is_not_a_0d_bool():
    for pred in (torch.tensor(1), torch.tensor([True])):
        with pytest.raises(ValueError, match="0-d bool"):
            device_cond(pred, lambda x: x, lambda x: x, torch.zeros(2))


def test_graphed_step_writes_the_same_buffers_whichever_branch_runs():
    """A step whose output comes out of a nested cond: over the four
    predicate pairs the step's output buffers stay the same tensors and
    hold each call's result, and each call returns fresh tensors."""
    def args_of(outer, inner):
        return (torch.tensor(outer), torch.tensor(inner),
                Pair(torch.arange(4, dtype=torch.float32) + outer, torch.tensor([5, 7])))

    step = GraphedStep(lambda x: nested(*x), args_of(True, True), CPU, "cond step", "x")
    buffers = None
    for outer, inner in ((True, True), (False, True), (True, False), (False, False)):
        args = args_of(outer, inner)
        got = step(args)
        want = nested(*args)
        out = [t for _, t in state_leaves(step.out, "out")]
        if buffers is None:
            buffers = out
        assert all(x is y for x, y in zip(out, buffers))
        assert torch.equal(got.a, want.a) and torch.equal(got.b, want.b)
        assert all(torch.equal(t, x) for t, x in zip(out, (got.a, got.b)))
        assert not {got.a.data_ptr(), got.b.data_ptr()} & {t.data_ptr() for t in out}


def siblings(first: torch.Tensor, second: torch.Tensor, op: Pair) -> Pair:
    """Two conds one after the other, as the tracking step's retry and
    fallback: a = first ? 2a : a (passed through); then second ? a + sum(b)
    : op's own a - 1, the second reading the first's output."""
    a = device_cond(first, lambda p: p.a * 2, lambda p: p.a, op, name="first")
    b = device_cond(second, lambda _: a + op.b.sum(), lambda _: op.a - 1, (), name="second")
    return Pair(a, b)


def test_graphed_step_with_sibling_conds_equals_the_eager_step():
    """A step of two sibling conds in a `GraphedStep` on the CPU: over the
    four predicate pairs it equals the eager step, reads the two
    predicates and nothing else on the host, keeps its output buffers and
    returns fresh tensors; the operands stay as they were."""
    def args_of(first, second):
        return (torch.tensor(first), torch.tensor(second),
                Pair(torch.arange(4, dtype=torch.float32) - float(first), torch.tensor([5.0, 7.0])))

    step = GraphedStep(lambda x: siblings(*x), args_of(True, True), CPU, "sibling step", "x")
    buffers = None
    for first, second in ((True, True), (False, True), (True, False), (False, False)):
        args = args_of(first, second)
        a0 = args[2].a.clone()
        with host_reads_trapped(allowed=[(graph_cond, "predicate_on_host")]) as reads:
            got = step(args)
        assert reads == {"predicate_on_host": 2}
        want_a = a0 * 2 if first else a0
        want_b = want_a + 12.0 if second else a0 - 1
        assert torch.equal(got.a, want_a) and torch.equal(got.b, want_b)
        eager = siblings(*args)
        assert torch.equal(got.a, eager.a) and torch.equal(got.b, eager.b)
        assert torch.equal(args[2].a, a0)
        out = [t for _, t in state_leaves(step.out, "out")]
        buffers = buffers or out
        assert all(x is y for x, y in zip(out, buffers))
        assert not {got.a.data_ptr(), got.b.data_ptr()} & {t.data_ptr() for t in out}

"""The dynamic masks as CUDA graphs: `MaskRunner`.

JAX jits each mask into one program, `flow_dynamic_mask_fitted` with its
RANSAC homography and `geometry_dynamic_mask`, and the host dispatches it
and goes on. Neither mask reads the card on the host here either
(`ops/homography.py`: the DLT's eigenvectors from the `sym_eig` kernel,
the best hypothesis gathered on the device, `inv_ex`, the minimal sets'
uniforms a device constant), so `MaskRunner` captures each into a CUDA
graph (`mapping/graphed_step.py::GraphedStep`) and replays it: a masked
frame costs the host the copies into the graph's inputs and one
`cudaGraphLaunch` a mask, where the eager flow mask made ~2,200 kernel
launches and waited on the card five times, and the geometry mask made
~700 launches.

One graph per mask and per what JAX's jit holds static, with the shapes
and dtypes of the inputs: the flow mask's `DynamicConfig` and grid
stride; the geometry mask's `DynamicConfig`, `CameraConfig` and number of
reference views. Two graphs, not one for both masks, as JAX keeps two
programs: `Tracker.process` times them in two stages. The flow graph's
inputs are the previous and the current gray image; the geometry graph's
the six tensors of the view ring, the predicted pose and the depth in
metres. The graph captures at its first call (`capture_flow`,
`capture_geometry`), after `GraphedStep`'s warm-up, which also builds
`sym_eig` and fills the device constants; nothing falls back to the
eager masks on the card. On the CPU the masks run eagerly on the same
static buffers, as every `GraphedStep` does there.
"""

from __future__ import annotations

import dataclasses

import torch

from orb_slam2_ssd_semantic_tpu_torch.config import CameraConfig, DynamicConfig
from orb_slam2_ssd_semantic_tpu_torch.dynamic.flowmask import flow_dynamic_mask_fitted
from orb_slam2_ssd_semantic_tpu_torch.dynamic.geommask import GeomRefViews, geometry_dynamic_mask
from orb_slam2_ssd_semantic_tpu_torch.mapping.graph_cond import state_leaves
from orb_slam2_ssd_semantic_tpu_torch.mapping.graphed_step import GraphedStep, GraphRunner
from orb_slam2_ssd_semantic_tpu_torch.utils import precision


@dataclasses.dataclass
class FlowArgs:
    """The flow mask's tensor arguments, as its graph takes them."""

    prev_gray: torch.Tensor
    gray: torch.Tensor


@dataclasses.dataclass
class GeomArgs:
    """The geometry mask's tensor arguments, as its graph takes them."""

    views: GeomRefViews
    T_cw: torch.Tensor  # (4, 4) the predicted pose
    depth: torch.Tensor  # (H, W) float32 metres


def _spec(args) -> tuple:
    return tuple((tuple(x.shape), x.dtype) for _, x in state_leaves(args, "mask"))


class MaskRunner(GraphRunner):
    """`flow(...)` is `flow_dynamic_mask_fitted(prev_gray, gray, cfg,
    grid_stride)` and `geometry(...)` is `geometry_dynamic_mask(views, T_cw,
    depth, cam, cfg, n_refs)`, each replayed from one CUDA graph per kind
    on the card. `device=None` is the card (raises without one)."""

    @staticmethod
    def _flow_key(args: FlowArgs, cfg: DynamicConfig, grid_stride: int):
        return "flow", cfg, grid_stride, _spec(args)

    @staticmethod
    def _geom_key(args: GeomArgs, cam: CameraConfig, cfg: DynamicConfig, n_refs):
        return "geometry", cfg, cam, n_refs, _spec(args)

    def ready_flow(self, prev_gray, gray, cfg: DynamicConfig, grid_stride: int = 8) -> bool:
        """Whether the flow graph of these arguments' kind is captured (on
        the CPU: its buffers made)."""
        return self._flow_key(FlowArgs(prev_gray, gray), cfg, grid_stride) in self._captured

    def ready_geometry(self, views: GeomRefViews, T_cw, depth, cam: CameraConfig,
                       cfg: DynamicConfig, n_refs: int | None = None) -> bool:
        """Whether the geometry graph of these arguments' kind is captured."""
        return self._geom_key(GeomArgs(views, T_cw, depth), cam, cfg, n_refs) in self._captured

    @precision.scoped
    def capture_flow(self, prev_gray, gray, cfg: DynamicConfig,
                     grid_stride: int = 8) -> GraphedStep:
        """The flow graph of these arguments' kind, made from them (on the
        card: warmed up, captured and replayed once on them) unless it
        exists."""
        args = FlowArgs(prev_gray, gray)
        return self._graph(self._flow_key(args, cfg, grid_stride), lambda: GraphedStep(
            lambda a: flow_dynamic_mask_fitted(a.prev_gray, a.gray, cfg, grid_stride),
            args, self.device, "MaskRunner.flow", "flow"))

    @precision.scoped
    def capture_geometry(self, views: GeomRefViews, T_cw, depth, cam: CameraConfig,
                         cfg: DynamicConfig, n_refs: int | None = None) -> GraphedStep:
        """The geometry graph of these arguments' kind, made from them
        unless it exists."""
        args = GeomArgs(views, T_cw, depth)
        return self._graph(self._geom_key(args, cam, cfg, n_refs), lambda: GraphedStep(
            lambda a: geometry_dynamic_mask(a.views, a.T_cw, a.depth, cam, cfg, n_refs),
            args, self.device, "MaskRunner.geometry", "geometry"))

    @precision.scoped
    def flow(self, prev_gray, gray, cfg: DynamicConfig, grid_stride: int = 8) -> torch.Tensor:
        """The flow mask (H, W) bool, True = static (capturing first if this
        kind has no graph yet): a fresh tensor."""
        graph = self.capture_flow(prev_gray, gray, cfg, grid_stride)
        return graph(FlowArgs(prev_gray, gray))

    @precision.scoped
    def geometry(self, views: GeomRefViews, T_cw, depth, cam: CameraConfig,
                 cfg: DynamicConfig, n_refs: int | None = None) -> torch.Tensor:
        """The geometry mask (H, W) bool, True = static, at the pose `T_cw`
        from `depth` in metres (capturing first if this kind has no graph
        yet): a fresh tensor."""
        graph = self.capture_geometry(views, T_cw, depth, cam, cfg, n_refs)
        return graph(GeomArgs(views, T_cw, depth))

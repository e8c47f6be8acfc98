"""The per-frame tracking step as one CUDA graph: `TrackStepRunner`; and
keyframe insertion as another: `InsertKeyframeRunner`.

JAX compiles `fused_track_step` into one program, and the host makes one
small transfer a frame, the packed stats (`Tracker.process`). The port's
step has no host read either, so the runner captures it into a CUDA graph
(`mapping/graphed_step.py::GraphedStep`) and replays it every frame: a
tracked frame costs the host its two image uploads, the copies into the
graph's inputs, one `cudaGraphLaunch` and the stats fetch, where the
eager step made ~12,000 launches. JAX's two `lax.cond`s in the step (the
doubled-window retry, the reference-keyframe fallback) are
`mapping/graph_cond.py::device_cond`s (`tracking/tracker.py`), so the
graph holds four conditional bodies, the retry and its pass-through, the
fallback and its pass-through, and a frame runs only the bodies its
predicates name (`GraphedStep.body_runs` counts each on the card).

One graph per (configuration, with a dynamic mask or not, with
pre-extracted features or not), as JAX compiles one program per static
`cfg`, `use_mask` and `use_feats`. Its static inputs are the images (the
gray one only without features), the mask, the features, every tensor of
the last frame, the last pose, keypoint associations and velocity, the
frame counter and the reference keyframe's inlier count (a Python int is
filled into a 0-d tensor on the device, so no value is baked into the
graph), and the twelve tensors of the map state the step reads
(`STATE_READS`); the rest of the state stands in as
`mapping/graphed_step.py::Unread` tensors, on which any operation raises
with the leaf's name (so a step that comes to read another leaf fails at
its capture, there), and comes back as the caller's own.

JAX jits `insert_keyframe` too; `InsertKeyframeRunner` replays it from
one graph per (configuration, `spawn_all`): `Tracker.process` inserts
every keyframe through it, and `init_scan` its first.
"""

from __future__ import annotations

import dataclasses

import torch

from orb_slam2_ssd_semantic_tpu_torch.config import SlamConfig
from orb_slam2_ssd_semantic_tpu_torch.frontend.extractor import Features
from orb_slam2_ssd_semantic_tpu_torch.mapping.graphed_step import (
    GraphedStep,
    GraphRunner,
    config_key,
)
from orb_slam2_ssd_semantic_tpu_torch.mapping.map_state import SlamState
from orb_slam2_ssd_semantic_tpu_torch.tracking import tracker as tk
from orb_slam2_ssd_semantic_tpu_torch.utils import precision

# The map state's tensors that `fused_track_step` reads: the motion model
# and local-map tracking read the points, the reference-keyframe fallback
# the newest keyframe's row.
STATE_READS = frozenset((
    "points.pos", "points.desc", "points.min_dist", "points.max_dist", "points.n_visible",
    "points.n_found", "points.valid", "kfs.angle", "kfs.desc", "kfs.kp_valid", "kfs.kp_point",
    "last_kf"))


@dataclasses.dataclass
class TrackArgs:
    """`fused_track_step`'s tensor arguments, as the graph takes them."""

    state: SlamState
    gray: torch.Tensor | None  # None with `feats`
    depth: torch.Tensor
    static_mask: torch.Tensor | None
    feats: Features | None
    last_frame: tk.Frame
    last_T_cw: torch.Tensor
    last_kp_point: torch.Tensor
    velocity: torch.Tensor
    frames_since_kf: torch.Tensor | int
    ref_kf_inliers: torch.Tensor | int


def _reads(path: str) -> bool:
    state = "step.state."
    return not path.startswith(state) or path[len(state):] in STATE_READS


class TrackStepRunner(GraphRunner):
    """`step(...)` is `tracker.fused_track_step(...)` (the same arguments),
    replayed from one CUDA graph per (configuration, mask or none,
    features or none) on the card. `device=None` is the card (raises
    without one)."""

    @staticmethod
    def _key(cfg: SlamConfig, static_mask, feats):
        return config_key(cfg), static_mask is not None, feats is not None

    def ready(self, cfg: SlamConfig, static_mask=None, feats=None) -> bool:
        """Whether the graph for `cfg` with (or without) a mask and
        features is captured (on the CPU: its buffers made)."""
        return self._key(cfg, static_mask, feats) in self._captured

    def stats(self, cfg: SlamConfig, static_mask=None, feats=None) -> dict:
        """That graph's capture: host ms, private pool bytes, replays, and
        launches by kernel that it recorded outside and inside its
        conditional bodies, with each body's record (`GraphedStep.bodies`)."""
        g = self._captured[self._key(cfg, static_mask, feats)]
        return dict(capture_ms=g.capture_ms, pool_bytes=g.pool_bytes, replays=g.replays,
                    captured=dict(g.captured), conditional=dict(g.conditional),
                    bodies=g.bodies)

    @precision.scoped
    def capture(self, state: SlamState, gray, depth_img, last_frame: tk.Frame, last_T_cw,
                last_kp_point, velocity, frames_since_kf, ref_kf_inliers, cfg: SlamConfig,
                feats: Features | None = None,
                static_mask: torch.Tensor | None = None) -> tuple[GraphedStep, TrackArgs]:
        """The graph for these arguments' kind, made from them (on the card:
        warmed up, captured and replayed once on them) unless it exists;
        with the arguments as the graph takes them."""
        args = TrackArgs(state, None if feats is not None else gray, depth_img, static_mask,
                         feats, last_frame, last_T_cw, last_kp_point, velocity,
                         frames_since_kf, ref_kf_inliers)

        def step(a: TrackArgs):
            return tk.fused_track_step(a.state, a.gray, a.depth, a.last_frame, a.last_T_cw,
                                       a.last_kp_point, a.velocity, a.frames_since_kf,
                                       a.ref_kf_inliers, cfg, feats=a.feats,
                                       static_mask=a.static_mask)

        graph = self._graph(self._key(cfg, static_mask, feats), lambda: GraphedStep(
            step, args, self.device, "TrackStepRunner", "step", _reads))
        return graph, args

    @precision.scoped
    def step(self, *args, **kwargs):
        """`fused_track_step` on these arguments (capturing first if their
        kind has no graph yet): (state, frame, T_cw, velocity, kp_point,
        packed), every tensor fresh or the caller's own."""
        graph, a = self.capture(*args, **kwargs)
        return graph(a)


@dataclasses.dataclass
class InsertArgs:
    """`insert_keyframe`'s tensor arguments, as the graph takes them."""

    state: SlamState
    frame: tk.Frame
    T_cw: torch.Tensor
    kp_point: torch.Tensor
    frame_id: torch.Tensor | int  # 0-d int64
    stamp: torch.Tensor  # 0-d float32


class InsertKeyframeRunner(GraphRunner):
    """`step(...)` is `tracker.insert_keyframe(...)` (the same arguments),
    replayed from one CUDA graph per (configuration, `spawn_all`) on the
    card, as JAX jits it. `frame_id` and `stamp` enter as 0-d device
    tensors: the stamp as float32, as JAX's weak float becomes under
    `jit`. `device=None` is the card (raises without one)."""

    def stats(self, cfg: SlamConfig, spawn_all: bool = False) -> dict:
        """That graph's capture: host ms (and of them the first replay's,
        which uploads the graph), private pool bytes and replays."""
        g = self._captured[(config_key(cfg), spawn_all)]
        return dict(capture_ms=g.capture_ms, upload_ms=g.upload_ms, pool_bytes=g.pool_bytes,
                    replays=g.replays)

    @precision.scoped
    def step(self, state: SlamState, frame: tk.Frame, T_cw, kp_point, frame_id, stamp,
             cfg: SlamConfig, spawn_all: bool = False):
        """(state, kp_point) after inserting `frame` at `T_cw` (capturing
        first if this kind has no graph yet), every tensor fresh or the
        caller's own."""
        if not isinstance(stamp, torch.Tensor):
            stamp = torch.full((), stamp, dtype=torch.float32, device=self.device)
        args = InsertArgs(state, frame, T_cw, kp_point, frame_id, stamp)
        graph = self._graph((config_key(cfg), spawn_all), lambda: GraphedStep(
            lambda a: tk.insert_keyframe(a.state, a.frame, a.T_cw, a.kp_point, a.frame_id,
                                         a.stamp, cfg, spawn_all=spawn_all),
            args, self.device, "InsertKeyframeRunner", "insert"))
        return graph(args)

#!/usr/bin/env python3
"""Bring-up check of the PyTorch port on one CUDA card.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught). They run in the
order 1-3, 9 (without 9c), 10, 11, 12a-c, 9c, 4-8, 12c-d, 13, 14: the
views of phases 4-8 and 9c render on the CPU in a pool of worker
processes at a lower priority while phases 9-12, which render on the card
or need no view, run; phase 13 needs phase 4's views and 12c's files,
phase 14 phase 10's views and phase 7's map.
  1. print the card (nvidia-smi) and torch; build the CUDA kernels from
     `orb_slam2_ssd_semantic_tpu_torch/csrc/` with nvcc (one process per
     source, all at once) into `build/torch_kernels/`; time an empty
     kernel's launch (`launch_floor.cu`, beside this script), the floor
     under every kernel time below;
  2. the window matcher (B1) against its plain PyTorch version at the main
     path's shapes and at shapes that leave ragged tiles, on a tie-heavy
     problem, with all targets or some queries masked, and with a scalar
     radius, and at loop closing's two shapes ((1024, 1024) at a 40 px
     window, (4096, 1024) at 8 px) and the monocular initializer's
     ((1024, 1024) at 100 px): all four outputs exactly equal, and equal
     again on a second run;
  3. the SPD solve (B2) against its plain version and an f64 solve, with
     the Pallas kernel tests' tolerances, at six sizes, through a strided
     and a transposed view, and on a near-singular damped system;
  4. the main path: `Tracker.process` on a rendered synthetic RGB-D
     sequence at 640x480 with the default config (loop closing and
     relocalization off), long enough for local mapping to run; checks
     ATE, tracking status, map size, and that B1 launched; every tracked
     frame replays the tracking step's CUDA graph, which the tracker
     captured once at frame 1 (`tracking/graphed_track.py`; stage
     `track.capture`), with CUDA's sync debug mode "error" from the copies
     into its inputs to the stats fetch; local mapping runs twice,
     replayed from one CUDA graph the tracker captured once
     (`mapping/graphed_step.py`; stage `local_mapping.capture`); from each
     replay until `process` returns, the sync debug mode is "error"
     (`async_mapping`: the frame must not wait on local mapping); a
     steady window and a keyframe frame that replays the graph are
     profiled (syncs, copies and launches a frame: a steady frame makes
     one `cudaGraphLaunch` and one stream sync, the stats fetch; inside
     the `local_mapping` range: a `cudaGraphLaunch` and no sync); in both
     traces B1's two kernels and B2's ran on the card as many times as
     the window's own wrapper calls, its replays' captured launches and
     its conditional bodies' runs (see "Launches" below) add up to; the
     tracking step's retry and fallback are conditional bodies of its
     graph: a steady replay runs B1 twice, and once more where the retry
     body ran, and no fallback body (their counters on the card); the
     steady window's kernels and card-busy ms a replay are logged beside
     the parent tree's, which computed both branches; 4b, in a process
     of its own (a trace in the script's process, after its earlier
     profiler sessions, lost kernels of a conditional body's replay): the
     tracking graph (a runner of its own) against the eager
     `fused_track_step` on
     the arguments phase 4 gave frame 50 and frame 94 (after the
     local-mapping replay) and on frame 50's with the velocity pushed
     0.6 m (the reference-keyframe fallback decides): every output tensor
     equal bit for bit, each replay one `cudaGraphLaunch`, no wait and no
     wrapper call, B1 in its trace twice and once more where the retry
     body ran, the fallback body run where the motion model failed (the
     pushed frame alone), the first replay's outputs unchanged by later
     ones; the graph's dispatch, the replay and the eager step timed;
  5. local mapping at a 12 + 8 keyframe window (6 * 20 = 120 unknowns, the
     size at which local BA routes its reduced camera system to B2) on the
     phase-4 map; checks that B2 launched and that the refined poses agree
     with the same step forced through B2's plain version; 5b: the step's
     graph at the default 16 + 8 window and at 12 + 8 (a runner each):
     its output equal to the eager step's on every tensor, bit for bit,
     and to a second replay; a returned state unchanged by a replay on
     another state and sharing no memory with the graph's outputs; B1's
     kernels in a traced replay at both windows and B2's at 12 + 8 only,
     as many as the capture recorded and the eager step launched, and no
     wrapper called by a replay; every replay under sync debug mode
     "error" and no stream sync or synchronous copy in a profiled one;
     the dispatch under half
     the same call ending in a synchronize (the JAX package's gate);
     the capture's host ms and pool size logged; 5c: `ic_angle`,
     `gaussian_blur` and `steered_brief` (ORB-SLAM2's orientation and
     descriptor, the references of the extractor's fast path) on phase
     4's first view, card against CPU; 5d: `tests/test_map_hygiene.py`'s
     async-mapping test on the card (phase 4's first 14 frames, a keyframe
     at least every third frame, a synchronous and then an asynchronous
     `Tracker`): both ATEs under 0.02 m, at least two asynchronous
     local-mapping calls, and the asynchronous `local_mapping` stage
     under half the synchronous one;
  6. relocalization: `Tracker.process` with
     `LoopConfig(enabled=False, enable_relocalization=True)` on phase 4's
     frames, with a NAMED vocabulary (a DBoW2 tree of the trained file's
     shape built from a fixed seed into `build/`; a missing-vocabulary
     warning is an error here, so the phase never measures the codebook
     under the vocabulary's name). Checks: `relocalize` called directly on
     fresh frames near keyframe 0's view succeeds with >= 50 inliers and
     within 5 cm of the tracked pose, on the vocabulary and on the flat
     codebook, and on the vocabulary with the frames' depth zeroed (the
     monocular EPnP branch); in localization-only mode with the map's
     points dropped for 4 frames the status is never LOST and
     relocalization is tried, and with the points back it is OK; a
     kidnapped camera (the first poses rolled by 180 degrees) goes LOST,
     relocalizes within 5 cm of ground truth and tracks OK on, with B1
     launched over those frames and the tracking graph's fallback body
     run on every frame tracked LOST. Logs the median host time of a
     relocalization stage call and of a direct `relocalize` call, and the
     launches and syncs of one call by profiler range;
  7. loop closing, on the same named vocabulary:
     a. `tests/test_loop_e2e.py`'s forced closure at 640x480 with the
        default map widths (18 keyframes over 1.3 laps, 0.30 m of
        injected drift, `insert_keyframe` + `fuse_map_points` +
        `on_keyframe`, global BA on): a loop closes at keyframe >= 12 and
        leaves the closure keyframe under 0.6x its error; the open arc of
        the same length closes none; B1 launches inside `on_keyframe`.
        The closing call is replayed under the profiler (launches and
        syncs by range `loop.*`);
     b. on 7a's corrected map (512 keyframe slots, 524,288 observation
        slots, 32,768 points): `global_ba_step_state` on the card and on a
        CPU copy of the state through the same code: one Gauss-Newton
        iteration agrees within 2e-4 (poses) and 2e-3 (points); the full
        20 within the larger of those and twice the CPU's own change
        under a 1e-7 m nudge of the points (truncated CG under Huber
        weights is that sensitive on this map); the median reprojection
        error after it meets the correction guard's rule; the PCG
        essential graph agrees with the dense solve within 1e-3 m on 7a's
        loop graph; times each;
     c. `Tracker.process` on the 90-frame loop circuit (2% depth noise)
        with the default config and `min_kfs_before_loop=6`, loop closing
        on and off: not LOST at the end, the `loop_closing` stage on every
        keyframe after the first, B1 launched, and the ATE gate (the JAX
        package on the CPU misses `on < 0.75 x off` here, so `on <= off +
        5 mm`). Logs the median `loop_closing` stage time;
  8. the whole-sequence path (`tracking/scan_tracker.py`,
     `tracking/segmented.py`):
     a. `track_sequence` on phase 4's frames at the default config: per-
        frame status and keyframe frames equal to phase 4's
        `Tracker.process`, camera positions within 1e-4 m of its poses,
        and a second `process` run on its first 64 frames as close (the
        entry points run deterministic kernels only), ATE under 1 cm, B1
        launched; then
        the first frames one at a time through `init_scan` and
        `track_sequence_scan` for the per-frame time and a profiled
        window of steady frames, whose trace holds B1's and B2's kernels
        as often as the window's launches count them (twice a replay and
        once a retry body run, no fallback body run);
     b. `track_sequence_segmented` on `tests/test_segmented.py`'s circuit
        at 640x480 (145 frames, 2.35 laps, 1% depth noise, segments of
        36), all four segments (145 frames), at `bench.py`'s
        widths with the named vocabulary, three
        times: a verifier whose estimates agree (D = 0) with the real
        `_correct` (at least 2 loop events and 1 correction), the test's
        disagreeing estimates (no correction), and the plain
        `LoopCloser`; every frame `OK` and resolved ATE under 0.15 m in
        each; each real correction, applied again to a CPU copy of the
        state it met, resolves the frames tracked before it to the same
        ATE within 2 mm; frames/s, `scan_s` (the fetches' wait),
        `correct_s`, corrections and re-dispatches (the runner queues
        segment s+1 before it reads segment s, and again after a
        correction), and the peak memory with two segments in flight;
     c. the scan without a host read: phase 4's frames 28-63 (36 frames,
        keyframes at 31 and 62, local mapping at 62) as one segment under
        the profiler, from a carry that tracked frames 1-27, with the
        segmented runner's fetch: exactly one device-to-host copy and one
        wait (the fetch) in the trace; each frame two graph launches (the
        tracking step, the keyframe branch under conditional nodes); per
        frame the branch's kernels, and B1's runs traced in each launch:
        2 in every tracking replay and 1 more in each, by the retry body's
        counter, that ran the retry; no fallback body run; 20 in the
        branch only where local mapping ran (a keyframe that made 3 or
        more); graph launches,
        copies, kernels, device busy ms and host dispatch ms a frame; the
        branch graph's capture ms, pools (their segments) and first-replay
        upload; the bodies' counters on the card equal to the keyframes
        and local mappings; the same segment untraced before and after the
        trace, each runner's step call and each graph's `replay()` alone
        timed on the host. Run twice: in the script's own process (the
        trace's B1 and its ties logged, not held: after earlier profiler
        sessions that trace has held kernels of other launches) and in a
        process of its own (held). 8a and 8b also hold the bodies'
        counters: to the scan's insertions and local mappings, and in
        each segmented run to the frames dispatched and the insertions
        the final map counts; the tracking graph's retry cond once a
        tracked frame in each;
  9. the dynamic masks and the device renderer (counters zeroed before,
     read after; B1's launches here are `launches_dynamic`):
     a. `io/device_render.render_frames` on the card: `bench.py`'s walker
        scene (`SyntheticSequence(trajectory="sway")` poses of its 337
        frames, `cross_walkers(..., n_objects=3)`, 1% depth noise) at
        640x480, cut to its first WALK_FRAMES frames; two frames rendered
        without noise on the card and on the CPU by the same function:
        depth within 1 mm on >= 99.9% of pixels, gray within 1 level on
        >= 99% (the CPU test's limits); ms a frame on the card;
     b. `sym_eig` (`csrc/sym_eig.cu`, the homography DLT's eigensolver)
        against `torch.linalg.eigh` on the card, on the flow mask's own
        (128, 9, 9) and (9, 9) systems of both MASK_PAIRS and on seeded
        degenerate minimal sets (a repeated row, collinear points):
        eigenvalues within 1e-5 of each matrix's Frobenius norm, each
        eigenvector with a relative gap over 1e-3 within 1 - |v . v_ref|
        <= 1e-4, and `_dlt`'s homography within 1e-4 (relative) of the
        plain version's where the null vector is so separated; its
        launch-to-end and on-device ms, the library call's and the bound;
        the flow mask (`flow_dynamic_mask_fitted`) and the geometry mask
        (`geometry_dynamic_mask`) on 9a's frames, on the card and on a CPU
        copy of their inputs with the same minimal sets: at most 0.5% of
        pixels differ (the CPU parity test's limit against JAX); each
        mask's ms on the card; `MaskRunner`'s two graphs equal to the eager
        masks bit for bit, the flow graph holding `sym_eig` twice, each
        graph's capture and pool, and a replay's host and synchronized ms
        (timed before any profiler session in the process);
     c. `tests/test_accuracy_gates.py`'s dynamic runs at 640x480 through
        `Tracker.process`: 20 frames of the static and of the 2-object
        dynamic scene, `max_frames_between_kfs=4`, loop closing and
        relocalization off, four runs (static, unmasked, flow, geometry),
        that test's gates as written (unmasked > 1.25 x static; flow <
        unmasked + 0.25 x static; geometry < unmasked; geometry < 1.9 x
        static); each mask's replay under CUDA's sync debug mode "error";
        the `mask.flow`, `mask.geometry` and `mask.capture` stage times,
        the launches and syncs of a profiled steady masked frame, and in
        its `mask.flow` or `mask.geometry` range one graph launch and no
        wait;
     d. `track_sequence_segmented` on 9a's frames at `bench.py`'s
        `cfg_dyn` (its widths, `min_static_area=0.45`) with the named
        vocabulary, three runs (unmasked, `use_flow`, `use_geom`): no
        frame LOST, the masked runs' resolved ATE under 0.15 m
        (`bench.py`'s gate), geometry <= unmasked; the unmasked run's ATE
        is logged, not gated; frames/s beside the parent tree's (eager
        masks, WALK_FPS_BEFORE);
     e. frames 13-48 of 9a's walker scene as one segment of the scan with
        both masks, from a carry that tracked frames 1-12, traced whole
        with the segmented runner's fetch: one wait and one device-to-host
        copy, no host-to-device copy, four graph launches a frame (the two
        masks, the tracking step, the keyframe branch), `sym_eig` twice a
        frame; the same bits as the segment untraced before it;
     9b's comparisons are not counted: the counters are zeroed after 9b;
 10. semantics (counts zeroed before, read after; B1's launches here are
     `launches_semantic`), with the seeded full-width SSDLite
     (`init_ssdlite(21, seed=0)`, made on the CPU and passed explicitly: a
     missing-artifact warning is an error) on the default orbit's room
     with three boxes flat at `bench.py`'s class gray levels, rendered on
     the card at 640x480 by `io/device_render.py`:
     a. the network on one frame on the card against the port on the CPU
        (f32, TF32 off): loc and conf within 1e-3 of each output's largest
        magnitude; the bf16 batch of 8 against the card's f32 within 0.05;
        each path's ms a call (median of 20, ending in a synchronize);
     b. the card's decode, top-k and NMS on the CPU's raw outputs: boxes
        within 1e-3 px, scores within 1e-6, classes and valid flags equal;
     c. both fusion schemes and `add_objects` on one detection per planted
        box seen (its face's projected bbox, the class of its gray level,
        score 0.9) at 5 views, on the card and a CPU copy: databases
        within 1e-4 m, `segment_objects` labels equal on every pixel;
        every box seen within 0.10 m of a depth-window object (0.4 m for
        MergeSG, `tests/test_semantic.py`'s margin);
     d. `SlamSystem(enable_semantics=True).track_rgbd` on 48 frames
        against `Tracker.process` on the same frames: every frame OK,
        poses and keyframes equal, ATE within phase 4's 0.01 m, one
        detector call per keyframe and the queue empty after each frame;
        a second system with the score gates at 0: its object database
        against the port's consumers on the CPU replaying its keyframe
        payloads (count, classes, centroids within 1e-4 m); ms a frame with
        and without semantics, each consumer's ms, a flush's launches and
        syncs under the profiler;
 11. the dense map, persistence and the other sensor modes on phase 10's
     frames (counts zeroed before, read after; B1's and B2's launches here
     are `launches_dense`):
     a. at 640x480 on one keyframe, card against CPU: `keyframe_cloud`
        (within 1e-5 m), `split_ground` on the same hypotheses, and
        `insert_scan` of the same cloud into the 64^3 block holding most
        endpoints and into the batched consumer's 160 x 40 x 160 grid at
        0.1 m (log-odds flips at most 1e-4 of the touched voxels, colors
        within 1e-5); the ms of each and one block insertion's launches
        and syncs;
     b. `SlamSystem(enable_semantics=True, enable_dense_map=True)` on the
        48 frames with a keyframe at least every 4, against
        `Tracker.process` at that config: every frame OK, keyframes and
        poses equal (0.0 m), > 500 occupied voxels, >= 90% of their
        centres within 0.075 m of a wall or a box face; every block against
        the CPU replaying the keyframe payloads; the octomap file round
        trip (1e-5 m); a map saved after frame 39 and loaded into a new
        system localizes the last 8 frames (no new keyframe, never LOST);
        a keyframe's frame ms with and without the dense map, a keyframe's
        dense consumer ms and its launches and syncs;
     c. `make_batched_consume` on 11b's keyframes against the engine path
        on the same payloads, with `tests/test_semantic.py`'s rules (object
        counts equal, centroids within 0.10 m, at most 2% of the touched
        voxels differing); its ms;
     d. `track_stereo` on 24 pairs (right views rendered on the card at
        the baseline bf / fx): no frame LOST, two extractions a frame, ATE
        under twice the CPU rehearsal's;
     e. `track_monocular` on 24 gray frames: initialized, >= 2 keyframes,
        finite poses, the camera moved, B1 launched at the initializer's
        (1024, 1024) r = 100 search (also held exact against the plain
        version in phase 2);
 12. training, the apps and profiling (counts zeroed before each part,
     read after; B1's and B2's launches here are `launches_apps`):
     a. one training step (`semantic/train.value_and_grad`) of the seeded
        4-class SSDLite on a numpy batch of 2, on the card and on a CPU
        copy: the loss within 1e-5 relative, each of the 404 gradients
        (the BatchNorm statistics' too) within 1e-4 of its norm;
     b. `apps/train_ssdlite.main` (200 steps of 16 device-drawn images, 4
        classes): the last chunk's mean loss under 0.6x the first's; ms a
        step, a step's launches, peak memory; its checkpoint loaded into a
        card `Detector` with no warning and run on `test_ssd_e2e.py`'s
        rectangle (the best detection reported, not gated);
     c. the apps: `rgbd_tum.main` on phase 10's 48 frames written as a TUM
        sequence (PNGs, `associate.txt`, `groundtruth.txt`) with a JSON of
        phase 11b's configuration, `--semantics --dense-map --groundtruth`
        (every frame OK, ATE under 1 cm, both trajectory files read back);
        `detect_locate.main` with 12b's checkpoint on 4 of phase 10's
        views and the rectangle at 2 m as npy, both schemes, against the
        app on the CPU (1e-4 m, labels equal, at least one object);
        `cloud_to_occupancy.main` on 11a's keyframe cloud (5 chunks),
        against the CPU on every voxel;
        after phase 8, `run_synthetic.track` on phase 4's first 24 frames
        (phase 4's poses, 0.0 m) and `train_vocabulary`'s tree and TF-IDF
        on the card's descriptors of 8 of phase 4's frames (k = 10, depth
        3: the file loads, and `quantize` on the card equals the CPU's);
     d. `utils/profiling.trace` around 4 tracked frames in `annotate`
        ranges: the Chrome trace holds the labels and B1's two kernels;
 13. the live app and the rest (counts zeroed before, read after; B1's
     and B2's launches here are `launches_live`):
     a. `ops/register.register_depth_to_color` on phase 10's 640x480 depth
        of view 24 through a 0.025 m baseline with a 1 degree yaw, on the
        card and on the CPU: the same pixels filled on >= 99.99% of them,
        depths within 1e-5 m; the identity returns the input within 1e-5
        m; a 40 px square at 1 m before a 3 m wall keeps its near z on >=
        95% of its pixels (the scatter-min); ms a call;
     b. `undistort_image` on that view, gray and RGB, with
        `tests/test_register.py`'s k1 = -0.2: the card within 1e-3 gray
        levels of the CPU; zero coefficients return the input within 1e-3;
     c. `apps/live_rgbd.run` on phase 4's first 24 frames with
        undistortion and an identity registration read from an npz
        (`load_registration`), `live_rgbd.main --source synthetic` on 2
        frames, and `run` on the `watch:` source over a spool of 8 of
        12c's TUM PNG pairs (1.5 s idle timeout): every frame OK, ATE
        under phase 4's 0.01 m, the trajectory files and `map.npz`
        written, the map read back through `io/map_io.load_map`; ms a
        frame, and the launches and syncs of 2 profiled frames;
     d. `mapping/pose_graph.optimize_pose_graph_sim3` on
        `tests/test_loop_reloc.py`'s scale-drift graph (10 keyframes, 11
        edges, 30 iterations): log-scales and poses within 1e-3 of ground
        truth, and within 1e-5 of a CPU run;
 14. the multi-device code (counts zeroed before 14a's mesh run, read
     after; B1's and B2's launches there are `launches_mesh`). The card
     machine has one card and NCCL takes one rank a card, so 14a-14d run
     on a 1-rank NCCL group that the script makes (a `file://` store in a
     temporary directory, destroyed afterwards):
     a. `SlamSystem(mesh=...)` with the bounded dense grid and loop
        closing on the named vocabulary, on phase 10's first 24 frames,
        against the same system without a mesh
        (`tests/test_mesh_engine.py`'s gates: every frame OK, positions
        within 5e-3 m, log-odds differing on at most 0.5% of the touched
        voxels, colors agreeing on 99%); ms a frame of each;
     b. `global_ba_step_state_sharded` on 7a's corrected map against
        `global_ba_step_state` (1e-3 m), each timed by the host clock;
     c. the sharded L1 query, BoW build and `make_sharded_detect` on 14a's
        keyframes against the single-device scorer, `bow_vector` and
        `detect_candidates` (1e-5, ids and `ok` equal);
     d. the keyframe-sharded `flush_detections` on 4 of phase 10's views
        (score gates 0) against the single-device flush (the same count,
        centroids within 0.05 m);
     e. two spawned ranks on the one card over gloo (`make_mesh(1, 2,
        device="cuda")`): the sharded global BA at 2 iterations on 7a's
        map, its keyframe slots interleaved so that both ranks own
        observations, against 14b's one-rank run at 2 iterations
        (1e-3 m), and three scans into a 64x32x32 grid at
        0.1 m in two X slabs against `insert_scan` (1e-5); the copies a
        profiled all-reduce of a CUDA tensor makes say whether gloo
        stages it through the host; every result on the card;
 15. one JSON line of per-kernel numbers, the card's name and power limit,
     and the result line last.

Launches: B1's, B2's and `sym_eig`'s wrappers count their calls (`ops/cuda_build.py`
also counts those made into a CUDA graph being captured), and a replay of
a graph (`mapping/graphed_step.py::GraphedStep`: every tracked frame
replays the tracking step's, every local-mapping call local mapping's)
runs its capture's launches without calling a wrapper. A phase's
`launches` are the runs on the card: the wrappers' calls outside a
capture plus each replay's captured launches (`_kernel_runs`), with
`launches_wrapper_calls`, `launches_replayed` and `launches_in_bodies`
beside them. Launches captured inside a conditional body (the scan's
keyframe branch and the tracking step's retry and fallback,
`mapping/graph_cond.py`) run only where the body's
predicate holds on the card: each body bumps a counter on the card
(`GraphedStep.body_runs`), and its launches count once a run
(`launches_in_bodies`). The tracking graph holds four bodies (the
doubled-window retry, the reference-keyframe fallback and the
pass-through of each; `track_branches` counts the retries and fallbacks
run), the scan's keyframe branch four more. Phases 4, 4b, 8a and 8c hold
these counts to the card's trace, 8a-8c the bodies' runs to the frames
that took them, and every phase that tracks frames requires B1 in a
replay.

Without a CUDA card it exits non-zero and prints no result.

    python3 chip_smoke.py --host-times

builds the kernels and prints only what the two wrappers cost the host at
the main path's shapes (see `host_times`). It uses nothing of the package
but the wrappers' `prepare` and `launch`, so a copy of this script placed
in another commit's tree reads that tree's wrappers the same way.
"""

from __future__ import annotations

import copy
import ctypes
import dataclasses
import json
import multiprocessing
import os
import pickle
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import warnings
import weakref
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch
import torch.distributed as dist
from torch.profiler import record_function

from orb_slam2_ssd_semantic_tpu_torch.apps import (
    cloud_to_occupancy,
    detect_locate,
    live_rgbd,
    rgbd_tum,
    run_synthetic,
    train_ssdlite,
    train_vocabulary,
)
from orb_slam2_ssd_semantic_tpu_torch.config import (
    CameraConfig,
    DenseMapConfig,
    DynamicConfig,
    SemanticConfig,
    SlamConfig,
)
from orb_slam2_ssd_semantic_tpu_torch.dense.occupancy import empty_grid, insert_scan
from orb_slam2_ssd_semantic_tpu_torch.dense.pointcloud import (
    keyframe_cloud,
    sample_ground_hypotheses,
    split_ground,
)
from orb_slam2_ssd_semantic_tpu_torch.dynamic.flowmask import (
    downscaled_flow,
    flow_dynamic_mask_fitted,
    grid_correspondences,
)
from orb_slam2_ssd_semantic_tpu_torch.dynamic.geommask import (
    empty_ref_views,
    geometry_dynamic_mask,
    insert_ref_view,
)
from orb_slam2_ssd_semantic_tpu_torch.dynamic.graphed_masks import MaskRunner
from orb_slam2_ssd_semantic_tpu_torch.eval.ate import evaluate_ate_xyz
from orb_slam2_ssd_semantic_tpu_torch.frontend import extractor
from orb_slam2_ssd_semantic_tpu_torch.geometry import se3
from orb_slam2_ssd_semantic_tpu_torch.io import device_render
from orb_slam2_ssd_semantic_tpu_torch.io import vocabulary as voc
from orb_slam2_ssd_semantic_tpu_torch.io.map_io import load_map
from orb_slam2_ssd_semantic_tpu_torch.io.tum import read_trajectory, write_trajectory
from orb_slam2_ssd_semantic_tpu_torch.io.synthetic import (
    BoxRoom,
    SyntheticSequence,
    _default_boxes,
    cross_walkers,
    orbit_trajectory,
)
from orb_slam2_ssd_semantic_tpu_torch.mapping import map_state
from orb_slam2_ssd_semantic_tpu_torch.mapping import place_recognition
from orb_slam2_ssd_semantic_tpu_torch.mapping.global_ba import (
    global_ba_step_state,
    global_ba_step_state_sharded,
    problem_from_state,
)
from orb_slam2_ssd_semantic_tpu_torch.mapping.graphed_step import (
    GraphedStep,
    LocalMappingRunner,
    state_leaves,
)
from orb_slam2_ssd_semantic_tpu_torch.mapping.local_mapping import (
    fuse_map_points,
    local_mapping_step,
)
from orb_slam2_ssd_semantic_tpu_torch.mapping.loop_closing import (
    LoopCloser,
    map_median_reproj_error,
)
from orb_slam2_ssd_semantic_tpu_torch.mapping.pose_graph import (
    Sim3Graph,
    build_graph_arrays,
    optimize_pose_graph,
    optimize_pose_graph_pcg,
    optimize_pose_graph_sim3,
)
from orb_slam2_ssd_semantic_tpu_torch.ops import (
    cuda_build,
    cuda_eigh,
    cuda_match,
    cuda_solve,
    orb_descriptor,
)
from orb_slam2_ssd_semantic_tpu_torch.ops import homography
from orb_slam2_ssd_semantic_tpu_torch.ops import image as image_ops
from orb_slam2_ssd_semantic_tpu_torch.ops.homography import sample_minimal_sets
from orb_slam2_ssd_semantic_tpu_torch.ops.match import popcount32, window_mask
from orb_slam2_ssd_semantic_tpu_torch.ops.register import register_depth_to_color, undistort_image
from orb_slam2_ssd_semantic_tpu_torch.parallel import dist_bow, dist_occupancy
from orb_slam2_ssd_semantic_tpu_torch.parallel.mesh import (
    KF_AXIS,
    PT_AXIS,
    gather_rows,
    make_mesh,
    mesh_device,
    shard_rows,
)
from orb_slam2_ssd_semantic_tpu_torch.tracking import scan_tracker
from orb_slam2_ssd_semantic_tpu_torch.tracking import tracker as tracker_mod
from orb_slam2_ssd_semantic_tpu_torch.tracking.graphed_track import TrackStepRunner
from orb_slam2_ssd_semantic_tpu_torch.tracking.reloc import relocalize
from orb_slam2_ssd_semantic_tpu_torch.tracking.segmented import (
    resolve_trajectory,
    track_sequence_segmented,
)
from orb_slam2_ssd_semantic_tpu_torch.semantic.consume import (
    gt_box_localization,
    make_batched_consume,
)
from orb_slam2_ssd_semantic_tpu_torch.semantic.detector import Detections, Detector
from orb_slam2_ssd_semantic_tpu_torch.semantic.fusion import fuse_detections, segment_objects
from orb_slam2_ssd_semantic_tpu_torch.semantic.object_db import add_objects, empty_db
from orb_slam2_ssd_semantic_tpu_torch.semantic.ssdlite import init_ssdlite
from orb_slam2_ssd_semantic_tpu_torch.semantic.train import (
    adam,
    make_train_step,
    synthetic_detection_batch,
    synthetic_detection_batch_device,
    value_and_grad,
)
from orb_slam2_ssd_semantic_tpu_torch.system import SlamSystem
from orb_slam2_ssd_semantic_tpu_torch.tracking.tracker import (
    Tracker,
    build_frame,
    depth_metres,
    insert_keyframe,
)
from orb_slam2_ssd_semantic_tpu_torch.utils import profiling
from orb_slam2_ssd_semantic_tpu_torch.utils.precision import highest_precision

# Published H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth, and the
# CUDA-core float32 rate, used here for every scalar operation the
# kernels do (integer XOR/popcount/add and float compares): an
# optimistic bound, since popcount issues at a quarter of that rate.
HBM_BYTES_PER_S = 3.35e12
CUDA_CORE_OPS_PER_S = 67e12

# Main path: frames of the default orbit sequence. The default config
# inserts a keyframe every 30 frames on this gentle trajectory, so 96
# frames give keyframes at frames 0, 31, 62 and 93: local mapping (which
# starts at the third keyframe) runs twice.
N_FRAMES = 96
# Steady frames (no keyframe) traced with torch.profiler for the device
# breakdown; they are left out of the per-frame timing statistics.
PROFILE_FRAMES = range(40, 45)
# The keyframe frame profiled on its own: the fourth keyframe, where local
# mapping runs the second time, a replay of the graph the third captured.
PROFILE_KEYFRAME = 93
# Phase 4b: the tracking graph held to the eager step on the inputs phase 4
# gave a steady frame and the frame after the local-mapping replay at
# PROFILE_KEYFRAME, and on the steady frame's with the velocity pushed
# TRACK_PUSH_M sideways (the motion model then finds too few inliers and the
# reference-keyframe fallback decides); TRACK_REPEATS timed calls each.
TRACK_OK_FRAME = 50
TRACK_PUSH_M = 0.6
TRACK_REPEATS = 5
# A steady replay of the tracking graph in the parent tree, which computed
# both branches of the step's two conds every frame: kernels and card-busy
# ms (PERF.md section 5: H100 80GB HBM3, 700.00 W). Logged beside this
# run's; not part of the `kernels` line.
PARENT_STEADY_KERNELS, PARENT_STEADY_BUSY_MS = 17600, 25.18
# B1: the main path's three shapes first; then a T of six splits (384), Q and
# T that fill no tile (300, 200: a last split of 8 targets), a T under one
# split (40), a T whose splits are two staged chunks long (4096), a wide one.
B1_SHAPES = ((2048, 1024), (1024, 1024), (512, 128), (768, 384), (256, 128), (300, 200),
             (256, 40), (512, 4096), (2048, 2048))
# B1 at loop closing's two shapes (Q, T, radius): the guided loop search
# (K x K at the wide 40 px window) and the guided confirmation (4096
# landmarks x K keypoints at the fine 8 px window), with TH_LOW.
B1_LOOP_SHAPES = ((1024, 1024, 40.0), (4096, 1024, 8.0))
# B1 at the monocular initializer's search (K x K at SearchForInitialization's
# 100 px window, TH_LOW; `SlamSystem._mono_initialize`).
B1_INIT_SHAPE = (1024, 1024, 100.0)
B2_SIZES = (6, 59, 96, 108, 120, 128)
B2_MAIN_N = 120
# Times of the kernels these replaced (one thread per query on 8 blocks; a
# Gauss-Jordan elimination on 1024 threads), read by this script on an
# NVIDIA H100 80GB HBM3 at 700.00 W before the redesign (PERF.md, section 6).
# Shown in the log beside this run's times; not part of the `kernels` line,
# which holds only what this run measured.
B1_PREV_MS = {(2048, 1024): 0.1563, (1024, 1024): 0.1533}
B2_PREV_MS = {120: 0.2857}
SPD_RTOL, SPD_ATOL, SPD_RESID, SPD_RESID_ILL = 2e-2, 2e-3, 1e-3, 5e-2
# Phase 5: the same local-mapping step with B2 and with its plain version.
# Both are f32 eliminations of the same damped system (per-solve
# difference ~1e-6 relative); up to 15 Gauss-Newton iterations amplify
# it. Sound runs on an H100 differed by at most 6.2e-5 (metres /
# rotation-matrix entries), so poses are held to about three times that.
# The step must move some pose by at least 4x the limit, or the
# comparison could pass with a solve that does nothing.
POSE_ATOL = 2e-4
POSE_MIN_MOVE = 4 * POSE_ATOL
# Phase 5b: host-time repeats of each local-mapping step. 5c: keypoints
# drawn on phase 4's first view (seeded), at least DESC_MARGIN px inside;
# angles card against CPU within DESC_ANGLE_TOL rad, the blur within
# DESC_BLUR_TOL gray levels, descriptors equal.
ASYNC_REPEATS = 5
# Phase 5d: `tests/test_map_hygiene.py:334-366`'s run (14 frames of the
# default orbit at 640x480, `max_frames_between_kfs=2`, loop closing and
# relocalization off) and its ATE gate.
GATE_FRAMES, GATE_KF_GAP, GATE_ATE = 14, 2, 0.02
DESC_POINTS, DESC_MARGIN = 1024, 20
DESC_ANGLE_TOL, DESC_BLUR_TOL = 1e-5, 1e-4
# Phase 6: frames tracked with relocalization on before the checks (the
# default config's second keyframe falls at frame 31), frames of each
# half of the localization-only test, kidnapped views, frames relocalized
# directly (near keyframe 0, the database's only keyframe while loop
# closing is off) and calls timed per frame; the named vocabulary's shape
# is the trained file's (k = 10, depth = 4). Poses are held to the JAX
# relocalization test's 5 cm.
RELOC_TRACK_FRAMES = 40
MBVO_FRAMES = 4
KIDNAP_FRAMES = 3
RELOC_FRAMES = (5, 20)
RELOC_TIMED_CALLS = 3
RELOC_VOCAB_SEED, RELOC_VOCAB_K, RELOC_VOCAB_DEPTH = 3, 10, 4
RELOC_POSE_TOL = 0.05
# Phase 7 (loop closing). 7a: `tests/test_loop_e2e.py`'s forced closure
# (BoxRoom seed 3, 18 keyframes over 1.3 laps of a yawing circle, 0.30 m
# of injected drift) at 640x480 with the default map widths; the loop
# settings of that test, with global BA on (the JAX package accepts this
# closure with global BA on, on the CPU: `loop_reference_jax.py`). Gates:
# a closure at keyframe >= 12 that leaves the closure keyframe under 0.6x
# its error, none on the open arc. 7b: global BA on the card against the
# same port code on a CPU copy (the tolerances of `test_global_ba.py`'s
# two orderings of the same sums, for one Gauss-Newton iteration; the
# full 20 also against the CPU's own spread under a 1e-7 m nudge), the
# correction guard's own rule, PCG
# against the dense pose graph (`test_loop_reloc.py`'s 1e-3 m). 7c: the
# loop circuit through `Tracker.process`, loop closing on and off. The
# JAX package on the CPU (`loop_reference_jax.py`) gives both runs the
# same ATE, 0.0619 m, so it misses its own gate (on < 0.75 x off) and the
# card is held to on <= off + 5 mm.
LOOP_N_KF, LOOP_DRIFT = 18, 0.30
LOOP_CLOSE_MIN_KF, LOOP_ERR_RATIO = 12, 0.6
LOOP_SEQ_FRAMES, LOOP_MIN_KFS = 90, 6
GBA_POSE_TOL, GBA_POINT_TOL, GBA_NUDGES = 2e-4, 2e-3, 2
PCG_POS_TOL = 1e-3
JAX_7C_MEETS_GATE, ATE_SLACK = False, 0.005
LOOP_RANGES = ("loop.detect", "loop.sim3", "loop.confirm", "loop.pose_graph", "loop.fuse",
               "loop.global_ba")
# Phase 8. 8a: the scan on phase 4's frames against phase 4's poses, and a
# second `Tracker.process` run on the first AGAIN_FRAMES frames (past the
# keyframe at frame 62; cut from 96 to fit the script's time)
# against them too. The entry points run
# deterministic kernels only (`utils/precision.py`), so both should repeat
# phase 4 exactly; 1e-4 m leaves room for nothing but a changed order of
# the same ops. (Before the entry points were made deterministic, two
# `process` runs on the card parted by up to 5.4e-4 m, from frame 62's
# keyframe on: `determinism_probe.py` shows it.) The frames up
# to phase 4's profiled window are then replayed one at a time. 8b:
# `tests/test_segmented.py`'s circuit at 640x480, `bench.py`'s ATE gate.
SCAN_POS_TOL, AGAIN_FRAMES = 1e-4, 64
SEG_FRAMES, SEG_LAPS, SEG_NOISE, SEG_LEN = 145, 2.35, 0.01, 36
# The runs take the whole circuit, four segments.
SEG_RUN_FRAMES = 1 + 4 * SEG_LEN
# 8c: one segment of phase 4's frames traced whole: keyframes at 31 (the
# second: insertion alone) and 62 (the third: local mapping).
SCAN_TRACE_FRAMES = range(28, 28 + SEG_LEN)
# Each real correction of run 1 is applied again to a CPU copy of the
# state it met, through the same code: the frames tracked before it (up to
# the end of its segment) must then resolve to the same ATE within
# SEG_EFFECT_TOL, a bound on global BA's own card-vs-CPU spread (phase 7b
# measured up to 2.2e-3 in single poses on a sensitive map; an ATE over a
# hundred frames moves less). On the CPU, `scan_reference_jax.py` holds
# the port's `_correct` to JAX's on JAX's own states at this width: poses
# within 4.8e-5, points within 1.1e-4, the same ATE within 3.2e-6 m. What
# a correction does to that ATE, and run 1's resolved ATE against the
# plain run's, are logged, not gated: both follow the state the run met,
# which parts chaotically from any other run's: run 1 on the CPU ended at
# 0.0261 or 0.0594 m by torch's thread count alone, and the same D = 0
# correction moved its frames' ATE by -4.5 mm in JAX's run and by +5.9 mm
# in a card run.
SEG_ATE_GATE, SEG_EFFECT_TOL = 0.15, 2e-3
SEG_MIN_EVENTS, SEG_MIN_CORRECTIONS = 2, 1
SEG_DISAGREE = ([0.3, 0.0, 0.0], [-0.3, 0.0, 0.2])

# Phase 9. 9a/9d: `bench.py`'s walker scene (its N_FRAMES = 337 poses and
# walkers, so the motion per frame is the bench's), cut to a prefix of
# WALK_FRAMES = 1 + 2 x WALK_SEG_LEN frames to fit the script's time limit;
# 9a's render limits are `tests/test_torch_device_render.py`'s. 9b: the
# CPU parity test's 0.5% of pixels for both masks. 9c:
# `tests/test_accuracy_gates.py::dynamic_runs` (20 frames, a keyframe at
# least every 4) and its gates; 9d: `bench.py`'s ATE gate.
WALK_SEQ_FRAMES, WALK_FRAMES, WALK_SEG_LEN, WALK_NOISE = 337, 97, 48, 0.01
RENDER_CHECK_FRAMES = (0, 60)
RENDER_DEPTH_MIN, RENDER_GRAY_MIN = 0.999, 0.99
MASK_PAIRS = ((1, 2), (60, 61))
MASK_PIXEL_TOL = 0.005
DYN_FRAMES, DYN_KF_GAP = 20, 4
DYN_PROFILE_FRAMES = range(12, 14)
WALK_ATE_GATE = 0.15
# 9b's limits for `sym_eig` against `torch.linalg.eigh`: eigenvalues within
# SYM_EIG_TOL of the matrix's Frobenius norm; an eigenvector whose
# eigenvalue lies more than SYM_EIG_GAP of the largest magnitude from the
# others within 1 - |v . v_ref| <= SYM_EIG_VEC_TOL; where the null vector
# is so separated, `_dlt`'s homography within SYM_EIG_H_TOL of the plain
# version's, relative to its largest entry.
SYM_EIG_TOL, SYM_EIG_GAP, SYM_EIG_VEC_TOL, SYM_EIG_H_TOL = 1e-5, 1e-3, 1e-4, 1e-4
# The first design's launch-to-end ms (a warp a matrix in shared memory,
# four passes a round), read by this script on an NVIDIA H100 80GB HBM3 at
# 700.00 W (PERF.md section 6). Logged beside this run's; not part of the
# `kernels` line.
SYM_EIG_PREV_MS = {"minimal_sets": 0.1169, "refit": 0.0976}
# 9e: one segment of SEG_LEN frames of 9a's walker scene with both masks,
# after frames 1-12 from `init_scan` (every graph captured there).
MASK_TRACE_FRAMES = range(13, 13 + SEG_LEN)
# 9d's frames/s with the eager masks, for the log: the parent tree's 9d
# (`run_masked_segmented` after 9a, in a process of its own, run before
# and after this tree's in one call; H100 80GB HBM3, 700.00 W). In this
# script 9d runs after 9b in a warmer process, so only the masked runs'
# ratios to the unmasked one compare.
WALK_FPS_BEFORE = {"unmasked": [7.25, 7.53], "flow": [13.53, 13.11], "geom": [19.15, 22.02]}
# Phase 10 (semantics). The scene: the default orbit's room and seed,
# with `bench.py`'s SEM_FLAT_BOXES gray levels of classes 2, 1 and 3 on
# three boxes of this room that the orbit sees (the bench's indices name
# boxes of the loop room). Box 2 stays textured: flat as well, it took
# the tracked ATE over 48 frames from 1.7 to 8.5 mm in a CPU rehearsal.
# 10a: the card's f32 forward against the CPU's within 1e-3 of each
# output's largest magnitude; the bf16 batch against the card's f32
# within 0.05 of it (bf16 keeps 8 bits over ~70 layers: the CPU measured
# 0.015 and 0.018 on the seeded weights; the CPU test of the trained
# detections holds 3 px and 0.05 in score). 10b: the decode on the same
# raw outputs, boxes within 1e-3 px and scores within 1e-6. 10c: the
# planted boxes' detections at SEM_VIEWS, databases within 1e-4 m of the
# CPU's; every box seen within 0.10 m of a depth-window object, and within
# `tests/test_semantic.py`'s 0.4 m of a MergeSG object: MergeSG removes a
# box's front face with the planes (the face alone fills a plane bin), and
# the clusters left beside it lay boxes 0 and 1 0.23 and 0.28 m away in
# the port's CPU rehearsal at 640x480 (the port equals JAX's MergeSG on
# the CPU). 10d: 48 frames, phase 4's ATE gate, the database within
# 1e-4 m of the CPU's replay.
SEM_FRAMES, SEM_ROOM, SEM_SEED = 48, (5.0, 3.0, 6.0), 17
SEM_FLAT_BOXES = {0: 161.5, 1: 93.5, 4: 229.5}
SEM_VIEWS = (0, 12, 24, 36, 47)
SEM_SEEN_FRACTION, SEM_SEEN_PX = 0.25, 40
SEM_BATCH, SEM_TIMED_CALLS = 8, 20
SEM_NET_TOL, SEM_BF16_TOL = 1e-3, 0.05
SEM_BOX_TOL, SEM_SCORE_TOL = 1e-3, 1e-6
SEM_CENTROID_TOL, SEM_ATE_GATE = 1e-4, 0.01
SEM_GT_TOL = {"depth_window": 0.10, "merge_sg": 0.4}
# Phase 11 (the dense map, persistence, stereo, monocular) on phase 10's
# frames. 11a: one keyframe (view DENSE_VIEW, in camera 0's frame) card
# against CPU: clouds within DENSE_CLOUD_TOL, and maps inserted from the
# same cloud with at most DENSE_FLIP_SHARE of the touched voxels differing
# (the CPU tests' rule against JAX; the CPU measured none), colors within
# DENSE_COLOR_TOL. 11b: a keyframe at least every DENSE_KF_GAP frames
# (`tests/test_system.py`); the occupied centres, taken to the world frame
# by frame 0's true pose, must lie within DENSE_SURFACE_TOL of a wall or a
# box face (the voxel half-diagonal is 0.043 m) for DENSE_SURFACE_SHARE of
# them; the last DENSE_LOC_FRAMES frames localize on a saved map. 11c: the
# batched consumer at 0.1 m on `tests/test_semantic.py`'s grid, with that
# test's rules. 11d: STEREO_FRAMES pairs; the CPU rehearsal of 11d on
# CPU-rendered frames (`run_stereo` on `torch.device("cpu")`, 640x480)
# gave an ATE of STEREO_CPU_ATE (0.0024569 m, 24 frames all OK). 11e:
# MONO_FRAMES gray frames.
DENSE_VIEW, DENSE_KF_GAP, DENSE_LOC_FRAMES = 24, 4, 8
DENSE_CLOUD_TOL, DENSE_FLIP_SHARE, DENSE_COLOR_TOL = 1e-5, 1e-4, 1e-5
DENSE_SURFACE_TOL, DENSE_SURFACE_SHARE, DENSE_MIN_OCCUPIED = 0.075, 0.90, 500
OCTO_TOL = 1e-5
CONSUME_GRID = dict(grid_extent=(10.0, 6.0, 10.0), grid_origin=(-2.0, -3.0, -2.0),
                    grid_resolution=0.1)
CONSUME_BENCH_EXTENT, CONSUME_BENCH_ORIGIN = (16.0, 4.0, 16.0), (-2.0, 0.0, -2.0)
CONSUME_CENTROID_TOL, CONSUME_VOXEL_SHARE = 0.10, 0.02
STEREO_FRAMES, STEREO_ATE_FACTOR = 24, 2.0
STEREO_CPU_ATE = 0.0024569
MONO_FRAMES = 24
# Phase 12 (training, the apps, profiling). 12a: one step of the seeded
# 4-class SSDLite on a batch of 2, card against CPU: the loss within
# TRAIN_LOSS_TOL relative, each gradient within TRAIN_GRAD_TOL of its norm
# (`tests/test_torch_train.py`'s limits against JAX). 12b: the training
# app, TRAIN_STEPS steps of TRAIN_BATCH (22-27 s on the card), the
# last chunk's mean loss under TRAIN_DROP of the first's
# (`tests/test_ssd_train.py`'s rule). 12c: `detect_locate` on
# LOCATE_VIEWS of phase 10, card against CPU within LOCATE_TOL (phase
# 10c's database limit); `cloud_to_occupancy` on 11a's cloud (76,800
# points at 640x480: 5 chunks); `run_synthetic` on phase 4's first
# APP_FRAMES frames;
# `train_vocabulary` on VOCAB_FRAMES of phase 4. 12d: a trace of
# TRACE_FRAMES tracked frames.
TRAIN_CLASSES, TRAIN_STEPS, TRAIN_BATCH, TRAIN_DROP = 4, 200, 16, 0.6
TRAIN_LOSS_TOL, TRAIN_GRAD_TOL = 1e-5, 1e-4
LOCATE_VIEWS, LOCATE_TOL = (0, 12, 24, 36), 1e-4
APP_FRAMES = 24
VOCAB_FRAMES, VOCAB_K, VOCAB_DEPTH = tuple(range(0, 96, 12)), 10, 3
TRACE_FRAMES = range(1, 5)
# Phase 13 (the live app and the rest). 13a: `register_depth_to_color` on
# phase 10's view REG_VIEW through a REG_BASELINE m baseline with a
# REG_YAW_DEG yaw, card against CPU: the same pixels filled on at least
# REG_MATCH of them and depths within REG_TOL where both have one
# (`tests/test_register.py`'s identity limit), the identity within REG_TOL
# of the input, and a REG_PATCH px square at 1 m before a 3 m wall kept
# whole (at least REG_NEAR_SHARE of its pixels nearest). 13b:
# `undistort_image` on that view, gray and RGB, with
# `tests/test_register.py`'s k1, card against CPU within UND_TOL gray
# levels; zero coefficients give the input within UND_TOL (that test's).
# 13c: `live_rgbd.run` on phase 4's first LIVE_FRAMES frames with
# undistortion and an identity registration at phase 4's intrinsics;
# `live_rgbd.main` on LIVE_SYNTHETIC_FRAMES synthetic frames; the
# `watch:` source over LIVE_WATCH_FRAMES of 12c's TUM PNGs with a
# LIVE_IDLE_S idle timeout; every frame OK and phase 4's ATE gate in each.
# 13d: `tests/test_loop_reloc.py`'s scale-drift Sim(3) graph (SIM3_F
# keyframes, SIM3_ITERS iterations), JAX's gate against ground truth and
# SIM3_CPU_TOL against a CPU run.
REG_VIEW, REG_BASELINE, REG_YAW_DEG = DENSE_VIEW, 0.025, 1.0
REG_TOL, REG_MATCH, REG_PATCH, REG_NEAR_SHARE = 1e-5, 0.9999, 40, 0.95
UND_K1, UND_TOL = -0.2, 1e-3
# Cut to fit the script's time (the whole script took 1039 s on a host
# where the main path took 256 ms a frame): the synthetic source renders
# its views on the host, ~2.3 s each, so it tracks 2 frames (8 took 44 s
# for all of 13c), and the watch run 8.
LIVE_FRAMES, LIVE_SYNTHETIC_FRAMES, LIVE_WATCH_FRAMES, LIVE_IDLE_S = 24, 2, 8, 1.5
LIVE_PROFILE_FRAMES = range(12, 14)
SIM3_F, SIM3_ITERS, SIM3_GT_TOL, SIM3_CPU_TOL = 10, 30, 1e-3, 1e-5
# Phase 14 (the multi-device code; `tests/test_mesh_engine.py`'s gates).
# 14a: `SlamSystem(mesh=...)` on a 1-rank NCCL group, the dense grid
# bounded (`dense.unbounded` off), loop closing on the named vocabulary,
# on phase 10's first MESH_FRAMES frames, against the same system without
# a mesh: every frame OK, positions within MESH_POS_TOL, log-odds
# differing on at most MESH_VOXEL_SHARE of the touched voxels, colors
# agreeing on MESH_COLOR_SHARE. 14b: `global_ba_step_state_sharded` on
# phase 7's closure map against `global_ba_step_state`, MESH_GBA_TOL m.
# 14c: the sharded L1 scores and `make_sharded_detect` against the
# single-device scorer and `detect_candidates`, MESH_SCORE_TOL, ids equal.
# 14d: the keyframe-sharded `flush_detections` on phase 10's
# MESH_DETECT_VIEWS (score gates 0) against the single-device flush: the
# same count, centroids within MESH_CENTROID_TOL. 14e: two spawned ranks
# on the one card over gloo (NCCL takes one rank a card): the sharded GBA
# at MESH_TWO_RANK_GBA_ITERS iterations against 14b's one-rank run at as
# many, and MESH_SCANS scans of MESH_SCAN_POINTS rays into a
# MESH_GRID_DIMS grid at 0.1 m in two X slabs against `insert_scan`
# (`tests/test_parallel.py`'s 1e-5). Cut to fit the script's time: gloo
# stages every CUDA all-reduce through the host, and the full 10
# iterations took 16.9 s at two ranks (the whole script 1044 s).
MESH_FRAMES, MESH_POS_TOL, MESH_VOXEL_SHARE, MESH_COLOR_SHARE = 24, 5e-3, 0.005, 0.99
MESH_GBA_TOL, MESH_SCORE_TOL, MESH_CENTROID_TOL = 1e-3, 1e-5, 0.05
MESH_DETECT_VIEWS = (0, 12, 24, 36)
MESH_RANKS, MESH_SCANS, MESH_SCAN_POINTS, MESH_GRID_DIMS = 2, 3, 256, (64, 32, 32)
MESH_OCC_TOL = 1e-5
MESH_TWO_RANK_GBA_ITERS = 2


def _log(msg: str) -> None:
    print(msg, flush=True)


def _time_ms(fn, reps: int = 20, rounds: int = 5) -> float:
    """Median over `rounds` of the mean CUDA-event time of `reps` calls."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        out.append(start.elapsed_time(end) / reps)
    return statistics.median(out)


def _graph_ms(fn, reps: int = 20, rounds: int = 5) -> float:
    """Time on the device of everything one call of `fn` puts there: `reps`
    calls are captured into one CUDA graph and the graph replayed, so the
    host's launch rate, which sets `_time_ms` for kernels this short, is
    out of the reading. Median over `rounds` replays, per call."""
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    return _time_ms(graph.replay, reps=1, rounds=rounds) / reps


def _host_ms(fn, reps: int = 50, rounds: int = 7) -> float:
    """What one call of `fn` costs the host: `perf_counter` around `reps`
    calls that nothing waits on, median over `rounds` of the mean. The
    device is drained before each round, so that the stream's queue never
    fills and makes the host wait."""
    for _ in range(3):
        fn()
    out = []
    for _ in range(rounds):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        out.append((time.perf_counter() - t0) * 1e3 / reps)
    torch.cuda.synchronize()
    return statistics.median(out)


def _bound_ms(n_bytes: float, n_ops: float):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / CUDA_CORE_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _reset_counts() -> None:
    cuda_match.window_match.launches = 0
    cuda_solve.spd_solve.launches = 0
    cuda_eigh.eigh_small.launches = 0
    cuda_build.captured.clear()
    cuda_build.conditional.clear()
    _REPLAYED.update(dict.fromkeys(_REPLAYED, 0))
    # A dead graph runs no body again; a live one counts from 0.
    _BODIES[:] = [b for b in _BODIES if b[0]() is not None]
    for *_, runs in _BODIES:
        runs.zero_()


def _counts() -> dict:
    return {"window_match": cuda_match.window_match.launches,
            "spd_solve": cuda_solve.spd_solve.launches,
            "sym_eig": cuda_eigh.eigh_small.launches}


def _captured_counts() -> dict:
    """The wrappers' launches into a CUDA graph being captured since the
    last `_reset_counts`, those into its conditional bodies included."""
    return {k: cuda_build.captured.get(k, 0) + cuda_build.conditional.get(k, 0)
            for k in _REPLAYED}


# B1's, B2's and `sym_eig`'s kernels by the names the card's trace gives
# them; a call of B1's wrapper launches the first two.
_TRACED_KERNELS = {"window_match": "window_match_partial_kernel",
                   "window_match_merge": "window_match_merge_kernel",
                   "spd_solve": "spd_solve_kernel",
                   "sym_eig": "sym_eig_kernel"}


def _traced_launches(prof) -> dict:
    """How many times B1's two kernels, B2's and `sym_eig`'s ran on the card
    in a profile, counted from its device events (a graph's replay
    included, which calls no wrapper)."""
    out = dict.fromkeys(_TRACED_KERNELS, 0)
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            for key, name in _TRACED_KERNELS.items():
                if name in e.name():
                    out[key] += 1
    return out


def _check_traced(label: str, traced: dict, want: dict) -> None:
    """Raise unless the trace ran B1's two kernels `want["window_match"]`
    times each, B2's `want["spd_solve"]` times and `sym_eig`'s
    `want["sym_eig"]` (0 when not given)."""
    expected = dict(window_match=want["window_match"], window_match_merge=want["window_match"],
                    spd_solve=want["spd_solve"], sym_eig=want.get("sym_eig", 0))
    if traced != expected:
        raise AssertionError(f"{label}: the card ran {traced} of B1's, B2's and sym_eig's "
                             f"kernels, {expected} expected")


# B1's and B2's launches that replays of CUDA graphs ran on the card since
# the last `_reset_counts`: a replay runs the launches its graph's capture
# recorded and calls no wrapper, so the wrapper counters do not see them.
_REPLAYED = {"window_match": 0, "spd_solve": 0, "sym_eig": 0}


def _count_replays() -> None:
    """Make every `GraphedStep` (`mapping/graphed_step.py`: the tracking and
    local-mapping graphs of every tracker, scan and segmented run) add its
    captured launches to `_REPLAYED` at each replay, the capture's own
    upload replay included, and register the counters of its conditional
    bodies, whose launches run only where their predicate holds
    (`_body_runs`). Phases 4, 4b and 8a hold these counts to the card's
    trace."""
    def tallied(method):
        def run(self, *args, **kwargs):
            before = getattr(self, "replays", 0)
            out = method(self, *args, **kwargs)
            for k in _REPLAYED:
                _REPLAYED[k] += self.captured.get(k, 0) * (self.replays - before)
            return out
        return run

    def registered(init):
        def make(self, *args, **kwargs):
            init(self, *args, **kwargs)
            if self.bodies:
                _BODIES.append((weakref.ref(self), self.name, self.bodies, self.body_runs))
        return make

    GraphedStep.__init__ = registered(tallied(GraphedStep.__init__))
    GraphedStep.__call__ = tallied(GraphedStep.__call__)


# The conditional bodies of the graphs captured since `_count_replays`:
# (the graph, weakly; its name; its bodies' records; their run counter on
# the card, which outlives the graph until the next `_reset_counts`).
_BODIES: list = []


def _body_runs() -> list:
    """[(graph name, body record, runs since the last `_reset_counts`)] of
    every registered graph's conditional bodies: a read of the card's
    counters (call it outside a profiled window)."""
    if not _BODIES:
        return []
    runs = torch.cat([r for *_, r in _BODIES]).tolist()
    out, i = [], 0
    for _, name, bodies, r in _BODIES:
        out += [(name, body, n) for body, n in zip(bodies, runs[i:i + len(bodies)])]
        i += r.numel()
    return out


def _body_kind(body: dict) -> str:
    """"<cond's name>_<taken on>" for a body of a named `device_cond` (the
    tracking step's "retry_True": the doubled window matched;
    "fallback_False": the reference-keyframe fallback ran), else
    "d<depth>_<taken on>" (the keyframe branch's "d0_True": the outer
    branch taken, "d1_True": the nested one)."""
    return f"{body['name'] or 'd' + str(body['depth'])}_{body['taken_on']}"


def _body_totals(graph: str = "KeyframeBranchRunner") -> dict:
    """Runs of the bodies of the registered graphs named `graph` since the
    last `_reset_counts`, summed by `_body_kind`."""
    out = {}
    for name, body, n in _body_runs():
        if name == graph:
            key = _body_kind(body)
            out[key] = out.get(key, 0) + n
    return out


def _track_branches(kinds: dict) -> dict:
    """The tracking step's bodies from their runs by `_body_kind`: the
    replays that reached its conds (each runs one of the retry's two
    bodies), the doubled-window retries and the reference-keyframe
    fallbacks."""
    return dict(replays=kinds.get("retry_True", 0) + kinds.get("retry_False", 0),
                retry=kinds.get("retry_True", 0), fallback=kinds.get("fallback_False", 0))


def _tally() -> dict:
    """B1's and B2's counts since the last `_reset_counts`: the wrappers'
    calls, the launches those calls made into graphs being captured, the
    launches that graph replays ran outside conditional bodies, and those
    that the bodies' runs ran; and the tracking graphs' branch runs
    (`_track_branches`)."""
    bodies = dict.fromkeys(_REPLAYED, 0)
    for _, body, n in _body_runs():
        for k, c in body["kernels"].items():
            bodies[k] += c * n
    return dict(wrapper=_counts(), captured=_captured_counts(), replayed=dict(_REPLAYED),
                bodies=bodies, track=_track_branches(_body_totals("TrackStepRunner")))


def _since(before: dict) -> dict:
    """`_tally()` less `before` (an earlier `_tally()`)."""
    return {part: {k: n - before[part][k] for k, n in counts.items()}
            for part, counts in _tally().items()}


def _kernel_runs(tally: dict | None = None) -> dict:
    """B1's and B2's launches on the card in `tally` (by default all since
    the last `_reset_counts`): the wrappers' calls outside a capture (a
    capture records its launches and runs none) and the replays' runs,
    in conditional bodies included."""
    t = tally or _tally()
    return {k: t["wrapper"][k] - t["captured"][k] + t["replayed"][k] + t["bodies"][k]
            for k in t["wrapper"]}


def _path_launches(label: str, dev) -> dict:
    """A phase's launches since the last `_reset_counts`: B1's and B2's
    runs on the card (`launches`), the wrappers' calls and the replays'
    runs, and the tracking graphs' branch runs; on the card, raises unless
    B1 ran in a graph's replay (every tracked frame replays the tracking
    step's graph)."""
    t = _tally()
    if dev.type == "cuda" and t["replayed"]["window_match"] == 0:
        raise AssertionError(f"{label} never ran the window matcher in a graph's replay: {t}")
    return dict(launches=_kernel_runs(t), launches_wrapper_calls=t["wrapper"],
                launches_replayed=t["replayed"], launches_in_bodies=t["bodies"],
                track_branches=t["track"])


# ---- phase 1 ---------------------------------------------------------------

def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def build_kernels() -> float:
    """The port's kernels and this script's empty one, one nvcc each."""
    cuda_build.register("launch_floor", Path(__file__).resolve().parent / "launch_floor.cu",
                        [ctypes.c_void_p])
    t0 = time.perf_counter()
    logs = cuda_build.build_all(force=True, extra=("launch_floor",))
    secs = time.perf_counter() - t0
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                _log(f"  ptxas[{name}]: {line.strip()}")
    _log(f"build: {len(logs)} kernels in {secs:.2f} s")
    return secs


def launch_floor_ms() -> float:
    """Back-to-back launches of an empty kernel through the same ctypes
    route as the port's kernels: no kernel's time can lie below this."""
    stream = torch.cuda.current_stream().cuda_stream
    prepared = cuda_build.Prepared("launch_floor", (stream,), ())
    ms = _time_ms(lambda: cuda_build.launch(prepared))
    _log(f"launch floor: an empty kernel takes {ms:.5f} ms a launch")
    return ms


# ---- phase 2: B1 -------------------------------------------------------------

def _b1_problem(seed: int, q: int, t: int, dev):
    """Targets are noisy copies of the queries' descriptors near their
    predicted positions, so windowed matches, ties and duplicate claims
    all occur, as on a tracked frame."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 2**32, (t, 8), dtype=np.uint32)
    uv_t = rng.uniform(0, 640, (t, 2)).astype(np.float32)
    src = rng.integers(0, t, q)
    flips = (rng.random((q, 8, 32)) < 0.08) * (1 << np.arange(32, dtype=np.uint64))
    desc_q = base[src] ^ flips.sum(-1).astype(np.uint32)
    arrays = dict(
        desc_q=desc_q.view(np.int32), desc_t=base.view(np.int32),
        centers=(uv_t[src] + rng.normal(0, 3, (q, 2))).astype(np.float32), uv_t=uv_t,
        radius=rng.uniform(5, 60, (q,)).astype(np.float32),
        valid_q=rng.random(q) > 0.1, valid_t=rng.random(t) > 0.1,
    )
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev) for k, v in arrays.items()}


def _b1_tie_problem(seed: int, q: int, t: int, dev):
    """A few descriptors and spots repeated over all targets: every query
    finds many targets at the same distance inside its window, in every
    split, so equal values meet in the walk and in the merge."""
    rng = np.random.default_rng(seed)
    proto = rng.integers(0, 2**32, (8, 8), dtype=np.uint32)
    spots = rng.uniform(100, 500, (8, 2)).astype(np.float32)
    kind_t, kind_q = rng.integers(0, 8, t), rng.integers(0, 8, q)
    desc_q = proto[kind_q].copy()
    desc_q[::2, 0] ^= np.uint32(1)
    arrays = dict(
        desc_q=desc_q.view(np.int32), desc_t=proto[kind_t].view(np.int32),
        centers=spots[kind_q], uv_t=(spots[kind_t] + rng.uniform(-2, 2, (t, 2))).astype(np.float32),
        radius=np.full((q,), 4.0, np.float32),
        valid_q=rng.random(q) > 0.1, valid_t=rng.random(t) > 0.3,
    )
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev) for k, v in arrays.items()}


def _b1_compare(p: dict, max_dist: int, label: str):
    """Kernel against plain version: all four outputs equal (tolerance 0).
    Returns the kernel's outputs and the largest difference found."""
    got = cuda_match.window_match(**p, max_dist=max_dist)
    ref = cuda_match.window_match_reference(**p, max_dist=max_dist)
    torch.cuda.synchronize()
    err = 0
    for name, a, b in zip(("best", "second", "idx", "key_min"), got, ref):
        err = max(err, int((a.to(torch.int64) - b.to(torch.int64)).abs().max()))
        if not torch.equal(a, b.to(torch.int32)):
            raise AssertionError(f"B1 {name} differs, {label}: {int((a != b).sum())} entries")
    return got, err


def check_b1(dev) -> dict:
    rows = []
    for i, (q, t) in enumerate(B1_SHAPES):
        max_dist = 100 if q >= 1024 else 50
        p = _b1_problem(100 + i, q, t, dev)
        got, err = _b1_compare(p, max_dist, f"Q={q} T={t}")
        n_claimed = int((got[3] < cuda_match.BIG_KEY).sum())
        if n_claimed == 0:
            raise AssertionError(f"B1 check at Q={q} T={t} claimed no target")
        if i == 0:  # a second run gives the same bits: the claims' atomics are order-free
            again = cuda_match.window_match(**p, max_dist=max_dist)
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                raise AssertionError("B1 gave two different results on the same input")
        split_len, n_splits = cuda_match.tiles(q, t)
        grid = [-(-q // cuda_match.Q_TILE), n_splits]
        # The kernels alone: the launch on buffers the wrapper's checks and
        # allocations prepared once.
        prepared, _ = cuda_match.prepare(**p, max_dist=max_dist)
        ms = _time_ms(lambda: cuda_match.launch(prepared))
        wrapper_ms = _time_ms(lambda: cuda_match.window_match(**p, max_dist=max_dist))
        device_ms = _graph_ms(lambda: cuda_match.window_match(**p, max_dist=max_dist))
        host_prepare_ms = _host_ms(lambda: cuda_match.prepare(**p, max_dist=max_dist))
        host_launch_ms = _host_ms(lambda: cuda_match.launch(prepared))
        plain_ms = _time_ms(lambda: cuda_match.window_match_reference(**p, max_dist=max_dist),
                            reps=5)
        # Work this data needs: every pair takes the window and validity
        # test and a top-2 update (~8 ops); only in-window pairs take the
        # 8 XOR + 8 popcount + 8 add of the Hamming distance.
        in_win = int(window_mask(p["centers"], p["uv_t"], p["radius"], p["valid_q"],
                                 p["valid_t"]).sum())
        n_ops = 8.0 * q * t + 24.0 * in_win
        n_bytes = q * (32 + 8 + 4 + 1) + t * (32 + 8 + 1) + q * 12 + t * 4
        bound, by = _bound_ms(n_bytes, n_ops)
        row = dict(q=q, t=t, max_abs_err=err, claimed=n_claimed, in_window_pairs=in_win,
                   ms=ms, wrapper_ms=wrapper_ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                   device_ms=device_ms, host_prepare_ms=host_prepare_ms,
                   host_launch_ms=host_launch_ms, grid=grid, split_len=split_len)
        _log(f"B1 window_match Q={q} T={t}: exact (tolerance 0), {n_claimed} targets claimed; "
             f"grid {grid[0]} x {grid[1]} = {grid[0] * grid[1]} blocks of {cuda_match.Q_TILE} "
             f"queries x {split_len} targets; launch to end {ms:.4f} ms (before the redesign: "
             f"{B1_PREV_MS.get((q, t))}), the wrapper's work on the device {device_ms:.4f} ms, "
             f"wrapper {wrapper_ms:.4f} ms, of the host's time {host_prepare_ms:.4f} ms in "
             f"prepare and {host_launch_ms:.4f} ms in launch, plain {plain_ms:.4f} ms, bound {bound:.6f} ms ({by})")
        rows.append(row)
    if rows[0]["grid"][0] * rows[0]["grid"][1] < 64:
        raise AssertionError(f"B1 grid at {B1_SHAPES[0]} has under 64 blocks: {rows[0]['grid']}")

    q, t = B1_SHAPES[0]
    p = _b1_tie_problem(7, q, t, dev)
    (best, second, _, key_min), err_ties = _b1_compare(p, 100, "tie-heavy case")
    n_tied = int(((best == second) & (best < cuda_match.BIG)).sum())
    if n_tied < q // 2 or int((key_min < cuda_match.BIG_KEY).sum()) == 0:
        raise AssertionError(f"B1 tie-heavy case is vacuous: {n_tied} tied queries")
    p = _b1_problem(200, q, t, dev)
    none_t = p | {"valid_t": torch.zeros_like(p["valid_t"])}
    (best, second, idx, key_min), err_none = _b1_compare(none_t, 100, "all targets masked")
    if not (bool((best == cuda_match.BIG).all()) and bool((second == cuda_match.BIG).all())
            and bool((idx == 0).all()) and bool((key_min == cuda_match.BIG_KEY).all())):
        raise AssertionError("B1 with all targets masked: expected best = second = BIG, idx = 0")
    some_q = p["valid_q"].clone()
    some_q[::5] = False
    (best, *_), err_some = _b1_compare(p | {"valid_q": some_q}, 100, "every fifth query masked")
    if not bool((best[::5] == cuda_match.BIG).all()):
        raise AssertionError("B1 matched a masked query")
    err_radius = max(
        _b1_compare(p | {"radius": 25.0}, 100, "scalar radius (a Python float)")[1],
        _b1_compare(p | {"radius": torch.tensor(25.0, device=dev)}, 100, "scalar radius (0-d)")[1],
        _b1_compare(p | {"radius": p["radius"].repeat_interleave(2)[::2]}, 100,
                    "strided radius")[1])
    _log(f"B1 window_match cases at Q={q} T={t}: tie-heavy ({n_tied} queries with best == "
         f"second), all targets masked, every fifth query masked, scalar and strided radius: "
         f"all exact; a second run of the first problem gave the same bits")
    loop_rows = []
    for j, (q, t, r) in enumerate(B1_LOOP_SHAPES + (B1_INIT_SHAPE,)):
        p = _b1_problem(300 + j, q, t, dev) | {"radius": torch.full((q,), r, device=dev)}
        got, err = _b1_compare(p, 50, f"shape Q={q} T={t} r={r}")
        n_claimed = int((got[3] < cuda_match.BIG_KEY).sum())
        if n_claimed == 0:
            raise AssertionError(f"B1 shape Q={q} T={t} r={r} claimed no target")
        prepared, _ = cuda_match.prepare(**p, max_dist=50)
        ms = _time_ms(lambda: cuda_match.launch(prepared))
        device_ms = _graph_ms(lambda: cuda_match.window_match(**p, max_dist=50))
        plain_ms = _time_ms(lambda: cuda_match.window_match_reference(**p, max_dist=50), reps=5)
        in_win = int(window_mask(p["centers"], p["uv_t"], p["radius"], p["valid_q"],
                                 p["valid_t"]).sum())
        bound, by = _bound_ms(q * (32 + 8 + 4 + 1) + t * (32 + 8 + 1) + q * 12 + t * 4,
                              8.0 * q * t + 24.0 * in_win)
        loop_rows.append(dict(q=q, t=t, radius=r, max_abs_err=err, claimed=n_claimed, ms=ms,
                              device_ms=device_ms, plain_ms=plain_ms, bound_ms=bound,
                              bound_by=by))
        kind = "initializer" if (q, t, r) == B1_INIT_SHAPE else "loop"
        _log(f"B1 window_match {kind} shape Q={q} T={t} r={r}: exact (tolerance 0), {n_claimed} "
             f"targets claimed; launch to end {ms:.4f} ms, on the device {device_ms:.4f} ms, "
             f"plain {plain_ms:.4f} ms, bound {bound:.6f} ms ({by})")
    return rows[0] | {"max_abs_err": max(err_ties, err_none, err_some, err_radius,
                                         *(r["max_abs_err"] for r in rows + loop_rows)),
                      "loop_shapes": loop_rows[:-1], "init_shape": loop_rows[-1]}


# ---- phase 3: B2 -------------------------------------------------------------

def _spd(rng, n: int, damp: float = 1e-3) -> np.ndarray:
    a = rng.normal(0, 1, (n, n)).astype(np.float32)
    a = a @ a.T
    return a + np.diag(1e-3 * np.abs(np.diag(a)) + damp)


def check_b2(dev) -> dict:
    rng = np.random.default_rng(0)
    main = None
    for n in B2_SIZES:
        a_np = _spd(rng, n)
        b_np = rng.normal(0, 1, (n,)).astype(np.float32)
        a, b = torch.from_numpy(a_np).to(dev), torch.from_numpy(b_np).to(dev)
        x = cuda_solve.spd_solve(a, b)
        x_plain = cuda_solve.spd_solve_reference(a, b)
        torch.cuda.synchronize()
        xk = x.cpu().numpy()
        ref64 = np.linalg.solve(a_np.astype(np.float64), b_np.astype(np.float64))
        resid = np.linalg.norm(a_np @ xk - b_np) / max(np.linalg.norm(b_np), 1e-9)
        if resid >= SPD_RESID:
            raise AssertionError(f"B2 n={n}: residual {resid:.3e} >= {SPD_RESID}")
        np.testing.assert_allclose(xk, ref64, rtol=SPD_RTOL, atol=SPD_ATOL)
        np.testing.assert_allclose(xk, x_plain.cpu().numpy(), rtol=SPD_RTOL, atol=SPD_ATOL)
        err = float((x - x_plain).abs().max())
        prepared, _ = cuda_solve.prepare(a, b)
        ms = _time_ms(lambda: cuda_solve.launch(prepared))
        wrapper_ms = _time_ms(lambda: cuda_solve.spd_solve(a, b))
        device_ms = _graph_ms(lambda: cuda_solve.spd_solve(a, b))
        host_prepare_ms = _host_ms(lambda: cuda_solve.prepare(a, b))
        host_launch_ms = _host_ms(lambda: cuda_solve.launch(prepared))
        plain_ms = _time_ms(lambda: cuda_solve.spd_solve_reference(a, b))
        library_ms = _time_ms(lambda: torch.linalg.solve(a, b))
        # What an SPD system of n unknowns needs, whatever the kernel does:
        # a Cholesky factorisation, n^3 / 3 flops, and two triangular
        # solves, 2 n^2; one triangle of the symmetric A and b read once, x
        # written once.
        bound, by = _bound_ms(4.0 * (n * (n + 1) // 2 + 2 * n), n**3 / 3.0 + 2.0 * n * n)
        _log(f"B2 spd_solve n={n}: residual {resid:.2e}, max |kernel - plain| {err:.3e} "
             f"(rtol {SPD_RTOL}, atol {SPD_ATOL}); launch to end {ms:.4f} ms (before the "
             f"redesign: {B2_PREV_MS.get(n)}), the wrapper's work on the device "
             f"{device_ms:.4f} ms, wrapper {wrapper_ms:.4f} ms, of the host's time "
             f"{host_prepare_ms:.4f} ms in prepare and {host_launch_ms:.4f} ms in launch, "
             f"plain {plain_ms:.4f} ms, "
             f"torch.linalg.solve {library_ms:.4f} ms, bound {bound:.6f} ms ({by})")
        if n == B2_MAIN_N:
            main = dict(n=n, max_abs_err=err, ms=ms, device_ms=device_ms, wrapper_ms=wrapper_ms,
                        plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound, bound_by=by,
                        host_prepare_ms=host_prepare_ms, host_launch_ms=host_launch_ms)
            # A read through its row stride (a block of a larger matrix):
            # the same bits as from the contiguous matrix. Through a
            # transposed view, which the wrapper copies, the kernel reads
            # A's upper triangle, equal to the lower only up to rounding.
            big = torch.zeros((n + 5, n + 9), dtype=torch.float32, device=dev)
            big[2:n + 2, 3:n + 3] = a
            block = big[2:n + 2, 3:n + 3]
            if block.is_contiguous() or a.t().is_contiguous():
                raise AssertionError("the views under test are contiguous")
            if not torch.equal(cuda_solve.spd_solve(block, b), x):
                raise AssertionError("B2 through a strided block differs")
            torch.testing.assert_close(cuda_solve.spd_solve(a.t(), b), x, rtol=SPD_RTOL,
                                       atol=SPD_ATOL)
            _log(f"B2 spd_solve n={n}: a strided block gives the same bits, a transposed view "
                 f"agrees (rtol {SPD_RTOL}, atol {SPD_ATOL})")
    # The near-singular damped case of the Pallas kernel's tests.
    n = 108
    u = np.linalg.qr(rng.normal(0, 1, (n, n)))[0].astype(np.float32)
    s = np.geomspace(1e4, 1e-2, n).astype(np.float32)
    a_np = (u * s) @ u.T
    a_np = a_np + np.diag(1e-3 * np.abs(np.diag(a_np)) + 1e-5)
    b_np = rng.normal(0, 1, (n,)).astype(np.float32)
    xk = cuda_solve.spd_solve(torch.from_numpy(a_np).to(dev),
                              torch.from_numpy(b_np).to(dev)).cpu().numpy()
    resid = np.linalg.norm(a_np @ xk - b_np) / np.linalg.norm(b_np)
    if resid >= SPD_RESID_ILL:
        raise AssertionError(f"B2 ill-conditioned: residual {resid:.3e} >= {SPD_RESID_ILL}")
    _log(f"B2 spd_solve ill-conditioned n=108: residual {resid:.2e} (< {SPD_RESID_ILL})")
    return main


# ---- phase 4: the main path ------------------------------------------------------

_SEQ = _LOOP_SEQ = _LOOP_ROOM = _SEG_SEQ = None


def loop_sequence() -> SyntheticSequence:
    """Phase 7c's sequence: the loop circuit with its revisit overshoot and
    2% depth noise."""
    return SyntheticSequence(n_frames=LOOP_SEQ_FRAMES, trajectory="loop", loop_laps=1.35,
                             depth_noise=0.02)


def segmented_sequence(cam: CameraConfig | None = None) -> SyntheticSequence:
    """Phase 8b's sequence: `tests/test_segmented.py`'s multi-lap circuit
    (at 640x480 unless `cam` says otherwise)."""
    return SyntheticSequence(n_frames=SEG_FRAMES, cam=cam or CameraConfig(), trajectory="loop",
                             loop_laps=SEG_LAPS, depth_noise=SEG_NOISE)


def _render_init(n_frames: int, seg_cam: CameraConfig | None = None) -> None:
    global _SEQ, _LOOP_SEQ, _LOOP_ROOM, _SEG_SEQ
    # The pool may render while the main process drives the card (`main`):
    # a lower priority leaves that process its core.
    os.nice(10)
    _SEQ = SyntheticSequence(n_frames=n_frames)
    _LOOP_SEQ = loop_sequence()
    _LOOP_ROOM = BoxRoom(seed=3, cam=CameraConfig())
    _SEG_SEQ = segmented_sequence(seg_cam)
    _dyn9_init(CameraConfig())


def _sequential_render(seq: SyntheticSequence, i: int):
    """Frame i of a noisy sequence, its depth noise drawn as a sequential
    render draws it (one normal per pixel per frame from one generator,
    so frames 0..i-1's draws are skipped)."""
    rng = np.random.default_rng(seq.seed)
    for _ in range(i):
        rng.normal(0.0, seq.depth_noise, (seq.cam.height, seq.cam.width))
    return seq.room.render(seq.poses_wc[i], seq.depth_noise, rng)


def _render(task):
    """A frame of the sequence by index, or a view of its room from a
    camera-to-world pose; ("loop", i): frame i of phase 7c's sequence,
    its depth noise drawn as a sequential render draws it; ("seg", i):
    frame i of phase 8b's sequence, likewise, quantized to uint8 gray and
    uint16 mm depth as the segmented runner's tests feed it; ("room3",
    pose): a view of phase 7a's room; ("dyn", kind, i): frame i of phase
    9c's static or dynamic scene."""
    if isinstance(task, int):
        return _SEQ.gray_depth(task)
    if isinstance(task, tuple) and task[0] == "loop":
        return _sequential_render(_LOOP_SEQ, task[1])
    if isinstance(task, tuple) and task[0] == "seg":
        g, d = _sequential_render(_SEG_SEQ, task[1])
        return np.clip(g, 0, 255).astype(np.uint8), (d * 1000).astype(np.uint16)
    if isinstance(task, tuple) and task[0] == "room3":
        return _LOOP_ROOM.render(task[1])
    if isinstance(task, tuple) and task[0] == "dyn":
        return _dyn9_render(task[1:])
    return _SEQ.room.render(task)


def kidnap_poses(seq: SyntheticSequence) -> list:
    """Phase 6's kidnapped camera: the first KIDNAP_FRAMES poses of the
    sequence rolled by 180 degrees about the optical axis, so inside
    keyframe 0's view but beyond what the motion model or the newest
    keyframe's matches can follow."""
    c, s = np.cos(np.pi), np.sin(np.pi)
    roll = np.eye(4, dtype=np.float32)
    roll[:2, :2] = [[c, -s], [s, c]]
    return [(seq.poses_wc[i] @ roll).astype(np.float32) for i in range(KIDNAP_FRAMES)]


def start_render(n_frames: int, n_loop: int = 0, n_seg: int = 0,
                 seg_cam: CameraConfig | None = None, dyn: bool = False) -> dict:
    """Start rendering the sequence's frames, phase 6's kidnapped views,
    with `n_loop` phase 7's views (the first `n_loop` frames of 7c's
    sequence, 7a's revisit and open-arc keyframes), with `n_seg` the
    first `n_seg` frames of phase 8b's sequence (at `seg_cam`, 640x480 by
    default) and with `dyn` phase 9c's 2 x DYN_FRAMES frames at 640x480, in
    a pool of worker processes (the renderer is single-threaded numpy);
    `finish_render` collects them."""
    seq = SyntheticSequence(n_frames=n_frames)
    poses = kidnap_poses(seq)
    tasks = list(range(n_frames)) + poses
    arcs = None
    if n_loop:
        arcs = {"revisit": closure_poses(True), "open": closure_poses(False)}
        tasks += [("loop", i) for i in range(n_loop)]
        tasks += [("room3", T) for T in arcs["revisit"] + arcs["open"]]
    tasks += [("seg", i) for i in range(n_seg)]
    n_dyn = 2 * DYN_FRAMES if dyn else 0
    tasks += [("dyn", k, i) for k in ("static", "dynamic") for i in range(DYN_FRAMES)][:n_dyn]
    workers = max(1, min(8, os.cpu_count() or 1))
    pool = multiprocessing.get_context("spawn").Pool(
        workers, initializer=_render_init, initargs=(n_frames, seg_cam))
    return dict(pool=pool, result=pool.map_async(_render, tasks), t0=time.perf_counter(),
                seq=seq, poses=poses, arcs=arcs, n_frames=n_frames, n_loop=n_loop,
                n_seg=n_seg, seg_cam=seg_cam, n_dyn=n_dyn)


def finish_render(job: dict):
    """Wait for `start_render`'s views and stop its pool. Returns
    (sequence, frames, [(T_wc, frame)] of the kidnapped views, phase 7's
    views or None, phase 8b's sequence and frames or None, phase 9c's
    {"static": frames, "dynamic": frames} or None)."""
    t_wait = time.perf_counter()
    try:
        out = job["result"].get()
    finally:
        job["pool"].terminate()
        job["pool"].join()
    n_frames, n_loop, n_seg, poses = job["n_frames"], job["n_loop"], job["n_seg"], job["poses"]
    n7 = n_loop + 2 * LOOP_N_KF if n_loop else 0
    n_dyn = job["n_dyn"]
    _log(f"rendered {n_frames} frames, {KIDNAP_FRAMES} kidnapped views, phase 7's {n7} views, "
         f"phase 8b's {n_seg} and phase 9c's {n_dyn} in {time.perf_counter() - job['t0']:.1f} s, "
         f"of which {time.perf_counter() - t_wait:.1f} s were waited for")
    n_kid = n_frames + len(poses)
    loop = seg = None
    k = n_kid
    if n_loop:
        arcs = job["arcs"]
        k = n_kid + n7
        loop = dict(seq=loop_sequence(), frames=out[n_kid:n_kid + n_loop],
                    revisit=(arcs["revisit"], out[n_kid + n_loop:n_kid + n_loop + LOOP_N_KF]),
                    open=(arcs["open"], out[n_kid + n_loop + LOOP_N_KF:k]))
    if n_seg:
        seg = dict(seq=segmented_sequence(job["seg_cam"]), frames=out[k:k + n_seg])
    dyn = None
    if n_dyn:
        k += n_seg
        dyn = {"static": out[k:k + DYN_FRAMES], "dynamic": out[k + DYN_FRAMES:k + n_dyn]}
    return (job["seq"], out[:n_frames], list(zip(poses, out[n_frames:n_kid])), loop, seg,
            dyn)


def render_frames(n_frames: int, n_loop: int = 0, n_seg: int = 0,
                  seg_cam: CameraConfig | None = None):
    """`start_render` and `finish_render` in one call."""
    return finish_render(start_render(n_frames, n_loop, n_seg, seg_cam))


def main_path_config() -> SlamConfig:
    base = SlamConfig()
    return base.replace(loop=dataclasses.replace(base.loop, enabled=False,
                                                 enable_relocalization=False))


# The port's host ranges (`record_function`): the trace also draws each on
# the device's timeline, which is no kernel.
_HOST_RANGES = ("scan.segment", "track", "track.capture", "keyframe.insert", "local_mapping",
                "local_mapping.capture", "mask.flow", "mask.geometry", "mask.capture")


def _device_breakdown(prof, n_frames: int, frame_ms: float) -> dict:
    """Per-frame device busy time and share, kernel launches, CUDA runtime
    calls that copy, synchronise or launch a graph, and the kernels that
    take the most device time, from a profiled window of `n_frames`
    frames. The share is taken against the unprofiled median frame time
    `frame_ms`."""
    busy_us, by_kernel, runtime = 0.0, {}, {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA and e.name not in _HOST_RANGES:
            us = e.time_range.elapsed_us()
            busy_us += us
            k = by_kernel.setdefault(e.name, [0, 0.0])
            k[0] += 1
            k[1] += us
        elif e.name in ("cudaLaunchKernel", "cudaMemcpyAsync", "cudaStreamSynchronize",
                        "cudaDeviceSynchronize", "cudaGraphLaunch"):
            runtime[e.name] = runtime.get(e.name, 0) + 1
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1][1])[:8]
    busy_ms = busy_us / 1e3 / n_frames
    return dict(
        device_busy_ms_per_frame=busy_ms, device_busy_share=busy_ms / frame_ms,
        kernels_per_frame=sum(v[0] for v in by_kernel.values()) / n_frames,
        runtime_calls_per_frame={k: v / n_frames for k, v in runtime.items()},
        top_kernels=[dict(name=name[:80], per_frame=c / n_frames, ms_per_frame=us / 1e3 / n_frames)
                     for name, (c, us) in top])


def run_main_path(dev, n_frames: int = N_FRAMES, n_loop: int = LOOP_SEQ_FRAMES,
                  n_seg: int = SEG_RUN_FRAMES, seg_cam: CameraConfig | None = None,
                  rendered=None) -> dict:
    """Phase 4, on `rendered` (`finish_render`'s result; rendered here
    when None). The result holds the tracker, the poses `process` returned
    and what was rendered (also phase 6's kidnapped views and phases 7 and
    8b's views), and the tracking step's arguments at TRACK_OK_FRAME and
    the frame after PROFILE_KEYFRAME (phase 4b), for phases 4b-8."""
    if rendered is None:
        rendered = render_frames(n_frames, n_loop, n_seg, seg_cam)
    seq, frames, *_ = rendered
    n_frames = len(frames)
    cfg = main_path_config()
    tracker = Tracker(cfg, device=dev)
    card = dev.type == "cuda"
    sync = torch.cuda.synchronize if card else (lambda: None)
    profiled = PROFILE_FRAMES if card else range(0)
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    prof = torch.profiler.profile(activities=activities) if len(profiled) else None
    prof_kf = torch.profiler.profile(activities=activities) if card else None
    frame_ms, poses = [], []
    current = {"frame": 0}
    track_args = {}

    def step_no_wait(runner, state, c):
        # From the dispatch (the graph's replay; its capture, which
        # synchronizes, comes before in a stage of its own) on, any wait on
        # the card raises, until the frame's `process` returns
        # (async_mapping).
        torch.cuda.set_sync_debug_mode("error")
        return replay(runner, state, c)

    def track_no_wait(runner, *args, **kwargs):
        # The tracking step: from the copies into its graph's inputs to the
        # replay's outputs any wait on the card raises; the stats fetch
        # follows.
        if current["frame"] in (TRACK_OK_FRAME, PROFILE_KEYFRAME + 1):
            track_args[current["frame"]] = (args, kwargs)
        if card:
            torch.cuda.set_sync_debug_mode("error")
        try:
            return track_step(runner, *args, **kwargs)
        finally:
            if card:
                torch.cuda.set_sync_debug_mode(0)

    replay, track_step = LocalMappingRunner.step, TrackStepRunner.step
    if card:
        LocalMappingRunner.step = step_no_wait
    TrackStepRunner.step = track_no_wait
    _reset_counts()
    try:
        for i, (gray, depth) in enumerate(frames):
            current["frame"] = i
            if len(profiled) and i == profiled.start:
                window_before = _tally()
                prof.start()
            if card and i == PROFILE_KEYFRAME:
                kf_before = _tally()
                prof_kf.start()
            t = time.perf_counter()
            try:
                poses.append(tracker.process(gray, depth, float(seq.stamps[i])))
            finally:
                if card:
                    torch.cuda.set_sync_debug_mode(0)
            sync()
            if i not in profiled and i != PROFILE_KEYFRAME:
                frame_ms.append((time.perf_counter() - t) * 1e3)
            if len(profiled) and i == profiled[-1]:
                prof.stop()
                window_since = _since(window_before)
                window_python, window_graphs = window_since["wrapper"], window_since["replayed"]
                window_bodies, window_branches = window_since["bodies"], window_since["track"]
            if card and i == PROFILE_KEYFRAME:
                prof_kf.stop()
                kf_since = _since(kf_before)
                kf_python, kf_graphs = kf_since["wrapper"], kf_since["replayed"]
                kf_bodies = kf_since["bodies"]
    finally:
        LocalMappingRunner.step, TrackStepRunner.step = replay, track_step
    counts = _counts()
    captured = _captured_counts()
    graph_runs = dict(_REPLAYED)
    whole = _tally()
    runs = _kernel_runs(whole)
    ate = evaluate_ate_xyz(tracker.camera_positions(), seq.gt_positions()).rmse
    statuses = [s["status"] for s in tracker.stats[1:]]
    ok_frac = statuses.count("OK") / len(statuses)
    n_points = int(tracker.state.n_points)
    stages = tracker.metrics.stages
    n_lm = stages["local_mapping"].count if "local_mapping" in stages else 0
    n_capture = stages["local_mapping.capture"].count if "local_mapping.capture" in stages else 0
    n_track_capture = stages["track.capture"].count if "track.capture" in stages else 0
    n_tracked = stages["track"].count if "track" in stages else 0
    kf_frames = [i for i in range(1, len(tracker.stats))
                 if tracker.stats[i]["kfs"] != tracker.stats[i - 1]["kfs"]]
    res = dict(frames=n_frames, ate_m=ate, ok_frac=ok_frac, n_points=n_points,
               n_kfs=int(tracker.state.n_kfs), keyframe_frames=kf_frames,
               local_mapping_steps=n_lm, local_mapping_captures=n_capture,
               track_captures=n_track_capture, tracked_frames=n_tracked, launches=runs,
               launches_wrapper_calls=counts, launches_captured=captured,
               launches_replayed=graph_runs, launches_in_bodies=whole["bodies"],
               track_branches=whole["track"],
               median_frame_ms=statistics.median(frame_ms[1:]),
               mean_frame_ms=statistics.mean(frame_ms[1:]), timed_frames=len(frame_ms) - 1,
               b1_launches_per_frame=runs["window_match"] / (n_frames - 1))
    _log("main path: " + json.dumps(res))
    _log("main path stages (Tracker.metrics, host clock):\n" + tracker.metrics.report())
    if card:
        res["capture"] = _capture_stats(tracker.local_mapper(), cfg)
        res["insert_capture"] = {
            name: {k: v / 2**20 if k == "pool_bytes" else v
                   for k, v in tracker.insert_runner().stats(cfg, spawn_all).items()}
            for name, spawn_all in (("first", True), ("keyframe", False))}
        track_graph = tracker.track_runner().stats(cfg)
        res["track_capture"] = dict(capture_ms=track_graph["capture_ms"],
                                    pool_mib=track_graph["pool_bytes"] / 2**20,
                                    replays=track_graph["replays"],
                                    captured=track_graph["captured"],
                                    conditional=track_graph["conditional"],
                                    bodies=track_graph["bodies"])
        _log("main path local-mapping graph: " + json.dumps(res["capture"])
             + "; tracking graph: " + json.dumps(res["track_capture"])
             + "; insertion graphs (pool_bytes in MiB): " + json.dumps(res["insert_capture"]))
    if len(profiled):
        breakdown = _device_breakdown(prof, len(profiled), res["median_frame_ms"])
        breakdown.update(launches_python=window_python, launches_replayed=window_graphs,
                         launches_in_bodies=window_bodies, track_branches=window_branches,
                         b1_per_replay=(window_graphs["window_match"]
                                        + window_bodies["window_match"]) / len(profiled),
                         traced=_traced_launches(prof))
        res["profile"] = breakdown
        _log(f"profiled frames {profiled.start}-{profiled[-1]}: " + json.dumps(breakdown))
        _log(f"a steady replay: {breakdown['kernels_per_frame']:.1f} kernels, the card busy "
             f"{breakdown['device_busy_ms_per_frame']:.2f} ms (the parent tree, both branches of "
             f"each cond computed: ~{PARENT_STEADY_KERNELS} and {PARENT_STEADY_BUSY_MS} ms, "
             f"PERF.md section 5); retry and fallback bodies run in the window: "
             f"{window_branches['retry']} and {window_branches['fallback']} of "
             f"{window_branches['replays']} replays; B1 {breakdown['b1_per_replay']} a replay")
        _log(prof.key_averages().table(sort_by="self_cpu_time_total", row_limit=12,
                                       max_name_column_width=50))
    if card:
        kf = dict(frame=PROFILE_KEYFRAME, runtime_calls=_runtime_in(prof_kf),
                  local_mapping=_runtime_in(prof_kf, "local_mapping"),
                  keyframe_insert=_runtime_in(prof_kf, "keyframe.insert"),
                  launches_python=kf_python, launches_replayed=kf_graphs,
                  traced=_traced_launches(prof_kf))
        res["keyframe_profile"] = kf
        steady = breakdown["runtime_calls_per_frame"]
        _log(f"syncs (cudaStreamSynchronize) a steady frame {steady.get('cudaStreamSynchronize', 0)}"
             f", keyframe frame {PROFILE_KEYFRAME} {kf['runtime_calls'].get('cudaStreamSynchronize', 0)}"
             f", inside its local_mapping range {kf['local_mapping']}: " + json.dumps(kf))
        if not kf["local_mapping"].get("cudaGraphLaunch"):
            raise AssertionError(f"frame {PROFILE_KEYFRAME} replayed no local-mapping graph: "
                                 f"{kf}")
        waits = {k: v for k, v in kf["local_mapping"].items() if k in _SYNC_CALLS}
        if waits:
            raise AssertionError(f"local mapping waited on the card at frame {PROFILE_KEYFRAME}: "
                                 f"{waits}")
        # Insertion is one replay of its graph, with no wait (the eager
        # insertion made about 600 kernel launches here).
        ins = kf["keyframe_insert"]
        _log(f"keyframe frame {PROFILE_KEYFRAME}: insertion {json.dumps(ins)}; the frame "
             f"{json.dumps(kf['runtime_calls'])}")
        if ins.get("cudaGraphLaunch") != 1 or any(k in _SYNC_CALLS for k in ins):
            raise AssertionError(f"frame {PROFILE_KEYFRAME} inserted its keyframe with {ins}, not "
                                 "one graph launch and no wait")
        _check_traced(f"frame {PROFILE_KEYFRAME}", kf["traced"],
                      {k: kf_python[k] + kf_graphs[k] + kf_bodies[k] for k in kf_python})
        if captured["window_match"] == 0:
            raise AssertionError(f"the main path's graphs hold no B1 launch: {captured}")
        # A steady frame: one replay of the tracking graph and one wait, the
        # stats fetch; B1 only inside the graph.
        for name in ("cudaGraphLaunch", "cudaStreamSynchronize"):
            if steady.get(name, 0) != 1:
                raise AssertionError(f"a steady frame made {steady.get(name, 0)} {name} a frame, "
                                     f"not 1: {steady}")
        if any(window_python.values()) or not window_graphs["window_match"]:
            raise AssertionError(f"steady frames called the wrappers {window_python} and "
                                 f"replayed {window_graphs}")
        # B1 twice a steady replay (the motion model's first window, local-map
        # tracking), once more in each retry body run; no fallback there.
        n_window = len(profiled)
        if (window_branches["replays"] != n_window or window_branches["fallback"]
                or window_graphs["window_match"] != 2 * n_window
                or window_bodies["window_match"] != window_branches["retry"]):
            raise AssertionError(f"the steady window's {n_window} replays ran B1 "
                                 f"{window_graphs['window_match']} times outside bodies and "
                                 f"{window_bodies['window_match']} inside, the branches "
                                 f"{window_branches}")
        _check_traced(f"frames {profiled.start}-{profiled[-1]}", breakdown["traced"],
                      {k: window_graphs[k] + window_bodies[k] for k in window_graphs})
    if not ate < 0.01:
        raise AssertionError(f"main path ATE {ate:.5f} m >= 0.01 m")
    if not ok_frac >= 0.9:
        raise AssertionError(f"main path OK fraction {ok_frac:.3f} < 0.9")
    if not n_points >= 900:
        raise AssertionError(f"main path map has {n_points} points < 900")
    if n_lm < 2:
        raise AssertionError(f"local mapping ran {n_lm} times on the main path, not twice")
    if n_capture != 1:
        raise AssertionError(f"the main path captured local mapping {n_capture} times, not once")
    if n_track_capture != 1 or n_tracked != n_frames - 1:
        raise AssertionError(f"the main path captured the tracking step {n_track_capture} times "
                             f"and tracked {n_tracked} frames through it, not once and "
                             f"{n_frames - 1}")
    if card and runs["window_match"] == 0:
        raise AssertionError("the main path never launched the window matcher")
    return res | {"tracker": tracker, "rendered": rendered, "poses": np.stack(poses),
                  "frame_ms": frame_ms, "track_args": track_args}


def _pushed(args: tuple, metres: float) -> tuple:
    """The tracking step's arguments with the velocity (the seventh)
    pushed `metres` along the camera's x axis."""
    velocity = args[6].clone()
    velocity[0, 3] += metres
    return args[:6] + (velocity,) + args[7:]


def check_track_graph(dev, track_args: dict, cfg: SlamConfig, card: str) -> dict:
    """Phase 4b: the tracking step's graph (a `TrackStepRunner` of its own,
    captured on the arguments phase 4 gave the frame after the
    local-mapping replay) against the eager `fused_track_step` on the same
    arguments, bit for bit on every output tensor: a steady frame
    (TRACK_OK_FRAME), the frame after the local-mapping replay, and the
    steady frame with its velocity pushed TRACK_PUSH_M (the reference-
    keyframe fallback decides: the motion model keeps under
    `min_inliers_track` inliers). Each replay under sync debug mode
    "error", profiled: one `cudaGraphLaunch`, no wait, no wrapper call, B1
    twice outside the conditional bodies and once in each run of the retry
    body (its counter on the card), its two kernels in the trace as often,
    the fallback body run on the pushed frame alone; the first case's
    outputs unchanged by the later replays. Times the
    graph's dispatch, the graph and the eager step synchronized (host
    clock), and logs the capture's host ms and pool."""
    on_card = dev.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    ok_args, kw = track_args[TRACK_OK_FRAME]
    cases = {"ok": (ok_args, kw), "after_local_mapping": track_args[PROFILE_KEYFRAME + 1],
             "fallback": (_pushed(ok_args, TRACK_PUSH_M), kw)}
    activities = [torch.profiler.ProfilerActivity.CPU]
    if on_card:
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    t0 = time.perf_counter()
    runner = TrackStepRunner(dev)
    sync()
    _reset_counts()
    cap_args, cap_kw = cases["after_local_mapping"]
    graph, _ = runner.capture(*cap_args, **cap_kw)
    captured = _captured_counts()
    sync()
    retry_b1 = [b["kernels"].get("window_match", 0) for b in graph.bodies
                if _body_kind(b) == "retry_True"]
    if on_card and (graph.captured.get("window_match") != 2 or retry_b1 != [1]
                    or len(graph.bodies) != 4):
        raise AssertionError(f"4b: the tracking graph recorded B1 {graph.captured} outside its "
                             f"bodies and {graph.conditional} inside, bodies {graph.bodies}: "
                             "2 outside, 1 in the retry body of 4 expected")

    def call(args, kwargs):
        if on_card:
            torch.cuda.set_sync_debug_mode("error")
        try:
            with record_function("track"):
                return runner.step(*args, **kwargs)
        finally:
            if on_card:
                torch.cuda.set_sync_debug_mode(0)

    res = dict(cases={})
    kept = None
    for label, (args, kwargs) in cases.items():
        with highest_precision():
            eager = tracker_mod.fused_track_step(*args, **kwargs)
        sync()
        before = _tally()
        with torch.profiler.profile(activities=activities) as prof:
            out = call(args, kwargs)
            sync()
        since = _since(before)
        wrapper, replayed, bodies = since["wrapper"], since["replayed"], since["bodies"]
        stats = eager[-1].cpu().numpy()
        r = dict(status=int(stats[16]), need_kf=bool(stats[17] > 0.5), n_inliers=int(stats[18]),
                 n_inliers_motion_model=int(stats[20]), launches_python=wrapper,
                 launches_replayed=replayed, launches_in_bodies=bodies,
                 track_branches=since["track"],
                 traced=_traced_launches(prof) if on_card else None,
                 runtime_calls=_runtime_in(prof, "track"),
                 replay_kernels=_device_kernels(prof, ("track",)) if on_card else None,
                 differs_from_eager=[
                     path for (path, x), (_, y) in zip(state_leaves(out, "out"),
                                                       state_leaves(eager, "out"), strict=True)
                     if x.dtype != y.dtype or not torch.equal(x, y)])
        res["cases"][label] = r
        if kept is None:
            first = out
            kept = [t.clone() for _, t in state_leaves(out, "out")]
        if r["differs_from_eager"]:
            raise AssertionError(f"4b: the tracking graph on the {label} frame differs from the "
                                 f"eager step in {r['differs_from_eager']}")
        if not on_card:
            continue
        waits = {k: v for k, v in r["runtime_calls"].items() if k in _SYNC_CALLS}
        if waits or r["runtime_calls"].get("cudaGraphLaunch") != 1:
            raise AssertionError(f"4b: the {label} frame's replay made {r['runtime_calls']}")
        # The fallback body runs where the motion model failed, here where it
        # kept too few inliers (its other failure, a jump over 0.5 m, does
        # not happen on these frames).
        branches = since["track"]
        want_fallback = int(r["n_inliers_motion_model"] < cfg.tracking.min_inliers_track)
        if (any(wrapper.values()) or replayed["window_match"] != 2
                or bodies["window_match"] != branches["retry"] or branches["replays"] != 1
                or branches["fallback"] != want_fallback):
            raise AssertionError(f"4b: the {label} frame's replay called the wrappers {wrapper}, "
                                 f"replayed {replayed} outside bodies and {bodies} inside, ran "
                                 f"the branches {branches}: B1 2 + retries, the fallback "
                                 f"{want_fallback} expected")
        _check_traced(f"4b: the {label} frame's replay", r["traced"],
                      {k: replayed[k] + bodies[k] for k in replayed})
    res["changed_by_later_replays"] = [
        path for (path, t), k in zip(state_leaves(first, "out"), kept, strict=True)
        if not torch.equal(t, k)]
    fb = res["cases"]["fallback"]
    if not fb["n_inliers_motion_model"] < cfg.tracking.min_inliers_track:
        raise AssertionError(f"4b: the pushed frame's motion model kept "
                             f"{fb['n_inliers_motion_model']} inliers: the fallback did not "
                             "decide")
    if res["changed_by_later_replays"]:
        raise AssertionError(f"4b: the outputs of the first replay changed with later ones in "
                             f"{res['changed_by_later_replays']}")
    # Timed apart: a steady frame, which skips both branches, and the pushed
    # one, which runs the fallback body.
    times = {}
    for label in ("ok", "fallback"):
        args, kwargs = cases[label]
        dispatch, synced, eager_ms = [], [], []
        for _ in range(TRACK_REPEATS):
            sync()
            t = time.perf_counter()
            call(args, kwargs)
            dispatch.append((time.perf_counter() - t) * 1e3)
            sync()
            synced.append((time.perf_counter() - t) * 1e3)
            t = time.perf_counter()
            with highest_precision():
                tracker_mod.fused_track_step(*args, **kwargs)
            sync()
            eager_ms.append((time.perf_counter() - t) * 1e3)
        times[label] = dict(dispatch_ms=statistics.median(dispatch),
                            synced_ms=statistics.median(synced),
                            eager_ms=statistics.median(eager_ms))
    res.update(**times["ok"], fallback_frame=times["fallback"], launches_captured=captured,
               capture=(_capture_stats(runner, cfg) | {"replays": runner.stats(cfg)["replays"]}
                        if on_card else None),
               phase_s=time.perf_counter() - t0)
    _log("4b the tracking step's graph against the eager step: " + json.dumps(res)
         + f"; card: {card}")
    return res


def _moved(tree, dev):
    """The tracking step's arguments (tensors in dataclasses and tuples,
    ints, a `SlamConfig`, None) with every tensor on `dev`."""
    if isinstance(tree, torch.Tensor):
        return tree.to(dev)
    if isinstance(tree, SlamConfig) or tree is None or isinstance(tree, (int, float)):
        return tree
    if isinstance(tree, tuple):
        return tuple(_moved(x, dev) for x in tree)
    if isinstance(tree, dict):
        return {k: _moved(x, dev) for k, x in tree.items()}
    return dataclasses.replace(tree, **{f.name: _moved(getattr(tree, f.name), dev)
                                        for f in dataclasses.fields(tree)})


def _track_graph_child(track_args: dict, cfg: SlamConfig, card: str) -> dict:
    _count_replays()
    dev = torch.device("cuda")
    return check_track_graph(dev, _moved(track_args, dev), cfg, card)


def run_track_graph_check(track_args: dict, cfg: SlamConfig, card: str) -> dict:
    """4b in a process of its own, on CPU copies of phase 4's arguments:
    after the script's earlier profiler sessions, a trace in the script's
    process lost one of B1's kernels from a replay that ran the fallback
    body, though the replay's outputs equaled the eager step's (so B1
    ran), as 8c's traces there tied body kernels to the wrong launches; a
    fresh process traces cleanly."""
    cpu = _moved(track_args, torch.device("cpu"))
    with multiprocessing.get_context("spawn").Pool(1) as pool:
        return pool.apply(_track_graph_child, (cpu, cfg, card))


# ---- phase 5: B2 through local BA ----------------------------------------------

def run_b2_path(tracker, dev) -> dict:
    cfg = tracker.cfg
    cfg5 = cfg.replace(map=dataclasses.replace(cfg.map, local_ba_window=12,
                                               local_ba_fixed_anchors=8))
    state = tracker.state
    _reset_counts()
    t = time.perf_counter()
    with highest_precision():
        out_kernel = local_mapping_step(state, cfg5)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t) * 1e3
    counts = _counts()
    # The same step with B2's plain version swapped in for the kernel.
    kernel_fn = cuda_solve.spd_solve
    cuda_solve.spd_solve = cuda_solve.spd_solve_reference
    try:
        with highest_precision():
            out_plain = local_mapping_step(state, cfg5)
    finally:
        cuda_solve.spd_solve = kernel_fn
    live = out_kernel.kfs.valid
    pose_err = float((out_kernel.kfs.T_cw[live] - out_plain.kfs.T_cw[live]).abs().max())
    moved = float((out_kernel.kfs.T_cw[live] - state.kfs.T_cw[live]).abs().max())
    res = dict(n_unknowns=6 * 20, launches=counts, step_ms=step_ms, pose_max_abs_err=pose_err,
               pose_max_move=moved, live_keyframes=int(live.sum()))
    _log("B2 through local BA: " + json.dumps(res))
    if dev.type == "cuda" and counts["spd_solve"] == 0:
        raise AssertionError("local BA at a 12 + 8 window never launched the SPD solve kernel")
    if not moved >= POSE_MIN_MOVE:
        raise AssertionError(f"local BA moved no pose by {POSE_MIN_MOVE} (max {moved:.3e}): "
                             "the kernel-vs-plain comparison would be vacuous")
    if not pose_err <= POSE_ATOL:
        raise AssertionError(f"kernel vs plain local BA poses differ by {pose_err:.3e} "
                             f"> {POSE_ATOL}")
    return res


_SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
               "cudaMemcpy")


def _runtime_in(prof, range_name: str | None = None) -> dict:
    """CUDA runtime calls (launches, copies, syncs) in a profile: all of
    them, or those made while a host range named `range_name` was open.
    Read from the raw trace events: building the profiler's event tree
    takes seconds for a local-mapping step's ~20,000 launches."""
    names = ("cudaLaunchKernel", "cuLaunchKernel", "cudaMemcpyAsync",
             "cudaGraphLaunch") + _SYNC_CALLS
    events = prof.profiler.kineto_results.events()
    spans = [(e.start_ns(), e.end_ns()) for e in events
             if e.name() == range_name and e.device_type() == torch.autograd.DeviceType.CPU]
    out = {}
    for e in events:
        name = e.name()
        if name not in names:
            continue
        if range_name is None or any(a <= e.start_ns() <= b for a, b in spans):
            out[name] = out.get(name, 0) + 1
    return out


def _capture_stats(runner, cfg) -> dict:
    """A runner's capture for `cfg`: host ms (warm-up, capture,
    instantiation and the first replay's dispatch) and MiB its graph's
    private pool reserved."""
    st = runner.stats(cfg)
    return dict(capture_ms=st["capture_ms"], pool_mib=st["pool_bytes"] / 2**20)


def _device_kernels(prof, ranges: tuple = (), top: int = 8) -> dict:
    """Kernels on the device in a profile, from the raw trace events: how
    many, their summed ms, and the `top` names by ms. The device-side spans
    of the host ranges named in `ranges` are left out."""
    by = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA and e.name() not in ranges:
            k = by.setdefault(e.name(), [0, 0])
            k[0] += 1
            k[1] += e.end_ns() - e.start_ns()
    ranked = sorted(by.items(), key=lambda kv: -kv[1][1])[:top]
    return dict(kernels=sum(v[0] for v in by.values()),
                busy_ms=sum(v[1] for v in by.values()) / 1e6,
                top=[dict(name=n[:80], count=c, ms=ns / 1e6) for n, (c, ns) in ranked])


def _differing_leaves(a, b) -> list:
    """The tensors of two SlamStates that are not equal bit for bit."""
    return [path for (path, x), (_, y) in zip(state_leaves(a), state_leaves(b), strict=True)
            if x.dtype != y.dtype or not torch.equal(x, y)]


def check_async_mapping(tracker, dev, card: str) -> dict:
    """Phase 5b: local mapping on phase 4's map at the default 16 + 8
    window (its solve `torch.linalg.solve_ex`) and at 12 + 8 (B2), each
    through a `LocalMappingRunner` of its own. Gates: the graph's output
    equal bit for bit, on every tensor of the state, to the eager
    `local_mapping_step` and to a second replay; a state the runner
    returned unchanged after a replay on another state, and sharing no
    memory with the graph's outputs; in a traced replay B1's two kernels
    at both windows and B2's at 12 + 8 only, each as many times as the
    capture recorded launches of it and the eager step made, and no
    wrapper called; every replay under CUDA's sync debug mode "error" and
    a profiled one with a `cudaGraphLaunch` and no stream sync or
    synchronous copy in its range; the dispatch
    (copy in, replay, clones: what the tracker waits for with
    `async_mapping`) under half the same call ending in a synchronize, the
    gate of `tests/test_map_hygiene.py:334-366`. Logs the capture's host
    ms and its pool's size."""
    on_card = dev.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    cfg = tracker.cfg
    state = tracker.state
    cfg5 = cfg.replace(map=dataclasses.replace(cfg.map, local_ba_window=12,
                                               local_ba_fixed_anchors=8))
    activities = [torch.profiler.ProfilerActivity.CPU]
    if on_card:
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    t0 = time.perf_counter()
    res = {}
    for label, c in (("window_16_8", cfg), ("window_12_8", cfg5)):
        runner = LocalMappingRunner(dev)

        def call():
            if on_card:
                torch.cuda.set_sync_debug_mode("error")
            try:
                with record_function("local_mapping"):
                    return runner.step(state, c)
            finally:
                if on_card:
                    torch.cuda.set_sync_debug_mode(0)

        sync()
        _reset_counts()
        with highest_precision():
            eager = local_mapping_step(state, c)
        eager_counts = _counts()
        sync()
        _reset_counts()
        runner.capture(state, c)
        captured = _captured_counts()
        sync()
        # The capture's own replay mapped `state`: this call replays nothing.
        first = call()
        kept = [t.clone() for _, t in state_leaves(first)]
        sync()
        _reset_counts()
        with torch.profiler.profile(activities=activities) as prof:
            again = call()
            sync()
        replay_counts = _counts()
        # A replay on another state must leave the states returned so far
        # as they were.
        after = runner.step(first, c)
        sync()
        graph_out = runner.graphs()[0].out
        graph_mem = (set() if graph_out is None else
                     {t.untyped_storage().data_ptr() for _, t in state_leaves(graph_out)})
        dispatch, synced = [], []
        for _ in range(ASYNC_REPEATS):
            sync()
            t = time.perf_counter()
            call()
            dispatch.append((time.perf_counter() - t) * 1e3)
            sync()
            t = time.perf_counter()
            call()
            sync()
            synced.append((time.perf_counter() - t) * 1e3)
        r = dict(launches_eager=eager_counts, launches_captured=captured,
                 launches_python_in_replay=replay_counts,
                 traced_replay=_traced_launches(prof) if on_card else None,
                 runtime_calls=_runtime_in(prof, "local_mapping"),
                 replay_kernels=_device_kernels(prof, ("local_mapping",)) if on_card else None,
                 dispatch_ms=statistics.median(dispatch), synced_ms=statistics.median(synced),
                 dispatch_all_ms=dispatch, synced_all_ms=synced,
                 capture=_capture_stats(runner, c) if on_card else None,
                 differs_from_eager=_differing_leaves(first, eager),
                 differs_between_replays=_differing_leaves(first, again),
                 changed_by_later_replay=[
                     path for (path, t), k in zip(state_leaves(first), kept, strict=True)
                     if not torch.equal(t, k)],
                 sharing_graph_memory=[path for path, t in state_leaves(first)
                                       if t.untyped_storage().data_ptr() in graph_mem],
                 later_replay_differs_in=len(_differing_leaves(after, first)))
        r["dispatch_over_synced"] = r["dispatch_ms"] / r["synced_ms"]
        res[label] = r
        _log(f"5b local mapping at {label} (graph): " + json.dumps(r) + f"; card: {card}")
        if r["differs_from_eager"]:
            raise AssertionError(f"local mapping's graph at {label} differs from the eager step "
                                 f"in {r['differs_from_eager']}")
        if r["differs_between_replays"]:
            raise AssertionError(f"local mapping's graph at {label} did not repeat itself in "
                                 f"{r['differs_between_replays']}")
        if r["changed_by_later_replay"] or r["sharing_graph_memory"]:
            raise AssertionError(f"a state returned at {label} changed with a later replay in "
                                 f"{r['changed_by_later_replay']} or shares the graph's memory in "
                                 f"{r['sharing_graph_memory']}")
        if not r["later_replay_differs_in"]:
            raise AssertionError(f"the step on its own output at {label} changed nothing: the "
                                 "aliasing check would be vacuous")
        if not on_card:
            continue
        waits = {k: v for k, v in r["runtime_calls"].items() if k in _SYNC_CALLS}
        if waits:
            raise AssertionError(f"local mapping's replay at {label} waited on the card: {waits}")
        if not r["runtime_calls"].get("cudaGraphLaunch"):
            raise AssertionError(f"local mapping at {label} launched no graph: "
                                 f"{r['runtime_calls']}")
        if captured != eager_counts:
            raise AssertionError(f"the capture at {label} recorded {captured} launches, the eager "
                                 f"step made {eager_counts}")
        if any(replay_counts.values()):
            raise AssertionError(f"a replay at {label} called the wrappers: {replay_counts}")
        _check_traced(f"local mapping's replay at {label}", r["traced_replay"], captured)
        if captured["window_match"] == 0:
            raise AssertionError(f"local mapping's graph at {label} holds no B1 launch")
        if (captured["spd_solve"] > 0) != (label == "window_12_8"):
            raise AssertionError(f"local mapping's graph at {label}: B2 launches {captured}")
        if not r["dispatch_ms"] < 0.5 * r["synced_ms"]:
            raise AssertionError(f"local mapping at {label}: dispatch {r['dispatch_ms']:.3f} ms is "
                                 f"not under half of {r['synced_ms']:.3f} ms synchronized")
    res["phase_s"] = time.perf_counter() - t0
    _log(f"phase 5b took {res['phase_s']:.1f} s")
    return res


def check_async_gate(dev, rendered, card: str) -> dict:
    """Phase 5d: `tests/test_map_hygiene.py:334-366` on the card: its
    sequence (the orbit's first GATE_FRAMES frames at 640x480, phase 4's
    frames), its config (a keyframe at least every GATE_KF_GAP + 1
    frames, loop closing and relocalization off), a synchronous and then
    an asynchronous `Tracker`; its gates: both ATEs under GATE_ATE, at
    least two asynchronous local-mapping calls, and the asynchronous
    `local_mapping` stage's mean under half the synchronous one's (each
    over the calls after its run's capture, which is the stage
    `local_mapping.capture`)."""
    seq, frames, *_ = rendered
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    base = SlamConfig()
    t0 = time.perf_counter()
    res = {}
    for name, async_on in (("sync", False), ("async", True)):
        cfg = base.replace(
            tracking=dataclasses.replace(base.tracking, max_frames_between_kfs=GATE_KF_GAP,
                                         async_mapping=async_on),
            loop=dataclasses.replace(base.loop, enabled=False, enable_relocalization=False))
        tracker = Tracker(cfg, device=dev)
        t = time.perf_counter()
        for i in range(GATE_FRAMES):
            gray, depth = frames[i]
            tracker.process(gray, depth, float(seq.stamps[i]))
        sync()
        stages = tracker.metrics.stages
        lm, cap = stages.get("local_mapping"), stages.get("local_mapping.capture")
        res[name] = dict(
            ate_m=evaluate_ate_xyz(tracker.camera_positions(),
                                   seq.gt_positions()[:GATE_FRAMES]).rmse,
            local_mapping_calls=lm.count if lm else 0,
            local_mapping_mean_ms=lm.mean_s * 1e3 if lm else None,
            local_mapping_max_ms=lm.max_s * 1e3 if lm else None,
            captures=cap.count if cap else 0, capture_ms=cap.total_s * 1e3 if cap else None,
            run_s=time.perf_counter() - t)
    sy, asy = res["sync"], res["async"]
    if sy["local_mapping_calls"] and asy["local_mapping_calls"]:
        res["async_over_sync"] = asy["local_mapping_mean_ms"] / sy["local_mapping_mean_ms"]
    res["phase_s"] = time.perf_counter() - t0
    _log(f"5d the async-mapping gate of tests/test_map_hygiene.py: " + json.dumps(res)
         + f"; card: {card}")
    if not (sy["ate_m"] < GATE_ATE and asy["ate_m"] < GATE_ATE):
        raise AssertionError(f"5d ATE sync {sy['ate_m']:.5f} / async {asy['ate_m']:.5f} m, not "
                             f"both under {GATE_ATE} m")
    if asy["local_mapping_calls"] < 2:
        raise AssertionError(f"5d ran asynchronous local mapping {asy['local_mapping_calls']} "
                             "times, under 2")
    if sy["captures"] != 1 or asy["captures"] != 1:
        raise AssertionError(f"5d captured local mapping {sy['captures']} / {asy['captures']} "
                             "times, not once a run")
    if dev.type == "cuda" and not res["async_over_sync"] < 0.5:
        raise AssertionError(f"5d asynchronous local_mapping stage {asy['local_mapping_mean_ms']:.3f}"
                             f" ms is not under half the synchronous "
                             f"{sy['local_mapping_mean_ms']:.3f} ms")
    return res


def check_descriptor_references(dev, rendered) -> dict:
    """Phase 5c: ORB-SLAM2's intensity-centroid angle, the 7x7 pre-blur and
    rotation-steered BRIEF on phase 4's first view, card against CPU, at
    DESC_POINTS seeded keypoints (every 17th invalid). The descriptors are
    held equal with the CPU's angles on both sides; with the card's own
    angles the differing bits are logged."""
    gray = torch.from_numpy(np.ascontiguousarray(rendered[1][0][0], np.float32))
    h, w = gray.shape
    rng = np.random.default_rng(0)
    uv = torch.from_numpy(np.stack([rng.uniform(DESC_MARGIN, w - DESC_MARGIN, DESC_POINTS),
                                    rng.uniform(DESC_MARGIN, h - DESC_MARGIN, DESC_POINTS)],
                                   -1).astype(np.float32))
    valid = torch.ones(DESC_POINTS, dtype=torch.bool)
    valid[::17] = False

    def run(device, angle=None):
        g, u, v = gray.to(device), uv.to(device), valid.to(device)
        ang = orb_descriptor.ic_angle(g, u, v)
        blur = image_ops.gaussian_blur(g)
        desc = orb_descriptor.steered_brief(torch.round(blur), u,
                                            ang if angle is None else angle.to(device), v)
        return ang.cpu(), blur.cpu(), desc.cpu()

    a_cpu, b_cpu, d_cpu = run(torch.device("cpu"))
    a_dev, b_dev, d_dev = run(dev, angle=a_cpu)
    d_own = run(dev)[2]
    bits = int(popcount32(torch.bitwise_xor(d_own, d_cpu)).sum())
    res = dict(keypoints=DESC_POINTS, angle_max_abs_err=float((a_dev - a_cpu).abs().max()),
               blur_max_abs_err=float((b_dev - b_cpu).abs().max()),
               descriptors_equal=bool(torch.equal(d_dev, d_cpu)),
               bits_differing_with_card_angles=bits)
    _log("5c descriptor references, card against CPU: " + json.dumps(res))
    if not res["angle_max_abs_err"] <= DESC_ANGLE_TOL:
        raise AssertionError(f"ic_angle card vs CPU {res['angle_max_abs_err']:.3e} > "
                             f"{DESC_ANGLE_TOL}")
    if not res["blur_max_abs_err"] <= DESC_BLUR_TOL:
        raise AssertionError(f"gaussian_blur card vs CPU {res['blur_max_abs_err']:.3e} > "
                             f"{DESC_BLUR_TOL}")
    if not res["descriptors_equal"]:
        raise AssertionError("steered_brief on the card differs from the CPU's")
    return res


# ---- phase 6: relocalization ------------------------------------------------------

def named_vocabulary(directory: Path) -> str:
    """A DBoW2 tree vocabulary at the trained file's shape (k = 10,
    depth = 4) built from a fixed seed and saved under `directory`; its
    path. The trained file is not part of the tree this script may run
    from, and the config's "auto" would fall back to the flat codebook
    with only a warning."""
    directory.mkdir(parents=True, exist_ok=True)
    path = directory / f"orbvoc_random_k{RELOC_VOCAB_K}_d{RELOC_VOCAB_DEPTH}.npz"
    voc.save_binary(voc.make_random_vocabulary(seed=RELOC_VOCAB_SEED, k=RELOC_VOCAB_K,
                                               depth=RELOC_VOCAB_DEPTH), str(path))
    return str(path)


def reloc_config(vocabulary_path) -> SlamConfig:
    base = SlamConfig()
    return base.replace(loop=dataclasses.replace(
        base.loop, enabled=False, enable_relocalization=True, vocabulary_path=vocabulary_path))


def _center(T) -> np.ndarray:
    T = T.cpu().numpy() if torch.is_tensor(T) else np.asarray(T)
    return -T[:3, :3].T @ T[:3, 3]


def _direct_relocalization(tracker, closer, frames, dev, sync, epnp: bool = False) -> dict:
    """`relocalize` on freshly built frames near keyframe 0's view, with
    no motion prior, against `closer` (with `epnp`, the frames' depth is
    zeroed, which takes the 2D-3D EPnP branch); each must succeed with at
    least `min_inliers_reloc` inliers within RELOC_POSE_TOL of the frame's
    tracked pose. Returns the results and the median time of a call."""
    cfg = tracker.cfg
    poses = tracker.absolute_poses()
    out, ms = [], []
    for i in RELOC_FRAMES:
        gray, depth = (torch.from_numpy(a).to(dev) for a in frames[i])
        frame = build_frame(gray, torch.zeros_like(depth) if epnp else depth, cfg)
        if (int(frame.is_stereo.sum()) < 3 * cfg.loop.sim3_min_inliers) != epnp:
            raise AssertionError(f"frame {i} would not take the {'EPnP' if epnp else '3D-3D'} "
                                 "branch")
        for _ in range(RELOC_TIMED_CALLS):
            sync()
            t = time.perf_counter()
            ok, T, n = relocalize(tracker.state, frame, closer, cfg)
            sync()
            ms.append((time.perf_counter() - t) * 1e3)
        err = float(np.linalg.norm(_center(T) - _center(poses[i][1])))
        out.append(dict(frame=i, ok=bool(ok), n_inliers=int(n), pose_err_m=err))
        if not (ok and n >= cfg.tracking.min_inliers_reloc and err < RELOC_POSE_TOL):
            raise AssertionError(f"direct relocalization of frame {i} with the {closer.backend}: "
                                 f"ok={ok}, {n} inliers, {err:.4f} m from the tracked pose")
    return dict(backend=closer.backend + (", EPnP branch (depth zeroed)" if epnp else ""),
                frames=out, median_ms=statistics.median(ms), timed_calls=len(ms))


_RUNTIME_CALLS = ("cudaLaunchKernel", "cudaMemcpyAsync", "cudaStreamSynchronize",
                  "cudaDeviceSynchronize")


def _profile_call(fn, dev, prefix: str = "reloc.") -> dict:
    """Kernel launches, copies and stream syncs of one call of `fn`, its
    device busy time with the device events that take most of it, and per
    profiler range named `prefix*` inside it the host time and the runtime
    calls, from a torch.profiler window."""
    if dev.type != "cuda":
        return {}
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    busy_us, runtime, ranges, device = 0.0, {}, {}, {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            if e.name.startswith(prefix):  # a range's mark on the device's timeline
                continue
            busy_us += e.time_range.elapsed_us()
            d = device.setdefault(e.name[:60], [0, 0.0])
            d[0] += 1
            d[1] += e.time_range.elapsed_us() / 1e3
        elif e.name.startswith(prefix):
            r = ranges.setdefault(e.name, {"host_ms": 0.0})
            r["host_ms"] += e.time_range.elapsed_us() / 1e3
        elif e.name in _RUNTIME_CALLS:
            runtime[e.name] = runtime.get(e.name, 0) + 1
            parent = e.cpu_parent
            while parent is not None and not parent.name.startswith(prefix):
                parent = parent.cpu_parent
            if parent is not None:
                r = ranges.setdefault(parent.name, {"host_ms": 0.0})
                r[e.name] = r.get(e.name, 0) + 1
    top = sorted(device.items(), key=lambda kv: -kv[1][1])[:4]
    return dict(runtime_calls=runtime, device_busy_ms=busy_us / 1e3, ranges=ranges,
                top_device_events=[dict(name=n, count=c, ms=ms) for n, (c, ms) in top])


def run_reloc_path(dev, rendered, card: str) -> dict:
    """Phase 6: `Tracker.process` with relocalization on a named
    vocabulary: direct relocalization on both backends, the
    localization-only mbVO fallback, and recovery from a kidnap. Times
    are logged beside `card` (name and power limit)."""
    seq, frames, kidnap, *_ = rendered
    n_track = RELOC_TRACK_FRAMES
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    t_phase = time.perf_counter()
    res = {}
    with warnings.catch_warnings():
        # The missing-vocabulary fallback would measure the codebook under
        # the vocabulary's name: here it is an error.
        warnings.filterwarnings("error", message="trained artifact")
        vocab_path = named_vocabulary(Path(__file__).resolve().parent / "build" / "reloc_vocab")
        cfg = reloc_config(vocab_path)
        tracker = Tracker(cfg, device=dev)
        closer = tracker.loop_closer
        if closer.vocab is None:
            raise AssertionError("phase 6 runs without its named vocabulary")
        _log(f"relocalization: tracker database backend {closer.backend}, from {vocab_path} "
             f"(seed {RELOC_VOCAB_SEED})")
        for i in range(n_track):
            tracker.process(*frames[i], float(seq.stamps[i]))
        if tracker.status != "OK":
            raise AssertionError(f"phase 6 tracking ended {tracker.status} before the checks")

        # Direct relocalization, both backends.
        res["direct"] = [_direct_relocalization(tracker, closer, frames, dev, sync)]
        codebook = LoopCloser(reloc_config(None), device=dev)
        codebook.on_keyframe(tracker.state, 0)
        res["direct"].append(_direct_relocalization(tracker, codebook, frames, dev, sync))
        res["direct"].append(_direct_relocalization(tracker, closer, frames, dev, sync, epnp=True))
        for d in res["direct"]:
            _log(f"direct relocalization, {d['backend']}: {json.dumps(d['frames'])}; median "
                 f"{d['median_ms']:.2f} ms a call over {d['timed_calls']} calls (host clock, "
                 f"ending in torch.cuda.synchronize()); card: {card}")
        gray, depth = (torch.from_numpy(a).to(dev) for a in frames[RELOC_FRAMES[0]])
        frame = build_frame(gray, depth, cfg)
        mono = build_frame(gray, torch.zeros_like(depth), cfg)
        for key, f in (("direct_call_profile", frame), ("direct_call_profile_epnp", mono)):
            res[key] = _profile_call(lambda: relocalize(tracker.state, f, closer, cfg), dev)
            _log(f"one direct relocalize call ({closer.backend}"
                 f"{', EPnP branch' if f is mono else ''}): " + json.dumps(res[key]))

        # Localization-only mode: the map's points die for MBVO_FRAMES
        # frames, odometry rides on temporal points, never LOST, and
        # relocalization is tried; with the points back, OK.
        stage_ms = []

        def process(gray, depth, stamp):
            st = tracker.metrics.stages.get("relocalization")
            before = (st.count, st.total_s) if st is not None else (0, 0.0)
            tracker.process(gray, depth, stamp)
            st = tracker.metrics.stages.get("relocalization")
            if st is not None and st.count > before[0]:
                stage_ms.append((st.total_s - before[1]) * 1e3)

        tracker.allow_new_keyframes = False
        saved_valid = tracker.state.points.valid
        tracker.state = tracker.state.replace(
            points=tracker.state.points.replace(valid=torch.zeros_like(saved_valid)))
        mbvo = []
        for i in range(n_track, n_track + MBVO_FRAMES):
            process(*frames[i], float(seq.stamps[i]))
            mbvo.append(tracker.status)
        n_attempts = len(stage_ms)
        tracker.state = tracker.state.replace(points=tracker.state.points.replace(valid=saved_valid))
        for i in range(n_track + MBVO_FRAMES, n_track + 2 * MBVO_FRAMES):
            process(*frames[i], float(seq.stamps[i]))
            mbvo.append(tracker.status)
        tracker.allow_new_keyframes = True
        res["mbvo"] = dict(statuses=mbvo, relocalization_attempts=n_attempts)
        _log("localization-only fallback: " + json.dumps(res["mbvo"]))
        if "LOST" in mbvo[:MBVO_FRAMES] or n_attempts < 1 or mbvo[-1] != "OK":
            raise AssertionError(f"mbVO fallback: statuses {mbvo}, {n_attempts} relocalization "
                                 "attempts (wanted never LOST, at least one attempt, OK last)")

        # The kidnap: B1's launches and the tracking graph's branch bodies are
        # counted over these frames alone (the graph's replays run them).
        last = n_track + 2 * MBVO_FRAMES - 1
        lost_before = tracker.metrics.counters.get("lost", 0)
        _reset_counts()
        kid = []
        for j, (T_wc, (gray, depth)) in enumerate(kidnap):
            process(gray, depth, float(seq.stamps[last]) + (j + 1) / seq.fps)
            gt = (np.linalg.inv(seq.poses_wc[0]) @ T_wc)[:3, 3]
            err = float(np.linalg.norm(tracker.camera_positions()[-1] - gt))
            kid.append(dict(status=tracker.status, pose_err_m=err,
                            lost=tracker.metrics.counters.get("lost", 0) - lost_before))
        sync()
        counts = _path_launches("6: the kidnapped frames", dev)
    res["kidnap"] = dict(frames=kid, **counts)
    st = tracker.metrics.stages["relocalization"]
    res |= dict(relocalization_stage_median_ms=statistics.median(stage_ms),
                phase_s=time.perf_counter() - t_phase)
    _log("kidnap: " + json.dumps(res["kidnap"]))
    _log(f"relocalization stage: {st.count} calls, median {res['relocalization_stage_median_ms']:.2f}"
         f" ms (host clock; a call ends on host syncs of its inlier counts); phase 6 took "
         f"{res['phase_s']:.1f} s; card: {card}")
    _log("phase 6 stages (Tracker.metrics, host clock):\n" + tracker.metrics.report())
    if kid[0]["lost"] < 1:
        raise AssertionError(f"the kidnap gave no LOST frame: {kid}")
    # A frame tracked LOST had its motion model fail, so it ran the
    # tracking graph's fallback body.
    fallbacks = res["kidnap"]["track_branches"]["fallback"]
    if dev.type == "cuda" and fallbacks < kid[-1]["lost"]:
        raise AssertionError(f"the kidnap's {kid[-1]['lost']} LOST frames ran the fallback body "
                             f"{fallbacks} times")
    if not all(k["status"] == "OK" and k["pose_err_m"] < RELOC_POSE_TOL for k in kid):
        raise AssertionError(f"no recovery from the kidnap within {RELOC_POSE_TOL} m: {kid}")
    return res


# ---- phase 7: loop closing ---------------------------------------------------

def closure_poses(revisit: bool) -> list:
    """7a's keyframe poses (camera to world) on a circle around which the
    camera yaws a full turn (`tests/test_loop_e2e.py::_circle_poses`): 1.3
    laps with the revisit, else the first half of a circle twice as fine
    (an open arc of the same length)."""

    def circle(n, radius=0.55, room=(5.0, 3.0, 6.0)):
        sx, sy, sz = room
        out = []
        for i in range(n):
            a = 2 * np.pi * i / n
            ca, sa = np.cos(a), np.sin(a)
            T = np.eye(4, dtype=np.float32)
            T[:3, :3] = np.asarray([[ca, 0, sa], [0, 1, 0], [-sa, 0, ca]], np.float32)
            T[:3, 3] = [sx / 2 + radius * np.sin(a), sy / 2,
                        sz / 2 + radius * (np.cos(a) - 1.0) * 0.5]
            out.append(T)
        return out

    if revisit:
        n_pose = max(int(LOOP_N_KF / 1.3), 4)
        return [circle(n_pose)[i % n_pose] for i in range(LOOP_N_KF)]
    return circle(2 * LOOP_N_KF)[:LOOP_N_KF]


def closure_config(vocabulary_path, small: bool = False) -> SlamConfig:
    """`tests/test_loop_e2e.py::_cfg` with the default map widths (512
    keyframes, 32768 points; with `small`, the test's 32 keyframes), global
    BA on and the named vocabulary."""
    base = SlamConfig()
    return base.replace(
        map=dataclasses.replace(base.map, max_keyframes=32 if small else base.map.max_keyframes,
                                local_ba_window=4, local_ba_fixed_anchors=2,
                                triangulation_neighbors=2, fuse_neighbors=2),
        loop=dataclasses.replace(base.loop, enabled=True, min_kfs_before_loop=4,
                                 covisibility_consistency_th=2, run_global_ba=True,
                                 vocabulary_path=vocabulary_path))


def _closer_copy(lc: LoopCloser) -> LoopCloser:
    """A closer to replay a call from: its database tensors are replaced,
    never written in place, so only the host lists are copied."""
    c = copy.copy(lc)
    c.prev_groups = [(set(g), n) for g, n in lc.prev_groups]
    c.loops = list(lc.loops)
    return c


def run_closure(dev, cfg: SlamConfig, poses, frames) -> dict:
    """7a's pipeline: per keyframe, `insert_keyframe(spawn_all=True)` at
    the drifted pose, `fuse_map_points`, then `on_keyframe`. B1's launches
    are counted inside the `on_keyframe` calls alone (zeroed before each,
    read after)."""
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    state = map_state.empty_state(cfg, dev)
    lc = LoopCloser(cfg, device=dev)
    closed_at, errs, b1, open_ms, snap = [], None, 0, [], None
    for i, (T_wc, (gray, depth)) in enumerate(zip(poses, frames)):
        with highest_precision():
            frame = build_frame(torch.from_numpy(gray).to(dev), torch.from_numpy(depth).to(dev),
                                cfg)
            d = LOOP_DRIFT * i / (LOOP_N_KF - 1)
            T_true = np.linalg.inv(T_wc).astype(np.float32)
            T_drift = np.eye(4, dtype=np.float32)
            T_drift[:3, 3] = [d, 0.0, 0.4 * d]
            kp = torch.full((cfg.orb.max_keypoints,), -1, dtype=torch.int64, device=dev)
            state, kp = insert_keyframe(state, frame, torch.from_numpy(T_true @ T_drift).to(dev),
                                        kp, i, float(i), cfg, spawn_all=True)
            slot = int(state.last_kf)
            if i > 0:
                state = fuse_map_points(state, cfg)
        e_pre = float(np.linalg.norm(state.kfs.T_cw[slot].cpu().numpy()[:3, 3] - T_true[:3, 3]))
        before = (state, _closer_copy(lc))
        sync()
        _reset_counts()
        t = time.perf_counter()
        state, closed = lc.on_keyframe(state, slot)
        sync()
        ms = (time.perf_counter() - t) * 1e3
        b1 += _counts()["window_match"]
        if closed:
            closed_at.append(i)
            if errs is None:
                errs = (e_pre, float(np.linalg.norm(
                    state.kfs.T_cw[slot].cpu().numpy()[:3, 3] - T_true[:3, 3])))
                snap = dict(state=before[0], closer=before[1], slot=slot, ms=ms, after=state)
        else:
            open_ms.append(ms)
    return dict(closed_at=closed_at, errs=errs, b1=b1, open_ms=open_ms, snap=snap, state=state,
                closer=lc)


def check_closure(dev, views: dict, vocab: str, card: str, small: bool = False) -> dict:
    """7a: the forced closure and the open arc."""
    cfg = closure_config(vocab, small)
    rev = run_closure(dev, cfg, *views["revisit"])
    opn = run_closure(dev, cfg, *views["open"])
    snap = rev["snap"]
    res = dict(closed_at=rev["closed_at"], open_arc_closed_at=opn["closed_at"],
               b1_launches_in_on_keyframe=rev["b1"] + opn["b1"])
    if snap is not None:
        e0, e1 = rev["errs"]
        res |= dict(err_before_m=e0, err_after_m=e1, closing_call_ms=snap["ms"],
                    open_call_median_ms=statistics.median(rev["open_ms"] + opn["open_ms"]))
        # The closing call again, from the state and closer it started from,
        # under the profiler: launches and syncs by range.
        res["closing_call_profile"] = _profile_call(
            lambda: snap["closer"].on_keyframe(snap["state"], snap["slot"]), dev, prefix="loop.")
    _log("7a forced closure: " + json.dumps({k: v for k, v in res.items()
                                             if k != "closing_call_profile"}) + f"; card: {card}")
    if "closing_call_profile" in res:
        _log("7a the closing on_keyframe call, profiled: " + json.dumps(res["closing_call_profile"]))
    if not rev["closed_at"] or min(rev["closed_at"]) < LOOP_CLOSE_MIN_KF:
        raise AssertionError(f"7a: loop closed at {rev['closed_at']}, wanted one at keyframe "
                             f">= {LOOP_CLOSE_MIN_KF}")
    if not res["err_after_m"] < LOOP_ERR_RATIO * res["err_before_m"]:
        raise AssertionError(f"7a: closure keyframe error {res['err_before_m']:.4f} -> "
                             f"{res['err_after_m']:.4f} m, not below {LOOP_ERR_RATIO}x")
    if opn["closed_at"]:
        raise AssertionError(f"7a: false loop(s) on the open arc at {opn['closed_at']}")
    if dev.type == "cuda" and res["b1_launches_in_on_keyframe"] == 0:
        raise AssertionError("7a: B1 never launched inside on_keyframe")
    return res | {"cfg": cfg, "run": rev}


def _timed(fn, dev):
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    sync()
    t = time.perf_counter()
    out = fn()
    sync()
    return out, (time.perf_counter() - t) * 1e3


def _gba_diff(a, b, state) -> tuple:
    """Largest pose and point differences between two global-BA results
    (live keyframes and points of `state`), on the host."""
    live, pts = state.kfs.valid.cpu(), state.points.valid.cpu()
    return (float((a.kfs.T_cw.cpu()[live] - b.kfs.T_cw.cpu()[live]).abs().max()),
            float((a.points.pos.cpu()[pts] - b.points.pos.cpu()[pts]).abs().max()))


def check_global_ba_and_pose_graph(dev, closure: dict, card: str) -> dict:
    """7b on 7a's corrected map (the state the closing call returned):
    global BA on the card and on a CPU copy of the same state through the
    same code, the correction guard's rule, and the PCG pose graph against
    the dense one on 7a's loop graph.

    One Gauss-Newton iteration (20 CG steps) must agree within
    GBA_POSE_TOL / GBA_POINT_TOL. The full 20 iterations are compared
    against this problem's own floor as well: the CPU run again with the
    points nudged by 1e-7 m (the size of a rounding difference; the
    largest change over GBA_NUDGES nudges). Truncated CG under Huber
    reweighting carries such a nudge to 1e-4-4e-4 in the result on this
    map, so the card is held to the larger of the tolerance and twice that
    floor, and all three numbers are logged."""
    cfg, run = closure["cfg"], closure["run"]
    snap = run["snap"]
    state = snap["after"]
    F, K = state.kfs.kp_point.shape
    P = state.points.pos.shape[0]
    cpu = torch.device("cpu")
    cpu_state = map_state.state_from_numpy(map_state.state_to_numpy(state), cpu)
    one = cfg.replace(optimizer=dataclasses.replace(cfg.optimizer, global_ba_iters=1))
    step = global_ba_step_state(state, one)
    step_pose, step_point = _gba_diff(step, global_ba_step_state(cpu_state, one), state)
    step_moved = float((step.kfs.T_cw[state.kfs.valid] - state.kfs.T_cw[state.kfs.valid]).abs()
                       .max())
    err0 = map_median_reproj_error(state, cfg)
    out, gba_ms = _timed(lambda: global_ba_step_state(state, cfg), dev)
    _, gba_ms2 = _timed(lambda: global_ba_step_state(state, cfg), dev)
    out_cpu, cpu_ms = _timed(lambda: global_ba_step_state(cpu_state, cfg), cpu)
    floor_pose = floor_point = 0.0
    for seed in range(GBA_NUDGES):
        gen = torch.Generator().manual_seed(seed)
        nudge = 1e-7 * torch.randn(cpu_state.points.pos.shape, generator=gen)
        nudged = cpu_state.replace(points=cpu_state.points.replace(pos=cpu_state.points.pos + nudge))
        fp, fq = _gba_diff(out_cpu, global_ba_step_state(nudged, cfg), state)
        floor_pose, floor_point = max(floor_pose, fp), max(floor_point, fq)
    pose_err, point_err = _gba_diff(out, out_cpu, state)
    moved = float((out.kfs.T_cw[state.kfs.valid] - state.kfs.T_cw[state.kfs.valid]).abs().max())
    err1 = map_median_reproj_error(out, cfg)
    pose_lim, point_lim = max(GBA_POSE_TOL, 2 * floor_pose), max(GBA_POINT_TOL, 2 * floor_point)
    # The dense and the PCG essential graph on the loop's graph.
    st0 = snap["state"]
    cand, kf, T_ji = run["closer"].loops[0]
    covis = map_state.covisibility(st0.kfs.kp_point, st0.kfs.valid, P)
    graph = build_graph_arrays(covis, st0.kfs.valid, cfg.loop.essential_graph_covis_threshold,
                               4 * F, st0.kfs.T_cw,
                               extra_edges=[(cand, kf, cfg.loop.loop_edge_weight, T_ji)],
                               uid=st0.kfs.uid)
    uid, valid = st0.kfs.uid.cpu().numpy(), st0.kfs.valid.cpu().numpy()
    live_uid = np.where(valid & (uid >= 0), uid, 2 ** 30)
    fixed = torch.arange(F, device=dev) == int(np.argmin(live_uid))
    order = torch.from_numpy(np.argsort(live_uid, kind="stable")).to(dev)
    T_dense, dense_ms = _timed(lambda: optimize_pose_graph(st0.kfs.T_cw, st0.kfs.valid, graph,
                                                           fixed=fixed), dev)
    T_pcg, pcg_ms = _timed(lambda: optimize_pose_graph_pcg(st0.kfs.T_cw, st0.kfs.valid, graph,
                                                           fixed=fixed, chain_perm=order), dev)
    pcg_err = float(torch.linalg.norm(T_pcg[:, :3, 3] - T_dense[:, :3, 3], dim=-1)[st0.kfs.valid]
                    .max())
    pg_moved = float(torch.linalg.norm(T_dense[:, :3, 3] - st0.kfs.T_cw[:, :3, 3], dim=-1).max())
    res = dict(keyframe_slots=F, observation_slots=F * K, points=P,
               live_keyframes=int(state.kfs.valid.sum()), live_points=int(state.points.valid.sum()),
               one_iteration_pose_err=step_pose, one_iteration_point_err=step_point,
               one_iteration_pose_move=step_moved,
               global_ba_ms=gba_ms, global_ba_ms_again=gba_ms2, global_ba_cpu_copy_ms=cpu_ms,
               pose_max_abs_err=pose_err, point_max_abs_err=point_err,
               cpu_floor_pose=floor_pose, cpu_floor_point=floor_point, pose_limit=pose_lim,
               point_limit=point_lim, pose_max_move=moved,
               median_reproj_before_px=err0, median_reproj_after_px=err1,
               dense_pose_graph_ms=dense_ms, pcg_pose_graph_ms=pcg_ms,
               pcg_vs_dense_max_m=pcg_err, pose_graph_max_move_m=pg_moved)
    _log("7b global BA and pose graph at full width: " + json.dumps(res) + f"; card: {card}")
    if not (step_pose <= GBA_POSE_TOL and step_point <= GBA_POINT_TOL):
        raise AssertionError(f"7b: one global-BA iteration, card vs CPU: {step_pose:.3e} (poses, "
                             f"limit {GBA_POSE_TOL}) / {step_point:.3e} (points, limit "
                             f"{GBA_POINT_TOL})")
    if not step_moved > 5 * GBA_POSE_TOL:
        raise AssertionError(f"7b: one global-BA iteration moved no pose by {5 * GBA_POSE_TOL}: "
                             "the comparison would be vacuous")
    if not (pose_err <= pose_lim and point_err <= point_lim):
        raise AssertionError(f"7b: global BA card vs CPU differ by {pose_err:.3e} (poses, limit "
                             f"{pose_lim:.3e}) / {point_err:.3e} (points, limit {point_lim:.3e})")
    guard = cfg.loop.correction_guard_slack * err0 + 0.1
    if not (np.isfinite(err1) and err1 <= guard):
        raise AssertionError(f"7b: median reprojection error {err0:.4f} -> {err1:.4f} px, "
                             f"over the guard's {guard:.4f}")
    if not pcg_err <= PCG_POS_TOL:
        raise AssertionError(f"7b: PCG pose graph {pcg_err:.3e} m from the dense solve")
    if not pg_moved > 10 * PCG_POS_TOL:
        raise AssertionError("7b: the pose graph moved no keyframe: the comparison is vacuous")
    return res


def tracker_loop_configs(vocabulary_path, small: bool = False):
    """7c: the default config with the named vocabulary and
    `min_kfs_before_loop=6` (`test_accuracy_gates.py`'s loop run), and
    the same with loop closing and relocalization off; with `small`, 32
    keyframe slots."""
    base = SlamConfig()
    if small:
        base = base.replace(map=dataclasses.replace(base.map, max_keyframes=32))
    on = base.replace(loop=dataclasses.replace(base.loop, enabled=True,
                                               min_kfs_before_loop=LOOP_MIN_KFS,
                                               vocabulary_path=vocabulary_path))
    off = base.replace(loop=dataclasses.replace(base.loop, enabled=False,
                                                enable_relocalization=False))
    return on, off


def check_tracker_loop(dev, views: dict, vocab: str, card: str, small: bool = False) -> dict:
    """7c: `Tracker.process` on the loop circuit, loop closing on, then off."""
    seq, frames = views["seq"], views["frames"]
    n = len(frames)
    out = {}
    for name, cfg in zip(("on", "off"), tracker_loop_configs(vocab, small)):
        tracker = Tracker(cfg, device=dev)
        if name == "on" and tracker.loop_closer.vocab is None:
            raise AssertionError("7c runs without its named vocabulary")
        stage_ms = []
        _reset_counts()
        for i, (gray, depth) in enumerate(frames):
            st = tracker.metrics.stages.get("loop_closing")
            before = (st.count, st.total_s) if st is not None else (0, 0.0)
            tracker.process(gray, depth, float(seq.stamps[i]))
            st = tracker.metrics.stages.get("loop_closing")
            if st is not None and st.count > before[0]:
                stage_ms.append((st.total_s - before[1]) * 1e3)
        stages = tracker.metrics.stages
        out[name] = dict(
            ate_m=evaluate_ate_xyz(tracker.camera_positions(), seq.gt_positions()[:n]).rmse,
            status=tracker.status, keyframes=tracker.metrics.counters.get("keyframes", 0),
            loop_closing_calls=len(stage_ms), loops_closed=tracker.n_loops_closed,
            lost=tracker.metrics.counters.get("lost", 0),
            relocalizations=stages["relocalization"].count if "relocalization" in stages else 0,
            loop_closing_median_ms=statistics.median(stage_ms) if stage_ms else None,
            launches=_kernel_runs())
        _log(f"7c loop closing {name}: " + json.dumps(out[name]) + f"; card: {card}")
        if name == "on":
            _log("7c stages (Tracker.metrics, host clock):\n" + tracker.metrics.report())
    on, off = out["on"], out["off"]
    if on["status"] == "LOST":
        raise AssertionError("7c: LOST at the end with loop closing on")
    if on["loop_closing_calls"] != on["keyframes"] or on["keyframes"] < 1:
        raise AssertionError(f"7c: {on['loop_closing_calls']} loop_closing calls for "
                             f"{on['keyframes']} keyframes after the first")
    if dev.type == "cuda" and on["launches"]["window_match"] == 0:
        raise AssertionError("7c: B1 never launched")
    if JAX_7C_MEETS_GATE:
        ok, gate = on["ate_m"] < 0.75 * off["ate_m"], "ate_on < 0.75 x ate_off"
    else:
        ok, gate = on["ate_m"] <= off["ate_m"] + ATE_SLACK, f"ate_on <= ate_off + {ATE_SLACK}"
    _log(f"7c ATE gate ({gate}): on {on['ate_m']:.6f} m, off {off['ate_m']:.6f} m")
    if not ok:
        raise AssertionError(f"7c: ATE gate {gate} missed: on {on['ate_m']:.6f}, "
                             f"off {off['ate_m']:.6f}")
    return out


def run_loop_path(dev, views: dict, card: str, small: bool = False) -> dict:
    """Phase 7: loop closing on the card, on the named vocabulary (a
    missing-vocabulary warning is an error here)."""
    t0 = time.perf_counter()
    with warnings.catch_warnings():
        warnings.filterwarnings("error", message="trained artifact")
        vocab = named_vocabulary(Path(__file__).resolve().parent / "build" / "reloc_vocab")
        _log(f"loop closing: named vocabulary {vocab} (seed {RELOC_VOCAB_SEED})")
        closure = check_closure(dev, views, vocab, card, small)
        gba = check_global_ba_and_pose_graph(dev, closure, card)
        track = check_tracker_loop(dev, views, vocab, card, small)
    closure_map = dict(cfg=closure.pop("cfg"), state=closure.pop("run")["snap"]["after"])
    res = dict(closure=closure, global_ba=gba, tracker=track, phase_s=time.perf_counter() - t0,
               closure_map=closure_map,
               b1_launches=closure["b1_launches_in_on_keyframe"]
               + track["on"]["launches"]["window_match"])
    _log(f"phase 7 took {res['phase_s']:.1f} s; B1 launched {res['b1_launches']} times in it; "
         f"card: {card}")
    return res


# ---- phase 8: the whole-sequence path ------------------------------------------

def _centres(T: np.ndarray) -> np.ndarray:
    return np.einsum("nji,nj->ni", T[:, :3, :3], -T[:, :3, 3])


def _kf_frames(n_kfs) -> list:
    """Frames (1-based after frame 0) at which the keyframe count grew."""
    n_kfs = list(n_kfs)
    return [i + 1 for i in range(len(n_kfs)) if n_kfs[i] != (n_kfs[i - 1] if i else 1)]


def run_scan_path(dev, main_res: dict, card: str) -> dict:
    """8a: `track_sequence` on phase 4's frames with phase 4's config,
    held against phase 4's `Tracker.process`, as is a second `process` run
    on its first AGAIN_FRAMES frames (deterministic kernels: both repeat phase 4); then the frames up to phase 4's profiled
    window again, one at a time through `init_scan` and
    `track_sequence_scan`, for the per-frame time and, on the card, the
    launches and syncs a steady frame."""
    seq, frames, *_ = main_res["rendered"]
    tracker, poses = main_res["tracker"], main_res["poses"]
    cfg = main_path_config()
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    grays = np.stack([g for g, _ in frames])
    depths = np.stack([d for _, d in frames])
    n = len(frames)
    _reset_counts()
    sync()
    t = time.perf_counter()
    T_all, state, stats = scan_tracker.track_sequence(grays, depths, cfg, device=dev)
    sync()
    wall_s = time.perf_counter() - t
    counts = _path_launches("8a: the scan", dev)
    body_runs = _body_totals()
    branches = counts["track_branches"]
    runs = counts["launches"]
    status_scan = [("OK", "WEAK", "LOST")[int(c)] for c in stats[:, 0]]
    status_proc = [st["status"] for st in tracker.stats[1:]]
    kf_scan = _kf_frames(stats[:, 2])
    lm_scan = [f for f in kf_scan if stats[f - 1, 2] >= 3]
    kf_proc = [i for i in range(1, len(tracker.stats))
               if tracker.stats[i]["kfs"] != tracker.stats[i - 1]["kfs"]]
    pos_diff = np.linalg.norm(_centres(T_all) - _centres(poses), axis=1)
    pos_err = float(pos_diff.max())
    ate = evaluate_ate_xyz(_centres(T_all), seq.gt_positions()[:n]).rmse

    # The card's own spread: `Tracker.process` again on the first
    # AGAIN_FRAMES frames.
    again = Tracker(cfg, device=dev)
    poses2, again_ms = [], []
    for i, (gray, depth) in enumerate(frames[:AGAIN_FRAMES]):
        sync()
        t = time.perf_counter()
        poses2.append(again.process(gray, depth, float(seq.stamps[i])))
        sync()
        again_ms.append((time.perf_counter() - t) * 1e3)
    spread = float(np.linalg.norm(_centres(np.stack(poses2)) - _centres(poses[:len(poses2)]),
                                  axis=1).max())

    # The replay: frame by frame, the window profiled on the card.
    n_replay = min(PROFILE_FRAMES[-1] + 1, n)
    profiled = PROFILE_FRAMES if dev.type == "cuda" and n_replay > PROFILE_FRAMES[-1] else range(0)
    g_dev = torch.from_numpy(grays[:n_replay]).to(dev)
    d_dev = torch.from_numpy(depths[:n_replay]).to(dev)
    carry = scan_tracker.init_scan(map_state.empty_state(cfg, dev), g_dev[0], d_dev[0], cfg)
    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                              torch.profiler.ProfilerActivity.CUDA]
                                  ) if len(profiled) else None
    frame_ms, dispatch_ms = [], []
    for i in range(1, n_replay):
        if i == profiled.start:
            window_before = _tally()
            prof.start()
        sync()
        t = time.perf_counter()
        carry, *_ = scan_tracker.track_sequence_scan(carry, g_dev[i:i + 1], d_dev[i:i + 1], cfg)
        t_dispatch = time.perf_counter()
        sync()
        if i not in profiled:
            frame_ms.append((time.perf_counter() - t) * 1e3)
            dispatch_ms.append((t_dispatch - t) * 1e3)
        if len(profiled) and i == profiled[-1]:
            prof.stop()
            window_since = _since(window_before)
            window_runs, window_branches = _kernel_runs(window_since), window_since["track"]
    proc_ms = main_res["frame_ms"][1:n_replay - len(profiled)]
    res = dict(frames=n, wall_s=wall_s, mean_frame_ms=wall_s * 1e3 / (n - 1),
               process_mean_frame_ms=main_res["mean_frame_ms"],
               process_again_mean_frame_ms=statistics.mean(again_ms[1:]), **counts,
               keyframe_frames=kf_scan, local_mapping_frames=lm_scan,
               inserted=int(state.next_uid) - 1, body_runs=body_runs,
               max_position_diff_m=pos_err,
               max_position_diff_frame=int(np.argmax(pos_diff)), process_spread_m=spread,
               position_limit_m=SCAN_POS_TOL, ate_m=ate,
               replay_frames=len(frame_ms), replay_median_frame_ms=statistics.median(frame_ms),
               replay_median_dispatch_ms=statistics.median(dispatch_ms),
               process_median_frame_ms_same_frames=statistics.median(proc_ms),
               process_again_median_frame_ms_same_frames=statistics.median(
                   again_ms[1:1 + len(frame_ms)]),
               b1_launches_per_frame=runs["window_match"] / (n - 1))
    if len(profiled):
        res["profile"] = _device_breakdown(prof, len(profiled), res["replay_median_frame_ms"])
        res["profile"].update(launches=window_runs, track_branches=window_branches,
                              traced=_traced_launches(prof))
        res["process_profile"] = main_res.get("profile")
    _log("8a scan vs Tracker.process: " + json.dumps(res) + f"; card: {card}")
    if status_scan != status_proc:
        raise AssertionError(f"8a: per-frame statuses differ: scan {status_scan}, process "
                             f"{status_proc}")
    if kf_scan != kf_proc:
        raise AssertionError(f"8a: keyframes at {kf_scan} in the scan, {kf_proc} in process")
    if not pos_err <= SCAN_POS_TOL:
        raise AssertionError(f"8a: camera positions {pos_err:.3e} m from process's (limit "
                             f"{SCAN_POS_TOL:.0e}; a second process run: {spread:.3e})")
    if not spread <= SCAN_POS_TOL:
        raise AssertionError(f"8a: a second process run {spread:.3e} m from the first (limit "
                             f"{SCAN_POS_TOL:.0e})")
    if not ate < 0.01:
        raise AssertionError(f"8a: scan ATE {ate:.5f} m >= 0.01 m")
    if dev.type == "cuda":
        _check_bodies("8a", body_runs, n - 1, res["inserted"], len(lm_scan))
        if branches["replays"] != n - 1:
            raise AssertionError(f"8a: the tracking graph's bodies ran {branches} in {n - 1} "
                                 "frames: one of the retry's two a frame expected")
    if len(profiled):
        # The steady window: B1 twice a replay and once a retry, no fallback.
        want = 2 * len(profiled) + window_branches["retry"]
        if window_branches["fallback"] or window_runs["window_match"] != want:
            raise AssertionError(f"8a: the steady window ran B1 {window_runs['window_match']} "
                                 f"times ({want} expected) and the branches {window_branches}")
        _check_traced(f"8a: the scan's frames {profiled.start}-{profiled[-1]}",
                      res["profile"]["traced"], window_runs)
    return res


def _by_graph_launch(events, device: list) -> list:
    """The events of `device` that each `cudaGraphLaunch` in `events` ran,
    in launch order, matched by the launch's correlation id."""
    launches = sorted((e for e in events if e.device_type() == torch.autograd.DeviceType.CPU
                       and e.name() == "cudaGraphLaunch"), key=lambda e: e.start_ns())
    for key in ("correlation_id", "linked_correlation_id"):
        by_id = {}
        for e in device:
            by_id.setdefault(getattr(e, key)(), []).append(e)
        out = [by_id.get(e.correlation_id(), []) for e in launches]
        if sum(map(len, out)) >= len(device) // 2:
            return out
    raise AssertionError(f"8c: the trace ties no device event to its graph launch "
                         f"({len(launches)} launches, {len(device)} device events)")


def _bodies_by_kind(graph: GraphedStep) -> dict:
    """A graph's body runs by its counter on the card, summed by
    `_body_kind`."""
    out = {}
    for body, n in zip(graph.bodies, graph.body_runs[:len(graph.bodies)].tolist()):
        key = _body_kind(body)
        out[key] = out.get(key, 0) + n
    return out


def _check_bodies(label: str, runs: dict, frames: int, inserted: int, mapped: int) -> None:
    """Raise unless the keyframe branch's conditional bodies ran as the
    frames took them, by their counters on the card: the keyframe body on
    the `inserted` of `frames` frames and the other outer body on the
    rest; inside it local mapping's body on `mapped` of the insertions and
    its other body on the rest."""
    want = {"d0_True": inserted, "d0_False": frames - inserted, "d1_True": mapped,
            "d1_False": inserted - mapped}
    if runs != want:
        raise AssertionError(f"{label}: the branch's bodies ran {runs}, {want} expected")


def _timed_calls(runner, out: list) -> None:
    """Make `runner.step` (on this instance only) append each call's host ms
    to `out`; `del runner.step` undoes it."""
    step = runner.step

    def timed(*args, **kwargs):
        t = time.perf_counter()
        try:
            return step(*args, **kwargs)
        finally:
            out.append((time.perf_counter() - t) * 1e3)

    runner.step = timed


def check_scan_trace(dev, rendered, card: str, fresh: bool = True) -> dict:
    """8c: phase 4's frames SCAN_TRACE_FRAMES as one segment under the
    profiler (`track_sequence_scan` with `with_rel`, then the segmented
    runner's pack and fetch), from a carry that tracked the frames before
    them, with the same segment untraced before and after the trace, each
    runner's step call timed and each graph's `replay()` alone. Holds the trace to one
    device-to-host copy and one wait, and the branch's conditional bodies
    by their counters to the frames that took them, the tracking graph's
    to one retry body a frame and no fallback. In a process of its own
    (`fresh`, `run_scan_trace`) also two graph launches a frame and B1's
    traced runs: 2 in each tracking replay and 1 more where the retry body
    ran (3 in all before the retry was a conditional body), as many as its
    counter says, 20 in the keyframe branch exactly where local mapping
    ran. In the script's process, after the
    profiler sessions of the phases before, the trace's B1 count and its
    ties of kernels to launches are logged, not held."""
    from orb_slam2_ssd_semantic_tpu_torch.tracking import segmented as seg_mod

    _, frames, *_ = rendered
    cfg = main_path_config()
    lo, hi = SCAN_TRACE_FRAMES.start, SCAN_TRACE_FRAMES.stop
    g = torch.from_numpy(np.stack([a for a, _ in frames[:hi]])).to(dev)
    d = torch.from_numpy(np.stack([b for _, b in frames[:hi]])).to(dev)
    carry = scan_tracker.init_scan(map_state.empty_state(cfg, dev), g[0], d[0], cfg)
    carry, *_ = scan_tracker.track_sequence_scan(carry, g[1:lo], d[1:lo], cfg, with_rel=True)
    n_kfs_before = int(carry.state.n_kfs)
    branch_graph = carry.branch.graphs()[-1]
    branch = carry.branch.stats(cfg, None, False, True)
    track_graph = carry.track.graphs()[-1]
    torch.cuda.synchronize()
    mem_before = torch.cuda.memory_allocated(dev)
    n = hi - lo

    def segment():
        t0 = time.perf_counter()
        out, T, stats, rel, uid = scan_tracker.track_sequence_scan(carry, g[lo:hi], d[lo:hi],
                                                                   cfg, with_rel=True)
        t_dispatch = time.perf_counter() - t0
        kfs = out.state.kfs
        packed = seg_mod._fetch(*seg_mod._start_fetch(seg_mod._pack_segment(
            T, stats, rel, uid, kfs.uid, kfs.valid, kfs.frame_id)))
        return packed, t_dispatch * 1e3 / n, (time.perf_counter() - t0) * 1e3 / n

    runners = {"track": carry.track, "branch": carry.branch}

    def timed_segment() -> dict:
        """The segment untraced, each runner's step call timed; then each
        graph's `replay()` alone, the card idle before each."""
        step_ms = {"track": [], "branch": []}
        for name, runner in runners.items():
            _timed_calls(runner, step_ms[name])
        try:
            _, dispatch_ms, wall_ms = segment()
        finally:
            for runner in runners.values():
                del runner.step
        replay_ms = {}
        for name, runner in runners.items():
            graph, ms = runner.graphs()[-1].graph, []
            for _ in range(10):
                torch.cuda.synchronize()
                t = time.perf_counter()
                graph.replay()
                ms.append((time.perf_counter() - t) * 1e3)
            torch.cuda.synchronize()
            replay_ms[name] = statistics.median(ms)
        return dict(host_dispatch_ms_per_frame=dispatch_ms, wall_ms_per_frame=wall_ms,
                    step_host_ms={f"{k}_median": statistics.median(v) for k, v in step_ms.items()}
                    | {f"{k}_max": max(v) for k, v in step_ms.items()},
                    replay_alone_host_ms=replay_ms)

    # Timed untraced first: once a profiler session has run in a process,
    # a graph's launch costs the host milliseconds more (`replay_alone_host_ms`
    # against `untraced_after_trace`'s), so that timing is kept apart.
    untraced = timed_segment()
    branch_graph.body_runs.zero_()
    track_graph.body_runs.zero_()
    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                              torch.profiler.ProfilerActivity.CUDA])
    prof.start()
    with torch.profiler.record_function("scan.segment"):
        packed, traced_dispatch_ms, traced_wall_ms = segment()
    prof.stop()
    body_runs = _bodies_by_kind(branch_graph)
    branches = _track_branches(_bodies_by_kind(track_graph))
    after_trace = timed_segment()
    n_kfs = packed[n * 16 + 2:n * 20:4].astype(np.int64)
    grew = np.diff(np.concatenate([[n_kfs_before], n_kfs])) > 0
    kf_frames = [lo + int(i) for i in np.nonzero(grew)[0]]
    lm_frames = [lo + int(i) for i in np.nonzero(grew & (n_kfs >= 3))[0]]

    events = prof.profiler.kineto_results.events()
    cuda = torch.autograd.DeviceType.CUDA
    # Waits from the segment's dispatch to its fetch's end (the profiler's
    # own stop synchronizes after), and the device's work from then on.
    a, b = next((e.start_ns(), e.end_ns()) for e in events if e.name() == "scan.segment"
                and e.device_type() == torch.autograd.DeviceType.CPU)
    waits = {}
    for e in events:
        if e.name() in _SYNC_CALLS and a <= e.start_ns() <= b:
            waits[e.name()] = waits.get(e.name(), 0) + 1
    device = [e for e in events if e.device_type() == cuda and e.name() not in _HOST_RANGES
              and e.start_ns() >= a]
    copies = {}
    for e in device:
        if e.name().startswith("Memcpy"):
            kind = e.name().split()[1]
            copies[kind] = copies.get(kind, 0) + 1
    b1 = _TRACED_KERNELS["window_match"]

    def kernels(evs):
        return [e for e in evs if not e.name().startswith(("Memcpy", "Memset"))]

    per_frame, tie_error = [], None
    try:
        per_launch = _by_graph_launch(events, device)
        if len(per_launch) != 2 * n:
            raise AssertionError(f"8c: {len(per_launch)} graph launches for {n} frames, not two "
                                 "a frame")
        for i in range(n):
            track, br = per_launch[2 * i], per_launch[2 * i + 1]
            per_frame.append(dict(
                frame=lo + i, track_kernels=len(kernels(track)),
                track_b1=sum(1 for e in track if b1 in e.name()),
                branch_kernels=len(kernels(br)), branch_b1=sum(1 for e in br if b1 in e.name()),
                branch_ms=sum(e.duration_ns() for e in kernels(br)) / 1e6))
    except AssertionError as e:
        if fresh:
            raise
        tie_error = str(e)
    runtime = _runtime_in(prof)
    traced = {key: sum(1 for e in device if name in e.name())
              for key, name in _TRACED_KERNELS.items()}
    bad = [f for f in per_frame if f["track_b1"] not in (2, 3)
           or f["branch_b1"] != (20 if f["frame"] in lm_frames else 0)]
    track_b1 = sum(f["track_b1"] for f in per_frame)
    want = 2 * n + branches["retry"] + 20 * len(lm_frames)
    res = dict(
        fresh_process=fresh, frames=[lo, hi - 1], keyframe_frames=kf_frames,
        local_mapping_frames=lm_frames, body_runs=body_runs, track_branches=branches,
        track_b1=track_b1, waits=waits, device_copies=copies,
        graph_launches_per_frame=runtime.get("cudaGraphLaunch", 0) / n,
        copies_per_frame=runtime.get("cudaMemcpyAsync", 0) / n,
        kernel_launches_per_frame=runtime.get("cudaLaunchKernel", 0) / n,
        kernels_per_frame=len(kernels(device)) / n,
        device_busy_ms_per_frame=sum(e.duration_ns() for e in kernels(device)) / 1e6 / n,
        **untraced, untraced_after_trace=after_trace,
        traced_host_dispatch_ms_per_frame=traced_dispatch_ms,
        traced_wall_ms_per_frame=traced_wall_ms, traced=traced, traced_b1_expected=want,
        frames_off_b1_count=[f["frame"] for f in bad], tie_error=tie_error,
        memory_growth_mib=(torch.cuda.memory_allocated(dev) - mem_before) / 2**20,
        branch_graph=dict(capture_ms=branch["capture_ms"],
                          pool_mib=branch["pool_bytes"] / 2**20,
                          upload_ms=branch["upload_ms"], conditional=branch["conditional"],
                          captured=branch["captured"], bodies=branch["bodies"]),
        per_frame=[f for f in per_frame if f["frame"] in kf_frames or f["frame"] in (lo, hi - 1)],
        branch_kernels_not_keyframe=sorted({f["branch_kernels"] for f in per_frame
                                            if f["frame"] not in kf_frames}))
    where = "in a process of its own" if fresh else "in the script's process"
    _log(f"8c the scan's segment traced whole, {where}: " + json.dumps(res) + f"; card: {card}")
    if waits != {"cudaEventSynchronize": 1} or copies.get("DtoH") != 1 or copies.get("HtoD"):
        raise AssertionError(f"8c: the segment waited {waits} and copied {copies}, not one wait "
                             "and one device-to-host copy (the fetch)")
    if len(kf_frames) < 2 or not lm_frames:
        raise AssertionError(f"8c: keyframes at {kf_frames}, local mapping at {lm_frames}: "
                             "vacuous")
    _check_bodies(f"8c {where}", body_runs, n, len(kf_frames), len(lm_frames))
    if branches["replays"] != n or branches["fallback"]:
        raise AssertionError(f"8c {where}: the tracking graph's bodies ran {branches} in {n} "
                             "steady frames: one retry body a frame and no fallback expected")
    if not fresh:
        return res
    if bad or track_b1 != 2 * n + branches["retry"]:
        raise AssertionError(f"8c: B1 ran off its count in {bad}, {track_b1} times in the "
                             f"tracking replays, where the retry body ran {branches['retry']}")
    if traced["window_match"] != want or traced["window_match_merge"] != want:
        raise AssertionError(f"8c: the trace ran B1 {traced}, {want} expected")
    if len(res["branch_kernels_not_keyframe"]) != 1:
        raise AssertionError(f"8c: the branch ran {res['branch_kernels_not_keyframe']} kernels "
                             "on frames without a keyframe: one count expected")
    return res


def _scan_trace_child(frames, card: str) -> dict:
    return check_scan_trace(torch.device("cuda"), (None, frames), card)


def run_scan_trace(rendered, card: str) -> dict:
    """8c in a process of its own: after the profiler sessions of the
    phases before, the script's own process traced kernels that no launch
    of this segment ran (`check_scan_trace(..., fresh=False)` logs how
    many); a fresh process traces cleanly."""
    with multiprocessing.get_context("spawn").Pool(1) as pool:
        return pool.apply(_scan_trace_child, (rendered[1][:SCAN_TRACE_FRAMES.stop], card))


def bench_config(vocabulary_path, cam: CameraConfig | None = None) -> SlamConfig:
    """`bench.py`'s widths (`th_depth=80`, 128 keyframes, 16,384 points,
    1536 local-map candidates) on the named vocabulary, at `cam` (640x480
    by default)."""
    base = SlamConfig()
    cam = cam or base.camera
    return base.replace(
        camera=dataclasses.replace(cam, th_depth=80.0),
        map=dataclasses.replace(base.map, max_keyframes=128, max_map_points=16384),
        tracking=dataclasses.replace(base.tracking, local_map_candidates=1536),
        loop=dataclasses.replace(base.loop, vocabulary_path=vocabulary_path))


def segmented_config(vocabulary_path, cam: CameraConfig | None = None) -> SlamConfig:
    """`bench_config` with `tests/test_segmented.py`'s
    `max_frames_between_kfs=8` and `min_kfs_before_loop=6`, loop closing
    on."""
    cfg = bench_config(vocabulary_path, cam)
    return cfg.replace(
        tracking=dataclasses.replace(cfg.tracking, max_frames_between_kfs=8),
        loop=dataclasses.replace(cfg.loop, enabled=True, min_kfs_before_loop=6))


class AgreeingCloser(LoopCloser):
    """8b's first run: every loop-transform estimate is the map's current
    relative pose (an implied correction D = 0, so every two estimates
    agree), and the real `_correct`, whose minimum-discrepancy gate the
    run's config sets to 0 (it would refuse a D = 0 loop)."""

    def __init__(self, cfg: SlamConfig, device):
        super().__init__(cfg, device=device)
        self.calls = 0
        # (kf, cand, T_ji, state before, state after) of each accepted correction
        self.applied = []

    def _estimate_loop_transform(self, state, kf_id: int, cand: int):
        self.calls += 1
        T = state.kfs.T_cw.cpu().numpy()
        return True, (T[kf_id] @ np.linalg.inv(T[cand])).astype(np.float32), 0

    def _correct(self, state, kf_id: int, cand: int, T_ji):
        out, accepted = super()._correct(state, kf_id, cand, T_ji)
        if accepted:
            self.applied.append((kf_id, cand, T_ji, state, out))
        return out, accepted


class DisagreeingCloser(LoopCloser):
    """8b's second run, `tests/test_segmented.py::_StubCloser`: estimates
    whose implied corrections alternate between SEG_DISAGREE's two, and a
    no-op `_correct`."""

    def __init__(self, cfg: SlamConfig, device):
        super().__init__(cfg, device=device)
        self.calls = 0

    def _estimate_loop_transform(self, state, kf_id: int, cand: int):
        T = state.kfs.T_cw.cpu().numpy()
        D = np.eye(4, dtype=np.float32)
        D[:3, 3] = SEG_DISAGREE[self.calls % len(SEG_DISAGREE)]
        self.calls += 1
        return True, (D @ T[kf_id] @ np.linalg.inv(T[cand])).astype(np.float32), 0

    def _correct(self, state, kf_id: int, cand: int, T_ji):
        return state, True


def _correction_effect(res, closer: AgreeingCloser, gt: np.ndarray) -> list:
    """Per applied correction: the resolved ATE of the frames tracked
    before it (up to the end of its segment) against the keyframe poses
    before `_correct`, after it, and after the same correction applied to
    a CPU copy of the state; the largest keyframe-pose difference between
    the two corrections, and each one's host time."""
    if len(closer.applied) != len(res.corrections):
        raise AssertionError(f"8b: {len(closer.applied)} corrections accepted by `_correct`, "
                             f"{len(res.corrections)} applied")
    cpu = torch.device("cpu")
    cpu_closer = LoopCloser(closer.cfg, device=cpu)
    out = []
    for (frame, *_), (kf, cand, T_ji, before, after) in zip(res.corrections, closer.applied):
        t = time.perf_counter()
        after_cpu, accepted = cpu_closer._correct(
            map_state.state_from_numpy(map_state.state_to_numpy(before), cpu), kf, cand, T_ji)
        cpu_s = time.perf_counter() - t
        if not accepted:
            raise AssertionError(f"8b: the CPU copy refused the correction at frame {frame}")
        hi = 1 + ((frame - 1) // SEG_LEN + 1) * SEG_LEN
        ate = {}
        for key, st in (("before", before), ("after", after), ("after_cpu", after_cpu)):
            part = res._replace(carry=SimpleNamespace(state=st), traj=res.traj[:hi])
            ate[key] = evaluate_ate_xyz(resolve_trajectory(part), gt[:hi]).rmse
        live = after.kfs.valid.cpu()
        pose_diff = float((after.kfs.T_cw.cpu()[live] - after_cpu.kfs.T_cw[live]).abs().max())
        out.append(dict(frame=frame, up_to_frame=hi - 1, ate_before_m=ate["before"],
                        ate_after_m=ate["after"], ate_after_cpu_copy_m=ate["after_cpu"],
                        pose_max_diff_vs_cpu_copy=pose_diff, cpu_copy_s=cpu_s))
    return out


def _check_segmented_bodies(name: str, r: dict) -> None:
    """Raise unless one 8b run's keyframe-branch bodies, by their counters
    on the card, ran once a dispatched frame (a re-dispatched segment's
    frames twice), the nested ones once a keyframe body, and the keyframe
    body on every insertion the final map counts: exactly that many
    without a re-dispatch, at least that many with one (a discarded
    segment's insertions are not in the final map); and the tracking
    graph's retry conds once a dispatched frame."""
    runs = r["body_runs"]
    dispatched = (r["frames"] // SEG_LEN + r["re_dispatches"]) * SEG_LEN
    kf = runs.get("d0_True", 0)
    if (kf + runs.get("d0_False", 0) != dispatched
            or r["track_branches"]["replays"] != dispatched
            or runs.get("d1_True", 0) + runs.get("d1_False", 0) != kf
            or kf < r["inserted"] or (not r["re_dispatches"] and kf != r["inserted"])):
        raise AssertionError(f"8b {name}: the branch's bodies ran {runs}, the tracking graph's "
                             f"{r['track_branches']}, over {dispatched} dispatched frames and "
                             f"{r['inserted']} insertions in the final map")


def run_segmented_path(dev, views: dict, card: str, cam: CameraConfig | None = None) -> dict:
    """8b: the segmented runner three times on phase 8b's circuit (a
    missing-vocabulary warning is an error here). Returns the runs and
    the kernels' launches over all three."""
    seq, frames = views["seq"], views["frames"]
    g = torch.from_numpy(np.stack([a for a, _ in frames])).to(dev)
    d = torch.from_numpy(np.stack([b for _, b in frames])).to(dev)
    gt = seq.gt_positions()[:len(frames)]
    runs = {}
    with warnings.catch_warnings():
        warnings.filterwarnings("error", message="trained artifact")
        vocab_path = named_vocabulary(Path(__file__).resolve().parent / "build" / "reloc_vocab")
        va = scan_tracker.VocabArrays.from_vocabulary(voc.load_binary(vocab_path), dev)
        cfg = segmented_config(vocab_path, cam)
        cfg_agree = cfg.replace(loop=dataclasses.replace(
            cfg.loop, min_correction_translation=0.0, min_correction_rotation_deg=0.0))
        _reset_counts()
        for name, run_cfg, closer in (
                ("agree", cfg_agree, AgreeingCloser(cfg_agree, dev)),
                ("disagree", cfg, DisagreeingCloser(cfg, dev)),
                ("plain", cfg, LoopCloser(cfg, device=dev))):
            if closer.vocab is None:
                raise AssertionError("8b runs without its named vocabulary")
            mem0 = 0
            if dev.type == "cuda":
                torch.cuda.reset_peak_memory_stats(dev)
                mem0 = torch.cuda.memory_allocated(dev)
            bodies_before = _body_totals()
            track_before = _body_totals("TrackStepRunner")
            t = time.perf_counter()
            res = track_sequence_segmented(g, d, run_cfg, vocab=va, segment_len=SEG_LEN,
                                           loop_closer=closer, device=dev)
            wall_s = time.perf_counter() - t
            body_runs = {k: v - bodies_before.get(k, 0) for k, v in _body_totals().items()}
            track_branches = _track_branches({
                k: v - track_before.get(k, 0)
                for k, v in _body_totals("TrackStepRunner").items()})
            n = len(frames) - 1
            n_seg = n // SEG_LEN
            runs[name] = dict(
                frames=n, body_runs=body_runs, track_branches=track_branches,
                inserted=int(res.carry.state.next_uid) - 1,
                n_loop_events=res.n_loop_events,
                event_frames=[int(i) + 1 for i in np.nonzero(res.stats[:, 3] >= 0)[0]],
                corrections=[[int(c[0]), int(c[1]), int(c[2])] for c in res.corrections],
                correction_wall_s=[float(c[3]) for c in res.corrections],
                # a correction before the last segment queues the next again
                re_dispatches=sum(1 for c in res.corrections if (c[0] - 1) // SEG_LEN < n_seg - 1),
                peak_mib_over_start=(torch.cuda.max_memory_allocated(dev) - mem0) / 2**20
                if dev.type == "cuda" else None,
                verifier_calls=getattr(closer, "calls", None),
                not_ok=int((res.stats[:, 0] != 0).sum()), n_kfs_end=int(res.stats[-1, 2]),
                ate_raw_m=evaluate_ate_xyz(_centres(res.T_all), gt).rmse,
                ate_resolved_m=evaluate_ate_xyz(resolve_trajectory(res), gt).rmse,
                wall_s=wall_s, scan_s=res.scan_s, correct_s=res.correct_s,
                fps_wall=n / wall_s, fps_without_correct=n / max(wall_s - res.correct_s, 1e-9))
            if name == "agree":
                runs[name]["correction_effect"] = _correction_effect(res, closer, gt)
            _log(f"8b {name}: " + json.dumps(runs[name]) + f"; card: {card}")
        counts = _path_launches("8b: the segmented runs", dev)
    agree, disagree, plain = runs["agree"], runs["disagree"], runs["plain"]
    for name, r in runs.items():
        if dev.type == "cuda":
            _check_segmented_bodies(name, r)
        if r["not_ok"]:
            raise AssertionError(f"8b {name}: {r['not_ok']} frames not OK")
        if not r["ate_resolved_m"] < SEG_ATE_GATE:
            raise AssertionError(f"8b {name}: resolved ATE {r['ate_resolved_m']:.4f} m >= "
                                 f"{SEG_ATE_GATE}")
    if not (agree["n_loop_events"] >= SEG_MIN_EVENTS
            and len(agree["corrections"]) >= SEG_MIN_CORRECTIONS):
        raise AssertionError(f"8b agree: {agree['n_loop_events']} events, "
                             f"{len(agree['corrections'])} corrections (wanted >= "
                             f"{SEG_MIN_EVENTS}, >= {SEG_MIN_CORRECTIONS})")
    if disagree["corrections"] or disagree["n_loop_events"] < SEG_MIN_EVENTS \
            or disagree["verifier_calls"] < 2:
        raise AssertionError(f"8b disagree: {disagree['corrections']} corrections after "
                             f"{disagree['n_loop_events']} events and "
                             f"{disagree['verifier_calls']} estimates (wanted none after >= 2)")
    _log(f"8b resolved ATE over the run: with corrections {agree['ate_resolved_m']:.6f} m, "
         f"plain {plain['ate_resolved_m']:.6f} m, disagreeing estimates "
         f"{disagree['ate_resolved_m']:.6f} m (logged, not gated)")
    for e in agree["correction_effect"]:
        if not abs(e["ate_after_m"] - e["ate_after_cpu_copy_m"]) <= SEG_EFFECT_TOL:
            raise AssertionError(f"8b: after the correction at frame {e['frame']} frames "
                                 f"0-{e['up_to_frame']} resolve to {e['ate_after_m']:.5f} m on the "
                                 f"card, {e['ate_after_cpu_copy_m']:.5f} m on a CPU copy (limit "
                                 f"{SEG_EFFECT_TOL})")
    return dict(runs=runs, **counts)


# ---- phase 9: the dynamic masks and the device renderer ---------------------

_DYN9 = None


def _dyn9_init(cam: CameraConfig) -> None:
    global _DYN9
    _DYN9 = {"static": SyntheticSequence(n_frames=DYN_FRAMES, cam=cam),
             "dynamic": SyntheticSequence(n_frames=DYN_FRAMES, cam=cam, dynamic_objects=True,
                                          n_dynamic=2)}


def _dyn9_render(task):
    kind, i = task
    return _DYN9[kind].gray_depth(i)


def walker_scene(n_frames: int):
    """`bench.py`'s `sway_dyn` scene, its first `n_frames` frames: (the
    sequence, camera-to-world poses (n, 4, 4), `render_frames` keywords)."""
    seq = SyntheticSequence(n_frames=WALK_SEQ_FRAMES, trajectory="sway")
    poses = np.stack(seq.poses_wc).astype(np.float32)[:n_frames]
    walkers = cross_walkers(WALK_SEQ_FRAMES, seq.room.size, n_objects=3)[:n_frames]
    boxes = tuple(tuple(map(tuple, b)) for b in seq.room.boxes)
    return seq, poses, dict(size=seq.room.size, boxes=boxes, seed=seq.seed, moving_boxes=walkers)


def check_render(dev, cam: CameraConfig, n_frames: int, card: str) -> dict:
    """9a: the walker scene on the card (with depth noise), the time a
    frame, and RENDER_CHECK_FRAMES without noise against the CPU."""
    seq, poses, kw = walker_scene(n_frames)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    sync()
    t = time.perf_counter()
    g, d = device_render.render_frames(poses, cam, depth_noise=WALK_NOISE, device=dev, **kw)
    sync()
    render_s = time.perf_counter() - t
    pick = list(RENDER_CHECK_FRAMES)
    sub = dict(kw, moving_boxes=kw["moving_boxes"][pick])
    g_dev, d_dev = device_render.render_frames(poses[pick], cam, device=dev, **sub)
    g_cpu, d_cpu = device_render.render_frames(poses[pick], cam, device="cpu", **sub)
    dd = (d_dev.cpu().to(torch.int64) - d_cpu.to(torch.int64)).abs()
    dg = (g_dev.cpu().to(torch.int64) - g_cpu.to(torch.int64)).abs()
    res = dict(frames=n_frames, ms_per_frame=render_s * 1e3 / n_frames,
               depth_within_1mm=float((dd <= 1).double().mean()),
               gray_within_1=float((dg <= 1).double().mean()),
               gray_equal=float((dg == 0).double().mean()),
               moving_pixels_frame0=int(((d_dev[0].cpu() != device_render.render_frames(
                   poses[:1], cam, device=dev, **dict(kw, moving_boxes=None))[1][0].cpu()))
                   .sum()))
    _log("9a device render: " + json.dumps(res) + f"; card: {card}")
    if g.shape != (n_frames, cam.height, cam.width) or g.dtype != torch.uint8 \
            or d.dtype != torch.uint16:
        raise AssertionError(f"9a: rendered {tuple(g.shape)} {g.dtype}/{d.dtype}")
    if not res["depth_within_1mm"] >= RENDER_DEPTH_MIN:
        raise AssertionError(f"9a: depth within 1 mm of the CPU on {res['depth_within_1mm']:.5f} "
                             f"of pixels < {RENDER_DEPTH_MIN}")
    if not res["gray_within_1"] >= RENDER_GRAY_MIN:
        raise AssertionError(f"9a: gray within 1 level of the CPU on {res['gray_within_1']:.5f} "
                             f"of pixels < {RENDER_GRAY_MIN}")
    if res["moving_pixels_frame0"] == 0:
        raise AssertionError("9a: no walker in view in frame 0")
    return dict(res=res, seq=seq, grays=g, depths=d)


def _eig_gaps(lam: torch.Tensor) -> torch.Tensor:
    """Each eigenvalue's distance to the nearest other over the largest
    magnitude, for ascending eigenvalues (..., n)."""
    d = lam[..., 1:] - lam[..., :-1]
    inf = torch.full_like(lam[..., :1], float("inf"))
    return (torch.minimum(torch.cat([inf, d], -1), torch.cat([d, inf], -1))
            / lam.abs().amax(-1, keepdim=True))


def degenerate_minimal_sets(dev, seed: int = 5):
    """Normalised 4-point sets, 16 with a repeated row (sets are drawn with
    replacement), 16 with three collinear points and 16 well-posed ones (a
    jittered square), mapped by a fixed homography with 1e-3 of noise:
    `_dlt`'s (src, dst, w) for the batch (48, 4)."""
    rng = np.random.default_rng(seed)
    src = rng.standard_normal((48, 4, 2)).astype(np.float32)
    square = np.array([[-1, -1], [1, -1], [1, 1], [-1, 1]], np.float32)
    src[32:] = square + 0.2 * rng.standard_normal((16, 4, 2)).astype(np.float32)
    src[:16, 3] = src[:16, 1]
    t = rng.random((16, 1)).astype(np.float32)
    src[16:32, 2] = src[16:32, 0] + t * (src[16:32, 1] - src[16:32, 0])
    H = np.array([[1.02, 0.03, 0.1], [-0.02, 0.98, -0.05], [0.01, -0.02, 1.0]], np.float32)
    ph = np.concatenate([src, np.ones((48, 4, 1), np.float32)], -1) @ H.T
    dst = (ph[..., :2] / ph[..., 2:]).astype(np.float32)
    dst += rng.standard_normal(dst.shape).astype(np.float32) * 1e-3
    return (torch.from_numpy(src).to(dev), torch.from_numpy(dst).to(dev),
            torch.ones((48, 4), dtype=torch.float32, device=dev))


def check_sym_eig(dev, scene: dict, card: str) -> dict:
    """9b: `sym_eig` (`ops/cuda_eigh.eigh_small`) against `torch.linalg.eigh`
    on the card, on the systems the flow mask hands it on MASK_PAIRS (the
    128 minimal sets and the refit of each pair) and on
    `degenerate_minimal_sets`: eigenvalues, eigenvectors and `_dlt`'s
    homography against the plain version's (`homography.eigh_small`
    swapped for `eigh_small_reference`), at the SYM_EIG_* limits; then the
    kernel's times at the flow mask's two shapes, beside the plain
    version's, the library call's and the bound."""
    cfg = DynamicConfig()
    g = scene["grays"]
    calls = []
    dlt = homography._dlt

    def recorded(src, dst, w):
        calls.append((src, dst, w))
        return dlt(src, dst, w)

    homography._dlt = recorded
    try:
        with highest_precision():
            for a, b in MASK_PAIRS:
                flow_dynamic_mask_fitted(g[a].float(), g[b].float(), cfg)
    finally:
        homography._dlt = dlt
    calls.append(degenerate_minimal_sets(dev))
    labels = [f"pair {a}-{b} {kind}" for a, b in MASK_PAIRS for kind in ("minimal sets", "refit")]
    labels.append("degenerate minimal sets")
    systems = []

    def keep(M):
        systems.append(M)
        return cuda_eigh.eigh_small(M)

    rows = []
    try:
        with highest_precision():
            for label, args in zip(labels, calls):
                homography.eigh_small = keep
                H_k = dlt(*args)
                homography.eigh_small = cuda_eigh.eigh_small_reference
                H_p = dlt(*args)
                M = systems[-1]
                w, v = cuda_eigh.eigh_small(M)
                wr, vr = torch.linalg.eigh(M)
                nrm = torch.linalg.norm(M, dim=(-1, -2))
                held = _eig_gaps(wr) > SYM_EIG_GAP
                vec = torch.where(held, 1 - (v * vr).sum(-2).abs(), torch.zeros_like(w))
                h_err = ((H_k - H_p).abs().amax((-1, -2)) / H_p.abs().amax((-1, -2)))
                h_err = torch.where(held[..., 0], h_err, torch.zeros_like(h_err))
                rows.append(dict(
                    systems=label, shape=list(M.shape),
                    eig_err=float(((w - wr).abs().amax(-1) / nrm).max()),
                    vec_err=float(vec.max()), h_err=float(h_err.max()),
                    null_vectors_held=int(held[..., 0].sum()),
                    max_abs_err=float((w - wr).abs().max())))
    finally:
        homography.eigh_small = cuda_eigh.eigh_small
    _log("9b sym_eig against torch.linalg.eigh: " + json.dumps(rows) + f"; limits eigenvalues "
         f"{SYM_EIG_TOL} of |M|_F, eigenvectors {SYM_EIG_VEC_TOL} where the gap is over "
         f"{SYM_EIG_GAP}, H {SYM_EIG_H_TOL}; card: {card}")
    for r in rows:
        if not (r["eig_err"] <= SYM_EIG_TOL and r["vec_err"] <= SYM_EIG_VEC_TOL
                and r["h_err"] <= SYM_EIG_H_TOL):
            raise AssertionError(f"9b: sym_eig on the {r['systems']} beyond its limits: {r}")
    if not all(r["null_vectors_held"] for r in rows):
        raise AssertionError(f"9b: a batch with no separated null vector: vacuous: {rows}")

    times = {}
    for name, M in (("minimal_sets", systems[0]), ("refit", systems[1])) if dev.type == "cuda" \
            else ():
        n, batch = M.shape[-1], M.reshape(-1, M.shape[-1], M.shape[-1]).shape[0]
        prepared, _, _ = cuda_eigh.prepare(M)
        # An eigensolver with its vectors needs about 9 n^3 flops a matrix
        # (symmetric QR, Golub and Van Loan), whatever the kernel does; M
        # read once, the eigenvalues and vectors written once.
        bound, by = _bound_ms(4.0 * batch * (2 * n * n + n), 9.0 * n**3 * batch)
        times[name] = dict(
            shape=list(M.shape), ms=_time_ms(lambda: cuda_eigh.launch(prepared)),
            device_ms=_graph_ms(lambda: cuda_eigh.eigh_small(M)),
            wrapper_ms=_time_ms(lambda: cuda_eigh.eigh_small(M)),
            host_prepare_ms=_host_ms(lambda: cuda_eigh.prepare(M)),
            host_launch_ms=_host_ms(lambda: cuda_eigh.launch(prepared)),
            plain_ms=_time_ms(lambda: cuda_eigh.eigh_small_reference(M)),
            library_ms=_time_ms(lambda: torch.linalg.eigh(M)), bound_ms=bound, bound_by=by)
    _log("9b sym_eig times (ms; `ms` launch to end, `device_ms` the wrapper's work replayed "
         "from a graph, `plain_ms` and `library_ms` torch.linalg.eigh): " + json.dumps(times)
         + f"; card: {card}")
    if times:
        _log("9b sym_eig launch to end, this design against the first (shared memory, "
             "PERF.md): " + ", ".join(f"{k} {t['ms']:.4f} ms against {SYM_EIG_PREV_MS[k]} ms"
                                      for k, t in times.items()) + f"; card: {card}")
    main = dict(times.get("minimal_sets", {}))
    main.update(max_abs_err=max(r["max_abs_err"] for r in rows[:-1]), checks=rows,
                refit=times.get("refit"))
    return main


def check_masks(dev, cam: CameraConfig, scene: dict, card: str) -> dict:
    """9b: both masks on 9a's frames on the card against a CPU copy of
    their inputs (the flow mask with the card's minimal sets), and each
    mask's time on the card. The geometry mask's ring holds frames 0 and
    30's views at their ground-truth poses, their keypoints on a 16 px
    grid with the rendered depth."""
    cpu = torch.device("cpu")
    cfg = DynamicConfig()
    seq, g, d = scene["seq"], scene["grays"], scene["depths"]
    T_cw = [np.linalg.inv(p).astype(np.float32) for p in seq.poses_wc]
    ys, xs = np.mgrid[8:cam.height:16, 8:cam.width:16]
    uv = np.stack([xs.ravel(), ys.ravel()], -1).astype(np.float32)
    dbs = []  # the ring on the card, and its CPU copy
    for dv in (dev, cpu):
        db = empty_ref_views(cfg.geom_db_size, uv.shape[0], dv)
        for i in (0, 30):
            dep = d[i].cpu().numpy()[ys.ravel(), xs.ravel()].astype(np.float32) * 1e-3
            db = insert_ref_view(db, *(torch.from_numpy(a).to(dv) for a in
                                       (T_cw[i], uv, dep, dep > 0)))
        dbs.append(db)

    def card_ms(fn):
        return _time_ms(fn, reps=5, rounds=3) if dev.type == "cuda" else None

    out = dict(flow=[], geometry=[])
    with highest_precision():
        for a, b in MASK_PAIRS:
            prev, cur = g[a].float(), g[b].float()
            src, dst, valid = grid_correspondences(downscaled_flow(prev, cur, cfg))
            idx = sample_minimal_sets(valid)
            m_dev = flow_dynamic_mask_fitted(prev, cur, cfg, idx=idx).cpu()
            m_cpu = flow_dynamic_mask_fitted(prev.cpu(), cur.cpu(), cfg, idx=idx.cpu())
            ms = card_ms(lambda: flow_dynamic_mask_fitted(prev, cur, cfg))
            out["flow"].append(dict(frames=[a, b], differ=float((m_dev != m_cpu).double().mean()),
                                    dynamic=float((~m_dev).double().mean()), ms=ms))
            depth_m = d[b].float() * 1e-3
            T = torch.from_numpy(T_cw[b])
            T_dev = T.to(dev)
            gm_dev = geometry_dynamic_mask(dbs[0], T_dev, depth_m, cam, cfg).cpu()
            gm_cpu = geometry_dynamic_mask(dbs[1], T, depth_m.cpu(), cam, cfg)
            gms = card_ms(lambda: geometry_dynamic_mask(dbs[0], T_dev, depth_m, cam, cfg))
            out["geometry"].append(dict(frames=[b],
                                        differ=float((gm_dev != gm_cpu).double().mean()),
                                        dynamic=float((~gm_dev).double().mean()), ms=gms))
    _log("9b masks, card against CPU: " + json.dumps(out) + f"; limit {MASK_PIXEL_TOL} of "
         f"pixels; card: {card}")
    for kind, rows in out.items():
        for r in rows:
            if not r["differ"] <= MASK_PIXEL_TOL:
                raise AssertionError(f"9b: the {kind} mask differs from the CPU's on "
                                     f"{r['differ']:.5f} of pixels (limit {MASK_PIXEL_TOL})")
        if not any(r["dynamic"] > 0 for r in rows):
            raise AssertionError(f"9b: the {kind} mask marked no pixel dynamic: vacuous")
    out["graphs"] = check_mask_graphs(dev, cam, scene, dbs[0], T_cw, card)
    return out


def _graph_record(graph: GraphedStep) -> dict:
    """A `GraphedStep`'s capture: host ms (and of them the first replay's,
    which uploads the graph), its pools' MiB, replays, and the launches by
    kernel that the capture recorded."""
    return dict(capture_ms=graph.capture_ms, upload_ms=graph.upload_ms,
                pool_mib=graph.pool_bytes / 2**20, replays=graph.replays,
                captured=dict(graph.captured))


def check_mask_graphs(dev, cam: CameraConfig, scene: dict, db, T_cw: list, card: str) -> dict:
    """9b: `MaskRunner`'s two graphs on the card against the eager masks on
    MASK_PAIRS (equal bit for bit), each graph's capture and pool, and,
    before any profiler session of the script, what a replay costs the
    host (`dispatch_ms`) and in all (`synced_ms`, ending in a
    synchronize), beside the eager mask's synchronized ms."""
    cfg = DynamicConfig()
    g, d = scene["grays"], scene["depths"]
    runner = MaskRunner(dev)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    res = dict(equal=[])
    calls = {}
    with highest_precision():
        for a, b in MASK_PAIRS:
            prev, cur = g[a].float(), g[b].float()
            depth_m = d[b].float() * 1e-3
            T = torch.from_numpy(T_cw[b]).to(dev)
            calls = {
                "flow": (lambda: runner.flow(prev, cur, cfg),
                         lambda: flow_dynamic_mask_fitted(prev, cur, cfg)),
                "geometry": (lambda: runner.geometry(db, T, depth_m, cam, cfg),
                             lambda: geometry_dynamic_mask(db, T, depth_m, cam, cfg))}
            res["equal"].append({k: bool(torch.equal(graphed(), eager()))
                                 for k, (graphed, eager) in calls.items()})
        for kind, (graphed, eager) in calls.items():
            graph = runner.graphs()[0 if kind == "flow" else 1]
            dispatch, synced, eager_ms = [], [], []
            for _ in range(TRACK_REPEATS):
                sync()
                t = time.perf_counter()
                graphed()
                dispatch.append((time.perf_counter() - t) * 1e3)
                sync()
                synced.append((time.perf_counter() - t) * 1e3)
                t = time.perf_counter()
                eager()
                sync()
                eager_ms.append((time.perf_counter() - t) * 1e3)
            res[kind] = dict(_graph_record(graph), dispatch_ms=statistics.median(dispatch),
                             synced_ms=statistics.median(synced),
                             eager_synced_ms=statistics.median(eager_ms))
    _log("9b mask graphs: " + json.dumps(res) + f"; card: {card}")
    if not all(all(e.values()) for e in res["equal"]):
        raise AssertionError(f"9b: a mask graph's replay differs from the eager mask: {res}")
    if dev.type == "cuda" and res["flow"]["captured"].get("sym_eig") != 2:
        raise AssertionError(f"9b: the flow graph recorded {res['flow']['captured']}, not "
                             "sym_eig twice")
    return res


def dynamic_configs(cam: CameraConfig) -> dict:
    """`tests/test_accuracy_gates.py::dynamic_runs`'s four configs (at
    `cam`; the test's is the default 640x480)."""
    base = SlamConfig(camera=cam)
    base = base.replace(tracking=dataclasses.replace(base.tracking,
                                                     max_frames_between_kfs=DYN_KF_GAP),
                        loop=dataclasses.replace(base.loop, enabled=False,
                                                 enable_relocalization=False))
    return {"static": base, "unmasked": base,
            "flow": base.replace(dynamic=DynamicConfig(enable_flow=True)),
            "geom": base.replace(dynamic=DynamicConfig(enable_geometry=True))}


def check_masked_tracking(dev, cam: CameraConfig, card: str, frames: dict | None = None) -> dict:
    """9c: the four dynamic runs through `Tracker.process` and their
    gates; stage times, and a profiled steady frame of each masked run,
    whose `mask.flow` or `mask.geometry` range must hold one graph launch
    and no wait; on the card each mask's replay runs under CUDA's sync
    debug mode "error". `frames`: the static and dynamic scenes' frames
    at `cam` (rendered here in a pool of their own when None)."""
    if frames is None:
        ctx = multiprocessing.get_context("spawn")
        tasks = [(k, i) for k in ("static", "dynamic") for i in range(DYN_FRAMES)]
        t0 = time.perf_counter()
        with ctx.Pool(max(1, min(8, os.cpu_count() or 1)), initializer=_dyn9_init,
                      initargs=(cam,)) as pool:
            out = pool.map(_dyn9_render, tasks)
        frames = {"static": out[:DYN_FRAMES], "dynamic": out[DYN_FRAMES:]}
        _log(f"9c: rendered {len(tasks)} frames in {time.perf_counter() - t0:.1f} s")
    seq = SyntheticSequence(n_frames=DYN_FRAMES, cam=cam)
    gt = seq.gt_positions()
    on_card = dev.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    runs = {}
    flow_step, geom_step = MaskRunner.flow, MaskRunner.geometry

    def no_wait(step):
        # A mask's replay: from the copies into its graph's inputs to its
        # output's clone any wait on the card raises (its capture, which
        # synchronizes, runs before in stage `mask.capture`).
        def run(*args, **kwargs):
            torch.cuda.set_sync_debug_mode("error")
            try:
                return step(*args, **kwargs)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        return run

    if on_card:
        MaskRunner.flow, MaskRunner.geometry = no_wait(flow_step), no_wait(geom_step)
    try:
        for name, cfg in dynamic_configs(cam).items():
            runs[name] = _masked_run(dev, name, cfg, frames, seq, gt, sync)
            _log(f"9c {name}: " + json.dumps(runs[name]) + f"; card: {card}")
    finally:
        MaskRunner.flow, MaskRunner.geometry = flow_step, geom_step
    ate = {k: v["ate_m"] for k, v in runs.items()}
    gates = {
        "unmasked > 1.25 x static": ate["unmasked"] > 1.25 * ate["static"],
        "flow < unmasked + 0.25 x static": ate["flow"] < ate["unmasked"] + 0.25 * ate["static"],
        "geom < unmasked": ate["geom"] < ate["unmasked"],
        "geom < 1.9 x static": ate["geom"] < 1.9 * ate["static"],
    }
    _log(f"9c ATE (m): {json.dumps(ate)}; gates: {json.dumps(gates)}")
    failed = [k for k, ok in gates.items() if not ok]
    if failed:
        raise AssertionError(f"9c: {failed} with ATEs {ate}")
    if runs["flow"].get("mask.flow_count") != DYN_FRAMES - 1 \
            or runs["geom"].get("mask.geometry_count") != DYN_FRAMES - 1:
        raise AssertionError("9c: a mask stage did not run on every frame after the first")
    for name, stage in (("flow", "mask.flow"), ("geom", "mask.geometry")):
        r = runs[name].get("mask_ranges", {}).get(stage)
        if r is None:
            continue
        if any(k in _SYNC_CALLS for k in r) or r.get("cudaGraphLaunch") != 1:
            raise AssertionError(f"9c {name}: a steady frame's {stage} range made {r}, not one "
                                 "graph launch and no wait")
    return dict(runs=runs, ate=ate)


def _masked_run(dev, name: str, cfg: SlamConfig, frames: dict, seq, gt, sync) -> dict:
    """One of 9c's four `Tracker.process` runs: ATE, statuses, keyframes,
    frame and stage times, and for a masked run on the card a profile of
    DYN_PROFILE_FRAMES with the runtime calls of each mask's range a
    frame."""
    tracker = Tracker(cfg, device=dev)
    profiled = DYN_PROFILE_FRAMES if dev.type == "cuda" and name in ("flow", "geom") \
        else range(0)
    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                              torch.profiler.ProfilerActivity.CUDA]
                                  ) if len(profiled) else None
    frame_ms = []
    for i, (gray, depth) in enumerate(frames["static" if name == "static" else "dynamic"]):
        if len(profiled) and i == profiled.start:
            prof.start()
        sync()
        t = time.perf_counter()
        tracker.process(gray, depth, float(seq.stamps[i]))
        sync()
        frame_ms.append((time.perf_counter() - t) * 1e3)
        if len(profiled) and i == profiled[-1]:
            prof.stop()
    stages = tracker.metrics.stages
    kf = [i for i in range(1, len(tracker.stats))
          if tracker.stats[i]["kfs"] != tracker.stats[i - 1]["kfs"]]
    r = dict(ate_m=evaluate_ate_xyz(tracker.camera_positions(), gt).rmse,
             statuses=[s["status"] for s in tracker.stats], keyframe_frames=kf,
             median_frame_ms=statistics.median(frame_ms[1:]))
    for st in ("mask.flow", "mask.geometry", "mask.capture"):
        if st in stages:
            r[f"{st}_mean_ms"] = stages[st].total_s * 1e3 / stages[st].count
            r[f"{st}_count"] = stages[st].count
    if tracker._mask_runner is not None:
        r["mask_graphs"] = [_graph_record(g) for g in tracker.mask_runner().graphs()]
    if len(profiled):
        r["profile"] = _device_breakdown(prof, len(profiled), r["median_frame_ms"])
        r["profiled_frames"] = [profiled.start, profiled[-1]]
        r["mask_ranges"] = {st: {k: v / len(profiled) for k, v in _runtime_in(prof, st).items()}
                            for st in ("mask.flow", "mask.geometry")}
    return r


def walker_config(vocabulary_path, cam: CameraConfig) -> SlamConfig:
    """`bench.py`'s `cfg_dyn`: `bench_config` with `min_static_area=0.45`."""
    cfg = bench_config(vocabulary_path, cam)
    return cfg.replace(dynamic=dataclasses.replace(cfg.dynamic, min_static_area=0.45))


def run_masked_segmented(dev, cam: CameraConfig, scene: dict, card: str) -> dict:
    """9d: the segmented runner on 9a's frames, unmasked, with the flow mask
    and with the geometry mask."""
    seq, g, d = scene["seq"], scene["grays"], scene["depths"]
    gt = seq.gt_positions()[:g.shape[0]]
    runs = {}
    with warnings.catch_warnings():
        warnings.filterwarnings("error", message="trained artifact")
        vocab_path = named_vocabulary(Path(__file__).resolve().parent / "build" / "reloc_vocab")
        va = scan_tracker.VocabArrays.from_vocabulary(voc.load_binary(vocab_path), dev)
        cfg = walker_config(vocab_path, cam)
        for name, kw in (("unmasked", {}), ("flow", dict(use_flow=True)),
                         ("geom", dict(use_geom=True))):
            closer = LoopCloser(cfg, device=dev)
            if closer.vocab is None:
                raise AssertionError("9d runs without its named vocabulary")
            t = time.perf_counter()
            res = track_sequence_segmented(g, d, cfg, vocab=va, segment_len=WALK_SEG_LEN,
                                           loop_closer=closer, device=dev, **kw)
            wall_s = time.perf_counter() - t
            n = g.shape[0] - 1
            runs[name] = dict(
                lost=int((res.stats[:, 0] == 2).sum()), ok=int((res.stats[:, 0] == 0).sum()),
                n_kfs_end=int(res.stats[-1, 2]), n_loop_events=res.n_loop_events,
                corrections=[[int(c[0]), int(c[1]), int(c[2])] for c in res.corrections],
                ate_raw_m=evaluate_ate_xyz(_centres(res.T_all), gt).rmse,
                ate_resolved_m=evaluate_ate_xyz(resolve_trajectory(res), gt).rmse,
                wall_s=wall_s, scan_s=res.scan_s, correct_s=res.correct_s, fps_wall=n / wall_s)
            _log(f"9d {name}: " + json.dumps(runs[name]) + f"; card: {card}")
    for name, r in runs.items():
        if r["lost"]:
            raise AssertionError(f"9d {name}: {r['lost']} frames LOST")
    for name in ("flow", "geom"):
        if not runs[name]["ate_resolved_m"] < WALK_ATE_GATE:
            raise AssertionError(f"9d {name}: resolved ATE {runs[name]['ate_resolved_m']:.4f} m "
                                 f">= {WALK_ATE_GATE}")
    if not runs["geom"]["ate_resolved_m"] <= runs["unmasked"]["ate_resolved_m"]:
        raise AssertionError(f"9d: geometry-masked ATE {runs['geom']['ate_resolved_m']:.4f} m > "
                             f"unmasked {runs['unmasked']['ate_resolved_m']:.4f} m")
    _log(f"9d resolved ATE: unmasked {runs['unmasked']['ate_resolved_m']:.6f} m (logged, not "
         f"gated), flow {runs['flow']['ate_resolved_m']:.6f} m, geometry "
         f"{runs['geom']['ate_resolved_m']:.6f} m; frames/s "
         + ", ".join(f"{k} {r['fps_wall']:.2f} (eager masks: {WALK_FPS_BEFORE[k]})"
                     for k, r in runs.items()) + f"; card: {card}")
    return runs


def check_masked_segment_trace(dev, cam: CameraConfig, scene: dict, card: str) -> dict:
    """9e: MASK_TRACE_FRAMES of 9a's walker scene as one segment of the scan
    with `use_flow` and `use_geom` (from a carry that tracked the frames
    before them, so that every graph is captured), untraced and then under
    the profiler, each with the segmented runner's pack and fetch. Holds
    the traced segment as 8c holds its own: one wait and one device-to-host
    copy (the fetch), no host-to-device copy; and four graph launches a
    frame (the two masks, the tracking step, the keyframe branch) and
    `sym_eig` twice a frame (the flow graph's two systems) in the trace.
    The two runs give the same bits."""
    from orb_slam2_ssd_semantic_tpu_torch.tracking import segmented as seg_mod

    g, d = scene["grays"], scene["depths"]
    cfg = walker_config(None, cam)
    lo, hi = MASK_TRACE_FRAMES.start, MASK_TRACE_FRAMES.stop
    n = hi - lo
    kw = dict(use_flow=True, use_geom=True, with_rel=True)
    carry = scan_tracker.init_scan(map_state.empty_state(cfg, dev), g[0], d[0], cfg,
                                   use_geom=True)
    carry, *_ = scan_tracker.track_sequence_scan(carry, g[1:lo], d[1:lo], cfg,
                                                 prev_grays=g[:lo - 1], **kw)
    torch.cuda.synchronize()

    def segment():
        t0 = time.perf_counter()
        out, T, stats, rel, uid = scan_tracker.track_sequence_scan(
            carry, g[lo:hi], d[lo:hi], cfg, prev_grays=g[lo - 1:hi - 1], **kw)
        t_dispatch = time.perf_counter() - t0
        kfs = out.state.kfs
        packed = seg_mod._fetch(*seg_mod._start_fetch(seg_mod._pack_segment(
            T, stats, rel, uid, kfs.uid, kfs.valid, kfs.frame_id)))
        return packed, t_dispatch * 1e3 / n, (time.perf_counter() - t0) * 1e3 / n

    packed_untraced, dispatch_ms, wall_ms = segment()
    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                              torch.profiler.ProfilerActivity.CUDA])
    prof.start()
    with torch.profiler.record_function("scan.segment"):
        packed, traced_dispatch_ms, traced_wall_ms = segment()
    prof.stop()
    events = prof.profiler.kineto_results.events()
    a, b = next((e.start_ns(), e.end_ns()) for e in events if e.name() == "scan.segment"
                and e.device_type() == torch.autograd.DeviceType.CPU)
    waits = {}
    for e in events:
        if e.name() in _SYNC_CALLS and a <= e.start_ns() <= b:
            waits[e.name()] = waits.get(e.name(), 0) + 1
    device = [e for e in events if e.device_type() == torch.autograd.DeviceType.CUDA
              and e.name() not in _HOST_RANGES and e.start_ns() >= a]
    copies = {}
    for e in device:
        if e.name().startswith("Memcpy"):
            kind = e.name().split()[1]
            copies[kind] = copies.get(kind, 0) + 1
    kernels = [e for e in device if not e.name().startswith(("Memcpy", "Memset"))]
    runtime = _runtime_in(prof)
    traced = {key: sum(1 for e in device if name in e.name())
              for key, name in _TRACED_KERNELS.items()}
    statuses = packed[n * 16:n * 20:4].astype(np.int64)
    graphs = {name: [_graph_record(gr) for gr in runner.graphs()]
              for name, runner in (("masks", carry.masks), ("track", carry.track),
                                   ("branch", carry.branch))}
    res = dict(frames=[lo, hi - 1], waits=waits, device_copies=copies,
               graph_launches_per_frame=runtime.get("cudaGraphLaunch", 0) / n,
               kernel_launches_per_frame=runtime.get("cudaLaunchKernel", 0) / n,
               copies_per_frame=runtime.get("cudaMemcpyAsync", 0) / n,
               kernels_per_frame=len(kernels) / n,
               device_busy_ms_per_frame=sum(e.duration_ns() for e in kernels) / 1e6 / n,
               traced=traced, host_dispatch_ms_per_frame=dispatch_ms,
               wall_ms_per_frame=wall_ms, traced_host_dispatch_ms_per_frame=traced_dispatch_ms,
               traced_wall_ms_per_frame=traced_wall_ms,
               lost=int((statuses == 2).sum()), equal_untraced=bool(
                   np.array_equal(packed, packed_untraced)), graphs=graphs)
    _log("9e a masked segment traced whole: " + json.dumps(res) + f"; card: {card}")
    if waits != {"cudaEventSynchronize": 1} or copies.get("DtoH") != 1 or copies.get("HtoD"):
        raise AssertionError(f"9e: the segment waited {waits} and copied {copies}, not one wait "
                             "and one device-to-host copy (the fetch)")
    if runtime.get("cudaGraphLaunch") != 4 * n:
        raise AssertionError(f"9e: {runtime.get('cudaGraphLaunch')} graph launches for {n} "
                             "frames, not four a frame")
    if traced["sym_eig"] != 2 * n:
        raise AssertionError(f"9e: the trace ran sym_eig {traced['sym_eig']} times, {2 * n} "
                             "expected")
    if not res["equal_untraced"] or res["lost"]:
        raise AssertionError(f"9e: the traced segment differs from the untraced one, or lost "
                             f"frames: {res}")
    return res


def run_dynamic_path(dev, card: str, cam: CameraConfig | None = None,
                     n_frames: int = WALK_FRAMES, masked_tracking: bool = True) -> dict:
    """Phase 9 at `cam` (640x480 by default); the launch counters are
    zeroed before and read after. Without `masked_tracking`, 9c is left to
    the caller (`main` runs it on views of the render pool)."""
    cam = cam or CameraConfig()
    t9 = time.perf_counter()
    scene = check_render(dev, cam, n_frames, card)
    sym_eig = check_sym_eig(dev, scene, card)
    masks = check_masks(dev, cam, scene, card)
    # The masked paths: 9b's comparisons and timings are not counted.
    _reset_counts()
    tracked = check_masked_tracking(dev, cam, card) if masked_tracking else None
    seg = run_masked_segmented(dev, cam, scene, card)
    # 9e after 9d: a profiler session makes every later graph launch
    # costlier on the host (PERF.md), and 9d's frames/s are the host's.
    trace = check_masked_segment_trace(dev, cam, scene, card) if dev.type == "cuda" else None
    counts = _path_launches("9: the masked runs", dev)
    _check_sym_eig_ran("9", counts, dev)
    _log(f"phase 9 took {time.perf_counter() - t9:.1f} s, launches {json.dumps(counts)}; "
         f"card: {card}")
    return dict(render=scene["res"], sym_eig=sym_eig, masks=masks, tracking=tracked,
                segmented=seg, trace=trace, **counts)


def _check_sym_eig_ran(label: str, counts: dict, dev) -> None:
    """On the card, raise unless `sym_eig` ran in a graph's replay among a
    masked path's launches (`_path_launches`)."""
    if dev.type == "cuda" and not counts["launches_replayed"]["sym_eig"]:
        raise AssertionError(f"{label} never ran sym_eig in a graph's replay: {counts}")


# ---- phase 10: semantics through SlamSystem ----------------------------------

class _CountingDetector:
    """Stands in for `SlamSystem.detector`: forwards both detection paths
    and counts the images each one took."""

    def __init__(self, det):
        self.det, self.calls, self.batched = det, 0, 0

    def __call__(self, rgb):
        self.calls += 1
        return self.det(rgb)

    def detect_batch(self, rgbs):
        self.batched += len(rgbs)
        return self.det.detect_batch(rgbs)


class _RecordingSystem(SlamSystem):
    """`SlamSystem` that keeps each keyframe payload its consumers got, and
    the frame it came with."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.payloads, self.frames = [], []

    def _on_new_keyframe(self, rgb, depth, T_cw):
        self.payloads.append((np.array(rgb), np.array(depth), np.array(T_cw, np.float32)))
        self.frames.append(len(self.tracker.stats) - 1)
        super()._on_new_keyframe(rgb, depth, T_cw)


def semantic_scene(dev, cam: CameraConfig, n_frames: int = SEM_FRAMES) -> dict:
    """Phase 10's scene: the default orbit's first `n_frames` poses in its
    room, the boxes of SEM_FLAT_BOXES flat at their gray levels, rendered
    on `dev`; the planted boxes' world AABBs and classes."""
    poses = orbit_trajectory(n_frames, room=SEM_ROOM).astype(np.float32)
    gray = [-1.0] * len(_default_boxes(SEM_ROOM))
    for i, level in SEM_FLAT_BOXES.items():
        gray[i] = level
    (g, d), render_ms = _timed(lambda: device_render.render_frames(
        poses, cam, size=SEM_ROOM, seed=SEM_SEED, box_gray=tuple(gray), device=dev), dev)
    boxes = [np.asarray(_default_boxes(SEM_ROOM)[i], np.float32) for i in SEM_FLAT_BOXES]
    # The class of a gray band (bench.py, SEM_FLAT_BOXES): class c of 3
    # renders at 127.5 * (1 + (-0.8 + 1.6 * c / 3)).
    classes = [int(round((level / 127.5 - 0.2) * 3 / 1.6)) for level in SEM_FLAT_BOXES.values()]
    return dict(poses=poses, grays=g, depths=d, gray_host=g.cpu().numpy(),
                depth_host=d.cpu().numpy(), gt_boxes=np.stack(boxes), classes=classes,
                box_gray=tuple(gray), render_ms_per_frame=render_ms / n_frames)


def _rgb(gray: torch.Tensor) -> torch.Tensor:
    """(..., H, W) gray -> (..., H, W, 3), as the system's consumers see it."""
    return gray[..., None].expand(*gray.shape, 3).contiguous()


def _sync_ms(fn, dev, calls: int = SEM_TIMED_CALLS) -> float:
    """Median host time of `calls` calls, each ending in a synchronize,
    after one call to warm up."""
    fn()
    return statistics.median(_timed(fn, dev)[1] for _ in range(calls))


def _rel_gap(a: torch.Tensor, ref: torch.Tensor) -> float:
    return float((a.cpu() - ref.cpu()).abs().max() / ref.abs().max().cpu())


def check_semantic_network(dev, scene: dict, params: dict, card: str) -> dict:
    """10a: the full-width SSDLite on the card against the port on the CPU
    (same weights, f32, TF32 off), the bf16 batch against the card's own
    f32, each path's time; 10b: the card's decode, top-k and NMS on the
    CPU's raw outputs against the CPU's."""
    cpu = torch.device("cpu")
    cfg = SemanticConfig(det_score_threshold=0.0)  # every kept box is valid: 10b sees NMS
    det = Detector(cfg, params=params, device=dev)
    det_cpu = Detector(cfg, params=params, device=cpu)
    rgb = _rgb(scene["grays"][0])
    loc, conf = det.raw(rgb)
    loc_c, conf_c = det_cpu.raw(rgb.cpu())
    out = dict(f32_loc_gap=_rel_gap(loc, loc_c), f32_conf_gap=_rel_gap(conf, conf_c),
               largest_loc=float(loc_c.abs().max()), largest_conf=float(conf_c.abs().max()))
    batch = _rgb(scene["grays"][:SEM_BATCH])
    l32, c32 = det.raw(batch)
    l16, c16 = det.raw(batch, bf16=True)
    out.update(bf16_loc_gap=_rel_gap(l16, l32), bf16_conf_gap=_rel_gap(c16, c32))
    frames = [batch[i] for i in range(SEM_BATCH)]
    out.update(f32_forward_ms=_sync_ms(lambda: det.raw(rgb), dev),
               bf16_forward_ms_batch=_sync_ms(lambda: det.raw(batch, bf16=True), dev),
               f32_detect_ms=_sync_ms(lambda: det(rgb), dev),
               bf16_detect_ms_batch=_sync_ms(lambda: det.detect_batch(frames), dev),
               batch=SEM_BATCH)
    # 10b: the CPU's raw outputs through the card's post-processing.
    h, w = rgb.shape[:2]
    want = det_cpu.postprocess(loc_c, conf_c, h, w)
    got = det.postprocess(loc_c.to(dev), conf_c.to(dev), h, w)
    out.update(decode_box_gap_px=float((got.boxes.cpu() - want.boxes).abs().max()),
               decode_score_gap=float((got.scores.cpu() - want.scores).abs().max()),
               decode_classes_equal=bool(torch.equal(got.classes.cpu(), want.classes)),
               decode_valid_equal=bool(torch.equal(got.valid.cpu(), want.valid)),
               decode_kept=int(want.valid.sum()),
               decode_ms=_sync_ms(lambda: det.postprocess(loc, conf, h, w), dev))
    _log("10a/10b network and decode: " + json.dumps(out) + f"; limits: f32 {SEM_NET_TOL}, bf16 "
         f"{SEM_BF16_TOL} of the largest magnitude, boxes {SEM_BOX_TOL} px, scores "
         f"{SEM_SCORE_TOL}; card: {card}")
    for k in ("f32_loc_gap", "f32_conf_gap"):
        if not out[k] <= SEM_NET_TOL:
            raise AssertionError(f"10a: {k} {out[k]:.3e} > {SEM_NET_TOL}")
    for k in ("bf16_loc_gap", "bf16_conf_gap"):
        if not out[k] <= SEM_BF16_TOL:
            raise AssertionError(f"10a: {k} {out[k]:.3e} > {SEM_BF16_TOL}")
    if not (out["decode_box_gap_px"] <= SEM_BOX_TOL and out["decode_score_gap"] <= SEM_SCORE_TOL
            and out["decode_classes_equal"] and out["decode_valid_equal"]):
        raise AssertionError(f"10b: the card's decode differs from the CPU's: {out}")
    if not 0 < out["decode_kept"] < cfg.max_detections:
        raise AssertionError(f"10b: NMS kept {out['decode_kept']} boxes: vacuous")
    return out


def _seen(box: np.ndarray, T_cw: np.ndarray, cam: CameraConfig):
    """The pixel bbox, clipped to the image, of a box's face toward the
    orbit's camera (its -z face: the boxes stand on the +z wall), or None
    unless the face lies in front of the camera and at least
    SEM_SEEN_FRACTION of its bbox, and SEM_SEEN_PX pixels each way, fall
    inside the image."""
    lo, hi = box
    corners = np.array([[x, y, lo[2]] for x in (lo[0], hi[0]) for y in (lo[1], hi[1])],
                       np.float32)
    pc = corners @ T_cw[:3, :3].T + T_cw[:3, 3]
    if not (pc[:, 2] > 0.1).all():
        return None
    u = cam.fx * pc[:, 0] / pc[:, 2] + cam.cx
    v = cam.fy * pc[:, 1] / pc[:, 2] + cam.cy
    b = np.array([u.min(), v.min(), u.max(), v.max()], np.float32)
    c = np.clip(b, 0, [cam.width - 1, cam.height - 1, cam.width - 1, cam.height - 1])
    cw, ch = c[2] - c[0], c[3] - c[1]
    if min(cw, ch) < SEM_SEEN_PX * cam.width / 640 \
            or cw * ch < SEM_SEEN_FRACTION * (b[2] - b[0]) * (b[3] - b[1]):
        return None
    return c


def planted_detections(scene: dict, i: int, cam: CameraConfig, D: int):
    """One detection per planted box view `i` sees: its projected bbox, the
    class of its gray level, score 0.9; the rest of the D rows invalid.
    Returns (Detections of numpy arrays, indices of the boxes seen)."""
    T_cw = np.linalg.inv(scene["poses"][i]).astype(np.float32)
    boxes = np.zeros((D, 4), np.float32)
    scores = np.zeros(D, np.float32)
    classes = np.zeros(D, np.int32)
    valid = np.zeros(D, bool)
    seen = []
    for k, (box, c) in enumerate(zip(scene["gt_boxes"], scene["classes"])):
        b = _seen(box, T_cw, cam)
        if b is not None:
            j = len(seen)
            boxes[j], scores[j], classes[j], valid[j] = b, 0.9, c, True
            seen.append(k)
    return Detections(boxes, scores, classes, valid), seen, T_cw


def check_semantic_fusion(dev, scene: dict, cam: CameraConfig, card: str) -> dict:
    """10c: both fusion schemes and `add_objects` on the planted boxes'
    detections at SEM_VIEWS, on the card and on a CPU copy: centroids and
    labels against the CPU, the databases against the ground truth."""
    cpu = torch.device("cpu")
    out, seen_any = {}, set()
    with highest_precision():
        for scheme in ("depth_window", "merge_sg"):
            scfg = SemanticConfig(fusion_scheme=scheme)
            db = {dv.type: empty_db(scfg.max_objects, dv) for dv in (dev, cpu)}
            label_diff = 0
            for i in SEM_VIEWS:
                det_np, seen, T_cw = planted_detections(scene, i, cam, scfg.max_detections)
                seen_any.update(seen)
                depth = scene["depths"][i].to(torch.float32) * 1e-3
                for dv in (dev, cpu):
                    det = Detections(*(torch.from_numpy(np.asarray(a)).to(dv) for a in det_np))
                    res = fuse_detections(det, depth.to(dv), torch.from_numpy(T_cw).to(dv), cam,
                                          scfg)
                    db[dv.type] = add_objects(db[dv.type], *res)
                if scheme == "merge_sg":
                    lab = segment_objects(depth, cam, scfg).cpu()
                    lab_c = segment_objects(depth.cpu(), cam, scfg)
                    label_diff += int((lab != lab_c).sum())
            card_db, cpu_db = db[dev.type], db["cpu"]
            v = card_db.valid.cpu()
            r = dict(objects=int(v.sum()), objects_cpu=int(cpu_db.valid.sum()),
                     same_classes=bool(torch.equal(card_db.class_id.cpu(), cpu_db.class_id)),
                     centroid_gap_m=float((card_db.centroid.cpu() - cpu_db.centroid)[v].abs().max())
                     if v.any() else 0.0)
            if scheme == "merge_sg":
                r["label_pixels_differing"] = label_diff
            per_gt, n_spur = gt_box_localization(card_db, scene["gt_boxes"][sorted(seen_any)])
            r.update(per_box_error_m=per_gt.tolist(), spurious=n_spur)
            out[scheme] = r
    _log("10c fusion on the planted boxes (card against CPU, database against the ground "
         f"truth): {json.dumps(out)}; boxes seen {sorted(seen_any)} of {len(scene['classes'])}; "
         f"limits {SEM_CENTROID_TOL} m, {json.dumps(SEM_GT_TOL)} m; card: {card}")
    for scheme, r in out.items():
        if not (r["objects"] == r["objects_cpu"] > 0 and r["same_classes"]
                and r["centroid_gap_m"] <= SEM_CENTROID_TOL):
            raise AssertionError(f"10c {scheme}: the card's database differs from the CPU's: {r}")
        if not max(r["per_box_error_m"]) <= SEM_GT_TOL[scheme]:
            raise AssertionError(f"10c {scheme}: a planted box lies {max(r['per_box_error_m']):.3f}"
                                 f" m from every database object (limit {SEM_GT_TOL[scheme]})")
    if out["merge_sg"]["label_pixels_differing"]:
        raise AssertionError(f"10c: segment_objects labels differ from the CPU's on "
                             f"{out['merge_sg']['label_pixels_differing']} pixels")
    if len(seen_any) < 3:
        raise AssertionError(f"10c: the views see {len(seen_any)} planted boxes")
    return out


def _cpu_consumers(payloads, cfg: SlamConfig, params: dict):
    """The port's keyframe consumers on the CPU, replaying `payloads`:
    the f32 detection, the configured fusion and `add_objects`."""
    cpu = torch.device("cpu")
    det = Detector(cfg.semantic, params=params, device=cpu)
    db = empty_db(cfg.semantic.max_objects, cpu)
    dets = []
    with highest_precision():
        for rgb, depth, T_cw in payloads:
            d = det(_rgb(torch.from_numpy(rgb)))
            dets.append(d)
            res = fuse_detections(d, depth_metres(torch.from_numpy(depth)),
                                  torch.from_numpy(T_cw), cfg.camera, cfg.semantic)
            db = add_objects(db, *res)
    return db, dets


def run_semantic_system(dev, scene: dict, params: dict, cam: CameraConfig, card: str) -> dict:
    """10d: `SlamSystem(enable_semantics=True).track_rgbd` on the scene
    against `Tracker.process` on the same frames; then, with the score
    gates at 0, its object database against the CPU's consumers replaying
    its keyframe payloads; the consumers' times, and one keyframe's flush
    under the profiler."""
    cfg = SlamConfig(camera=cam)
    n = scene["gray_host"].shape[0]
    frames = [(scene["gray_host"][i], scene["depth_host"][i]) for i in range(n)]
    stamps = np.arange(n) / 30.0

    def drive(step):
        runs = [_timed(lambda: step(gray, depth, float(stamps[i])), dev)
                for i, (gray, depth) in enumerate(frames)]
        return [ms for _, ms in runs], np.stack([T for T, _ in runs])

    tracker = Tracker(cfg, device=dev)
    plain_ms, plain_T = drive(tracker.process)
    sys1 = SlamSystem(cfg, enable_semantics=True, detector_params=params, device=dev)
    sys1.detector = counting = _CountingDetector(sys1.detector)
    queued = []

    def step1(gray, depth, stamp):
        T = sys1.track_rgbd(gray, depth, stamp)
        queued.append(len(sys1._det_queue))
        return T

    sem_ms, sem_T = drive(step1)
    kf = _kf_frames(s["kfs"] for s in sys1.tracker.stats[1:])
    kf_plain = _kf_frames(s["kfs"] for s in tracker.stats[1:])
    gt = scene["poses"][:, :3, 3]
    res = dict(frames=n, keyframe_frames=[0] + kf, statuses_ok=sum(
        s["status"] == "OK" for s in sys1.tracker.stats), pose_gap_m=float(np.abs(
            sem_T - plain_T).max()), position_gap_m=float(np.abs(
            sys1.tracker.camera_positions() - tracker.camera_positions()).max()),
        ate_m=evaluate_ate_xyz(sys1.tracker.camera_positions(), gt).rmse,
        detector_calls=counting.calls, detector_batched=counting.batched,
        objects_default_gates=int(sys1.object_db.valid.sum()),
        median_frame_ms=statistics.median(sem_ms[1:]),
        median_frame_ms_plain=statistics.median(plain_ms[1:]),
        keyframe_frame_ms=[sem_ms[i] for i in kf],
        keyframe_frame_ms_plain=[plain_ms[i] for i in kf])
    # The score gates at 0: the seeded weights' boxes reach fusion.
    cfg0 = cfg.replace(semantic=dataclasses.replace(cfg.semantic, det_score_threshold=0.0,
                                                    fusion_prob_threshold=0.0))
    sys2 = _RecordingSystem(cfg0, enable_semantics=True, detector_params=params, device=dev)
    for i, (gray, depth) in enumerate(frames):
        sys2.track_rgbd(gray, depth, float(stamps[i]))
    cpu_db, cpu_dets = _cpu_consumers(sys2.payloads, cfg0, params)
    card_db = sys2.object_db
    v = card_db.valid.cpu()
    det_diffs = []
    for (rgb, _, _), d_cpu in zip(sys2.payloads, cpu_dets):
        d = sys2.detector(_rgb(torch.from_numpy(rgb).to(dev)))
        det_diffs.append(dict(
            classes_equal=bool(torch.equal(d.classes.cpu(), d_cpu.classes)),
            valid_equal=bool(torch.equal(d.valid.cpu(), d_cpu.valid)),
            box_gap_px=float((d.boxes.cpu() - d_cpu.boxes).abs().max()),
            score_gap=float((d.scores.cpu() - d_cpu.scores).abs().max())))
    res.update(objects=int(v.sum()), objects_cpu=int(cpu_db.valid.sum()),
               same_classes=bool(torch.equal(card_db.class_id.cpu(), cpu_db.class_id)),
               centroid_gap_m=float((card_db.centroid.cpu() - cpu_db.centroid)[v].abs().max())
               if v.any() else 0.0, keyframes_replayed=len(sys2.payloads),
               detections_card_vs_cpu=det_diffs)
    # A keyframe's consumers on the card, one by one, and one flush profiled.
    rgb, depth, T_cw = (torch.from_numpy(a).to(dev) for a in sys2.payloads[-1])
    rgb3 = _rgb(rgb)
    depth_m = depth_metres(depth)
    det = sys2.detector
    with highest_precision():
        d = det(rgb3)
        fused = fuse_detections(d, depth_m, T_cw, cam, cfg0.semantic)
        cons = dict(detect_ms=_sync_ms(lambda: det(rgb3), dev, 10))
        for scheme in ("depth_window", "merge_sg"):
            scfg = dataclasses.replace(cfg0.semantic, fusion_scheme=scheme)
            cons[f"fusion_{scheme}_ms"] = _sync_ms(
                lambda: fuse_detections(d, depth_m, T_cw, cam, scfg), dev, 10)
        cons["add_objects_ms"] = _sync_ms(lambda: add_objects(card_db, *fused), dev, 10)
        merge_cfg = dataclasses.replace(cfg0.semantic, fusion_scheme="merge_sg")
        cons["merge_sg_profile"] = _profile_call(
            lambda: fuse_detections(d, depth_m, T_cw, cam, merge_cfg), dev)
    sys2._det_queue.append((rgb3, depth_m, T_cw))
    cons["flush_profile"] = _profile_call(sys2.flush_detections, dev, prefix="semantic.")
    res["consumers"] = cons
    _log("10d SlamSystem with semantics: " + json.dumps(res) + f"; card: {card}")
    if res["statuses_ok"] != n:
        raise AssertionError(f"10d: {n - res['statuses_ok']} frames not OK")
    if kf != kf_plain or res["pose_gap_m"] != 0.0 or res["position_gap_m"] != 0.0:
        raise AssertionError(f"10d: semantics changed tracking: keyframes {kf} against {kf_plain}"
                             f", poses {res['pose_gap_m']} m apart")
    if not res["ate_m"] <= SEM_ATE_GATE:
        raise AssertionError(f"10d: ATE {res['ate_m']:.5f} m > {SEM_ATE_GATE}")
    if counting.calls != len(kf) + 1 or counting.batched or any(queued):
        raise AssertionError(f"10d: {counting.calls} detector calls for {len(kf) + 1} keyframes, "
                             f"queue lengths {queued}")
    if not (res["objects"] == res["objects_cpu"] > 0 and res["same_classes"]
            and res["centroid_gap_m"] <= SEM_CENTROID_TOL):
        raise AssertionError(f"10d: the card's database ({res['objects']} objects) differs from "
                             f"the CPU's replay ({res['objects_cpu']}): centroids "
                             f"{res['centroid_gap_m']} m apart; detections {det_diffs}")
    return res


def run_semantic_path(dev, card: str, cam: CameraConfig | None = None,
                      n_frames: int = SEM_FRAMES) -> dict:
    """Phase 10 at `cam` (640x480 by default); the launch counters are
    zeroed before and read after. The seeded full-width weights are passed
    explicitly, and a missing-artifact warning is an error."""
    cam = cam or CameraConfig()
    t10 = time.perf_counter()
    _reset_counts()
    with warnings.catch_warnings():
        warnings.filterwarnings("error", message="trained artifact")
        params = init_ssdlite(21, seed=0, device="cpu").state_dict()
        scene = semantic_scene(dev, cam, n_frames)
        net = check_semantic_network(dev, scene, params, card)
        fusion = check_semantic_fusion(dev, scene, cam, card)
        system = run_semantic_system(dev, scene, params, cam, card)
    counts = _path_launches("10: the semantic runs", dev)
    phase_s = time.perf_counter() - t10
    _log(f"phase 10 took {phase_s:.1f} s (render {scene['render_ms_per_frame']:.2f} ms a frame), "
         f"launches {json.dumps(counts)}; card: {card}")
    return dict(network=net, fusion=fusion, system=system, **counts, phase_s=phase_s,
                scene=scene, params=params)


# ---- phase 11: the dense map, persistence, stereo and monocular --------------

class _B1Shapes:
    """Records (Q, T, radius) of every window-matcher call that reaches the
    card (through `cuda_match.prepare`; a radius given as a tensor is
    recorded as None). The launch counts are untouched."""

    def __enter__(self):
        self.seen, self._prepare = [], cuda_match.prepare

        def recording(desc_q, desc_t, centers, uv_t, radius, *args, **kw):
            r = float(radius) if isinstance(radius, (int, float)) else None
            self.seen.append((desc_q.shape[0], desc_t.shape[0], r))
            return self._prepare(desc_q, desc_t, centers, uv_t, radius, *args, **kw)

        cuda_match.prepare = recording
        return self

    def __exit__(self, *exc):
        cuda_match.prepare = self._prepare


class _CountingExtract:
    """Counts ORB extractions: replaces `extract` where the system and the
    tracker look it up."""

    def __enter__(self):
        self.calls, self._orig = 0, extractor.extract

        def counting(*args, **kw):
            self.calls += 1
            return self._orig(*args, **kw)

        extractor.extract = tracker_mod.extract = counting
        return self

    def __exit__(self, *exc):
        extractor.extract = tracker_mod.extract = self._orig


def _consume_dense(dense: DenseMapConfig) -> DenseMapConfig:
    """The batched consumer's ray schedule at CONSUME_GRID's resolution."""
    res = CONSUME_GRID["grid_resolution"]
    return dataclasses.replace(dense, resolution=res,
                               max_ray_steps=int(dense.cloud_max_depth / res) + 8)


def _grid_gaps(card_grid, cpu_grid) -> dict:
    """Log-odds flips (voxels not equal) against the voxels either map
    touched, and the color sums' largest difference."""
    lc, lp = card_grid.log_odds.cpu(), cpu_grid.log_odds
    return dict(touched=int(((lc != 0) | (lp != 0)).sum()), flips=int((lc != lp).sum()),
                color_gap=float((card_grid.color.cpu() - cpu_grid.color).abs().max()),
                n_color_gap=float((card_grid.n_color.cpu() - cpu_grid.n_color).abs().max()))


def _check_gaps(label: str, r: dict) -> None:
    if r["touched"] == 0:
        raise AssertionError(f"{label}: no voxel touched")
    if not (r["flips"] <= DENSE_FLIP_SHARE * r["touched"] and r["color_gap"] <= DENSE_COLOR_TOL
            and r["n_color_gap"] == 0.0):
        raise AssertionError(f"{label}: the card's map differs from the CPU's: {r} (limits: "
                             f"{DENSE_FLIP_SHARE} of the touched voxels, colors {DENSE_COLOR_TOL})")


def check_dense_functions(dev, scene: dict, cam: CameraConfig, card: str) -> dict:
    """11a: `keyframe_cloud`, `split_ground` on the same hypotheses and
    `insert_scan` (into the 64^3 block holding most endpoints, and into
    the batched consumer's 160 x 40 x 160 grid at 0.1 m) at full width on
    one keyframe, on the card and on the CPU: the inserts take the CPU's
    cloud, so their maps must agree voxel for voxel. The ms of each on the
    card, and the launches and syncs of one block insertion."""
    cpu = torch.device("cpu")
    dense = DenseMapConfig()
    poses = scene["poses"]
    # View DENSE_VIEW in camera 0's frame, as the tracker's map holds it.
    T_np = (np.linalg.inv(poses[DENSE_VIEW]) @ poses[0]).astype(np.float32)
    T_cw = torch.from_numpy(T_np)
    depth = scene["depths"][DENSE_VIEW].to(torch.float32) * 1e-3
    gray = scene["grays"][DENSE_VIEW].to(torch.float32)
    out = {}
    with highest_precision():
        pts, valid, colors = keyframe_cloud(depth, T_cw.to(dev), cam, dense, gray_img=gray)
        pts_c, valid_c, colors_c = keyframe_cloud(depth.cpu(), T_cw, cam, dense,
                                                  gray_img=gray.cpu())
        idx = sample_ground_hypotheses(valid_c, dense.ground_ransac_iters,
                                       torch.Generator().manual_seed(0))
        ground, plane = split_ground(pts, valid, idx.to(dev), 1, dense)
        ground_c, plane_c = split_ground(pts_c, valid_c, idx, 1, dense)
        out.update(
            points=int(valid_c.sum()), cloud_gap_m=float((pts.cpu() - pts_c).abs().max()),
            mask_equal=bool(torch.equal(valid.cpu(), valid_c)),
            colors_equal=bool(torch.equal(colors.cpu(), colors_c)),
            ground_points=int(ground_c.sum()),
            ground_differing=int((ground.cpu() != ground_c).sum()),
            plane_gap=float((plane.cpu() - plane_c).abs().max()), plane=plane_c.tolist(),
            cloud_ms=_sync_ms(lambda: keyframe_cloud(depth, T_cw.to(dev), cam, dense,
                                                     gray_img=gray), dev, 10),
            ground_ms=_sync_ms(lambda: split_ground(pts, valid, sample_ground_hypotheses(
                valid, dense.ground_ransac_iters, torch.Generator().manual_seed(0)), 1, dense),
                dev, 10))
        args_c = (se3.se3_inverse(T_cw)[:3, 3], pts_c, valid_c)
        args = tuple(a.to(dev) for a in args_c)
        e = dense.block_voxels * dense.resolution
        keys, counts = torch.unique(torch.floor(pts_c[valid_c] / e).to(torch.int64), dim=0,
                                    return_counts=True)
        key = keys[counts.argmax()].tolist()
        cases = (
            ("block_64", lambda d: empty_grid(extent=(e, e, e), resolution=dense.resolution,
                                              origin=tuple(k * e for k in key), device=d),
             dense, dict(colors=colors_c, carve_only=ground_c)),
            ("consume_grid", lambda d: empty_grid(extent=CONSUME_BENCH_EXTENT,
                                                  resolution=CONSUME_GRID["grid_resolution"],
                                                  origin=CONSUME_BENCH_ORIGIN, device=d),
             _consume_dense(dense), dict(carve_only=ground_c)),
        )
        for name, make, cfg, kw_c in cases:
            kw = {k: v.to(dev) for k, v in kw_c.items()}
            r = _grid_gaps(insert_scan(make(dev), *args, cfg=cfg, **kw),
                           insert_scan(make(cpu), *args_c, cfg=cfg, **kw_c))
            g0 = make(dev)
            r.update(shape=list(g0.shape), ray_steps=cfg.max_ray_steps,
                     ms=_sync_ms(lambda: insert_scan(g0, *args, cfg=cfg, **kw), dev, 10),
                     profile=_profile_call(lambda: insert_scan(g0, *args, cfg=cfg, **kw), dev,
                                           prefix="dense."))
            out[name] = r
    _log(f"11a dense functions at {cam.width}x{cam.height} (view {DENSE_VIEW}, block {key}): "
         f"{json.dumps(out)}; limits: cloud {DENSE_CLOUD_TOL} m, log-odds flips "
         f"{DENSE_FLIP_SHARE} of the touched voxels; card: {card}")
    if not (out["cloud_gap_m"] <= DENSE_CLOUD_TOL and out["mask_equal"] and out["colors_equal"]):
        raise AssertionError(f"11a: the card's keyframe cloud differs from the CPU's: {out}")
    if not (out["ground_differing"] <= DENSE_FLIP_SHARE * out["points"]
            and out["plane_gap"] <= DENSE_CLOUD_TOL and out["ground_points"] > 1000):
        raise AssertionError(f"11a: the card's ground split differs from the CPU's: {out}")
    for name, *_ in cases:
        _check_gaps(f"11a {name}", out[name])
    # Phase 12c inserts this keyframe's cloud through the occupancy app.
    out["cloud"] = dict(points=pts_c[valid_c].numpy(), origin=args_c[0].numpy())
    return out


def _surface_distance(p: np.ndarray, room, boxes) -> np.ndarray:
    """(M,) distance of world points to the nearest surface: a wall of the
    room's AABB [0, room] or a face of one of its boxes."""

    def to_surface(lo, hi):
        lo, hi = np.asarray(lo, np.float64), np.asarray(hi, np.float64)
        outside = np.linalg.norm(np.maximum(np.maximum(lo - p, p - hi), 0.0), axis=1)
        return np.where(outside > 0, outside, np.minimum(p - lo, hi - p).min(1))

    d = to_surface(np.zeros(3), room)
    for lo, hi in boxes:
        d = np.minimum(d, to_surface(lo, hi))
    return d


def run_dense_system(dev, scene: dict, params: dict, cam: CameraConfig, card: str,
                     work: Path) -> dict:
    """11b: `SlamSystem(enable_semantics=True, enable_dense_map=True)` on
    phase 10's frames with a keyframe at least every DENSE_KF_GAP frames,
    against `Tracker.process` at the same config; its map against the
    room's surfaces and against the CPU replaying its keyframe payloads;
    the occupancy file round trip; and a map saved after frame
    n - DENSE_LOC_FRAMES - 1, loaded into a new system that localizes on
    the last DENSE_LOC_FRAMES frames."""
    cpu = torch.device("cpu")
    base = SlamConfig(camera=cam)
    cfg = base.replace(tracking=dataclasses.replace(base.tracking,
                                                    max_frames_between_kfs=DENSE_KF_GAP))
    n = scene["gray_host"].shape[0]
    frames = [(scene["gray_host"][i], scene["depth_host"][i], i / 30.0) for i in range(n)]

    def drive(step, idx):
        runs = [_timed(lambda: step(*frames[i]), dev) for i in idx]
        return [ms for _, ms in runs], [T for T, _ in runs]

    tracker = Tracker(cfg, device=dev)
    plain_ms, plain_T = drive(tracker.process, range(n))
    sys_ = _RecordingSystem(cfg, enable_semantics=True, enable_dense_map=True,
                            detector_params=params, device=dev)
    dense_ms, insert = [], sys_._insert_keyframe_cloud
    sys_._insert_keyframe_cloud = lambda *a: dense_ms.append(_timed(lambda: insert(*a), dev)[1])
    split = n - DENSE_LOC_FRAMES
    sys_ms, sys_T = drive(sys_.track_rgbd, range(split))
    map_path = str(work / "map.npz")
    sys_.save_map(map_path)
    tr = sys_.tracker
    snap = dict(last_T_cw=tr.last_T_cw.clone(), last_frame=tr.last_frame,
                last_kp_point=tr.last_kp_point.clone(), velocity=tr.velocity.clone(),
                n_kfs=tr._n_kfs)
    ms2, T2 = drive(sys_.track_rgbd, range(split, n))
    sys_ms, sys_T = sys_ms + ms2, np.stack(sys_T + T2)
    kf = _kf_frames(s["kfs"] for s in tr.stats[1:])
    kf_plain = _kf_frames(s["kfs"] for s in tracker.stats[1:])
    centers, _ = sys_.grid.occupied_centers()
    T0 = scene["poses"][0].astype(np.float64)
    dist = _surface_distance(centers @ T0[:3, :3].T + T0[:3, 3], SEM_ROOM,
                             _default_boxes(SEM_ROOM))
    res = dict(frames=n, keyframe_frames=[0] + kf, statuses_ok=sum(
        s["status"] == "OK" for s in tr.stats), pose_gap_m=float(np.abs(
            sys_T - np.stack(plain_T)).max()), position_gap_m=float(np.abs(
            tr.camera_positions() - tracker.camera_positions()).max()),
        ate_m=evaluate_ate_xyz(tr.camera_positions(), scene["poses"][:, :3, 3]).rmse,
        blocks=len(sys_.grid.blocks), occupied=len(centers),
        near_surface_share=float((dist <= DENSE_SURFACE_TOL).mean()),
        surface_distance_median_m=float(np.median(dist)) if len(dist) else None,
        dense_consumer_ms=dense_ms,
        keyframe_frame_ms=[sys_ms[i] for i in kf],
        keyframe_frame_ms_plain=[plain_ms[i] for i in kf],
        median_keyframe_frame_ms=statistics.median(sys_ms[i] for i in kf),
        median_keyframe_frame_ms_plain=statistics.median(plain_ms[i] for i in kf),
        median_frame_ms=statistics.median(sys_ms[1:]),
        median_frame_ms_plain=statistics.median(plain_ms[1:]))
    # The CPU replays the keyframe payloads through the same consumers.
    t = time.perf_counter()
    cpu_sys = SlamSystem(cfg, enable_dense_map=True, device=cpu)
    for rgb, depth, T_cw in sys_.payloads:
        cpu_sys._on_new_keyframe(rgb, depth, T_cw)
    res["cpu_replay_s"] = time.perf_counter() - t
    gaps = [_grid_gaps(sys_.grid.blocks[k], cpu_sys.grid.blocks[k])
            for k in cpu_sys.grid.blocks if k in sys_.grid.blocks]
    res["replay"] = dict(blocks_equal=list(sys_.grid.blocks) == list(cpu_sys.grid.blocks),
                         touched=sum(g["touched"] for g in gaps),
                         flips=sum(g["flips"] for g in gaps),
                         color_gap=max(g["color_gap"] for g in gaps),
                         n_color_gap=max(g["n_color_gap"] for g in gaps))
    # The occupancy file: saved, loaded back.
    octo = str(work / "octomap.npz")
    before = np.sort(centers, axis=0)
    sys_.save_octomap(octo)
    sys_.load_octomap(octo)
    after = np.sort(sys_.grid.occupied_centers()[0], axis=0)
    res["octomap_gap_m"] = float(np.abs(after - before).max()) if after.shape == before.shape \
        else float("inf")
    # Localization on a loaded map.
    loc = SlamSystem(cfg, device=dev)
    loc.load_map(map_path)
    loc.activate_localization_mode()
    for k in ("last_T_cw", "last_frame", "last_kp_point", "velocity"):
        setattr(loc.tracker, k, snap[k])
    loc_n0 = loc.tracker._n_kfs
    for i in range(split, n):
        loc.track_rgbd(*frames[i])
    res["localization"] = dict(keyframes_loaded=loc_n0, keyframes_saved=snap["n_kfs"],
                               keyframes_after=loc.tracker._n_kfs,
                               statuses=[s["status"] for s in loc.tracker.stats])
    # One keyframe's dense consumer under the profiler, on a fresh map that
    # has taken the same payload once (its blocks allocated).
    rgb, depth, T_cw = sys_.payloads[-1]
    depth_m = depth_metres(torch.from_numpy(depth).to(dev))
    prof = SlamSystem(cfg, enable_dense_map=True, device=dev)
    prof._insert_keyframe_cloud(rgb, depth_m, T_cw)
    res["keyframe_profile"] = _profile_call(
        lambda: prof._insert_keyframe_cloud(rgb, depth_m, T_cw), dev, prefix="dense.")
    res["blocks_per_keyframe"] = len(prof.grid.blocks)
    _log("11b SlamSystem with semantics and the dense map: " + json.dumps(res) + f"; limits: "
         f">= {DENSE_SURFACE_SHARE} of the occupied centres within {DENSE_SURFACE_TOL} m of a "
         f"surface, > {DENSE_MIN_OCCUPIED} occupied, flips {DENSE_FLIP_SHARE}; card: {card}")
    if res["statuses_ok"] != n:
        raise AssertionError(f"11b: {n - res['statuses_ok']} frames not OK")
    if kf != kf_plain or res["pose_gap_m"] != 0.0 or res["position_gap_m"] != 0.0:
        raise AssertionError(f"11b: the dense map changed tracking: keyframes {kf} against "
                             f"{kf_plain}, poses {res['pose_gap_m']} m apart")
    if not (res["occupied"] > DENSE_MIN_OCCUPIED
            and res["near_surface_share"] >= DENSE_SURFACE_SHARE):
        raise AssertionError(f"11b: {res['occupied']} occupied voxels, "
                             f"{res['near_surface_share']:.3f} near a surface")
    if not res["replay"]["blocks_equal"]:
        raise AssertionError("11b: the CPU replay allocated other blocks")
    _check_gaps("11b replay", res["replay"])
    if not res["octomap_gap_m"] <= OCTO_TOL:
        raise AssertionError(f"11b: the octomap round trip moved centres {res['octomap_gap_m']}")
    lz = res["localization"]
    if lz["keyframes_after"] != lz["keyframes_loaded"] or lz["keyframes_loaded"] != \
            lz["keyframes_saved"] or "LOST" in lz["statuses"]:
        raise AssertionError(f"11b: localization on the loaded map: {lz}")
    res.update(payloads=sys_.payloads, payload_frames=sys_.frames)
    return res


def check_batched_consume(dev, scene: dict, params: dict, dense_res: dict,
                          cam: CameraConfig, card: str) -> dict:
    """11c: `make_batched_consume` on 11b's keyframe payloads against the
    engine path (`SlamSystem._on_new_keyframe` into a dense 0.1 m grid) on
    the same payloads, with JAX's rules (`tests/test_semantic.py`): the
    same object count, every batched centroid within 0.10 m of an engine
    one, at most 2% of the touched voxels differing. The score gates are 0
    so the seeded weights' boxes reach fusion; the engine detects its queue
    in one bf16 batch, as the consumer does (the seeded scores crowd within
    1e-7 of each other: bf16 against f32 would compare two draws of that
    noise)."""
    payloads, frames = dense_res["payloads"], dense_res["payload_frames"]
    base = SlamConfig(camera=cam)
    cfg = base.replace(
        semantic=dataclasses.replace(base.semantic, det_score_threshold=0.0,
                                     fusion_prob_threshold=0.0),
        dense=dataclasses.replace(_consume_dense(base.dense), unbounded=False))
    engine = SlamSystem(cfg, enable_semantics=True, enable_dense_map=True,
                        detector_params=params, device=dev)
    engine._det_batch = len(payloads)
    with highest_precision():
        for rgb, depth, T_cw in payloads:
            engine._on_new_keyframe(rgb, depth, T_cw)
    consume, _ = make_batched_consume(cfg, frames, np.arange(len(frames)),
                                      detector=engine.detector, device=dev, **CONSUME_GRID)
    T_all = torch.from_numpy(np.stack([p[2] for p in payloads])).to(dev)
    lo0 = torch.zeros_like(engine.grid.log_odds)

    def run():
        return consume(scene["grays"], scene["depths"], T_all, lo0,
                       torch.Generator().manual_seed(0))

    lo, nd, db = run()
    v_e, v_b = engine.object_db.valid.cpu().numpy(), db.valid.cpu().numpy()
    ce, cb = engine.object_db.centroid.cpu().numpy()[v_e], db.centroid.cpu().numpy()[v_b]
    lo_e, lo_b = engine.grid.log_odds.cpu().numpy(), lo.cpu().numpy()
    touched = int(((lo_e != 0) | (lo_b != 0)).sum())
    res = dict(keyframes=len(frames), objects_engine=int(v_e.sum()), objects_batched=int(v_b.sum()),
               detections=nd.cpu().tolist(),
               centroid_gap_m=max((float(np.linalg.norm(ce - c[None], axis=-1).min())
                                   for c in cb), default=0.0) if len(ce) else None,
               touched=touched, differing=int((np.abs(lo_e - lo_b) > 1e-4).sum()),
               consume_ms=_sync_ms(run, dev, 3))
    _log("11c batched consumer against the engine path: " + json.dumps(res) + "; limits: equal "
         f"object counts, centroids {CONSUME_CENTROID_TOL} m, {CONSUME_VOXEL_SHARE} of the touched "
         f"voxels; card: {card}")
    if not (res["objects_engine"] == res["objects_batched"] > 0
            and res["centroid_gap_m"] < CONSUME_CENTROID_TOL):
        raise AssertionError(f"11c: the batched consumer's objects differ: {res}")
    if not (touched > 5000 and res["differing"] <= CONSUME_VOXEL_SHARE * touched):
        raise AssertionError(f"11c: the batched consumer's map differs: {res}")
    return res


def run_stereo(dev, scene: dict, cam: CameraConfig, card: str) -> dict:
    """11d: `track_stereo` on phase 10's first STEREO_FRAMES views and
    right views rendered on the card at the left pose shifted along the
    camera's x by the baseline bf / fx: no frame LOST, two extractions a
    frame, ATE under STEREO_ATE_FACTOR times the CPU rehearsal's."""
    n = STEREO_FRAMES
    poses = scene["poses"][:n]
    shift = np.eye(4, dtype=np.float32)
    shift[0, 3] = cam.bf / cam.fx
    (right, _), render_ms = _timed(lambda: device_render.render_frames(
        poses @ shift, cam, size=SEM_ROOM, seed=SEM_SEED, box_gray=scene["box_gray"],
        device=dev), dev)
    left, right = scene["gray_host"][:n], right.cpu().numpy()
    sys_ = SlamSystem(SlamConfig(camera=cam), device=dev)
    with _CountingExtract() as count:
        ms = [_timed(lambda: sys_.track_stereo(left[i], right[i], i / 30.0), dev)[1]
              for i in range(n)]
    statuses = [s["status"] for s in sys_.tracker.stats]
    res = dict(frames=n, extractions=count.calls, statuses=statuses,
               keyframes=sys_.tracker._n_kfs,
               ate_m=evaluate_ate_xyz(sys_.tracker.camera_positions(), poses[:, :3, 3]).rmse,
               median_frame_ms=statistics.median(ms[1:]), render_ms_per_view=render_ms / n)
    _log("11d track_stereo: " + json.dumps(res) + f"; limits: ATE < {STEREO_ATE_FACTOR} x "
         f"{STEREO_CPU_ATE} m (the CPU rehearsal), 2 extractions a frame; card: {card}")
    if "LOST" in statuses or count.calls != 2 * n:
        raise AssertionError(f"11d: statuses {statuses}, {count.calls} extractions for {n} pairs")
    if not res["ate_m"] < STEREO_ATE_FACTOR * STEREO_CPU_ATE:
        raise AssertionError(f"11d: ATE {res['ate_m']:.5f} m")
    return res


def run_monocular(dev, scene: dict, cam: CameraConfig, card: str) -> dict:
    """11e: `track_monocular` on phase 10's first MONO_FRAMES gray views:
    initialized, at least 2 keyframes, finite poses, the camera moved, and
    the initializer's (1024, 1024) search at r = 100 went through B1."""
    n = MONO_FRAMES
    sys_ = SlamSystem(SlamConfig(camera=cam), device=dev)
    K = sys_.cfg.orb.max_keypoints
    with _B1Shapes() as b1:
        runs = [_timed(lambda: sys_.track_monocular(
            scene["gray_host"][i].astype(np.float32), i / 30.0), dev) for i in range(n)]
    T = np.stack([T for T, _ in runs])
    res = dict(frames=n, initialized=sys_.tracker.initialized, keyframes=sys_.tracker._n_kfs,
               tracked_frames=len(sys_.tracker.stats), finite=bool(np.isfinite(T).all()),
               moved=float(np.linalg.norm(T[-1][:3, 3])),
               statuses=[s["status"] for s in sys_.tracker.stats],
               init_searches=sum(s == (K, K, 100.0) for s in b1.seen),
               median_frame_ms=statistics.median(ms for _, ms in runs[1:]))
    _log("11e track_monocular: " + json.dumps(res) + f"; card: {card}")
    if not (res["initialized"] and res["keyframes"] >= 2 and res["finite"]
            and res["moved"] > 1e-3):
        raise AssertionError(f"11e: monocular tracking failed: {res}")
    if dev.type == "cuda" and res["init_searches"] == 0:
        raise AssertionError(f"11e: the initializer's ({K}, {K}) r = 100 search never reached "
                             f"B1: {sorted(set(b1.seen))}")
    return res


def run_dense_path(dev, card: str, scene: dict, params: dict,
                   cam: CameraConfig | None = None) -> dict:
    """Phase 11 on phase 10's scene (rendered on the card); the launch
    counters are zeroed before and read after."""
    cam = cam or CameraConfig()
    work = Path(__file__).resolve().parent / "build" / "dense_check"
    work.mkdir(parents=True, exist_ok=True)
    t11 = time.perf_counter()
    _reset_counts()
    times = {}
    t = time.perf_counter()
    funcs = check_dense_functions(dev, scene, cam, card)
    times["11a"] = time.perf_counter() - t
    t = time.perf_counter()
    system = run_dense_system(dev, scene, params, cam, card, work)
    times["11b"] = time.perf_counter() - t
    t = time.perf_counter()
    batched = check_batched_consume(dev, scene, params, system, cam, card)
    times["11c"] = time.perf_counter() - t
    for k in ("payloads", "payload_frames"):
        system.pop(k)
    t = time.perf_counter()
    stereo = run_stereo(dev, scene, cam, card)
    times["11d"] = time.perf_counter() - t
    t = time.perf_counter()
    mono = run_monocular(dev, scene, cam, card)
    times["11e"] = time.perf_counter() - t
    counts = _path_launches("11: the dense, stereo and monocular runs", dev)
    phase_s = time.perf_counter() - t11
    _log(f"phase 11 took {phase_s:.1f} s ({json.dumps(times)}), launches {json.dumps(counts)}; "
         f"card: {card}")
    return dict(functions=funcs, system=system, batched=batched, stereo=stereo, mono=mono,
                **counts, phase_s=phase_s, times=times)


# ---- phase 12: training, the apps and profiling -------------------------------

def check_training(dev, card: str) -> dict:
    """12a: one training step's loss and gradients (`train.value_and_grad`)
    of the seeded 4-class SSDLite on a numpy batch of 2, on the card and on
    a CPU copy: the loss within TRAIN_LOSS_TOL relative, every one of the
    404 gradients (the batch statistics' too) within TRAIN_GRAD_TOL of that
    gradient's norm. Gradients, not weights after a step: Adam's first step
    is +-lr for any nonzero gradient, so a gradient near 0 could flip a
    weight by 2 lr between devices. (How far each backend's f32 step lies
    from float64: `train_precision_probe.py`.)"""
    batch = synthetic_detection_batch(np.random.default_rng(1), 2, n_classes=3)
    (loss, grads), card_ms = _timed(
        lambda: value_and_grad(init_ssdlite(TRAIN_CLASSES, seed=0, device=dev), *batch), dev)
    t = time.perf_counter()
    loss_c, grads_c = value_and_grad(init_ssdlite(TRAIN_CLASSES, seed=0, device="cpu"), *batch)
    cpu_ms = (time.perf_counter() - t) * 1e3
    # Largest difference over the CPU gradient's norm, per nonzero gradient.
    rel = {k: float((grads[k].cpu().double() - g.double()).abs().max())
           / float(torch.linalg.vector_norm(g.double()))
           for k, g in grads_c.items() if float(g.abs().max()) > 0}
    zero_mismatch = [k for k, g in grads_c.items()
                     if k not in rel and float(grads[k].abs().max()) != 0.0]
    worst = max(rel, key=rel.get)
    stats = [k for k in rel if k.endswith(("running_mean", "running_var"))]
    res = dict(arrays=len(grads_c), loss=float(loss), loss_cpu=float(loss_c),
               loss_rel_gap=abs(float(loss) - float(loss_c)) / abs(float(loss_c)),
               worst_gradient=worst, worst_gradient_rel_gap=rel[worst],
               worst_batch_stat_rel_gap=max(rel[k] for k in stats),
               over_tol=sum(v > TRAIN_GRAD_TOL for v in rel.values()),
               batch_stats_with_gradient=len(stats), zero_gradients=len(grads_c) - len(rel),
               zero_mismatch=zero_mismatch, card_first_call_ms=card_ms, cpu_ms=cpu_ms)
    _log("12a one training step, card against CPU: " + json.dumps(res) + f"; limits: loss "
         f"{TRAIN_LOSS_TOL} relative, gradients {TRAIN_GRAD_TOL} of each norm; card: {card}")
    if res["arrays"] != 404 or len(stats) < 100 or zero_mismatch:
        raise AssertionError(f"12a: gradients missing or zero on one side only: {res}")
    if not (res["loss_rel_gap"] <= TRAIN_LOSS_TOL and rel[worst] <= TRAIN_GRAD_TOL):
        raise AssertionError(f"12a: the card's training step differs from the CPU's: {res}")
    return res


def e2e_rectangle(c: int = 2, n_classes: int = 3, w: int = 640, h: int = 480):
    """`tests/test_ssd_e2e.py::_render_scene`: a noisy background and one
    solid rectangle whose intensity band is class `c`; (rgb, box px)."""
    rng = np.random.default_rng(7)
    img = rng.normal(0.0, 0.08, (h, w, 3)).astype(np.float32)
    x1, y1, bw, bh = 0.3, 0.3, 0.35, 0.35
    px = [int(x1 * w), int(y1 * h), int((x1 + bw) * w), int((y1 + bh) * h)]
    img[px[1]:px[3], px[0]:px[2], :] = -0.8 + 1.6 * c / n_classes + rng.normal(
        0.0, 0.05, (px[3] - px[1], px[2] - px[0], 3))
    return np.clip(img * 127.5 + 127.5, 0, 255).astype(np.uint8), np.asarray(px, np.float32)


def _iou(a, b) -> float:
    lt, rb = np.maximum(a[:2], b[:2]), np.minimum(a[2:], b[2:])
    inter = float(np.prod(np.maximum(rb - lt, 0)))
    return inter / max(float(np.prod(a[2:] - a[:2]) + np.prod(b[2:] - b[:2])) - inter, 1e-9)


def run_training_app(dev, card: str, work: Path) -> dict:
    """12b: `train_ssdlite.main` (TRAIN_STEPS steps of batch TRAIN_BATCH,
    4 classes, seed 0) on `dev`: the last chunk's mean loss under
    TRAIN_DROP of the first's (`tests/test_ssd_train.py`'s rule); ms a step,
    the launches of a step, peak memory; the checkpoint loaded into a
    `Detector` with no warning and run on `test_ssd_e2e.py`'s rectangle
    (class 2): the best detection is reported, not gated."""
    ckpt = str(work / "ssdlite_c4.npz")
    argv = ["--steps", str(TRAIN_STEPS), "--batch", str(TRAIN_BATCH), "--classes",
            str(TRAIN_CLASSES), "--out", ckpt, "--seed", "0"]
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    else:
        argv += ["--device", "cpu"]
    res = train_ssdlite.main(argv)
    mem = profiling.device_memory_stats()
    steps = len(res.chunk_losses) * train_ssdlite.INNER
    step = make_train_step(res.model, adam(res.model))
    batch = synthetic_detection_batch_device(torch.Generator(device=dev).manual_seed(99),
                                             TRAIN_BATCH, n_classes=3)
    step(*batch)
    prof = _profile_call(lambda: step(*batch), dev, prefix="train.")
    with warnings.catch_warnings():
        warnings.filterwarnings("error", message="could not load SSD checkpoint")
        warnings.filterwarnings("error", message="trained artifact")
        det = Detector(SemanticConfig(num_classes=TRAIN_CLASSES, det_score_threshold=0.4,
                                      fusion_prob_threshold=0.4, checkpoint_path=ckpt),
                       device=dev)
    rgb, gt_px = e2e_rectangle()
    out = det(rgb)
    boxes, scores = out.boxes.cpu().numpy(), out.scores.cpu().numpy()
    classes, valid = out.classes.cpu().numpy(), out.valid.cpu().numpy()
    best = [dict(cls=int(classes[i]), score=float(scores[i]), iou=_iou(boxes[i], gt_px))
            for i in np.nonzero(valid)[0]]
    r = dict(steps=steps, batch=TRAIN_BATCH, seconds=res.seconds,
             ms_per_step=res.seconds * 1e3 / steps, chunk_losses=res.chunk_losses,
             first_chunk=res.chunk_losses[0], last_chunk=res.chunk_losses[-1],
             launches_per_step=prof.get("runtime_calls", {}).get("cudaLaunchKernel"),
             syncs_per_step=prof.get("runtime_calls", {}).get("cudaStreamSynchronize", 0),
             device_busy_ms_per_step=prof.get("device_busy_ms"),
             memory=mem,
             detections=len(best), top_detection=max(best, key=lambda d: d["score"], default=None),
             best_class2_iou=max((d["iou"] for d in best if d["cls"] == 2), default=0.0))
    _log("12b train_ssdlite on the card: " + json.dumps(r) + f"; limit: last chunk < "
         f"{TRAIN_DROP} x the first; card: {card}")
    if not r["last_chunk"] < TRAIN_DROP * r["first_chunk"]:
        raise AssertionError(f"12b: the loss fell from {r['first_chunk']:.4f} to only "
                             f"{r['last_chunk']:.4f}")
    return r | {"checkpoint": ckpt}


def write_tum_sequence(root: Path, scene: dict) -> None:
    """Phase 10's frames as a TUM RGB-D sequence: RGB PNGs (the gray view in
    three channels), 16-bit depth PNGs at the factor 5000,
    `associate.txt` and `groundtruth.txt` (the rendering poses)."""
    from PIL import Image

    (root / "rgb").mkdir(parents=True, exist_ok=True)
    (root / "depth").mkdir(parents=True, exist_ok=True)
    lines = []
    for i, (g, d) in enumerate(zip(scene["gray_host"], scene["depth_host"])):
        t = f"{i / 30.0:.6f}"
        Image.fromarray(np.repeat(g[..., None], 3, axis=-1)).save(root / "rgb" / f"{t}.png")
        Image.fromarray((d.astype(np.uint32) * 5).astype(np.uint16)).save(
            root / "depth" / f"{t}.png")
        lines.append(f"{t} rgb/{t}.png {t} depth/{t}.png")
    (root / "associate.txt").write_text("\n".join(lines) + "\n")
    T_wc = scene["poses"]
    qs = [se3.rot_to_quat(torch.from_numpy(np.ascontiguousarray(T[:3, :3]))).numpy()
          for T in T_wc]
    write_trajectory(str(root / "groundtruth.txt"), [i / 30.0 for i in range(len(T_wc))],
                     T_wc[:, :3, 3], qs)


def run_rgbd_tum_app(dev, scene: dict, cam: CameraConfig, card: str, work: Path) -> dict:
    """12c: `rgbd_tum.main` on phase 10's frames written as a TUM sequence,
    with a JSON settings file of phase 11b's configuration (the detector's
    seeded weights, which 11b passes as parameters), `--semantics
    --dense-map --groundtruth`: every frame OK, ATE under SEM_ATE_GATE,
    both trajectory files read back (a line a frame, a line a keyframe)."""
    root, out = work / "tum", work / "tum_out"
    t = time.perf_counter()
    write_tum_sequence(root, scene)
    write_s = time.perf_counter() - t
    base = SlamConfig(camera=cam)
    cfg = base.replace(
        tracking=dataclasses.replace(base.tracking, max_frames_between_kfs=DENSE_KF_GAP),
        semantic=dataclasses.replace(base.semantic, checkpoint_path=None))
    (root / "settings.json").write_text(cfg.to_json())
    argv = ["--sequence", str(root), "--settings", str(root / "settings.json"), "--semantics",
            "--dense-map", "--groundtruth", str(root / "groundtruth.txt"), "--out", str(out)]
    if dev.type != "cuda":
        argv += ["--device", "cpu"]
    res = rgbd_tum.main(argv)
    tr = res.system.tracker
    cam_stamps = read_trajectory(str(out / "CameraTrajectory.txt"))[0]
    kf_stamps = read_trajectory(str(out / "KeyFrameTrajectory.txt"))[0]
    r = dict(frames=len(res.frame_s), write_s=write_s,
             statuses_ok=sum(s["status"] == "OK" for s in tr.stats), ate_m=res.ate.rmse,
             ate_pairs=res.ate.n_pairs, camera_lines=len(cam_stamps), keyframe_lines=len(kf_stamps),
             keyframes=tr._n_kfs, objects=len(res.system.objects()),
             occupied=len(res.system.grid.occupied_centers()[0]),
             median_frame_ms=statistics.median(res.frame_s[1:]) * 1e3)
    _log("12c rgbd_tum on phase 10's frames: " + json.dumps(r) + f"; limits: ATE < "
         f"{SEM_ATE_GATE} m, every frame OK; card: {card}")
    n = len(scene["poses"])
    if not (r["statuses_ok"] == r["frames"] == n and r["ate_m"] < SEM_ATE_GATE):
        raise AssertionError(f"12c rgbd_tum: {r}")
    if not (r["camera_lines"] == n and r["keyframe_lines"] == r["keyframes"] >= 2):
        raise AssertionError(f"12c rgbd_tum: the trajectory files hold {r['camera_lines']} and "
                             f"{r['keyframe_lines']} lines for {n} frames, {r['keyframes']} "
                             f"keyframes")
    return r


def check_detect_locate_app(dev, scene: dict, ckpt: str, card: str, work: Path) -> dict:
    """12c: `detect_locate.main` with 12b's checkpoint on LOCATE_VIEWS of
    phase 10 and `test_ssd_e2e.py`'s rectangle on a plane 2 m away (so
    that at least one detection passes the fusion gate), saved as npy,
    both fusion schemes, on `dev` and on the CPU: the same objects (valid
    flags and classes equal, centroids within LOCATE_TOL), at least one."""
    src = work / "locate"
    src.mkdir(parents=True, exist_ok=True)
    views = [(np.repeat(scene["gray_host"][i][..., None], 3, axis=-1),
              scene["depth_host"][i].astype(np.float32) * 1e-3) for i in LOCATE_VIEWS]
    rect = e2e_rectangle(w=views[0][0].shape[1], h=views[0][0].shape[0])[0]
    views.append((rect, np.full(rect.shape[:2], 2.0, np.float32)))
    for i, (rgb, depth) in enumerate(views):
        np.save(src / f"rgb_{i:03d}.npy", rgb)
        np.save(src / f"depth_{i:03d}.npy", depth)
    res = {}
    for scheme in ("depth", "seg"):
        argv = ["--source", str(src), "--frames", str(len(views)), "--scheme", scheme,
                "--params", ckpt]
        db, ms = _timed(lambda: detect_locate.main(argv + (
            [] if dev.type == "cuda" else ["--device", "cpu"])), dev)
        db_c = detect_locate.main(argv + ["--device", "cpu"])
        v, v_c = db.valid.cpu().numpy(), db_c.valid.cpu().numpy()
        same = bool((v == v_c).all())
        res[scheme] = dict(objects=int(v.sum()), objects_cpu=int(v_c.sum()), valid_equal=same,
                           classes_equal=same and bool((db.class_id.cpu().numpy()[v]
                                                        == db_c.class_id.cpu().numpy()[v]).all()),
                           centroid_gap_m=float(np.abs(db.centroid.cpu().numpy()[v]
                                                       - db_c.centroid.cpu().numpy()[v]).max())
                           if same and v.any() else (0.0 if same else None),
                           app_ms=ms)
    _log("12c detect_locate, card against CPU: " + json.dumps(res) + f"; limit: centroids "
         f"{LOCATE_TOL} m, labels equal; card: {card}")
    for scheme, r in res.items():
        if not (r["classes_equal"] and r["centroid_gap_m"] <= LOCATE_TOL and r["objects"] > 0):
            raise AssertionError(f"12c detect_locate ({scheme}): the card's database differs "
                                 f"from the CPU's: {r}")
    return res


def check_cloud_app(dev, cloud: dict, card: str, work: Path) -> dict:
    """12c: `cloud_to_occupancy.main` on phase 11a's keyframe cloud (at
    least 2 chunks), from its sensor origin, on `dev` and on the CPU: the
    two files equal on every voxel."""
    pts = cloud["points"]
    path = work / "cloud.npz"
    np.savez(path, points=pts)
    argv = [str(path), "", "--origin", *(str(float(x)) for x in cloud["origin"])]
    outs = {}
    for name, extra in (("card", [] if dev.type == "cuda" else ["--device", "cpu"]),
                        ("cpu", ["--device", "cpu"])):
        argv[1] = str(work / f"occupancy_{name}.npz")
        outs[name] = _timed(lambda: cloud_to_occupancy.main(argv + extra), dev)[1]
    with np.load(work / "occupancy_card.npz") as a, np.load(work / "occupancy_cpu.npz") as b:
        lo, lo_c = a["log_odds"], b["log_odds"]
        r = dict(points=len(pts), chunks=-(-len(pts) // cloud_to_occupancy.CHUNK),
                 touched=int(((lo != 0) | (lo_c != 0)).sum()), flips=int((lo != lo_c).sum()),
                 occupied=int((lo > 0).sum()),
                 other_arrays_equal=all(np.array_equal(a[k], b[k]) for k in a.files),
                 card_ms=outs["card"], cpu_ms=outs["cpu"])
    _log("12c cloud_to_occupancy, card against CPU: " + json.dumps(r) + f"; card: {card}")
    if not (r["chunks"] >= 2 and r["touched"] > 1000 and r["flips"] == 0
            and r["other_arrays_equal"]):
        raise AssertionError(f"12c cloud_to_occupancy: {r}")
    return r


def run_apps_path(dev, card: str, scene: dict, cloud: dict,
                  cam: CameraConfig | None = None) -> dict:
    """Phase 12a-12c's apps on phases 10-11's data (counts zeroed before,
    read after): training against the CPU, the training app, `rgbd_tum`,
    `detect_locate` and `cloud_to_occupancy`."""
    cam = cam or CameraConfig()
    work = Path(__file__).resolve().parent / "build" / "apps_check"
    work.mkdir(parents=True, exist_ok=True)
    t12 = time.perf_counter()
    _reset_counts()
    times = {}
    t = time.perf_counter()
    training = check_training(dev, card)
    times["12a"] = time.perf_counter() - t
    t = time.perf_counter()
    train_app = run_training_app(dev, card, work)
    times["12b"] = time.perf_counter() - t
    t = time.perf_counter()
    tum = run_rgbd_tum_app(dev, scene, cam, card, work)
    times["12c_rgbd_tum"] = time.perf_counter() - t
    t = time.perf_counter()
    locate = check_detect_locate_app(dev, scene, train_app["checkpoint"], card, work)
    times["12c_detect_locate"] = time.perf_counter() - t
    t = time.perf_counter()
    occupancy = check_cloud_app(dev, cloud, card, work)
    times["12c_cloud_to_occupancy"] = time.perf_counter() - t
    counts = _path_launches("12c: rgbd_tum", dev)
    phase_s = time.perf_counter() - t12
    _log(f"phase 12a-c took {phase_s:.1f} s ({json.dumps(times)}), launches {json.dumps(counts)}; "
         f"card: {card}")
    return dict(training=training, train_app=train_app, rgbd_tum=tum, detect_locate=locate,
                cloud_to_occupancy=occupancy, **counts, phase_s=phase_s, times=times)


def check_run_synthetic(dev, rendered, main_poses: np.ndarray, card: str) -> dict:
    """12c: `run_synthetic.track` on phase 4's first APP_FRAMES frames at
    phase 4's config: the poses phase 4's `Tracker.process` returned
    (0.0 m: one code path, deterministic kernels)."""
    seq, frames, *_ = rendered
    n = APP_FRAMES
    tracker, poses, times = run_synthetic.track(
        ((g, d, seq.stamps[i]) for i, (g, d) in enumerate(frames[:n])), main_path_config(), dev,
        log=lambda s: None)
    r = dict(frames=n, pose_gap=float(np.abs(poses - main_poses[:n]).max()),
             median_frame_ms=statistics.median(times[1:]) * 1e3)
    _log("12c run_synthetic on phase 4's frames: " + json.dumps(r) + f"; card: {card}")
    if r["pose_gap"] != 0.0:
        raise AssertionError(f"12c run_synthetic: poses {r['pose_gap']} from phase 4's")
    return r


def check_vocabulary_app(dev, rendered, card: str, work: Path) -> dict:
    """12c: `train_vocabulary`'s tree (k = VOCAB_K, depth = VOCAB_DEPTH) and
    TF-IDF weights on the card's descriptors of VOCAB_FRAMES of phase 4's
    frames; the saved file loads, and `quantize` of those descriptors
    through it on the card equals `quantize` on the CPU."""
    frames = rendered[1]
    orb = main_path_config().orb
    descs = [train_vocabulary.image_descriptors(frames[i][0], orb, dev) for i in VOCAB_FRAMES]
    t = time.perf_counter()
    vocab = train_vocabulary.build_tree(np.concatenate(descs), VOCAB_K, VOCAB_DEPTH, seed=0)
    vocab = train_vocabulary.tfidf(vocab, descs, dev)
    build_s = time.perf_counter() - t
    path = str(work / "vocab.npz")
    voc.save_binary(vocab, path)
    loaded = voc.load_binary(path)
    data = torch.from_numpy(np.concatenate(descs).view(np.int32))
    ones = torch.ones(len(data), dtype=torch.bool)
    w_card = voc.quantize(voc.to_device(loaded, dev), data.to(dev), ones.to(dev)).cpu()
    w_cpu = voc.quantize(voc.to_device(loaded, torch.device("cpu")), data, ones)
    r = dict(descriptors=len(data), nodes=int(loaded.children.shape[0]), words=loaded.n_words,
             weighted_words=int((loaded.word_weight > 0).sum()), build_s=build_s,
             words_differing=int((w_card != w_cpu).sum()), unassigned=int((w_cpu < 0).sum()))
    _log("12c train_vocabulary on the card's descriptors: " + json.dumps(r) + f"; card: {card}")
    if not (r["words"] > VOCAB_K and r["words_differing"] == 0 and r["unassigned"] == 0
            and r["weighted_words"] > 0):
        raise AssertionError(f"12c train_vocabulary: {r}")
    return r


def check_trace(dev, rendered, card: str, work: Path) -> dict:
    """12d: `profiling.trace` around TRACE_FRAMES tracked frames of phase 4
    (a fresh tracker, frame 0 before the trace), each in an `annotate`
    range: the Chrome trace exists and holds the labels and, on the card,
    B1's two kernels."""
    seq, frames, *_ = rendered
    tracker = Tracker(main_path_config(), device=dev)
    tracker.process(*frames[0], float(seq.stamps[0]))
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    with profiling.trace(str(work / "trace")) as log_dir:
        for i in TRACE_FRAMES:
            with profiling.annotate(f"app.frame_{i}"):
                tracker.process(*frames[i], float(seq.stamps[i]))
        sync()
    path = Path(log_dir) / "trace.json"
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    kernels = {e["name"] for e in events if e.get("cat") == "kernel"}
    r = dict(trace_mb=path.stat().st_size / 2**20, events=len(events),
             labels=sum(e.get("name", "").startswith("app.frame_") for e in events),
             kernel_names=len(kernels),
             b1_kernels=sorted(k[:60] for k in kernels if "window_match" in k))
    _log("12d profiling.trace around tracked frames: " + json.dumps(r) + f"; card: {card}")
    if r["labels"] < len(TRACE_FRAMES):
        raise AssertionError(f"12d: the trace holds {r['labels']} annotate labels")
    if dev.type == "cuda" and len(r["b1_kernels"]) < 2:
        raise AssertionError(f"12d: B1's kernels are not in the trace: {r['b1_kernels']}")
    return r


def run_frame_apps_path(dev, card: str, rendered, main_poses: np.ndarray) -> dict:
    """Phase 12c-12d on phase 4's frames (counts zeroed before, read after):
    `run_synthetic`, `train_vocabulary` and the profiler trace."""
    work = Path(__file__).resolve().parent / "build" / "apps_check"
    work.mkdir(parents=True, exist_ok=True)
    t12 = time.perf_counter()
    _reset_counts()
    synthetic = check_run_synthetic(dev, rendered, main_poses, card)
    vocab = check_vocabulary_app(dev, rendered, card, work)
    trace = check_trace(dev, rendered, card, work)
    counts = _path_launches("12c-d: run_synthetic and the trace", dev)
    phase_s = time.perf_counter() - t12
    _log(f"phase 12c-d on phase 4's frames took {phase_s:.1f} s, launches "
         f"{json.dumps(counts)}; card: {card}")
    return dict(run_synthetic=synthetic, vocabulary=vocab, trace=trace, **counts,
                phase_s=phase_s)


# ---- phase 13: the live app and the rest ----------------------------------------

def check_registration(dev, scene: dict, card: str) -> dict:
    """13a: `register_depth_to_color` on phase 10's view REG_VIEW (metres)
    through a small baseline and yaw, on `dev` and on the CPU; the
    identity; a near square before a far wall (the nearest z must win
    where both land)."""
    cam = CameraConfig()
    depth = scene["depth_host"][REG_VIEW].astype(np.float32) * 1e-3
    h, w = depth.shape
    T_cd = se3.se3_exp(torch.tensor([REG_BASELINE, 0.0, 0.0, 0.0, np.deg2rad(REG_YAW_DEG),
                                     0.0])).numpy()
    wall = np.full((h, w), 3.0, np.float32)
    y0, x0 = (h - REG_PATCH) // 2, (w - REG_PATCH) // 2
    wall[y0:y0 + REG_PATCH, x0:x0 + REG_PATCH] = 1.0

    def reg(d, T, device):
        return register_depth_to_color(d, T, cam, cam, h, w, device=device).cpu().numpy()

    cpu = torch.device("cpu")
    a, b = reg(depth, T_cd, dev), reg(depth, T_cd, cpu)
    both = (a > 0) & (b > 0)
    ident = reg(depth, np.eye(4, dtype=np.float32), dev)
    occ, occ_c = reg(wall, T_cd, dev), reg(wall, T_cd, cpu)
    near = (occ > 0) & (occ < 2.0)
    depth_t, T_t = torch.from_numpy(depth).to(dev), torch.from_numpy(T_cd).to(dev)
    r = dict(shape=[h, w], filled=int((a > 0).sum()), filled_cpu=int((b > 0).sum()),
             same_pixels_share=float(((a > 0) == (b > 0)).mean()),
             depth_gap_m=float(np.abs(a[both] - b[both]).max()),
             identity_gap_m=float(np.abs(ident - depth).max()),
             near_pixels=int(near.sum()), patch_pixels=REG_PATCH ** 2,
             near_z=[float(occ[near].min()), float(occ[near].max())],
             occluder_same_pixels=bool(np.array_equal(occ > 0, occ_c > 0)),
             occluder_gap_m=float(np.abs(occ - occ_c).max()))
    if dev.type == "cuda":
        r["ms"] = _time_ms(lambda: register_depth_to_color(depth_t, T_t, cam, cam, h, w))
    _log("13a register_depth_to_color, card against CPU: " + json.dumps(r) + f"; limits: "
         f"{REG_MATCH} of pixels alike, {REG_TOL} m, a near square kept on {REG_NEAR_SHARE} of "
         f"its pixels; card: {card}")
    if not (r["same_pixels_share"] >= REG_MATCH and r["depth_gap_m"] <= REG_TOL
            and r["identity_gap_m"] <= REG_TOL and r["filled"] > 0.5 * h * w):
        raise AssertionError(f"13a registration: {r}")
    if not (r["near_pixels"] >= REG_NEAR_SHARE * r["patch_pixels"] and r["near_z"][1] < 1.1
            and r["occluder_same_pixels"] and r["occluder_gap_m"] <= REG_TOL):
        raise AssertionError(f"13a registration: the near square was not kept: {r}")
    return r


def check_undistortion(dev, scene: dict, card: str) -> dict:
    """13b: `undistort_image` on phase 10's view REG_VIEW, gray and as RGB,
    with k1 = UND_K1, on `dev` and on the CPU; with no distortion the
    input comes back."""
    gray = scene["gray_host"][REG_VIEW]
    cam, plain = CameraConfig(k1=UND_K1), CameraConfig()
    r = {}
    for name, img in (("gray", gray), ("rgb", np.repeat(gray[..., None], 3, axis=-1))):
        out = undistort_image(img, cam, device=dev).cpu().numpy()
        out_c = undistort_image(img, cam, device="cpu").numpy()
        same = undistort_image(img, plain, device=dev).cpu().numpy()
        r[name] = dict(shape=list(out.shape), gap_cpu=float(np.abs(out - out_c).max()),
                       moved_mean=float(np.abs(out - img).mean()),
                       identity_gap=float(np.abs(same - img).max()))
    if dev.type == "cuda":
        rgb_t = torch.from_numpy(np.repeat(gray[..., None], 3, axis=-1)).to(dev)
        r["rgb"]["ms"] = _time_ms(lambda: undistort_image(rgb_t, cam))
    _log("13b undistort_image, card against CPU: " + json.dumps(r) + f"; limit: {UND_TOL} "
         f"gray levels; card: {card}")
    for name, v in r.items():
        if not (v["gap_cpu"] <= UND_TOL and v["identity_gap"] <= UND_TOL
                and v["moved_mean"] > 1.0):
            raise AssertionError(f"13b undistortion ({name}): {v}")
    return r


class _MarkedFrames:
    """Frames for `live_rgbd.run` as (rgb, depth, stamp): the host clock at
    each frame's request (so the differences are whole frames: the
    undistortion, the registration and `track_rgbd`), and a profiler over
    LIVE_PROFILE_FRAMES on the card."""

    def __init__(self, items, dev):
        self.items, self.marks = items, []
        self.prof = torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        ) if dev.type == "cuda" else None

    def __iter__(self):
        for i, item in enumerate(self.items):
            if self.prof is not None and i == LIVE_PROFILE_FRAMES.start:
                self.prof.start()
            if self.prof is not None and i == LIVE_PROFILE_FRAMES.stop:
                self.prof.stop()
            self.marks.append(time.perf_counter())
            yield item
        self.marks.append(time.perf_counter())

    def frame_ms(self) -> list:
        """Whole-frame ms of the frames outside the profiled window."""
        ms = np.diff(self.marks) * 1e3
        return [float(v) for i, v in enumerate(ms) if i not in LIVE_PROFILE_FRAMES]


def _app_run_summary(res, gt_positions: np.ndarray, out: Path, cfg: SlamConfig, dev) -> dict:
    """Statuses, ATE, the files written and the map read back through
    `io/map_io.load_map`."""
    tr = res.system.tracker
    n = len(tr.stats)
    state = load_map(str(out / "map.npz"), cfg, dev)
    return dict(frames=n, statuses_ok=sum(s["status"] == "OK" for s in tr.stats),
                ate_m=evaluate_ate_xyz(tr.camera_positions(), gt_positions[:n]).rmse,
                files=sorted(p.name for p in out.iterdir()),
                camera_lines=len(read_trajectory(str(out / "CameraTrajectory.txt"))[0]),
                keyframes=tr._n_kfs, map_kfs=int(state.n_kfs), map_points=int(state.n_points),
                points=int(tr.state.n_points),
                median_track_ms=statistics.median(res.frame_s[1:]) * 1e3)


def _check_app_run(label: str, r: dict, n: int) -> None:
    want = {"CameraTrajectory.txt", "KeyFrameTrajectory.txt", "map.npz"}
    if not (r["frames"] == r["statuses_ok"] == r["camera_lines"] == n
            and r["ate_m"] < SEM_ATE_GATE):
        raise AssertionError(f"13c {label}: {r}")
    if not (want <= set(r["files"]) and r["map_kfs"] == r["keyframes"] >= 1
            and r["map_points"] == r["points"]):
        raise AssertionError(f"13c {label}: the saved map does not read back: {r}")


def check_live_app(dev, rendered, scene: dict, card: str, work: Path) -> dict:
    """13c (the launch counts zeroed before): `live_rgbd.run` on phase 4's
    frames with undistortion and an identity registration
    (`load_registration` of an npz at phase 4's intrinsics);
    `live_rgbd.main` on the synthetic source; `run` on the `watch:` source
    over a spool of TUM PNGs (12c's, or written here from phase 10's
    frames)."""
    seq, frames, *_ = rendered
    cfg = main_path_config()
    cam = cfg.camera
    (work / "settings.json").write_text(cfg.to_json())
    np.savez(work / "register.npz", T_cd=np.eye(4, dtype=np.float32), fx=cam.fx, fy=cam.fy,
             cx=cam.cx, cy=cam.cy)
    register = live_rgbd.load_registration(str(work / "register.npz"), cfg)
    quiet = lambda s: None  # noqa: E731
    marked = _MarkedFrames([(np.clip(np.repeat(g[..., None], 3, axis=-1), 0, 255).astype(np.uint8),
                             d, float(seq.stamps[i])) for i, (g, d) in
                            enumerate(frames[:LIVE_FRAMES])], dev)
    t = time.perf_counter()
    res = live_rgbd.run(marked, cfg, undistort=True, register=register, out=str(work / "run"),
                        device=dev, log=quiet)
    run_s = time.perf_counter() - t
    counts_run = _path_launches("13c: the live app", dev)["launches"]
    r = dict(run=_app_run_summary(res, seq.gt_positions(), work / "run", cfg, dev) | dict(
        median_frame_ms=statistics.median(marked.frame_ms()[1:]), wall_s=run_s,
        b1_launches_per_frame=counts_run["window_match"] / LIVE_FRAMES))
    if marked.prof is not None:
        r["run"]["profile"] = _device_breakdown(marked.prof, len(LIVE_PROFILE_FRAMES),
                                                r["run"]["median_frame_ms"])
    _check_app_run("run", r["run"], LIVE_FRAMES)

    t = time.perf_counter()
    res = live_rgbd.main(["--source", "synthetic", "--frames", str(LIVE_SYNTHETIC_FRAMES),
                          "--settings", str(work / "settings.json"), "--out",
                          str(work / "synthetic")] + ([] if dev.type == "cuda" else
                                                      ["--device", "cpu"]))
    r["synthetic"] = _app_run_summary(res, seq.gt_positions(), work / "synthetic", cfg, dev) | dict(
        wall_s=time.perf_counter() - t)
    _check_app_run("main --source synthetic", r["synthetic"], LIVE_SYNTHETIC_FRAMES)

    spool, tum = work / "spool", work.parent / "apps_check" / "tum"
    shutil.rmtree(spool, ignore_errors=True)
    names = sorted(p.name for p in (tum / "rgb").glob("*.png"))[:LIVE_WATCH_FRAMES] \
        if (tum / "rgb").is_dir() else []
    if len(names) == LIVE_WATCH_FRAMES and all((tum / "depth" / n).exists() for n in names):
        for sub in ("rgb", "depth"):
            (spool / sub).mkdir(parents=True)
            for n in names:
                shutil.copy(tum / sub / n, spool / sub / n)
        shutil.copy(tum / "groundtruth.txt", spool / "groundtruth.txt")
        source = "12c's TUM PNGs"
    else:
        write_tum_sequence(spool, {k: scene[k][:LIVE_WATCH_FRAMES]
                                   for k in ("gray_host", "depth_host", "poses")})
        source = "phase 10's frames"
    t = time.perf_counter()
    res = live_rgbd.run(live_rgbd.iter_watch(str(spool), cam.depth_map_factor,
                                             idle_timeout_s=LIVE_IDLE_S),
                        cfg, out=str(work / "watch"), device=dev, log=quiet)
    gt = read_trajectory(str(spool / "groundtruth.txt"))[1]
    r["watch"] = _app_run_summary(res, gt, work / "watch", cfg, dev) | dict(
        source=source, spool_frames=LIVE_WATCH_FRAMES, wall_s=time.perf_counter() - t)
    _check_app_run("watch", r["watch"], LIVE_WATCH_FRAMES)
    _log("13c the live app: " + json.dumps(r) + f"; limits: every frame OK, ATE < "
         f"{SEM_ATE_GATE} m; card: {card}")
    return r


def sim3_drift_problem(seed: int = 0):
    """`tests/test_loop_reloc.py`'s scale-drift graph: SIM3_F keyframes on a
    circle, poses perturbed by 0.05 rad / m and log-scales by 0.15
    (keyframe 0 exact), 11 exact edges with two loop edges."""
    rng = np.random.default_rng(seed)
    F = SIM3_F
    edges = [(i, i + 1) for i in range(F - 1)] + [(0, F - 1), (2, 7)]
    xi = np.stack([[np.cos(2 * np.pi * i / F), 0.05 * i, np.sin(2 * np.pi * i / F), 0.0,
                    2 * np.pi * i / F * 0.3, 0.0] for i in range(F)]).astype(np.float32)
    T_gt = se3.se3_exp(torch.from_numpy(xi)).numpy()
    T0 = T_gt.copy()
    T0[1:] = se3.se3_exp(torch.from_numpy(
        rng.normal(0, 0.05, (F - 1, 6)).astype(np.float32))).numpy() @ T0[1:]
    log_s0 = np.concatenate([[0.0], rng.normal(0, 0.15, F - 1)]).astype(np.float32)
    T_ji = np.stack([T_gt[j] @ np.linalg.inv(T_gt[i]) for i, j in edges]).astype(np.float32)
    E = len(edges)
    graph = dict(edge_i=np.array([e[0] for e in edges]), edge_j=np.array([e[1] for e in edges]),
                 s_ji=np.ones(E, np.float32), T_ji=T_ji, weight=np.ones(E, np.float32),
                 valid=np.ones(E, bool))
    return T_gt, T0, log_s0, graph


def check_sim3_graph(dev, card: str) -> dict:
    """13d: `optimize_pose_graph_sim3` on the scale-drift problem on `dev`
    and on the CPU."""
    T_gt, T0, log_s0, graph = sim3_drift_problem()
    out = {}
    for name, d in (("card", dev), ("cpu", torch.device("cpu"))):
        g = Sim3Graph(**{k: torch.from_numpy(v).to(d) for k, v in graph.items()})
        (T, ls), ms = _timed(lambda: optimize_pose_graph_sim3(
            torch.from_numpy(T0).to(d), torch.from_numpy(log_s0).to(d),
            torch.ones(SIM3_F, dtype=torch.bool, device=d), g, iters=SIM3_ITERS), d)
        out[name] = (T.cpu().numpy(), ls.cpu().numpy(), ms)
    (T, ls, ms), (T_c, ls_c, ms_c) = out["card"], out["cpu"]
    r = dict(keyframes=SIM3_F, edges=len(graph["valid"]), iters=SIM3_ITERS,
             log_scale_max=float(np.abs(ls).max()), pose_gap_gt=float(np.abs(T - T_gt).max()),
             pose_gap_cpu=float(np.abs(T - T_c).max()),
             log_scale_gap_cpu=float(np.abs(ls - ls_c).max()),
             log_scale_max_initial=float(np.abs(log_s0).max()), ms=ms, cpu_ms=ms_c)
    _log("13d optimize_pose_graph_sim3, card against ground truth and CPU: " + json.dumps(r)
         + f"; limits: {SIM3_GT_TOL} (scales, poses), {SIM3_CPU_TOL} against the CPU; "
         f"card: {card}")
    if not (r["log_scale_max"] < SIM3_GT_TOL and r["pose_gap_gt"] < SIM3_GT_TOL
            and r["pose_gap_cpu"] <= SIM3_CPU_TOL and r["log_scale_gap_cpu"] <= SIM3_CPU_TOL):
        raise AssertionError(f"13d Sim(3) pose graph: {r}")
    return r


def run_live_path(dev, card: str, rendered, scene: dict) -> dict:
    """Phase 13 (counts zeroed before, read after): registration,
    undistortion, the live app and the Sim(3) pose graph."""
    work = Path(__file__).resolve().parent / "build" / "live_check"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    t13 = time.perf_counter()
    _reset_counts()
    times = {}
    t = time.perf_counter()
    reg = check_registration(dev, scene, card)
    times["13a"] = time.perf_counter() - t
    t = time.perf_counter()
    und = check_undistortion(dev, scene, card)
    times["13b"] = time.perf_counter() - t
    t = time.perf_counter()
    app = check_live_app(dev, rendered, scene, card, work)
    times["13c"] = time.perf_counter() - t
    t = time.perf_counter()
    sim3 = check_sim3_graph(dev, card)
    times["13d"] = time.perf_counter() - t
    counts = _path_launches("13: the live app", dev)
    phase_s = time.perf_counter() - t13
    _log(f"phase 13 took {phase_s:.1f} s ({json.dumps(times)}), launches "
         f"{json.dumps(counts)}; card: {card}")
    return dict(registration=reg, undistortion=und, app=app, sim3=sim3, **counts,
                phase_s=phase_s, times=times)


# ---- phase 14: the multi-device code -----------------------------------------

def mesh_config(vocabulary_path, cam: CameraConfig | None = None) -> SlamConfig:
    """14a's config: the default one at `cam` with a keyframe at least
    every DENSE_KF_GAP frames (11b's cadence), the dense grid bounded (the
    grid a mesh splits into slabs), loop closing on the named
    vocabulary."""
    base = SlamConfig(camera=cam or CameraConfig())
    return base.replace(tracking=dataclasses.replace(base.tracking,
                                                     max_frames_between_kfs=DENSE_KF_GAP),
                        dense=dataclasses.replace(base.dense, unbounded=False),
                        loop=dataclasses.replace(base.loop, enabled=True,
                                                 vocabulary_path=vocabulary_path))


def _grid_of(sys_) -> tuple:
    """(log_odds, color) of a system's dense grid, a sharded grid's slabs
    gathered, on the host."""
    sg = sys_._sharded_grid
    if sg is None:
        return sys_.grid.log_odds.cpu().numpy(), sys_.grid.color.cpu().numpy()
    return tuple(gather_rows(sg[k], sys_.mesh, PT_AXIS).cpu().numpy() for k in ("log_odds", "color"))


def check_mesh_system(dev, mesh, scene: dict, vocab: str, card: str) -> dict:
    """14a: the same frames through `SlamSystem` without and with the mesh;
    B1's launches are counted over the mesh run alone."""
    cfg = mesh_config(vocab, CameraConfig(width=scene["gray_host"].shape[2],
                                          height=scene["gray_host"].shape[1]))
    n = min(MESH_FRAMES, scene["gray_host"].shape[0])
    frames = [(scene["gray_host"][i], scene["depth_host"][i]) for i in range(n)]
    out, ms, counts = {}, {}, None
    for tag, m in (("single", None), ("mesh", mesh)):
        sys_ = SlamSystem(cfg, enable_dense_map=True, mesh=m, device=None if m else dev)
        if tag == "mesh":
            _reset_counts()
        ms[tag] = [_timed(lambda: sys_.track_rgbd(g, d, i / 30.0), dev)[1]
                   for i, (g, d) in enumerate(frames)]
        if tag == "mesh":
            counts = _path_launches("14a: the mesh run", dev)
        out[tag] = sys_
    s, m = out["single"], out["mesh"]
    lo_s, col_s = _grid_of(s)
    lo_m, col_m = _grid_of(m)
    touched = (lo_s != 0) | (lo_m != 0)
    hit = (col_s != 0).any(-1) | (col_m != 0).any(-1)
    res = dict(frames=n, statuses_ok=sum(st["status"] == "OK" for st in m.tracker.stats),
               keyframes=m.tracker._n_kfs, sharded_scores=m.tracker.loop_closer._sharded_scores
               is not None, slab_x=int(m._sharded_grid["log_odds"].shape[0]),
               position_gap_m=float(np.abs(m.tracker.camera_positions()
                                           - s.tracker.camera_positions()).max()),
               ate_m=evaluate_ate_xyz(m.tracker.camera_positions(), scene["poses"][:n, :3, 3]).rmse,
               touched_voxels=int(touched.sum()),
               voxels_differing=int((np.abs(lo_m - lo_s) > 1e-5).sum()),
               voxels_unequal=int((lo_m != lo_s).sum()),
               color_agree_share=float(np.isclose(col_m, col_s, atol=1e-3).all(-1)[hit].mean()),
               median_frame_ms=statistics.median(ms["mesh"][1:]),
               median_frame_ms_single=statistics.median(ms["single"][1:]), **counts)
    _log("14a SlamSystem(mesh=...) on a 1-rank NCCL group against no mesh: " + json.dumps(res)
         + f"; card: {card}")
    if res["statuses_ok"] != n or s.status != "OK":
        raise AssertionError(f"14a: {n - res['statuses_ok']} frames of the mesh run not OK")
    if not (res["sharded_scores"] and res["slab_x"] == s.grid.shape[0]):
        raise AssertionError("14a: the mesh run did not take the sharded scorer and grid")
    if not res["position_gap_m"] <= MESH_POS_TOL:
        raise AssertionError(f"14a: trajectories {res['position_gap_m']} m apart")
    if not (res["touched_voxels"] > 10_000 and res["voxels_differing"]
            <= MESH_VOXEL_SHARE * res["touched_voxels"]):
        raise AssertionError(f"14a: {res['voxels_differing']} of {res['touched_voxels']} touched "
                             "voxels differ")
    if not res["color_agree_share"] > MESH_COLOR_SHARE:
        raise AssertionError(f"14a: colors agree on {res['color_agree_share']:.4f}")
    return res | {"systems": out}


def _few_gba_iterations(cfg: SlamConfig) -> SlamConfig:
    return cfg.replace(optimizer=dataclasses.replace(cfg.optimizer,
                                                     global_ba_iters=MESH_TWO_RANK_GBA_ITERS))


def check_mesh_global_ba(dev, mesh, cfg: SlamConfig, state, card: str) -> dict:
    """14b: the sharded global BA on phase 7's closure map against the
    single-device step, each timed by the host clock; and the sharded step
    at 14e's iterations, for 14e."""
    single, single_ms = _timed(lambda: global_ba_step_state(state, cfg), dev)
    sharded, sharded_ms = _timed(lambda: global_ba_step_state_sharded(state, cfg, mesh), dev)
    few, few_ms = _timed(lambda: global_ba_step_state_sharded(state, _few_gba_iterations(cfg),
                                                              mesh), dev)
    pose_err, point_err = _gba_diff(sharded, single, state)
    moved = float((single.kfs.T_cw[state.kfs.valid] - state.kfs.T_cw[state.kfs.valid]).abs().max())
    res = dict(observation_slots=int(state.kfs.kp_point.numel()), global_ba_ms=single_ms,
               sharded_global_ba_ms=sharded_ms, pose_max_abs_err=pose_err,
               point_max_abs_err=point_err, pose_max_move=moved,
               sharded_ms_at_two_rank_iters=few_ms)
    _log("14b sharded global BA (1 rank) against global_ba_step_state on 7a's map: "
         + json.dumps(res) + f"; card: {card}")
    if not (pose_err <= MESH_GBA_TOL and point_err <= MESH_GBA_TOL):
        raise AssertionError(f"14b: sharded global BA {pose_err:.3e} (poses) / {point_err:.3e} "
                             f"(points) from the single-device step")
    return res | {"sharded_few": few}


def check_mesh_bow(dev, mesh, systems: dict, card: str) -> dict:
    """14c: on 14a's keyframes, the sharded L1 query against the
    single-device scorer, and the sharded BoW build and detect against
    `place_recognition.bow_vector` and `detect_candidates`."""
    sm, ss = systems["mesh"], systems["single"]
    lc = sm.tracker.loop_closer
    kfs = sm.tracker.state.kfs
    live = torch.nonzero(kfs.valid).reshape(-1)
    kf = int(sm.tracker.state.last_kf)
    words = voc.quantize(lc.vocab, kfs.desc[kf], kfs.kp_valid[kf])
    vals = voc.bow_columns(words, lc.vocab.idf)
    sharded = dist_bow.make_sharded_l1_scores(mesh, lc.vocab.n_words)
    whole = lc.database_to_numpy()
    s_sh = sharded(words, vals, shard_rows(lc.word_db, mesh, KF_AXIS),
                   shard_rows(lc.val_db, mesh, KF_AXIS))
    s_one = voc.l1_scores(words, vals, torch.from_numpy(whole["word_db"].astype(np.int64)).to(dev),
                          torch.from_numpy(whole["val_db"]).to(dev), lc.vocab.n_words)
    s_sys = ss.tracker.loop_closer.frame_scores(kfs.desc[kf], kfs.kp_valid[kf])
    build = dist_bow.make_sharded_bow_vectors(mesh, place_recognition.bow_vector)
    db = gather_rows(build(shard_rows(kfs.desc[live], mesh, KF_AXIS),
                           shard_rows(kfs.kp_valid[live], mesh, KF_AXIS)), mesh, KF_AXIS)
    db_ref = torch.stack([place_recognition.bow_vector(kfs.desc[i], kfs.kp_valid[i]) for i in live])
    query = db_ref[-1] * 0.9 + db_ref[0] * 0.1
    query = query / torch.linalg.norm(query)
    db_valid = torch.ones(len(live), dtype=torch.bool, device=dev)
    exclude = torch.zeros_like(db_valid)
    exclude[-1] = True
    n_cand = min(4, len(live))
    detect = dist_bow.make_sharded_detect(mesh, max_candidates=n_cand)
    ids, sc, ok = detect(query, shard_rows(db, mesh, KF_AXIS), shard_rows(db_valid, mesh, KF_AXIS),
                         shard_rows(exclude, mesh, KF_AXIS), 0.05)
    ids_r, sc_r, ok_r = place_recognition.detect_candidates(query, db_ref, db_valid, exclude, 0.05,
                                                            max_candidates=n_cand)
    res = dict(keyframes=len(live), l1_max_abs_err=float((s_sh - s_one).abs().max()),
               l1_vs_single_system_max_abs_err=float(np.abs(s_sh.cpu().numpy() - s_sys).max()),
               bow_max_abs_err=float((db - db_ref).abs().max()),
               detect_score_max_abs_err=float((sc - sc_r).abs().max()),
               ids_equal=bool(torch.equal(ids, ids_r)), ok_equal=bool(torch.equal(ok, ok_r)),
               candidates=ids.tolist(), l1_ms=_sync_ms(lambda: sharded(
                   words, vals, lc.word_db, lc.val_db), dev, 10),
               l1_single_ms=_sync_ms(lambda: voc.l1_scores(words, vals, lc.word_db, lc.val_db,
                                                           lc.vocab.n_words), dev, 10))
    _log("14c sharded BoW scoring against the single-device scorer: " + json.dumps(res)
         + f"; card: {card}")
    errs = (res["l1_max_abs_err"], res["l1_vs_single_system_max_abs_err"], res["bow_max_abs_err"],
            res["detect_score_max_abs_err"])
    if not (max(errs) <= MESH_SCORE_TOL and res["ids_equal"] and res["ok_equal"]):
        raise AssertionError(f"14c: sharded scoring differs: {json.dumps(res)}")
    return res


def check_mesh_detection(dev, mesh, scene: dict, params: dict, card: str) -> dict:
    """14d: phase 10's MESH_DETECT_VIEWS as keyframe payloads through the
    keyframe-sharded flush and the single-device one, score gates at 0.
    Both queue the views as a kf axis of that many ranks would batch them
    (`_det_batch`), so both flushes take the bf16 batched forward (the
    single device's too, as in JAX): with the seeded weights and the
    gates at 0, the f32 and the bf16 paths can create other objects (the
    two paths' gap is phase 10's)."""
    cam = CameraConfig(width=scene["gray_host"].shape[2], height=scene["gray_host"].shape[1])
    base = SlamConfig(camera=cam)
    cfg0 = base.replace(semantic=dataclasses.replace(base.semantic, det_score_threshold=0.0,
                                                     fusion_prob_threshold=0.0))
    dbs = {}
    for tag, m in (("single", None), ("mesh", mesh)):
        sys_ = SlamSystem(cfg0, enable_semantics=True, detector_params=params, mesh=m,
                          device=None if m else dev)
        sys_._det_batch = len(MESH_DETECT_VIEWS)

        for i in MESH_DETECT_VIEWS:
            sys_._on_new_keyframe(_rgb(scene["grays"][i]), scene["depths"][i],
                                  np.linalg.inv(scene["poses"][i]).astype(np.float32))
        sys_.flush_detections()
        dbs[tag] = (sys_.object_db.valid.cpu().numpy(), sys_.object_db.centroid.cpu().numpy(),
                    sys_._det_batch)
    (v_s, c_s, _), (v_m, c_m, batch) = dbs["single"], dbs["mesh"]
    res = dict(keyframes=len(MESH_DETECT_VIEWS), det_batch=batch, objects=int(v_m.sum()),
               objects_single=int(v_s.sum()))
    if res["objects"] == res["objects_single"]:
        res["centroid_gap_m"] = float(np.abs(np.sort(c_m[v_m], 0) - np.sort(c_s[v_s], 0)).max()) \
            if v_m.any() else 0.0
    _log("14d keyframe-sharded detection against the single-device flush: " + json.dumps(res)
         + f"; card: {card}")
    if not (res["objects"] == res["objects_single"] > 0
            and res["centroid_gap_m"] <= MESH_CENTROID_TOL):
        raise AssertionError(f"14d: {json.dumps(res)}")
    return res


def mesh_scans(seed: int = 0) -> list:
    """14e's scans (`tests/test_parallel.py`'s): MESH_SCANS origins along X
    and MESH_SCAN_POINTS endpoints each in the 6.4 x 3.2 x 3.2 m box, 10%
    invalid, 20% carve-only."""
    rng = np.random.default_rng(seed)
    scans = []
    for scan in range(MESH_SCANS):
        o = np.asarray([0.4 + 2.2 * scan, 1.6, 1.6], np.float32)
        n = MESH_SCAN_POINTS
        pts = np.stack([rng.uniform(0.2, 6.2, n), rng.uniform(0.2, 3.0, n),
                        rng.uniform(0.2, 3.0, n)], -1).astype(np.float32)
        scans.append((o, pts, rng.uniform(size=n) > 0.1, rng.uniform(size=n) > 0.8))
    return scans


def _mesh_rank(rank: int, world: int, work: str, cfg: SlamConfig, device: str) -> None:
    """One of 14e's ranks: a gloo group on `device`'s tensors (the card's),
    the sharded GBA on phase 7's map and the scans into a sharded grid;
    rank 0 saves the results, and the copies an all-reduce makes."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{work}/store", rank=rank,
                            world_size=world)
    try:
        mesh = make_mesh(1, world, device=device)
        dev = mesh_device(mesh)
        with open(f"{work}/state.pkl", "rb") as f:
            state = map_state.state_from_numpy(pickle.load(f), dev)
        gba, gba_ms = _timed(lambda: global_ba_step_state_sharded(state, cfg, mesh), dev)
        dcfg = DenseMapConfig(resolution=0.1, max_ray_steps=64)
        lo, _ = dist_occupancy.make_sharded_grid(mesh, MESH_GRID_DIMS, 0.1, (0.0, 0.0, 0.0))
        insert = dist_occupancy.make_sharded_insert(mesh, dcfg, MESH_GRID_DIMS, (0.0, 0.0, 0.0))
        for o, pts, valid, carve in mesh_scans():
            lo = insert(lo, *(torch.from_numpy(a).to(dev) for a in (o, pts, valid, carve)))
        grid = gather_rows(lo, mesh, PT_AXIS)
        x = torch.ones(1 << 20, device=dev)
        copies = {}
        if dev.type == "cuda":
            torch.cuda.synchronize()
            with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                    torch.profiler.ProfilerActivity.CUDA]) as prof:
                dist.all_reduce(x, group=mesh.get_group(PT_AXIS))
                torch.cuda.synchronize()
            copies = {e.key: e.count for e in prof.key_averages() if "Memcpy" in e.key}
        devices = {str(t.device) for t in (gba.kfs.T_cw, gba.points.pos, grid, x)}
        if rank == 0:
            with open(f"{work}/rank0.pkl", "wb") as f:
                pickle.dump(dict(T_cw=gba.kfs.T_cw.cpu().numpy(), pos=gba.points.pos.cpu().numpy(),
                                 grid=grid.cpu().numpy(), gba_ms=gba_ms, devices=sorted(devices),
                                 copies=copies, slab_x=int(lo.shape[0])), f)
    finally:
        dist.destroy_process_group()


def _interleave_keyframes(state):
    """`state` with its keyframe slots reordered, even slots into the first
    half and odd ones into the second, and the slot references remapped:
    the global BA problem of a map whose keyframes fill the first slots
    (7a's) then has observations in both halves of its rows, so both of
    14e's ranks own some. Returns (state, inverse: old slot -> new)."""
    kfs = state.kfs
    F = kfs.valid.shape[0]
    dev = kfs.valid.device
    order = torch.cat([torch.arange(0, F, 2), torch.arange(1, F, 2)]).to(dev)
    inv = torch.empty_like(order)
    inv[order] = torch.arange(F, device=dev)
    ref = state.points.ref_kf
    return state.replace(
        kfs=kfs.replace(**{f.name: getattr(kfs, f.name)[order] for f in dataclasses.fields(kfs)}),
        points=state.points.replace(ref_kf=torch.where(ref >= 0, inv[ref.clamp(min=0)], ref)),
        last_kf=inv[state.last_kf]), inv


def check_two_ranks(dev, cfg: SlamConfig, state, gba_one, card: str) -> dict:
    """14e: MESH_RANKS spawned ranks on the one card over gloo, against
    14b's one-rank sharded result at MESH_TWO_RANK_GBA_ITERS iterations
    and the single-device `insert_scan`. The ranks take 7a's map with its
    keyframe slots interleaved, so that the sums cross the ranks; their
    poses are mapped back to 7a's slots."""
    cfg = _few_gba_iterations(cfg)
    ref = empty_grid(extent=tuple(d * 0.1 for d in MESH_GRID_DIMS), resolution=0.1,
                     origin=(0.0, 0.0, 0.0), device=dev)
    dcfg = DenseMapConfig(resolution=0.1, max_ray_steps=64)
    for o, pts, valid, carve in mesh_scans():
        ref = insert_scan(ref, *(torch.from_numpy(a).to(dev) for a in (o, pts, valid)),
                          carve_only=torch.from_numpy(carve).to(dev), cfg=dcfg)
    spread, inv = _interleave_keyframes(state)
    obs_valid = problem_from_state(spread, cfg).obs_valid
    per_rank = [int(v.sum()) for v in obs_valid.chunk(MESH_RANKS)]
    with tempfile.TemporaryDirectory(dir=Path(__file__).resolve().parent / "build") as work:
        with open(f"{work}/state.pkl", "wb") as f:
            pickle.dump(map_state.state_to_numpy(spread), f)
        t = time.perf_counter()
        torch.multiprocessing.start_processes(_mesh_rank, args=(MESH_RANKS, work, cfg, dev.type),
                                              nprocs=MESH_RANKS, join=True, start_method="spawn")
        spawn_s = time.perf_counter() - t
        with open(f"{work}/rank0.pkl", "rb") as f:
            r = pickle.load(f)
    live, pts = state.kfs.valid.cpu().numpy(), state.points.valid.cpu().numpy()
    T_two = r["T_cw"][inv.cpu().numpy()]
    res = dict(ranks=MESH_RANKS, backend="gloo", slab_x=r["slab_x"], devices=r["devices"],
               valid_observations_by_rank=per_rank, allreduce_copies=r["copies"],
               gba_ms=r["gba_ms"], wall_s=spawn_s,
               pose_max_abs_err=float(np.abs(T_two - gba_one.kfs.T_cw.cpu().numpy())[live].max()),
               point_max_abs_err=float(np.abs(r["pos"] - gba_one.points.pos.cpu().numpy())[pts].max()),
               occupancy_max_abs_err=float(np.abs(r["grid"] - ref.log_odds.cpu().numpy()).max()),
               occupancy_touched=int((ref.log_odds.cpu().numpy() != 0).sum()))
    copies = res["allreduce_copies"]
    if not copies:
        staging = "the profiler recorded no copy (staging not measured)"
    elif any("DtoH" in k for k in copies) and any("HtoD" in k for k in copies):
        staging = "gloo stages CUDA tensors through the host"
    else:
        staging = "gloo made no round trip through the host"
    _log(f"14e: one all_reduce of a CUDA tensor over gloo, profiled: copies {json.dumps(copies)}: "
         f"{staging}; every result stays on the card")
    _log(f"14e {MESH_RANKS} ranks on one card over gloo: " + json.dumps(res) + f"; card: {card}")
    if res["devices"] != [str(torch.device(dev.type, 0) if dev.type == "cuda" else dev)]:
        raise AssertionError(f"14e: results on {res['devices']}, not on the card")
    if res["slab_x"] * MESH_RANKS != MESH_GRID_DIMS[0] or min(per_rank) == 0:
        raise AssertionError("14e: the grid or the observations are not split over the ranks")
    if not (res["pose_max_abs_err"] <= MESH_GBA_TOL and res["point_max_abs_err"] <= MESH_GBA_TOL):
        raise AssertionError(f"14e: two-rank global BA {res['pose_max_abs_err']:.3e} / "
                             f"{res['point_max_abs_err']:.3e} from one rank's")
    if not (res["occupancy_max_abs_err"] <= MESH_OCC_TOL and res["occupancy_touched"] > 0):
        raise AssertionError(f"14e: two-slab grid {res['occupancy_max_abs_err']:.3e} from "
                             "insert_scan")
    return res


def run_mesh_path(dev, card: str, scene: dict, params: dict, closure: dict) -> dict:
    """Phase 14: 14a-14d on a 1-rank NCCL group the script makes (a
    `file://` store in a temporary directory, destroyed afterwards), then
    14e on two spawned gloo ranks."""
    t14 = time.perf_counter()
    with warnings.catch_warnings():
        warnings.filterwarnings("error", message="trained artifact")
        vocab = named_vocabulary(Path(__file__).resolve().parent / "build" / "reloc_vocab")
        with tempfile.TemporaryDirectory() as store:
            dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                    init_method=f"file://{store}/store", rank=0, world_size=1)
            try:
                mesh = make_mesh(1, 1, device=dev.type)
                system = check_mesh_system(dev, mesh, scene, vocab, card)
                gba = check_mesh_global_ba(dev, mesh, closure["cfg"], closure["state"], card)
                bow = check_mesh_bow(dev, mesh, system.pop("systems"), card)
                det = check_mesh_detection(dev, mesh, scene, params, card)
            finally:
                dist.destroy_process_group()
    two = check_two_ranks(dev, closure["cfg"], closure["state"], gba.pop("sharded_few"), card)
    phase_s = time.perf_counter() - t14
    _log(f"phase 14 took {phase_s:.1f} s; B1 launched {system['launches']['window_match']} times "
         f"in 14a's mesh run; card: {card}")
    return dict(system=system, global_ba=gba, bow=bow, detection=det, two_ranks=two,
                launches=system["launches"], phase_s=phase_s)


def host_times(dev) -> dict:
    """Host time of each wrapper's `prepare` and `launch`, and of the whole
    wrapper, for B1 at the main path's first shape and B2 at its size."""
    q, t = B1_SHAPES[0]
    p = _b1_problem(100, q, t, dev)
    rng = np.random.default_rng(0)
    a = torch.from_numpy(_spd(rng, B2_MAIN_N)).to(dev)
    b = torch.from_numpy(rng.normal(0, 1, (B2_MAIN_N,)).astype(np.float32)).to(dev)
    prep1, _ = cuda_match.prepare(**p, max_dist=100)
    prep2, _ = cuda_solve.prepare(a, b)
    res = {
        "window_match": dict(
            shape=[q, t],
            host_prepare_ms=_host_ms(lambda: cuda_match.prepare(**p, max_dist=100)),
            host_launch_ms=_host_ms(lambda: cuda_match.launch(prep1)),
            host_wrapper_ms=_host_ms(lambda: cuda_match.window_match(**p, max_dist=100))),
        "spd_solve": dict(
            shape=[B2_MAIN_N],
            host_prepare_ms=_host_ms(lambda: cuda_solve.prepare(a, b)),
            host_launch_ms=_host_ms(lambda: cuda_solve.launch(prep2)),
            host_wrapper_ms=_host_ms(lambda: cuda_solve.spd_solve(a, b))),
    }
    _log("host times: " + json.dumps(res))
    return res


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs only on the card", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    card = card_line()
    _log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    if sys.argv[1:] == ["--host-times"]:
        cuda_build.build_all(force=True)
        host_times(dev)
        return 0
    if sys.argv[1:]:
        print(f"chip_smoke: unknown arguments {sys.argv[1:]}", file=sys.stderr)
        return 2
    build_s = build_kernels()
    _count_replays()
    floor_ms = launch_floor_ms()
    b1 = check_b1(dev)
    b2 = check_b2(dev)
    # Phases 4-8's views render on the CPU while phases 9-11, which render
    # on the card, run; then phases 4-8 run on them.
    job = start_render(N_FRAMES, LOOP_SEQ_FRAMES, SEG_RUN_FRAMES, dyn=True)
    try:
        dyn = run_dynamic_path(dev, card, masked_tracking=False)
        sem = run_semantic_path(dev, card)
        scene = sem.pop("scene")
        params = sem.pop("params")
        dense = run_dense_path(dev, card, scene, params)
        apps = run_apps_path(dev, card, scene, dense["functions"].pop("cloud"))
    except BaseException:
        job["pool"].terminate()
        job["pool"].join()
        raise
    rendered = finish_render(job)
    t9 = time.perf_counter()
    _reset_counts()
    dyn["tracking"] = check_masked_tracking(dev, CameraConfig(), card, frames=rendered[5])
    dyn_9c = _path_launches("9c: the masked trackers", dev)
    _check_sym_eig_ran("9c", dyn_9c, dev)
    for key, counts in dyn_9c.items():
        dyn[key] = {k: v + counts[k] for k, v in dyn[key].items()}
    _log(f"phase 9c took {time.perf_counter() - t9:.1f} s; launches in phase 9 "
         f"{json.dumps(dyn['launches'])}; card: {card}")
    main_res = run_main_path(dev, rendered=rendered)
    tracker = main_res.pop("tracker")
    track_graph = run_track_graph_check(main_res.pop("track_args"), tracker.cfg, card)
    b2_path = run_b2_path(tracker, dev)
    async_mapping = check_async_mapping(tracker, dev, card)
    async_gate = check_async_gate(dev, main_res["rendered"], card)
    rendered = main_res.pop("rendered")
    descriptors = check_descriptor_references(dev, rendered)
    reloc = run_reloc_path(dev, rendered, card)
    loop = run_loop_path(dev, rendered[3], card)
    t8 = time.perf_counter()
    scan = run_scan_path(dev, main_res | {"tracker": tracker, "rendered": rendered}, card)
    scan_trace_here = check_scan_trace(dev, rendered, card, fresh=False)
    scan_trace = run_scan_trace(rendered, card)
    seg = run_segmented_path(dev, rendered[4], card)
    _log(f"phase 8 took {time.perf_counter() - t8:.1f} s; card: {card}")
    frame_apps = run_frame_apps_path(dev, card, rendered, main_res["poses"])
    live = run_live_path(dev, card, rendered, scene)
    mesh = run_mesh_path(dev, card, scene, params, loop.pop("closure_map"))
    launches_apps = {k: apps["launches"][k] + frame_apps["launches"][k]
                     for k in apps["launches"]}
    kernels = [
        dict(name="window_match", route="cuda",
             source="orb_slam2_ssd_semantic_tpu_torch/csrc/window_match.cu",
             replaces="orb_slam2_ssd_semantic_tpu/ops/pallas_match.py:104",
             launches=main_res["launches"]["window_match"], max_abs_err=b1["max_abs_err"],
             ms=b1["ms"], plain_ms=b1["plain_ms"], bound_ms=b1["bound_ms"],
             bound_by=b1["bound_by"], library_ms=None, shape=[b1["q"], b1["t"]],
             wrapper_ms=b1["wrapper_ms"], device_ms=b1["device_ms"],
             host_prepare_ms=b1["host_prepare_ms"], host_launch_ms=b1["host_launch_ms"],
             grid=b1["grid"], launch_floor_ms=floor_ms,
             launches_reloc_kidnap=reloc["kidnap"]["launches"]["window_match"],
             launches_loop=loop["b1_launches"], loop_shapes=b1["loop_shapes"],
             launches_scan=scan["launches"]["window_match"],
             launches_segmented=seg["launches"]["window_match"],
             launches_dynamic=dyn["launches"]["window_match"],
             launches_semantic=sem["launches"]["window_match"],
             launches_dense=dense["launches"]["window_match"],
             launches_apps=launches_apps["window_match"],
             launches_live=live["launches"]["window_match"],
             launches_mesh=mesh["launches"]["window_match"], init_shape=b1["init_shape"],
             launches_captured=main_res["launches_captured"]["window_match"],
             launches_wrapper_calls=main_res["launches_wrapper_calls"]["window_match"],
             launches_replayed=main_res["launches_replayed"]["window_match"],
             launches_traced_steady_window=main_res["profile"]["traced"]["window_match"],
             launches_traced_scan_window=scan["profile"]["traced"]["window_match"],
             launches_traced_scan_segment=scan_trace["traced"]["window_match"],
             launches_traced_scan_segment_in_process=scan_trace_here["traced"]["window_match"],
             launches_traced_track_replay=track_graph["cases"]["ok"]["traced"]["window_match"],
             launches_traced_keyframe_frame=main_res["keyframe_profile"]["traced"]["window_match"],
             launches_traced_replay=async_mapping["window_16_8"]["traced_replay"]["window_match"],
             path="Tracker.process, default config"),
        dict(name="spd_solve", route="cuda",
             source="orb_slam2_ssd_semantic_tpu_torch/csrc/spd_solve.cu",
             replaces="orb_slam2_ssd_semantic_tpu/ops/pallas_solve.py:79",
             launches=b2_path["launches"]["spd_solve"], max_abs_err=b2["max_abs_err"],
             ms=b2["ms"], plain_ms=b2["plain_ms"], bound_ms=b2["bound_ms"],
             bound_by=b2["bound_by"], library_ms=b2["library_ms"], shape=[b2["n"]],
             wrapper_ms=b2["wrapper_ms"], device_ms=b2["device_ms"],
             host_prepare_ms=b2["host_prepare_ms"], host_launch_ms=b2["host_launch_ms"],
             launch_floor_ms=floor_ms,
             launches_scan=scan["launches"]["spd_solve"],
             launches_segmented=seg["launches"]["spd_solve"],
             launches_dynamic=dyn["launches"]["spd_solve"],
             launches_semantic=sem["launches"]["spd_solve"],
             launches_dense=dense["launches"]["spd_solve"],
             launches_apps=launches_apps["spd_solve"],
             launches_live=live["launches"]["spd_solve"],
             launches_mesh=mesh["launches"]["spd_solve"],
             launches_traced_replay=async_mapping["window_12_8"]["traced_replay"]["spd_solve"],
             path="local_mapping_step, window 12 + 8"),
        dict(name="sym_eig", route="cuda",
             source="orb_slam2_ssd_semantic_tpu_torch/csrc/sym_eig.cu",
             replaces="orb_slam2_ssd_semantic_tpu/ops/homography.py:34",
             pallas_counterpart=None,
             launches=dyn["launches"]["sym_eig"], max_abs_err=dyn["sym_eig"]["max_abs_err"],
             ms=dyn["sym_eig"]["ms"], plain_ms=dyn["sym_eig"]["plain_ms"],
             bound_ms=dyn["sym_eig"]["bound_ms"], bound_by=dyn["sym_eig"]["bound_by"],
             library_ms=dyn["sym_eig"]["library_ms"], shape=dyn["sym_eig"]["shape"],
             wrapper_ms=dyn["sym_eig"]["wrapper_ms"], device_ms=dyn["sym_eig"]["device_ms"],
             host_prepare_ms=dyn["sym_eig"]["host_prepare_ms"],
             host_launch_ms=dyn["sym_eig"]["host_launch_ms"], launch_floor_ms=floor_ms,
             refit=dyn["sym_eig"]["refit"],
             launches_captured_flow_graph=dyn["masks"]["graphs"]["flow"]["captured"]["sym_eig"],
             launches_wrapper_calls=dyn["launches_wrapper_calls"]["sym_eig"],
             launches_replayed=dyn["launches_replayed"]["sym_eig"],
             launches_traced_masked_segment=dyn["trace"]["traced"]["sym_eig"],
             launches_main_path=main_res["launches"]["sym_eig"],
             path="the flow mask's graph in Tracker.process (9c) and the scan (9d, 9e)"),
    ]
    _log(f"summary: build {build_s:.2f} s, main path median {main_res['median_frame_ms']:.2f} "
         f"ms/frame over {main_res['timed_frames']} frames; relocalization stage median "
         f"{reloc['relocalization_stage_median_ms']:.2f} ms, direct relocalize median "
         f"{reloc['direct'][0]['median_ms']:.2f} ms ({reloc['direct'][0]['backend']}) and "
         f"{reloc['direct'][1]['median_ms']:.2f} ms ({reloc['direct'][1]['backend']}); "
         f"loop_closing stage median {loop['tracker']['on']['loop_closing_median_ms']:.2f} ms "
         f"(no closure), closing call {loop['closure']['closing_call_ms']:.2f} ms, global BA "
         f"{loop['global_ba']['global_ba_ms_again']:.2f} ms; scan median "
         f"{scan['replay_median_frame_ms']:.2f} ms/frame (process, same frames: "
         f"{scan['process_median_frame_ms_same_frames']:.2f}), its host dispatch "
         f"{scan['replay_median_dispatch_ms']:.2f} ms a frame; 8c a segment of "
         f"{SEG_LEN} frames {scan_trace['wall_ms_per_frame']:.2f} ms a frame, dispatch "
         f"{scan_trace['host_dispatch_ms_per_frame']:.2f} ms, device busy "
         f"{scan_trace['device_busy_ms_per_frame']:.2f} ms, waits "
         f"{json.dumps(scan_trace['waits'])}, the branch graph's capture "
         f"{scan_trace['branch_graph']['capture_ms']:.1f} ms and "
         f"{scan_trace['branch_graph']['pool_mib']:.1f} MiB; segmented plain run "
         f"{seg['runs']['plain']['fps_wall']:.2f} frames/s; device render "
         f"{dyn['render']['ms_per_frame']:.2f} ms/frame; mask.flow "
         f"{dyn['tracking']['runs']['flow']['mask.flow_mean_ms']:.2f} ms, mask.geometry "
         f"{dyn['tracking']['runs']['geom']['mask.geometry_mean_ms']:.2f} ms; sym_eig "
         f"{dyn['sym_eig']['ms']:.4f} ms at (128, 9, 9) (torch.linalg.eigh "
         f"{dyn['sym_eig']['library_ms']:.4f} ms); 9e a masked segment "
         f"{dyn['trace']['wall_ms_per_frame']:.2f} ms a frame, waits "
         f"{json.dumps(dyn['trace']['waits'])}; 9d resolved ATE "
         f"{dyn['segmented']['unmasked']['ate_resolved_m']:.4f} / "
         f"{dyn['segmented']['flow']['ate_resolved_m']:.4f} / "
         f"{dyn['segmented']['geom']['ate_resolved_m']:.4f} m; SSDLite f32 "
         f"{sem['network']['f32_forward_ms']:.2f} ms, bf16 batch of {SEM_BATCH} "
         f"{sem['network']['bf16_forward_ms_batch']:.2f} ms; a frame with semantics "
         f"{sem['system']['median_frame_ms']:.2f} ms (without "
         f"{sem['system']['median_frame_ms_plain']:.2f}); phase 10 {sem['phase_s']:.1f} s; "
         f"a block insertion {dense['functions']['block_64']['ms']:.2f} ms, a keyframe's frame "
         f"with the dense map {dense['system']['median_keyframe_frame_ms']:.2f} ms (without "
         f"{dense['system']['median_keyframe_frame_ms_plain']:.2f}), the batched consumer "
         f"{dense['batched']['consume_ms']:.2f} ms for {dense['batched']['keyframes']} "
         f"keyframes, stereo ATE {dense['stereo']['ate_m']:.4f} m; phase 11 "
         f"{dense['phase_s']:.1f} s; a training step of batch {TRAIN_BATCH} "
         f"{apps['train_app']['ms_per_step']:.2f} ms, rgbd_tum "
         f"{apps['rgbd_tum']['median_frame_ms']:.2f} ms a frame with semantics and the dense "
         f"map; phase 12 {apps['phase_s'] + frame_apps['phase_s']:.1f} s; live_rgbd "
         f"{live['app']['run']['median_frame_ms']:.2f} ms a frame with undistortion and "
         f"registration, register_depth_to_color {live['registration']['ms']:.4f} ms, "
         f"undistort_image (RGB) {live['undistortion']['rgb']['ms']:.4f} ms, the Sim(3) graph "
         f"{live['sim3']['ms']:.1f} ms; phase 13 {live['phase_s']:.1f} s; a frame of "
         f"SlamSystem(mesh=...) at one rank {mesh['system']['median_frame_ms']:.2f} ms (without "
         f"the mesh {mesh['system']['median_frame_ms_single']:.2f}), the sharded global BA "
         f"{mesh['global_ba']['sharded_global_ba_ms']:.1f} ms (single "
         f"{mesh['global_ba']['global_ba_ms']:.1f}), at {MESH_TWO_RANK_GBA_ITERS} iterations "
         f"{mesh['global_ba']['sharded_ms_at_two_rank_iters']:.1f} ms at one rank and "
         f"{mesh['two_ranks']['gba_ms']:.1f} ms at two ranks over gloo; phase 14 {mesh['phase_s']:.1f} s; "
         f"local mapping's graph at 16 + 8: dispatch "
         f"{async_mapping['window_16_8']['dispatch_ms']:.3f} ms against "
         f"{async_mapping['window_16_8']['synced_ms']:.3f} ms synchronized (at 12 + 8 "
         f"{async_mapping['window_12_8']['dispatch_ms']:.3f} against "
         f"{async_mapping['window_12_8']['synced_ms']:.3f}), capture "
         f"{async_mapping['window_16_8']['capture']['capture_ms']:.1f} ms and "
         f"{async_mapping['window_16_8']['capture']['pool_mib']:.1f} MiB, B1's kernels "
         f"{async_mapping['window_16_8']['traced_replay']['window_match']} times in a traced "
         f"replay, at 12 + 8 B2's {async_mapping['window_12_8']['traced_replay']['spd_solve']}; "
         f"5d local_mapping "
         f"stage async {async_gate['async']['local_mapping_mean_ms']:.3f} ms against sync "
         f"{async_gate['sync']['local_mapping_mean_ms']:.3f} ms; syncs a steady frame "
         f"{main_res['profile']['runtime_calls_per_frame'].get('cudaStreamSynchronize', 0)} and "
         f"graph launches {main_res['profile']['runtime_calls_per_frame'].get('cudaGraphLaunch', 0)}"
         f", kernel launches "
         f"{main_res['profile']['runtime_calls_per_frame'].get('cudaLaunchKernel', 0)}, device busy "
         f"{main_res['profile']['device_busy_ms_per_frame']:.2f} ms a steady frame; the tracking "
         f"graph's capture {main_res['track_capture']['capture_ms']:.1f} ms and "
         f"{main_res['track_capture']['pool_mib']:.1f} MiB; 4b dispatch "
         f"{track_graph['dispatch_ms']:.3f} ms, synchronized {track_graph['synced_ms']:.3f} ms, "
         f"the eager step {track_graph['eager_ms']:.3f} ms; "
         f"keyframe frame {PROFILE_KEYFRAME} "
         f"{main_res['keyframe_profile']['runtime_calls'].get('cudaStreamSynchronize', 0)}; "
         f"5c angles within {descriptors['angle_max_abs_err']:.2e} rad; card: {card}")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

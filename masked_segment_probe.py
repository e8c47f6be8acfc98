"""What one segment of the scan costs with and without the dynamic masks.

Renders the walker scene of `chip_smoke.py` phase 9a on the card (the
first 49 frames of `bench.py`'s `sway_dyn`, 640x480, 1% depth noise),
then, for each mask setting (none, `use_flow`, `use_geom`, both), makes a
carry with `init_scan` at `chip_smoke.walker_config`, tracks frames 1-12
(every graph the setting needs is captured there) and runs frames 13-48
as one segment of `track_sequence_scan`, three times from that carry,
each ending in the segmented runner's pack and fetch. It prints, for the
port found under `--tree` (default: this file's directory), each
setting's host ms a frame to the end of the dispatch and to the end of
the fetch (the median of the three) and whether the three gave the same
bits. No profiler runs in the process (a profiler session makes every
later graph launch costlier on the host).

    python3 masked_segment_probe.py [--tree DIR]

Run it on another commit's tree by unpacking that tree into a directory
and naming it with `--tree`; compare two trees in one call, in turns.
Needs one CUDA card. Prints one JSON object a line, the card's name and
power limit first.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

WARM, LO, HI = 13, 13, 49
SETTINGS = {"none": {}, "flow": dict(use_flow=True), "geom": dict(use_geom=True),
            "both": dict(use_flow=True, use_geom=True)}
REPEATS = 3


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--tree", default=str(Path(__file__).resolve().parent))
    tree = Path(parser.parse_args().tree).resolve()
    sys.path.insert(0, str(tree))
    import numpy as np
    import torch

    import chip_smoke
    from orb_slam2_ssd_semantic_tpu_torch.config import CameraConfig
    from orb_slam2_ssd_semantic_tpu_torch.io import device_render
    from orb_slam2_ssd_semantic_tpu_torch.mapping.map_state import empty_state
    from orb_slam2_ssd_semantic_tpu_torch.ops import cuda_build
    from orb_slam2_ssd_semantic_tpu_torch.tracking import scan_tracker
    from orb_slam2_ssd_semantic_tpu_torch.tracking import segmented as seg

    if not torch.cuda.is_available():
        print("masked_segment_probe: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    print(json.dumps({"card": chip_smoke.card_line(), "tree": str(tree)}), flush=True)
    cuda_build.build_all(force=True)
    cam = CameraConfig()
    _, poses, kw = chip_smoke.walker_scene(HI)
    g, d = device_render.render_frames(poses, cam, depth_noise=chip_smoke.WALK_NOISE,
                                       device=dev, **kw)
    cfg = chip_smoke.walker_config(None, cam)
    n = HI - LO
    for name, masks in SETTINGS.items():
        flow = dict(prev_grays=g[:WARM - 1]) if masks.get("use_flow") else {}
        carry = scan_tracker.init_scan(empty_state(cfg, dev), g[0], d[0], cfg,
                                       use_geom=masks.get("use_geom", False))
        carry, *_ = scan_tracker.track_sequence_scan(carry, g[1:WARM], d[1:WARM], cfg,
                                                     with_rel=True, **masks, **flow)
        torch.cuda.synchronize()
        flow = dict(prev_grays=g[LO - 1:HI - 1]) if masks.get("use_flow") else {}
        dispatch, wall, packs = [], [], []
        for _ in range(REPEATS):
            t0 = time.perf_counter()
            out, T, stats, rel, uid = scan_tracker.track_sequence_scan(
                carry, g[LO:HI], d[LO:HI], cfg, with_rel=True, **masks, **flow)
            dispatch.append((time.perf_counter() - t0) * 1e3 / n)
            kfs = out.state.kfs
            packs.append(seg._fetch(*seg._start_fetch(seg._pack_segment(
                T, stats, rel, uid, kfs.uid, kfs.valid, kfs.frame_id))))
            wall.append((time.perf_counter() - t0) * 1e3 / n)
        print(json.dumps(dict(
            setting=name, frames=[LO, HI - 1], dispatch_ms_per_frame=statistics.median(dispatch),
            wall_ms_per_frame=statistics.median(wall), wall_ms_runs=wall,
            same_bits=all(np.array_equal(p, packs[0]) for p in packs),
            lost=int((packs[0][n * 16:n * 20:4] == 2).sum()))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

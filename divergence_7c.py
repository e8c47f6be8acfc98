#!/usr/bin/env python3
"""Where the port's and the JAX package's runs of phase 7c's circuit part,
on the CPU:

    JAX_PLATFORMS=cpu python divergence_7c.py

The setup is `chip_smoke.py`'s phase 7c with loop closing off: the
default config on `SyntheticSequence(trajectory="loop", n_frames=90,
loop_laps=1.35, depth_noise=0.02)` at 640x480. Both packages'
`Tracker.process` take frames 0-18; at frame 19 (`WEAK`, tracked by the
motion model alone) the script prints

- per frame up to 18: both statuses and inlier counts, and how far the
  returned poses lie apart;
- frame 19's motion-model inputs compared between the packages (the new
  frame's keypoints and descriptors, the last frame, the poses, the map);
- `track_motion_model`'s inliers in each package on its own inputs, and
  the port's on JAX's inputs carried over;
- per pyramid level of frame 19, the pixels that the two packages round
  to different integers, with both unrounded values.

It writes `tests/frame19_7c.npz`, the inputs of
`tests/test_torch_divergence_7c.py`: frame 19's pyramid level 5 as JAX
builds it, and JAX's motion-model inputs at frame 19 (the map reduced to
the points the last frame observes).
"""

from __future__ import annotations

import dataclasses
import multiprocessing
import sys
from pathlib import Path

import numpy as np

FRAME = 19
OUT = Path(__file__).resolve().parent / "tests" / "frame19_7c.npz"


def _render(i: int):
    from orb_slam2_ssd_semantic_tpu_torch.io.synthetic import SyntheticSequence

    seq = SyntheticSequence(n_frames=90, trajectory="loop", loop_laps=1.35, depth_noise=0.02)
    rng = np.random.default_rng(seq.seed)
    for _ in range(i):  # the draws of frames 0..i-1, as a sequential render makes them
        rng.normal(0.0, seq.depth_noise, (seq.cam.height, seq.cam.width))
    return seq.room.render(seq.poses_wc[i], seq.depth_noise, rng)


def _frame_arrays(prefix: str, f) -> dict:
    ft = f.feats
    return {f"{prefix}_uv": np.asarray(ft.uv), f"{prefix}_level": np.asarray(ft.level),
            f"{prefix}_angle": np.asarray(ft.angle), f"{prefix}_score": np.asarray(ft.score),
            f"{prefix}_desc": np.asarray(ft.desc), f"{prefix}_valid": np.asarray(ft.valid),
            f"{prefix}_kp_depth": np.asarray(f.kp_depth), f"{prefix}_obs_uvr": np.asarray(f.obs_uvr),
            f"{prefix}_is_stereo": np.asarray(f.is_stereo)}


def main() -> int:
    with multiprocessing.get_context("spawn").Pool(4) as pool:
        frames = pool.map(_render, range(FRAME + 1))

    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import torch

    import orb_slam2_ssd_semantic_tpu.config as jc
    import orb_slam2_ssd_semantic_tpu_torch.config as tc
    from orb_slam2_ssd_semantic_tpu.ops import image as jim
    from orb_slam2_ssd_semantic_tpu.tracking import tracker as jtk
    from orb_slam2_ssd_semantic_tpu_torch.ops import image as tim
    from orb_slam2_ssd_semantic_tpu_torch.tracking import tracker as ttk
    from orb_slam2_ssd_semantic_tpu_torch.utils.precision import highest_precision

    sys.path.insert(0, str(OUT.parent))
    from test_torch_divergence_7c import port_frame

    def cfg_of(mod):
        b = mod.SlamConfig()
        return dataclasses.replace(b, loop=dataclasses.replace(b.loop, enabled=False,
                                                               enable_relocalization=False))

    jcfg, tcfg = cfg_of(jc), cfg_of(tc)
    jt, tt = jtk.Tracker(jcfg), ttk.Tracker(tcfg, device="cpu")
    for i in range(FRAME):
        g, d = frames[i]
        Tj, Tt = jt.process(g, d, float(i)), tt.process(g, d, float(i))
        print(f"frame {i}: {jt.status}/{tt.status}, inliers {jt.stats[-1]['inliers']}/"
              f"{tt.stats[-1]['inliers']}, poses {float(np.abs(Tj - Tt).max()):.3e} apart")

    g, d = frames[FRAME]
    jf = jtk.build_frame(jnp.asarray(g), jnp.asarray(d), jcfg)
    tf = ttk.build_frame(torch.from_numpy(g), torch.from_numpy(d), tcfg)

    def diff(name, a, b):
        a = np.asarray(a)
        b = b.numpy() if torch.is_tensor(b) else np.asarray(b)
        if a.dtype.kind == "f":
            print(f"{name}: max |jax - port| {float(np.abs(a - b).max()):.4e}")
        else:
            print(f"{name}: {int((a.astype(np.int64) != b.astype(np.int64)).sum())} entries differ")

    diff(f"frame {FRAME} keypoint uv", jf.feats.uv, tf.feats.uv)
    diff(f"frame {FRAME} descriptors", np.asarray(jf.feats.desc).view(np.int32), tf.feats.desc)
    diff(f"frame {FRAME} keypoint depth", jf.kp_depth, tf.kp_depth)
    diff("last frame uv", jt.last_frame.feats.uv, tt.last_frame.feats.uv)
    diff("last_T_cw", jt.last_T_cw, tt.last_T_cw)
    diff("velocity", jt.velocity, tt.velocity)
    diff("last_kp_point", jt.last_kp_point, tt.last_kp_point)
    diff("map positions", jt.state.points.pos, tt.state.points.pos)

    jT_pred = jt.velocity @ jt.last_T_cw
    jres = jtk.track_motion_model(jf, jt.last_frame, jt.last_T_cw, jT_pred, jcfg,
                                  map_pos=jt.state.points.pos, map_valid=jt.state.points.valid,
                                  last_kp_point=jt.last_kp_point)
    tres = ttk.track_motion_model(tf, tt.last_frame, tt.last_T_cw, tt.velocity @ tt.last_T_cw,
                                  tcfg, map_pos=tt.state.points.pos,
                                  map_valid=tt.state.points.valid, last_kp_point=tt.last_kp_point)
    print(f"motion model on each package's own inputs: JAX {int(jres[2])} inliers of "
          f"{int(jres[1])} matches, port {int(tres[2])} of {int(tres[1])}")

    # JAX's inputs, the map reduced to the points the last frame observes
    # (and point 0, so that it is never empty).
    lkp = np.asarray(jt.last_kp_point)
    ids = np.unique(np.concatenate([[0], lkp[lkp >= 0]]))
    remap = np.full(int(jt.state.points.pos.shape[0]), -1, np.int32)
    remap[ids] = np.arange(len(ids))
    arrays = dict(
        _frame_arrays("last", jt.last_frame), **_frame_arrays("cur", jf),
        last_T_cw=np.asarray(jt.last_T_cw), T_pred=np.asarray(jT_pred),
        map_pos=np.asarray(jt.state.points.pos)[ids], map_valid=np.asarray(jt.state.points.valid)[ids],
        last_kp_point=np.where(lkp >= 0, remap[np.clip(lkp, 0, None)], -1).astype(np.int32))
    carried = ttk.track_motion_model(
        port_frame(arrays, "cur"), port_frame(arrays, "last"),
        torch.from_numpy(arrays["last_T_cw"]), torch.from_numpy(arrays["T_pred"]), tcfg,
        map_pos=torch.from_numpy(arrays["map_pos"]), map_valid=torch.from_numpy(arrays["map_valid"]),
        last_kp_point=torch.from_numpy(arrays["last_kp_point"].astype(np.int64)))
    print(f"the port on JAX's inputs: {int(carried[2])} inliers of {int(carried[1])} matches, "
          f"pose {float(np.abs(carried[0].numpy() - np.asarray(jres[0])).max()):.3e} from JAX's")

    # The pyramid: each level resized from JAX's rounded level below.
    shapes = jim.pyramid_shapes(*g.shape, jcfg.orb.n_levels, jcfg.orb.scale_factor)
    prev = g
    for lvl in range(1, jcfg.orb.n_levels):
        a = np.asarray(jim.resize_bilinear(jnp.asarray(prev), *shapes[lvl]))
        with highest_precision():
            b = tim.resize_linear(torch.from_numpy(np.ascontiguousarray(prev)), *shapes[lvl]).numpy()
        flips = np.argwhere(np.round(a) != np.round(b))
        print(f"level {lvl}: unrounded max |jax - port| {float(np.abs(a - b).max()):.3e}, "
              f"{len(flips)} pixels rounded apart")
        for y, x in flips:
            print(f"  ({y}, {x}): JAX {a[y, x]:.6f}, port {b[y, x]:.6f} (1 ulp "
                  f"{float(np.spacing(np.float32(a[y, x]))):.3e})")
        if lvl == 5:
            arrays["level5"] = np.round(a).astype(np.uint8)
        prev = np.round(a)
    np.savez_compressed(OUT, **arrays)
    print(f"wrote {OUT} ({OUT.stat().st_size} bytes)")
    return 0


if __name__ == "__main__":
    sys.exit(main())

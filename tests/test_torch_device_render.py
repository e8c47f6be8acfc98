"""Port parity for the device renderer (`io/device_render.py`) against the
JAX package's `render_frames`, at QVGA on two poses of the walker scene
(`SyntheticSequence(trajectory="sway")` with `cross_walkers`), with
supersampling 2, flat gray levels on a static and a moving box, and
the moving boxes' own texture anchors.

Gates, and why:
- the lattice hash: exact (the same uint32 arithmetic, in masked int64);
- depth (uint16 mm, the centre ray): within 1 mm on >= 99.9% of pixels
  (measured: all equal);
- gray (uint8): within 1 level on >= 99% of pixels (the mean of the
  supersamples rounds down at an integer boundary now and then; measured
  99.997% within 1, 99.99% equal);
- with depth noise on: the streams differ (a torch generator keyed like
  JAX's key), so the relative depth error's standard deviation must lie
  within 10% of `depth_noise` (measured 0.0100015 for 0.01).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import orb_slam2_ssd_semantic_tpu.config as jconfig
import orb_slam2_ssd_semantic_tpu_torch.config as tconfig
from orb_slam2_ssd_semantic_tpu.io import device_render as jdr
from orb_slam2_ssd_semantic_tpu.io.synthetic import SyntheticSequence, cross_walkers
from orb_slam2_ssd_semantic_tpu_torch.io import device_render as tdr
from _torch_threads import _few_threads  # noqa: F401 (autouse)

CAM = dict(width=320, height=240, fx=262.75, fy=262.0, cx=159.75, cy=122.75)
FRAMES = (5, 23)
N_SEQ = 40


@pytest.fixture(scope="module")
def walker_scene():
    seq = SyntheticSequence(n_frames=N_SEQ, trajectory="sway")
    poses = np.stack(seq.poses_wc).astype(np.float32)[list(FRAMES)]
    boxes = tuple(tuple(map(tuple, b)) for b in seq.room.boxes)
    walkers = cross_walkers(N_SEQ, seq.room.size, n_objects=3)[list(FRAMES)]
    box_gray = tuple([-1.0] * (len(boxes) - 2) + [90.0, -1.0])
    kw = dict(size=seq.room.size, boxes=boxes, seed=seq.seed, ss=2, box_gray=box_gray,
              moving_gray=(-1.0, 120.0, -1.0))

    cache = {}

    def render(noise):
        if noise in cache:
            return cache[noise]
        gj, dj = jdr.render_frames(jnp.asarray(poses), jconfig.CameraConfig(**CAM),
                                   moving_boxes=jnp.asarray(walkers), depth_noise=noise, **kw)
        gt, dt = tdr.render_frames(poses, tconfig.CameraConfig(**CAM), moving_boxes=walkers,
                                   depth_noise=noise, device="cpu", **kw)
        cache[noise] = np.asarray(gj), np.asarray(dj), gt.numpy(), dt.numpy()
        return cache[noise]

    return render


def test_hash_matches_jax():
    rng = np.random.default_rng(0)
    ix = rng.integers(-2**31, 2**31 - 1, 4096, dtype=np.int64).astype(np.int32)
    iy = rng.integers(-70000, 70000, 4096).astype(np.int32)
    seed = rng.integers(0, 400, 4096).astype(np.int32)
    want = np.asarray(jdr._hash2(jnp.asarray(ix), jnp.asarray(iy), jnp.asarray(seed)))
    got = tdr._hash2(torch.from_numpy(ix), torch.from_numpy(iy), torch.from_numpy(seed)).numpy()
    np.testing.assert_array_equal(got, want)


def test_render_frames_matches_jax(walker_scene):
    gj, dj, gt, dt = walker_scene(0.0)
    assert gt.shape == gj.shape == (len(FRAMES), 240, 320)
    assert gt.dtype == np.uint8 and dt.dtype == np.uint16
    assert (np.abs(dt.astype(np.int64) - dj) <= 1).mean() >= 0.999
    assert (np.abs(gt.astype(np.int64) - gj) <= 1).mean() >= 0.99
    assert (gt == 120).mean() > 0.001, "the flat moving box is not in view: vacuous"


def test_render_depth_noise(walker_scene):
    noise = 0.01
    _, d0, _, _ = walker_scene(0.0)
    _, dj, _, dt = walker_scene(noise)
    ok = d0 > 0
    z = d0[ok].astype(np.float64)
    rel_t = (dt[ok] - z) / z
    rel_j = (dj[ok] - z) / z
    assert abs(rel_t.std() - noise) <= 0.1 * noise, rel_t.std()
    assert abs(rel_j.std() - noise) <= 0.1 * noise, rel_j.std()
    assert not np.array_equal(dt[0], dt[1])

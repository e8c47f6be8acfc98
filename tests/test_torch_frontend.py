"""Port parity: ORB extraction (pyramid, FAST, selection, IC angle,
steered BRIEF) against the JAX package on rendered synthetic frames.

Tolerances, and why:
- valid set and pyramid levels: exact (integer decisions on the same
  f32 pyramid, built with the same separable resize weights);
- keypoint positions: 1e-3 px (the sub-pixel refinement divides f32
  sums that XLA and torch accumulate in different orders);
- descriptors: bit-equal on >= 99% of valid keypoints. The IC angle is
  a moment ratio summed in another order; a keypoint whose angle lies on
  a 12-degree BRIEF bin boundary may take the neighbouring bin and so
  rotate its whole sampling pattern.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam2_ssd_semantic_tpu.config import CameraConfig as JCam
from orb_slam2_ssd_semantic_tpu.config import OrbConfig as JOrb
from orb_slam2_ssd_semantic_tpu.frontend.extractor import extract as j_extract
from orb_slam2_ssd_semantic_tpu.io.synthetic import SyntheticSequence
from orb_slam2_ssd_semantic_tpu_torch.config import OrbConfig as TOrb
from orb_slam2_ssd_semantic_tpu_torch.frontend.extractor import extract as t_extract
from orb_slam2_ssd_semantic_tpu_torch.utils.precision import highest_precision
from _torch_threads import _few_threads  # noqa: F401 (autouse)

SMALL_CAM = JCam(fx=267.7, fy=269.6, cx=160.0, cy=123.8, width=320, height=240, th_depth=80.0)


def _frame(cam, i):
    seq = SyntheticSequence(n_frames=8, cam=cam)
    gray, _ = seq.gray_depth(i)
    return gray


@pytest.mark.parametrize("case", ["vga_default", "qvga_truncated"])
def test_extract_matches_jax(case):
    if case == "vga_default":
        gray = _frame(JCam(), 3)
        orb = dict()
    else:
        # Fewer slots than detections: exercises the score top-k cut.
        gray = _frame(SMALL_CAM, 5)
        orb = dict(n_features=600, max_keypoints=384)
    fj = j_extract(jnp.asarray(gray), JOrb(**orb))
    with highest_precision():
        ft = t_extract(torch.from_numpy(gray), TOrb(**orb))

    vj = np.asarray(fj.valid)
    assert vj.sum() > 200, "vacuous frame"
    np.testing.assert_array_equal(vj, ft.valid.numpy())
    np.testing.assert_array_equal(np.asarray(fj.level)[vj], ft.level.numpy()[vj])
    np.testing.assert_allclose(np.asarray(fj.uv)[vj], ft.uv.numpy()[vj], atol=1e-3, rtol=0)
    dj = np.asarray(fj.desc)[vj]
    dt = ft.desc.numpy().view(np.uint32)[vj]
    same = np.all(dj == dt, axis=1)
    assert same.mean() >= 0.99, f"descriptor agreement {same.mean():.4f}"

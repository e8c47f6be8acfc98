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

The twins of `tests/test_frontend.py`'s rotation tests run the exact
references (`ic_angle`, `steered_brief` on the `gaussian_blur` pre-blur)
on a smooth float image: angles within 1e-5 rad of JAX's and the
rotation gates of the JAX tests; `level_mask` equal to JAX's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam2_ssd_semantic_tpu.config import CameraConfig as JCam
from orb_slam2_ssd_semantic_tpu.config import OrbConfig as JOrb
from orb_slam2_ssd_semantic_tpu.frontend.extractor import extract as j_extract
from orb_slam2_ssd_semantic_tpu.io.synthetic import SyntheticSequence
from orb_slam2_ssd_semantic_tpu_torch.config import OrbConfig as TOrb
from orb_slam2_ssd_semantic_tpu.ops import image as jimg
from orb_slam2_ssd_semantic_tpu.ops import match as jmatch
from orb_slam2_ssd_semantic_tpu.ops import orb_descriptor as jod
from orb_slam2_ssd_semantic_tpu_torch.frontend.extractor import extract as t_extract
from orb_slam2_ssd_semantic_tpu_torch.ops import image as timg
from orb_slam2_ssd_semantic_tpu_torch.ops import match as tmatch
from orb_slam2_ssd_semantic_tpu_torch.ops import orb_descriptor as tod
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


def _textured_image(seed, h, w):
    """`tests/test_frontend.py`'s smooth random texture (not rounded)."""
    base = np.random.default_rng(seed).uniform(0, 255, size=(h // 8, w // 8)).astype(np.float32)
    return np.asarray(jimg.resize_bilinear(jnp.asarray(base), h, w))


def _rotated(img, uv):
    """The image turned 90 degrees counter-clockwise and the keypoints with
    it: new[y, x] = old[x, H - 1 - y]."""
    return np.rot90(img, k=1).copy(), np.stack([uv[:, 1], (img.shape[0] - 1) - uv[:, 0]], -1)


def _angles(img, uv, valid):
    a = tod.ic_angle(torch.from_numpy(img), torch.from_numpy(uv), torch.from_numpy(valid))
    a_jax = np.asarray(jod.ic_angle(jnp.asarray(img), jnp.asarray(uv), jnp.asarray(valid)))
    np.testing.assert_allclose(a.numpy(), a_jax, atol=1e-5, rtol=0)
    return a


def test_ic_angle_rotation_consistency():
    """Rotating the image by 90 degrees turns the angles by -90 degrees (x
    right, y down), as in JAX's test."""
    img = _textured_image(0, 96, 96)
    uv = np.asarray([[48.0, 48.0], [40.0, 52.0]], np.float32)
    valid = np.ones((2,), bool)
    a0 = _angles(img, uv, valid).numpy()
    a1 = _angles(*_rotated(img, uv), valid).numpy()
    d = np.angle(np.exp(1j * (a1 - a0 + np.pi / 2)))
    assert np.all(np.abs(d) < 0.15), d


def test_brief_descriptor_rotation_invariance():
    """Steered BRIEF on the pre-blurred image: the same keypoint across a
    90-degree rotation stays within 80 bits, closer than other keypoints;
    the descriptors equal JAX's on both views."""
    img = _textured_image(1, 128, 128)
    uv = np.asarray([[64.0, 64.0], [56.0, 70.0], [72.0, 58.0]], np.float32)
    valid = np.ones((3,), bool)
    descs = []
    for im, u in ((img, uv), _rotated(img, uv)):
        ang = _angles(im, u, valid)
        blurred = timg.gaussian_blur(torch.from_numpy(im))
        d = tod.steered_brief(blurred, torch.from_numpy(u), ang, torch.from_numpy(valid))
        with jax.disable_jit():  # jitted, XLA fuses the blur's multiply-adds
            blurred_jax = jimg.gaussian_blur(jnp.asarray(im), 7, 2.0)
        d_jax = jod.steered_brief(blurred_jax, jnp.asarray(u), jnp.asarray(ang.numpy()),
                                  jnp.asarray(valid))
        np.testing.assert_array_equal(d.numpy(), np.asarray(d_jax).view(np.int32))
        descs.append(d)
    dist = tmatch.popcount32(torch.bitwise_xor(descs[0], descs[1])).sum(-1)
    others = tmatch.popcount32(torch.bitwise_xor(descs[0], descs[0][[1, 2, 0]])).sum(-1)
    assert (dist < 80).all(), dist
    assert dist.float().mean() < others.float().mean()


def test_level_mask_matches_jax():
    rng = np.random.default_rng(2)
    lq, lt = rng.integers(0, 8, 300), rng.integers(0, 8, 200)
    for lo, hi in ((-1, 0), (0, 0), (-2, 1)):
        m = tmatch.level_mask(torch.from_numpy(lq), torch.from_numpy(lt), lo, hi)
        m_jax = np.asarray(jmatch.level_mask(jnp.asarray(lq), jnp.asarray(lt), lo, hi))
        np.testing.assert_array_equal(m.numpy(), m_jax)
        assert 0 < m_jax.mean() < 1

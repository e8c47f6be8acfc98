"""Port parity: ORB-SLAM2's orientation and descriptor references
(`ic_angle`, `steered_brief`, the `gaussian_blur` pre-blur) against the JAX
package, and the port's fast patch path against those references (the
twins of `tests/test_descriptor_fast.py`).

Tolerances, and why:
- `ic_angle` within 1e-5 rad of JAX's: the disk moments are sums of
  integer products, exact in f32 on these integer images, so only
  `atan2` itself may differ (by an ulp);
- `steered_brief` equal on every bit: rotate, round half to even, clamp
  and compare, the same operations on the same f32 values;
- `gaussian_blur` within 1e-5 of JAX evaluated eagerly (jitted, XLA
  contracts the tap sums into fused multiply-adds, a few ulp at 255);
- the fast path against the references as `tests/test_descriptor_fast.py`
  holds JAX's: 1e-4 rad for the angle, every bit at bin centres, 1e-3
  for the blurred patches.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from orb_slam2_ssd_semantic_tpu.ops import image as jimg
from orb_slam2_ssd_semantic_tpu.ops import orb_descriptor as jod
from orb_slam2_ssd_semantic_tpu_torch.ops import image as timg
from orb_slam2_ssd_semantic_tpu_torch.ops import orb_descriptor as tod
from orb_slam2_ssd_semantic_tpu_torch.ops.match import popcount32
from _torch_threads import _few_threads  # noqa: F401 (autouse)


def textured(seed, h=200, w=240):
    """`tests/test_descriptor_fast.py`'s integer-valued texture."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(0, 255, size=(h // 8, w // 8)).astype(np.float32)
    return np.round(np.asarray(jimg.resize_bilinear(jnp.asarray(base), h, w)))


def keypoints(seed, n, h, w, margin=20):
    rng = np.random.default_rng(seed)
    uv = np.stack([rng.uniform(margin, w - margin, n), rng.uniform(margin, h - margin, n)],
                  -1).astype(np.float32)
    valid = np.ones((n,), bool)
    valid[::7] = False
    return uv, valid


def t(a):
    return torch.from_numpy(np.array(a))


def test_ic_angle_matches_jax_and_the_patch_path():
    img = textured(1)
    uv, valid = keypoints(1, 64, *img.shape)
    a_jax = np.asarray(jod.ic_angle(jnp.asarray(img), jnp.asarray(uv), jnp.asarray(valid)))
    a_ref = tod.ic_angle(t(img), t(uv), t(valid))
    np.testing.assert_allclose(a_ref.numpy(), a_jax, atol=1e-5, rtol=0)
    assert np.abs(a_jax[valid]).max() > 0.5, "vacuous angles"
    a_fast = tod.ic_angle_from_patches(tod.extract_patches(t(img), t(uv)), t(valid))
    np.testing.assert_allclose(a_fast.numpy(), a_ref.numpy(), atol=1e-4, rtol=0)


def test_extract_patches_exact():
    img = textured(2)
    uv, _ = keypoints(2, 32, *img.shape)
    p = tod.extract_patches(t(img), t(uv)).numpy()
    x0 = np.round(uv[:, 0]).astype(int)
    y0 = np.round(uv[:, 1]).astype(int)
    for k in range(8):
        np.testing.assert_array_equal(p[k], img[y0[k] - 15:y0[k] + 16, x0[k] - 15:x0[k] + 16])


def test_steered_brief_matches_jax_and_binned_brief_at_bin_centres():
    img = textured(3)
    with jax.disable_jit():
        blurred_jax = np.round(np.asarray(jimg.gaussian_blur(jnp.asarray(img), 7, 2.0)))
    blurred = torch.round(timg.gaussian_blur(t(img)))
    np.testing.assert_array_equal(blurred.numpy(), blurred_jax)
    uv, valid = keypoints(3, 48, *img.shape)
    ang = (np.arange(48) % tod.N_ANGLE_BINS).astype(np.float32) * np.float32(
        2.0 * np.pi / tod.N_ANGLE_BINS)
    d_jax = np.asarray(jod.steered_brief(jnp.asarray(blurred_jax), jnp.asarray(uv),
                                         jnp.asarray(ang), jnp.asarray(valid))).view(np.int32)
    d_ref = tod.steered_brief(blurred, t(uv), t(ang), t(valid))
    np.testing.assert_array_equal(d_ref.numpy(), d_jax)
    assert (d_jax[valid] != 0).any(axis=1).all(), "vacuous descriptors"
    d_fast = tod.binned_brief(tod.extract_patches(blurred, t(uv)), t(ang), t(valid))
    np.testing.assert_array_equal(d_fast.numpy(), d_ref.numpy())


def test_quantize_angle_wraps():
    a = np.asarray([0.0, 2 * np.pi - 1e-3, -0.05, np.pi], np.float32)
    b = tod.quantize_angle(t(a)).numpy()
    np.testing.assert_array_equal(b, np.asarray(jod.quantize_angle(jnp.asarray(a))))
    assert b[0] == 0 and b[1] == 0 and b[2] == 0 and b[3] == tod.N_ANGLE_BINS // 2


def test_binned_brief_rotation_invariance():
    """A 90-degree rotation lands on a bin: the port's descriptors stay
    within JAX's test's 80 bits across it, and equal JAX's on both views."""
    img = textured(4, 128, 128)
    uv = np.asarray([[64.0, 64.0], [56.0, 70.0], [72.0, 58.0]], np.float32)
    valid = np.ones((3,), bool)
    uv_r = np.stack([uv[:, 1], (img.shape[0] - 1) - uv[:, 0]], -1)
    descs = []
    for im, u in ((img, uv), (np.rot90(img, k=1).copy(), uv_r)):
        ang = tod.ic_angle(t(im), t(u), t(valid))
        blurred = torch.round(timg.gaussian_blur(t(im)))
        d = tod.binned_brief(tod.extract_patches(blurred, t(u)), ang, t(valid))
        j = jnp.asarray(im)
        with jax.disable_jit():
            blurred_jax = jnp.round(jimg.gaussian_blur(j, 7, 2.0))
        d_jax = jod.binned_brief(jod.extract_patches(blurred_jax, jnp.asarray(u)),
                                 jod.ic_angle(j, jnp.asarray(u), jnp.asarray(valid)),
                                 jnp.asarray(valid))
        np.testing.assert_array_equal(d.numpy(), np.asarray(d_jax).view(np.int32))
        descs.append(d)
    dist = popcount32(torch.bitwise_xor(descs[0], descs[1])).sum(-1)
    assert (dist < 80).all(), dist


def test_blur_matches_jax_and_blur_patches():
    img = textured(5)
    with jax.disable_jit():
        full_jax = np.asarray(jimg.gaussian_blur(jnp.asarray(img), 7, 2.0))
    full = timg.gaussian_blur(t(img))
    np.testing.assert_allclose(full.numpy(), full_jax, atol=1e-5, rtol=0)
    uv, _ = keypoints(5, 24, *img.shape, margin=25)
    ref = tod.extract_patches(torch.round(full), t(uv))
    got = tod.blur_patches(tod.extract_patches(t(img), t(uv), half=15 + tod.BLUR_PAD))
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-3, rtol=0)

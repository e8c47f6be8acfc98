"""Where the port's run of phase 7c's loop circuit parts from the JAX
package's, on frame 19's recorded inputs (`tests/frame19_7c.npz`, written
by `divergence_7c.py`).

On that circuit (the default config, loop closing off, 640x480) the two
runs agree within 5e-5 in pose up to frame 18. At frame 19, which the
motion model tracks alone, the port counts 502 inliers and JAX 503. The
cause is not in the motion model: on JAX's own inputs the port's
`track_motion_model` gives JAX's matches and inliers and its pose within
rounding. The inputs differ because the new frame differs: its pyramid is
rounded to integer pixels, and a few pixels whose resized value lies
within 1-3 ulp of a half-integer round to the other side in the port (the
resize sums its f32 products in another order than XLA). One of them, on
level 6, moves a keypoint's sub-pixel refinement by 0.099 px; another
turns one descriptor.

- `test_pyramid_rounding_parts_only_at_half_pixels`: level 6 resized
  from JAX's level 5 in both packages: the unrounded values agree within
  1e-3, the rounded pixels agree wherever the value lies more than 4 ulp
  from a half-integer, and the pixels that part (at least one) lie
  within 4 ulp of one in both packages;
- `test_motion_model_agrees_on_equal_inputs`: JAX's frame-19 inputs
  through both packages' `track_motion_model`: equal match and inlier
  counts, poses within 1e-5.
"""

import dataclasses
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import orb_slam2_ssd_semantic_tpu.config as jconfig
import orb_slam2_ssd_semantic_tpu_torch.config as tconfig
from orb_slam2_ssd_semantic_tpu.frontend.extractor import Features as JFeatures
from orb_slam2_ssd_semantic_tpu.ops import image as jim
from orb_slam2_ssd_semantic_tpu.tracking import tracker as jtk
from orb_slam2_ssd_semantic_tpu_torch.frontend.extractor import Features as TFeatures
from orb_slam2_ssd_semantic_tpu_torch.ops import image as tim
from orb_slam2_ssd_semantic_tpu_torch.tracking import tracker as ttk
from orb_slam2_ssd_semantic_tpu_torch.utils.precision import highest_precision
from _torch_threads import _few_threads  # noqa: F401 (autouse)

DATA = Path(__file__).resolve().parent / "frame19_7c.npz"
ULPS = 4


def port_frame(a: dict, prefix: str) -> ttk.Frame:
    """A recorded JAX frame as the port's `Frame`."""
    t = {k: torch.from_numpy(np.array(a[f"{prefix}_{k}"])) for k in (
        "uv", "angle", "score", "valid", "kp_depth", "obs_uvr", "is_stereo")}
    feats = TFeatures(uv=t["uv"], level=torch.from_numpy(a[f"{prefix}_level"].astype(np.int64)),
                      angle=t["angle"], score=t["score"],
                      desc=torch.from_numpy(a[f"{prefix}_desc"].view(np.int32)), valid=t["valid"])
    return ttk.Frame(feats, t["kp_depth"], t["obs_uvr"], t["is_stereo"])


def jax_frame(a: dict, prefix: str) -> jtk.Frame:
    feats = JFeatures(**{k: jnp.asarray(a[f"{prefix}_{k}"]) for k in (
        "uv", "level", "angle", "score", "desc", "valid")})
    return jtk.Frame(feats, jnp.asarray(a[f"{prefix}_kp_depth"]), jnp.asarray(a[f"{prefix}_obs_uvr"]),
                     jnp.asarray(a[f"{prefix}_is_stereo"]))


@pytest.fixture(scope="module")
def recorded():
    with np.load(DATA) as z:
        return {k: z[k] for k in z.files}


def _config(mod):
    base = mod.SlamConfig()
    return dataclasses.replace(base, loop=dataclasses.replace(base.loop, enabled=False,
                                                              enable_relocalization=False))


def test_pyramid_rounding_parts_only_at_half_pixels(recorded):
    cfg = jconfig.SlamConfig()
    level5 = recorded["level5"].astype(np.float32)
    shape6 = jim.pyramid_shapes(cfg.camera.height, cfg.camera.width, cfg.orb.n_levels,
                                cfg.orb.scale_factor)[6]
    a = np.asarray(jim.resize_bilinear(jnp.asarray(level5), *shape6))
    with highest_precision():
        b = tim.resize_linear(torch.from_numpy(level5), *shape6).numpy()
    np.testing.assert_allclose(b, a, atol=1e-3, rtol=0)

    def near_half(x):
        return np.abs(x - (np.floor(x) + 0.5)) <= ULPS * np.spacing(np.abs(x).astype(np.float32))

    apart = np.round(a) != np.round(b)
    assert apart.sum() >= 1, "the recorded flip does not reproduce"
    assert (near_half(a) & near_half(b))[apart].all()
    far = ~near_half(a)
    np.testing.assert_array_equal(np.round(b)[far], np.round(a)[far])


def test_motion_model_agrees_on_equal_inputs(recorded):
    r = recorded
    jT, jn_match, jn_inl = jtk.track_motion_model(
        jax_frame(r, "cur"), jax_frame(r, "last"), jnp.asarray(r["last_T_cw"]),
        jnp.asarray(r["T_pred"]), _config(jconfig), map_pos=jnp.asarray(r["map_pos"]),
        map_valid=jnp.asarray(r["map_valid"]), last_kp_point=jnp.asarray(r["last_kp_point"]))
    with highest_precision():
        tT, tn_match, tn_inl = ttk.track_motion_model(
            port_frame(r, "cur"), port_frame(r, "last"), torch.from_numpy(r["last_T_cw"]),
            torch.from_numpy(r["T_pred"]), _config(tconfig), map_pos=torch.from_numpy(r["map_pos"]),
            map_valid=torch.from_numpy(r["map_valid"]),
            last_kp_point=torch.from_numpy(r["last_kp_point"].astype(np.int64)))
    assert int(jn_inl) > 400, "vacuous: the recorded frame tracks"
    assert (int(tn_match), int(tn_inl)) == (int(jn_match), int(jn_inl))
    np.testing.assert_allclose(tT.numpy(), np.asarray(jT), atol=1e-5, rtol=0)

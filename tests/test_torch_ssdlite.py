"""Port parity for the detector: `semantic/ssdlite.py` (the network, its
anchors and decode, Flax weights carried across) and `semantic/detector.py`
(preprocessing, NMS, the f32 and bf16 paths), against the JAX package on
the same numpy inputs and weights.

Gates, and why:
- `params_from_flax` on JAX's `init_ssdlite(PRNGKey(0), 21)`: all 404
  arrays consumed, every parameter and buffer filled, each equal to its
  Flax array in the torch layout; a missing or extra key raises;
- the full-width forward of one 300x300 input: loc and conf within 1e-4
  of each output's largest magnitude (the same f32 convolutions summed in
  another order; measured 2.0e-6 and 1.9e-6);
- `load_params` of the in-repo checkpoints: the same arrays as JAX's
  `load_params` reads, exactly; an npz the port saves loads in JAX and
  gives the same forward (1e-4 as above);
- `preprocess` of a 640x480 frame within 1e-4 (the antialiased resize
  as two products of XLA's weights);
- `ssd_anchors` exactly equal, `decode_boxes` within 1e-6 (one `exp`);
- `nms_fixed` exactly equal, ties in score included;
- the trained 4-class checkpoint on `tests/test_ssd_e2e.py`'s scene
  through the port's `Detector`: JAX's classes and valid flags, boxes
  within 0.5 px and scores within 1e-4, and that test's 0.3 m gate on the
  fused object;
- the bf16 batch against the port's own f32 path, at
  `test_batched_bf16_detection_matches_single`'s tolerances (3 px, 0.05).

The JAX parameters are made by JAX's own `init_ssdlite` under `jax.jit`:
the same threefry draws as an eager call (bit-equal), in one compile
instead of one per layer.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam2_ssd_semantic_tpu.config import CameraConfig as JCameraConfig
from orb_slam2_ssd_semantic_tpu.config import SemanticConfig as JSemanticConfig
from orb_slam2_ssd_semantic_tpu.semantic import detector as jdet
from orb_slam2_ssd_semantic_tpu.semantic import ssdlite as jssd
from orb_slam2_ssd_semantic_tpu_torch.config import CameraConfig, SemanticConfig
from orb_slam2_ssd_semantic_tpu_torch.semantic import detector as tdet
from orb_slam2_ssd_semantic_tpu_torch.semantic import ssdlite as tssd
from orb_slam2_ssd_semantic_tpu_torch.semantic.fusion import fuse_depth_window
from orb_slam2_ssd_semantic_tpu_torch.semantic.object_db import add_objects, empty_db
from test_ssd_e2e import _render_scene
from _torch_threads import _few_threads  # noqa: F401 (autouse)

CKPT_DIR = os.path.join(os.path.dirname(__file__), "..", "checkpoints")
CKPT4 = os.path.join(CKPT_DIR, "ssdlite_synthetic.npz")
CKPT21 = os.path.join(CKPT_DIR, "ssdlite_synthetic_c21.npz")
OUT_TOL = 1e-4


def _flat(params) -> dict:
    leaves, _ = jax.tree_util.tree_flatten_with_path(params)
    return {"/".join(str(p) for p in k): np.asarray(v) for k, v in leaves}


def _jit_init(key, num_classes=21):
    return jax.jit(lambda k: jssd.init_ssdlite(k, num_classes)[1])(key)


def jit_init_ssdlite(key, num_classes=21):
    """`jssd.init_ssdlite` with its parameters made under `jax.jit`."""
    return jssd.SSDLite(num_classes=num_classes), _jit_init(key, num_classes)


@pytest.fixture(scope="module")
def jax21():
    """JAX's 21-class SSDLite: (params, jitted apply)."""
    params = _jit_init(jax.random.PRNGKey(0), 21)
    return params, jax.jit(jssd.SSDLite(num_classes=21).apply)


def _port_model(flat) -> tssd.SSDLite:
    sd = tssd.params_from_flax(flat)
    n_cls = sd["SSDLiteHead_1.Conv_1.bias"].shape[0] // 6
    model = tssd.SSDLite(num_classes=n_cls)
    model.load_state_dict(sd)
    return model.eval()


def _forward_gap(model, apply, params, x):
    lj, cj = (np.asarray(a) for a in apply(params, jnp.asarray(x)))
    with torch.no_grad():
        lt, ct = (a.numpy() for a in model(torch.from_numpy(x)))
    assert lt.shape == lj.shape == (x.shape[0], 3000, 4) and ct.shape == cj.shape
    return (float(np.abs(lt - lj).max() / np.abs(lj).max()),
            float(np.abs(ct - cj).max() / np.abs(cj).max()))


def test_params_from_flax_carries_every_array(jax21):
    flat = _flat(jax21[0])
    assert len(flat) == 404
    sd = tssd.params_from_flax(flat)
    assert set(sd) == set(tssd.SSDLite(21).state_dict()) and len(sd) == 404
    back = tssd.params_to_flax(_port_model(flat))
    assert set(back) == set(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    dw = "['params']/['SSDLiteExtra_0']/['Conv_1']/['kernel']"
    assert flat[dw].shape == (3, 3, 1, 256) and tuple(sd["SSDLiteExtra_0.Conv_1.weight"].shape) \
        == (256, 1, 3, 3)
    with pytest.raises(KeyError):
        tssd.params_from_flax({k: v for k, v in flat.items() if "SSDLiteHead_11" not in k})
    with pytest.raises(KeyError):
        tssd.params_from_flax(dict(flat, **{"['params']/['Extra_0']/['Conv_0']/['kernel']":
                                            np.zeros((1, 1, 2, 2), np.float32)}))


def test_forward_matches_jax(jax21):
    params, apply = jax21
    x = np.random.default_rng(0).uniform(-1, 1, (1, 300, 300, 3)).astype(np.float32)
    gap = _forward_gap(_port_model(_flat(params)), apply, params, x)
    assert max(gap) <= OUT_TOL, f"loc/conf gap {gap} of the largest magnitude > {OUT_TOL}"


@pytest.mark.parametrize("path", [CKPT4, CKPT21], ids=["c4", "c21"])
def test_load_params_reads_the_checkpoint_as_jax_does(jax21, path):
    ref = _flat(jssd.load_params(path, jax21[0]))
    n_cls = np.load(path)["['params']/['SSDLiteHead_1']/['Conv_1']/['bias']"].shape[0] // 6
    model = tssd.load_params(path, tssd.SSDLite(num_classes=n_cls))
    got = tssd.params_to_flax(model)
    assert set(got) == set(ref)
    for k, v in ref.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    with pytest.raises(ValueError):  # another class count: shapes differ
        tssd.load_params(path, tssd.SSDLite(num_classes=n_cls + 1))


def test_saved_npz_loads_in_jax(jax21, tmp_path):
    params, apply = jax21
    model = tssd.init_ssdlite(21, seed=3, device="cpu")
    # Flax's initializers: kernels a normal truncated at 2 sigma with
    # standard deviation sqrt(1 / fan_in); BatchNorm and biases at rest.
    w = model.SSDLiteExtra_0.Conv_0.weight.detach()
    assert abs(float(w.std()) * np.sqrt(1280) - 1.0) < 0.02
    assert float(w.abs().max()) <= 2.0 / 0.87962566103423978 / np.sqrt(1280) + 1e-6
    assert (model.SSDLiteHead_1.Conv_1.bias == 0).all()
    assert (model.MobileNetV2Backbone_0.BatchNorm_4.running_var == 1).all()
    again = tssd.init_ssdlite(21, seed=3, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(model.state_dict().values(),
                                                 again.state_dict().values()))
    path = str(tmp_path / "port.npz")
    tssd.save_params(path, model)
    loaded = jssd.load_params(path, params)
    x = np.random.default_rng(1).uniform(-1, 1, (1, 300, 300, 3)).astype(np.float32)
    gap = _forward_gap(model, apply, loaded, x)
    assert max(gap) <= OUT_TOL, f"loc/conf gap {gap} > {OUT_TOL}"


def test_preprocess_matches_jax():
    rgb = np.random.default_rng(2).integers(0, 256, (480, 640, 3), dtype=np.uint8)
    want = np.asarray(jdet.preprocess(jnp.asarray(rgb)))
    got = tdet.preprocess(torch.from_numpy(rgb)).numpy()
    assert got.shape == (300, 300, 3)
    gap = float(np.abs(got - want).max())
    assert gap <= 1e-4, f"preprocess differs by {gap} > 1e-4"
    batch = tdet.preprocess(torch.from_numpy(np.stack([rgb, rgb[::-1].copy()])))
    np.testing.assert_allclose(batch[0].numpy(), got, atol=1e-5)


def test_anchors_and_decode_equal_jax():
    anchors = jssd.ssd_anchors()
    np.testing.assert_array_equal(tssd.ssd_anchors(), anchors)
    assert anchors.shape == (3000, 4)
    loc = np.random.default_rng(3).normal(0, 1.5, (2, 3000, 4)).astype(np.float32)
    want = np.asarray(jssd.decode_boxes(jnp.asarray(loc), jnp.asarray(anchors)))
    got = tssd.decode_boxes(torch.from_numpy(loc), torch.from_numpy(anchors)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6, err_msg="decode within 1e-6")


def test_nms_fixed_equals_jax():
    rng = np.random.default_rng(4)
    D = 32
    xy = rng.uniform(0, 200, (D, 2))
    wh = rng.uniform(10, 60, (D, 2))
    boxes = np.concatenate([xy, xy + wh], 1).astype(np.float32)
    boxes[5:10] = boxes[4] + rng.uniform(-3, 3, (5, 4)).astype(np.float32)  # overlaps
    boxes[12] = boxes[11]
    scores = rng.uniform(0, 1, D).astype(np.float32)
    scores[[3, 7, 11, 12, 20]] = np.float32(0.625)  # ties, across classes too
    classes = rng.integers(1, 4, D).astype(np.int32)
    classes[12] = classes[11]
    args = (boxes, scores, classes)
    want = jdet.nms_fixed(*(jnp.asarray(a) for a in args), D, 0.45)
    got = tdet.nms_fixed(*(torch.from_numpy(a) for a in args), D, 0.45)
    for w, g, name in zip(want, got, ("boxes", "scores", "classes", "keep")):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    keep = got[3].numpy()
    assert 0 < keep.sum() < D
    four = (np.asarray([[0, 0, 10, 10], [1, 1, 11, 11], [50, 50, 60, 60], [0, 0, 10, 10]],
                       np.float32), np.asarray([0.9, 0.8, 0.7, 0.6], np.float32),
            np.asarray([1, 1, 1, 2], np.int32))
    assert tdet.nms_fixed(*(torch.from_numpy(a) for a in four), 4, 0.45)[3].tolist() == \
        [True, False, True, True]


@pytest.fixture(scope="module")
def trained4():
    """The 4-class checkpoint through JAX's `Detector` and the port's, on
    `tests/test_ssd_e2e.py`'s scenes."""
    cfg_kw = dict(num_classes=4, det_score_threshold=0.4, fusion_prob_threshold=0.4)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jdet, "init_ssdlite", jit_init_ssdlite)
        jd = jdet.Detector(JSemanticConfig(**cfg_kw))
    jd.params = jssd.load_params(CKPT4, jd.params)
    td = tdet.Detector(SemanticConfig(**cfg_kw), device="cpu")  # "auto" finds CKPT4
    scenes = {c: _render_scene(c=c) for c in (1, 2, 3)}
    return jd, td, scenes


def _iou(a, b):
    lt = np.maximum(a[:2], b[:2])
    rb = np.minimum(a[2:], b[2:])
    inter = np.prod(np.maximum(rb - lt, 0))
    return inter / max(np.prod(a[2:] - a[:2]) + np.prod(b[2:] - b[:2]) - inter, 1e-9)


def test_trained_detector_matches_jax_and_localizes(trained4):
    jd, td, scenes = trained4
    cam = CameraConfig()
    target_cls = 2
    rgb, gt_px = scenes[target_cls]
    want = jd(rgb)
    out = td(rgb)
    jv, tv = np.asarray(want.valid), out.valid.numpy()
    np.testing.assert_array_equal(tv, jv, err_msg="valid flags")
    np.testing.assert_array_equal(out.classes.numpy(), np.asarray(want.classes),
                                  err_msg="classes")
    box_gap = float(np.abs(out.boxes.numpy() - np.asarray(want.boxes)).max())
    score_gap = float(np.abs(out.scores.numpy() - np.asarray(want.scores)).max())
    assert box_gap <= 0.5, f"boxes differ by {box_gap} px > 0.5"
    assert score_gap <= 1e-4, f"scores differ by {score_gap} > 1e-4"
    boxes, classes = out.boxes.numpy(), out.classes.numpy()
    assert any(tv[i] and classes[i] == target_cls and _iou(boxes[i], gt_px) > 0.3
               for i in range(len(tv))), "no detection of the target class on its box"

    # Fusion at a 2 m fronto-parallel plane, then the database: the JAX
    # test's 0.3 m gate.
    depth = torch.full(rgb.shape[:2], 2.0)
    cents, sizes, probs, _, ok = fuse_depth_window(out, depth, torch.eye(4), cam, td.cfg)
    assert bool(ok.any())
    cx_px, cy_px = (gt_px[0] + gt_px[2]) / 2, (gt_px[1] + gt_px[3]) / 2
    expected = np.array([(cx_px - cam.cx) / cam.fx * 2.0, (cy_px - cam.cy) / cam.fy * 2.0, 2.0])
    db = add_objects(empty_db(32, "cpu"), cents, sizes, probs, out.classes, ok & out.valid)
    errs = [np.linalg.norm(db.centroid[i].numpy() - expected) for i in range(32)
            if bool(db.valid[i]) and int(db.class_id[i]) == target_cls]
    assert errs and min(errs) < 0.3, errs
    # JAX's own fusion of its own detections lands on the same object.
    jc, _, _, _, jok = jax_fuse(want, depth.numpy(), JCameraConfig(), jd.cfg)
    i = int(np.argmax(tv & (classes == target_cls) & ok.numpy()))
    assert bool(jok[i])
    np.testing.assert_allclose(cents[i].numpy(), np.asarray(jc)[i], atol=1e-4)


def jax_fuse(det, depth, cam, cfg):
    from orb_slam2_ssd_semantic_tpu.semantic.fusion import fuse_depth_window as jfuse

    return jfuse(det, jnp.asarray(depth), jnp.eye(4), cam, cfg)


def test_batched_bf16_detection_matches_single(trained4):
    _, td, scenes = trained4
    imgs = [scenes[c][0] for c in (1, 2, 3)]
    singles = [td(s) for s in imgs]
    batched = td.detect_batch(imgs)
    assert len(batched) == 3
    for s, b in zip(singles, batched):
        sv, bv = s.valid.numpy(), b.valid.numpy()
        assert sv.sum() == bv.sum() > 0
        np.testing.assert_array_equal(s.classes.numpy()[sv], b.classes.numpy()[bv])
        np.testing.assert_allclose(s.boxes.numpy()[sv], b.boxes.numpy()[bv], atol=3.0,
                                   err_msg="bf16 boxes within 3 px")
        np.testing.assert_allclose(s.scores.numpy()[sv], b.scores.numpy()[bv], atol=0.05,
                                   err_msg="bf16 scores within 0.05")

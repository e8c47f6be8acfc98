"""Port parity for SSD training (`semantic/train.py`) against the JAX
package on the same numpy inputs and weights.

Gates, and why:
- `encode_boxes` within 1e-6 of JAX's, and the port's decode inverts it
  within 1e-4 (`tests/test_ssd_train.py`'s round trip);
- `match_anchors` exactly equal on padded GTs, on two GTs that share a
  best anchor and on a GT whose best anchor is anchor 0, which the padded
  GTs' claims then overwrite (XLA's CPU scatter keeps the last write);
- `multibox_loss` and its gradient in `loc` and `conf` against `jax.grad`
  (1e-6, 1e-6 of each gradient's largest magnitude), on logits whose
  hard negatives tie in CE across the 3:1 cut: the stable ranking must
  pick JAX's;
- `synthetic_detection_batch` bit-equal;
- `adam` against `optax.adam`, three steps on fixed gradients (1e-6);
- one full train step on JAX's 4-class weights carried across with
  `params_from_flax`, batch 2: loss within 1e-5 relative, every one of
  the 404 gradients (batch statistics included) within 1e-4 of that
  gradient's norm (the same f32 convolutions summed in another order);
- the port's twin of `test_ssd_train.py::test_train_step_reduces_loss`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from orb_slam2_ssd_semantic_tpu.semantic import ssdlite as jssd
from orb_slam2_ssd_semantic_tpu.semantic import train as jtrain
from orb_slam2_ssd_semantic_tpu_torch.semantic import ssdlite as tssd
from orb_slam2_ssd_semantic_tpu_torch.semantic import train as ttrain
from _torch_threads import _few_threads  # noqa: F401 (autouse)

ANCHORS = tssd.ssd_anchors(300)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _flat(tree) -> dict:
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(str(p) for p in k): np.asarray(v) for k, v in leaves}


def test_encode_boxes_matches_jax_and_inverts_decode():
    rng = np.random.default_rng(0)
    c = rng.uniform(0.3, 0.7, (ANCHORS.shape[0], 2)).astype(np.float32)
    wh = rng.uniform(0.1, 0.3, (ANCHORS.shape[0], 2)).astype(np.float32)
    gt = np.concatenate([c - wh / 2, c + wh / 2], -1)
    want = np.asarray(jtrain.encode_boxes(jtrain._xyxy_to_cxcywh(jnp.asarray(gt)),
                                          jnp.asarray(ANCHORS)))
    got = ttrain.encode_boxes(ttrain._xyxy_to_cxcywh(_t(gt)), _t(ANCHORS))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    back = tssd.decode_boxes(got, _t(ANCHORS))
    np.testing.assert_allclose(back.numpy(), gt, atol=1e-4)


def _gt_sets():
    """(B, G) padded GT sets: one valid box and two pads; two valid boxes
    with one best anchor (different classes) and a pad; a valid box of
    zero area (IoU 0 with every anchor, so its best anchor is anchor 0, as
    a pad's is) followed by two pads; the same box after two pads; three
    valid boxes."""
    boxes = np.zeros((5, 3, 4), np.float32)
    cls = np.zeros((5, 3), np.int32)
    valid = np.zeros((5, 3), bool)
    boxes[0, 0], cls[0, 0] = [0.3, 0.3, 0.6, 0.6], 5
    boxes[1, :2], cls[1, :2] = [0.2, 0.25, 0.55, 0.5], [1, 3]
    boxes[2, 0] = boxes[3, 2] = [0.5, 0.5, 0.5, 0.5]
    cls[2, 0] = cls[3, 2] = 2
    boxes[4] = [[0.1, 0.1, 0.3, 0.4], [0.5, 0.2, 0.9, 0.6], [0.3, 0.6, 0.7, 0.95]]
    cls[4] = [1, 2, 3]
    valid[0, 0] = valid[1, :2] = valid[2, 0] = valid[3, 2] = True
    valid[4] = True
    return boxes, cls, valid


def test_match_anchors_matches_jax_on_pads_and_shared_anchors():
    boxes, cls, valid = _gt_sets()
    anchors = jnp.asarray(ANCHORS)
    got = ttrain.match_anchors(_t(ANCHORS), _t(boxes), _t(cls), _t(valid))
    for b in range(boxes.shape[0]):
        want = jtrain.match_anchors(anchors, jnp.asarray(boxes[b]), jnp.asarray(cls[b]),
                                    jnp.asarray(valid[b]))
        np.testing.assert_array_equal(got.pos[b].numpy(), np.asarray(want.pos))
        np.testing.assert_array_equal(got.cls[b].numpy(), np.asarray(want.cls))
        pos = np.asarray(want.pos)
        np.testing.assert_allclose(got.loc[b].numpy()[pos], np.asarray(want.loc)[pos],
                                   rtol=0, atol=1e-5)
    # The cases are what they claim: GTs 0 and 1 of set 1 share a best
    # anchor, whose class is the later GT's; the zero-area GT's claim on
    # anchor 0 is overwritten by the pads after it (set 2) and holds when
    # it comes last (set 3).
    iou = np.asarray(jtrain._iou_anchors_gt(
        jnp.concatenate([anchors[:, :2] - anchors[:, 2:] / 2,
                         anchors[:, :2] + anchors[:, 2:] / 2], -1), jnp.asarray(boxes[1])))
    shared = int(iou[:, 0].argmax())
    assert shared == int(iou[:, 1].argmax()) and int(got.cls[1, shared]) == 3
    assert not bool(got.pos[2].any())
    assert bool(got.pos[3, 0]) and int(got.cls[3, 0]) == 2 and int(got.pos[3].sum()) == 1


def test_multibox_loss_and_gradient_match_jax_with_tied_negatives():
    boxes, cls, valid = _gt_sets()
    rng = np.random.default_rng(1)
    A, C = ANCHORS.shape[0], 6
    loc = rng.normal(0.0, 1.0, (A, 4)).astype(np.float32)
    conf = rng.normal(0.0, 1.0, (A, C)).astype(np.float32)
    targets = [jtrain.match_anchors(jnp.asarray(ANCHORS), jnp.asarray(boxes[b]),
                                    jnp.asarray(cls[b]), jnp.asarray(valid[b])) for b in (0, 4)]
    # A block of 400 background anchors with one logit row: their CE ties
    # and sits above every other background anchor's, so the 3:1 cut falls
    # inside it.
    blk = np.nonzero(~np.asarray(targets[0].pos) & ~np.asarray(targets[1].pos))[0][600:1000]
    conf[blk] = np.array([-4.0, 2.0, 1.0, 0.5, 0.0, -1.0], np.float32)
    for t_j in targets:
        n_pos = int(np.asarray(t_j.pos).sum())
        assert 3 * n_pos < len(blk)

        def jloss(l, c):
            return jtrain.multibox_loss(l, c, t_j)[0]

        want, (g_loc, g_conf) = jax.value_and_grad(jloss, argnums=(0, 1))(
            jnp.asarray(loc), jnp.asarray(conf))
        t_t = ttrain.AnchorTargets(loc=_t(np.asarray(t_j.loc)),
                                   cls=_t(np.asarray(t_j.cls)).to(torch.int64),
                                   pos=_t(np.asarray(t_j.pos)))
        l_t = _t(loc).requires_grad_(True)
        c_t = _t(conf).requires_grad_(True)
        got, _ = ttrain.multibox_loss(l_t, c_t, t_t)
        got.backward()
        assert abs(float(got) - float(want)) <= 1e-6 * abs(float(want))
        for g, w in ((l_t.grad, g_loc), (c_t.grad, g_conf)):
            w = np.asarray(w)
            np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-6 * np.abs(w).max())
        # The picked negatives are JAX's: the tied block's first 3 n_pos.
        picked = np.nonzero(np.abs(np.asarray(g_conf)[blk]).sum(-1))[0]
        assert picked.tolist() == list(range(3 * n_pos))


def test_synthetic_detection_batch_is_bit_equal():
    want = jtrain.synthetic_detection_batch(np.random.default_rng(5), 3, n_classes=3)
    got = ttrain.synthetic_detection_batch(np.random.default_rng(5), 3, n_classes=3)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_device_batch_has_the_host_batch_layout():
    imgs, boxes, cls, valid = ttrain.synthetic_detection_batch_device(
        torch.Generator().manual_seed(0), 4, size=64)
    assert imgs.shape == (4, 64, 64, 3) and boxes.shape == (4, 3, 4)
    assert cls.dtype == torch.int32 and valid.dtype == torch.bool
    assert valid[:, 0].all() and ((cls > 0) == valid).all() and (cls <= 3).all()
    wh = boxes[..., 2:] - boxes[..., :2]
    assert ((wh >= 0.2 - 1e-6) & (wh <= 0.5 + 1e-6)).all() and (boxes[..., 2:] <= 1.0).all()


def test_adam_matches_optax():
    rng = np.random.default_rng(2)
    params = {"a": rng.normal(0, 1, (7, 5)).astype(np.float32),
              "b": rng.normal(0, 1, (3,)).astype(np.float32)}
    grads = [{k: rng.normal(0, 1, v.shape).astype(np.float32) for k, v in params.items()}
             for _ in range(3)]
    grads[1]["b"][0] = 0.0
    tx = optax.adam(1e-3)
    p_j = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(p_j)
    model = torch.nn.Module()
    for k, v in params.items():
        model.register_parameter(k, torch.nn.Parameter(_t(v.copy())))
    opt = ttrain.adam(model, 1e-3)
    for g in grads:
        upd, state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, state, p_j)
        p_j = optax.apply_updates(p_j, upd)
        for k, v in g.items():
            getattr(model, k).grad = _t(v)
        opt.step()
    for k in params:
        np.testing.assert_allclose(getattr(model, k).detach().numpy(), np.asarray(p_j[k]),
                                   rtol=0, atol=1e-6)


@pytest.fixture(scope="module")
def one_step():
    """JAX's 4-class weights, a batch of 2, and each package's loss and
    gradients on them (one JAX compile)."""
    params = jax.jit(lambda k: jssd.init_ssdlite(k, 4)[1])(jax.random.PRNGKey(0))
    model = jssd.SSDLite(num_classes=4)
    anchors = jnp.asarray(jssd.ssd_anchors(300))

    def loss_fn(p, images, b, c, v):
        loc, conf = model.apply(p, images)

        def one(l, cf, bb, cc, vv):
            return jtrain.multibox_loss(l, cf, jtrain.match_anchors(anchors, bb, cc, vv))[0]

        return jnp.mean(jax.vmap(one)(loc, conf, b, c, v))

    batch = jtrain.synthetic_detection_batch(np.random.default_rng(1), 2, n_classes=3)
    loss_j, grads_j = jax.jit(jax.value_and_grad(loss_fn))(params, *batch)
    flat = _flat(params)
    port = tssd.SSDLite(num_classes=4)
    port.load_state_dict(tssd.params_from_flax(flat, port))
    # On these weights oneDNN's f32 convolutions leave 2 of the gradients
    # more than 1e-4 of their norm from the same step in float64 (1.19e-4
    # at worst; JAX's step 3.7e-6), PyTorch's own CPU convolutions none
    # (4.1e-5): `train_precision_probe.py --jax-weights`. The port's side
    # runs the latter.
    with torch.backends.mkldnn.flags(enabled=False):
        loss_t, grads_t = ttrain.value_and_grad(port, *batch)
    return dict(loss_j=float(loss_j), grads_j=tssd.params_from_flax(_flat(grads_j), port),
                loss_t=float(loss_t), grads_t=grads_t, n_arrays=len(flat))


def test_train_step_gradients_match_jax(one_step):
    r = one_step
    assert r["n_arrays"] == len(r["grads_t"]) == 404
    assert abs(r["loss_t"] - r["loss_j"]) <= 1e-5 * abs(r["loss_j"])
    worst = {}
    for name, want in r["grads_j"].items():
        got = r["grads_t"][name]
        assert got is not None, name
        norm = float(torch.linalg.vector_norm(want))
        worst[name] = float((got - want).abs().max()) / max(norm, 1e-30)
    bad = {k: v for k, v in worst.items() if v > 1e-4}
    assert not bad, sorted(bad.items(), key=lambda kv: -kv[1])[:5]
    # The batch statistics take a gradient, as in JAX.
    stats = [k for k in r["grads_j"] if k.endswith(("running_mean", "running_var"))]
    assert len(stats) == 2 * sum(1 for k in r["grads_j"] if k.endswith("running_mean")) > 100
    nonzero = [k for k in stats if float(r["grads_j"][k].abs().max()) > 0]
    assert len(nonzero) > 100
    assert all(float(r["grads_t"][k].abs().max()) > 0 for k in nonzero)


def test_train_step_reduces_loss():
    """The twin of `test_ssd_train.py::test_train_step_reduces_loss`: Adam
    at 3e-3 on one fixed batch; the batch statistics move too."""
    model = tssd.init_ssdlite(4, seed=0, device="cpu")
    mean0 = model.MobileNetV2Backbone_0.BatchNorm_0.running_mean.clone()
    step = ttrain.make_train_step(model, ttrain.adam(model, 3e-3))
    batch = ttrain.synthetic_detection_batch(np.random.default_rng(1), 2, n_classes=3)
    losses = [float(step(*batch)) for _ in range(20)]
    assert losses[-1] < 0.6 * losses[0], losses
    assert not torch.equal(model.MobileNetV2Backbone_0.BatchNorm_0.running_mean.detach(), mean0)

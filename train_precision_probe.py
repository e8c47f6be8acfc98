"""How close is one f32 training step of SSDLite to the same step in float64?

Computes one step's loss and the gradients of all 404 arrays
(`semantic/train.value_and_grad`) of the 4-class SSDLite on a numpy batch
of 2 (`synthetic_detection_batch`, seed 1) in float64 on the CPU, then in
f32 through each convolution backend, and prints, per backend, how many
gradients lie more than 1e-4 of their norm from the float64 ones, the
largest such distance and where, and the whole gradient's relative
distance:
- on the CPU: oneDNN's convolutions and PyTorch's own;
- on the card (when one is present): cuDNN's convolutions under the
  precision scope (deterministic algorithms, TF32 off), PyTorch's own
  CUDA convolutions (what `value_and_grad` runs), and float64.

    python3 train_precision_probe.py                # the seeded weights
    JAX_PLATFORMS=cpu python3 train_precision_probe.py --jax-weights

`--jax-weights` takes the JAX package's `init_ssdlite(PRNGKey(0), 4)`
weights (carried across with `params_from_flax`) and adds JAX's own f32
step on the CPU; it imports JAX, so it is for the CPU only. Prints one
JSON object a line, the card's name and power limit first when there is
a card.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import subprocess

import numpy as np
import torch

from orb_slam2_ssd_semantic_tpu_torch.semantic import ssdlite
from orb_slam2_ssd_semantic_tpu_torch.semantic import train

TOL = 1e-4


def _jax_step(batch):
    """JAX's weights as a port state_dict, and JAX's f32 gradients in the
    port's names and layouts."""
    import jax
    import jax.numpy as jnp

    from orb_slam2_ssd_semantic_tpu.semantic import ssdlite as jssd
    from orb_slam2_ssd_semantic_tpu.semantic import train as jtrain

    def flat(tree):
        leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
        return {"/".join(str(p) for p in k): np.asarray(v) for k, v in leaves}

    params = jax.jit(lambda k: jssd.init_ssdlite(k, 4)[1])(jax.random.PRNGKey(0))
    model = jssd.SSDLite(num_classes=4)
    anchors = jnp.asarray(jssd.ssd_anchors(300))

    def loss_fn(p, images, b, c, v):
        loc, conf = model.apply(p, images)

        def one(l, cf, bb, cc, vv):
            return jtrain.multibox_loss(l, cf, jtrain.match_anchors(anchors, bb, cc, vv))[0]

        return jnp.mean(jax.vmap(one)(loc, conf, b, c, v))

    _, grads = jax.jit(jax.value_and_grad(loss_fn))(params, *batch)
    shape = ssdlite.SSDLite(num_classes=4)
    return (ssdlite.params_from_flax(flat(params), shape),
            ssdlite.params_from_flax(flat(grads), shape))


def _model(state, dev, dtype=torch.float32):
    m = ssdlite.init_ssdlite(4, seed=0, device="cpu")
    if state is not None:
        m.load_state_dict(state)
    return m.to(dtype).to(dev)


def _report(label: str, grads: dict, ref: dict) -> dict:
    rel, diff, norm = {}, [], []
    for k, g in ref.items():
        g = g.double()
        d = grads[k].detach().cpu().double() - g
        diff.append(d.reshape(-1))
        norm.append(g.reshape(-1))
        n = float(torch.linalg.vector_norm(g))
        if n > 0:
            rel[k] = float(d.abs().max()) / n
    worst = max(rel, key=rel.get)
    out = dict(backend=label, over_tol=sum(v > TOL for v in rel.values()),
               worst=rel[worst], worst_array=worst,
               whole=float(torch.linalg.vector_norm(torch.cat(diff))
                           / torch.linalg.vector_norm(torch.cat(norm))))
    print(json.dumps(out), flush=True)
    return out


@contextlib.contextmanager
def _cudnn(enabled: bool):
    saved = torch.backends.cudnn.enabled
    torch.backends.cudnn.enabled = enabled
    try:
        yield
    finally:
        torch.backends.cudnn.enabled = saved


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--jax-weights", action="store_true")
    args = p.parse_args(argv)
    batch = train.synthetic_detection_batch(np.random.default_rng(1), 2, n_classes=3)
    b64 = [batch[0].astype(np.float64), batch[1].astype(np.float64), *batch[2:]]
    state = jax_grads = None
    if args.jax_weights:
        state, jax_grads = _jax_step(batch)
    cpu = torch.device("cpu")
    _, ref = train.value_and_grad(_model(state, cpu, torch.float64), *b64)
    if torch.cuda.is_available():
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=True).stdout.strip(), flush=True)
    with torch.backends.mkldnn.flags(enabled=True):
        _report("cpu f32, oneDNN", train.value_and_grad(_model(state, cpu), *batch)[1], ref)
    with torch.backends.mkldnn.flags(enabled=False):
        _report("cpu f32, PyTorch's", train.value_and_grad(_model(state, cpu), *batch)[1], ref)
    if jax_grads is not None:
        _report("JAX f32 on the CPU", jax_grads, ref)
    if torch.cuda.is_available():
        dev = torch.device("cuda")
        _report("card f32, PyTorch's (value_and_grad)",
                train.value_and_grad(_model(state, dev), *batch)[1], ref)
        # cuDNN under the same scope, through the same loss: the step's
        # body without value_and_grad's switch.
        model = _model(state, dev)
        leaves = train.trainable(model)
        anchors = torch.as_tensor(ssdlite.ssd_anchors(300)).to(dev)
        with train.precision.highest_precision(), _cudnn(True):
            train.loss_fn(model, anchors, *(torch.as_tensor(a).to(dev) for a in batch)).backward()
        _report("card f32, cuDNN", {k: t.grad for k, t in leaves.items()}, ref)
        _report("card f64", train.value_and_grad(_model(state, dev, torch.float64), *b64)[1],
                ref)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""Port parity: windowed Hamming matching and the fused window matcher's
plain version against the JAX package (the Pallas kernel in interpret
mode, and the XLA formulation of ops/match.py). Integer outputs: every
comparison is exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam2_ssd_semantic_tpu.ops import match as jm
from orb_slam2_ssd_semantic_tpu.ops.pallas_match import fused_window_match
from orb_slam2_ssd_semantic_tpu_torch.ops import cuda_match
from orb_slam2_ssd_semantic_tpu_torch.ops import match as tm
from _torch_threads import _few_threads  # noqa: F401 (autouse)


def _problem(seed, q=256, t=128):
    rng = np.random.default_rng(seed)
    return dict(
        desc_q=rng.integers(0, 2**32, (q, 8), dtype=np.uint32),
        desc_t=rng.integers(0, 2**32, (t, 8), dtype=np.uint32),
        centers=rng.uniform(0, 640, (q, 2)).astype(np.float32),
        uv_t=rng.uniform(0, 640, (t, 2)).astype(np.float32),
        radius=rng.uniform(20, 120, (q,)).astype(np.float32),
        valid_q=rng.random(q) > 0.2,
        valid_t=rng.random(t) > 0.2,
    )


def _torch(p):
    out = {}
    for k, v in p.items():
        out[k] = torch.from_numpy(v.view(np.int32) if v.dtype == np.uint32 else v.copy())
    return out


def _jax(p):
    return {k: jnp.asarray(v) for k, v in p.items()}


@pytest.mark.parametrize("q,t,max_dist", [(256, 128, 256), (512, 128, 115), (512, 256, 256)])
def test_window_match_reference_equals_pallas_kernel(q, t, max_dist):
    p = _problem(q + t + max_dist, q, t)
    j = fused_window_match(**_jax(p), max_dist=max_dist, interpret=True)
    tt = cuda_match.window_match_reference(**_torch(p), max_dist=max_dist)
    for name, a, b in zip(("best", "second", "idx", "key_min"), j, tt):
        np.testing.assert_array_equal(np.asarray(a), b.numpy(), err_msg=name)
    if max_dist == 115:  # the claimed set must be non-trivial
        assert (tt[3].numpy() < cuda_match.BIG_KEY).sum() > 0


def test_window_match_all_masked_matches_pallas_kernel():
    p = _problem(7)
    p["valid_q"] = np.zeros_like(p["valid_q"])
    j = fused_window_match(**_jax(p), interpret=True)
    tt = cuda_match.window_match_reference(**_torch(p))
    for a, b in zip(j, tt):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    assert (tt[0].numpy() == tm.BIG).all() and (tt[2].numpy() == 0).all()


def _split_case(case):
    """Problems for the split-and-merge model of the card's two kernels."""
    if case == "random":
        return _problem(21, 256, 256)
    if case == "t384":
        return _problem(22, 256, 384)
    if case == "all_masked":
        p = _problem(23, 256, 256)
        p["valid_t"] = np.zeros_like(p["valid_t"])
        return p
    if case == "masked_rows":
        p = _problem(24, 256, 256)
        p["valid_q"][::3] = False
        return p
    assert case == "ties"
    # A handful of descriptors and positions repeated over all targets, so
    # that equal distances inside one window meet in every split and in
    # the merge; queries are exact copies (distance 0 ties) or one bit off.
    rng = np.random.default_rng(25)
    q, t = 256, 256
    proto = rng.integers(0, 2**32, (4, 8), dtype=np.uint32)
    spots = rng.uniform(100, 500, (4, 2)).astype(np.float32)
    kind_t = rng.integers(0, 4, t)
    kind_q = rng.integers(0, 4, q)
    desc_q = proto[kind_q].copy()
    desc_q[::2, 0] ^= np.uint32(1)
    return dict(desc_q=desc_q, desc_t=proto[kind_t],
                centers=spots[kind_q], uv_t=spots[kind_t],
                radius=np.full((q,), 4.0, np.float32),
                valid_q=rng.random(q) > 0.1, valid_t=rng.random(t) > 0.3)


@pytest.mark.parametrize("split", [32, 128, None])
@pytest.mark.parametrize("case", ["random", "ties", "all_masked", "masked_rows", "t384"])
def test_window_match_split_reference_equals_reference(case, split):
    """Partial top-2 per target split, merged in ascending order, gives
    exactly what the one-pass plain version gives, ties included.
    `split=None` is one split over all of T."""
    p = _split_case(case)
    tp = _torch(p)
    t = p["desc_t"].shape[0]
    ref = cuda_match.window_match_reference(**tp, max_dist=100)
    got = cuda_match.window_match_split_reference(**tp, max_dist=100, split=split or t)
    for name, a, b in zip(("best", "second", "idx", "key_min"), got, ref):
        np.testing.assert_array_equal(a.numpy(), b.numpy(), err_msg=name)
    if case == "ties":  # ties must really meet across splits
        assert (ref[0] == ref[1]).sum() > 50
        assert (ref[3] < cuda_match.BIG_KEY).sum() > 0
    if case == "all_masked":
        assert (ref[0] == tm.BIG).all() and (ref[2] == 0).all()


def test_window_match_split_reference_equals_pallas_kernel():
    p = _split_case("ties")
    j = fused_window_match(**_jax(p), max_dist=100, interpret=True)
    tt = cuda_match.window_match_split_reference(**_torch(p), max_dist=100, split=32)
    for name, a, b in zip(("best", "second", "idx", "key_min"), j, tt):
        np.testing.assert_array_equal(np.asarray(a), b.numpy(), err_msg=name)


@pytest.mark.parametrize("q,t", [(2048, 1024), (1024, 1024), (512, 128), (768, 384), (256, 100),
                                 (2048, 2048), (2048, 32768)])
def test_window_match_tiles_cover_the_problem(q, t):
    """The grid the card's launch gets: splits that cover T, at least 64
    blocks at the tracker's shapes, and scratch that does not grow with
    T beyond MAX_SPLITS partial results a query."""
    split_len, n_splits = cuda_match.tiles(q, t)
    assert split_len % cuda_match.SPLIT_UNIT == 0
    assert (n_splits - 1) * split_len < t <= n_splits * split_len
    assert n_splits <= cuda_match.MAX_SPLITS
    if q >= 1024 and t >= 1024:
        assert -(-q // cuda_match.Q_TILE) * n_splits >= 64


def test_hamming_matrix_popcount_exact():
    p = _problem(3, 64, 128)
    a = np.asarray(jm.hamming_matrix(jnp.asarray(p["desc_q"]), jnp.asarray(p["desc_t"])))
    b = tm.hamming_matrix(*(torch.from_numpy(p[k].view(np.int32)) for k in ("desc_q", "desc_t")))
    np.testing.assert_array_equal(a, b.numpy())


def _near_duplicates(seed, q=256, t=256, flips=40):
    """Targets that are noisy copies of queries, shuffled and jittered,
    so windowed matches, ties and duplicate claims all occur."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 2**32, (t, 8), dtype=np.uint32)
    uv_t = rng.uniform(0, 640, (t, 2)).astype(np.float32)
    src = rng.integers(0, t, q)
    desc_q = base[src].copy()
    for _ in range(flips):
        r, w, bit = rng.integers(0, q), rng.integers(0, 8), rng.integers(0, 32)
        desc_q[r, w] ^= np.uint32(1 << bit)
    noise = rng.integers(0, 2, (q, 8, 32)).astype(bool) & (rng.random((q, 8, 32)) < 0.08)
    desc_q ^= (noise * (1 << np.arange(32, dtype=np.uint64))).sum(-1).astype(np.uint32)
    return dict(
        desc_q=desc_q, desc_t=base,
        centers=(uv_t[src] + rng.normal(0, 3, (q, 2))).astype(np.float32),
        uv_t=uv_t,
        radius=rng.uniform(5, 30, (q,)).astype(np.float32),
        valid_q=rng.random(q) > 0.1, valid_t=rng.random(t) > 0.1,
        angle_q=rng.uniform(-np.pi, np.pi, q).astype(np.float32),
        angle_t=rng.uniform(-np.pi, np.pi, t).astype(np.float32),
    )


@pytest.mark.parametrize("variant", ["plain", "angles", "mutual", "scalar_radius", "small_q"])
def test_match_by_window_matches_jax(variant):
    """JAX on the CPU takes its XLA path (dense matrix + scatter-min); the
    port takes the fused path's plain version (claim keys) wherever the
    JAX gate would take the kernel — both must give the same matches."""
    q = 200 if variant == "small_q" else 256
    p = _near_duplicates({"plain": 1, "angles": 2, "mutual": 3, "scalar_radius": 4,
                          "small_q": 5}[variant], q=q)
    kw = dict(max_dist=tm.TH_HIGH)
    if variant == "mutual":
        kw["mutual"] = True
    if variant == "scalar_radius":
        p["radius"] = np.float32(12.0)
    args = ("desc_q", "desc_t", "centers", "uv_t", "valid_q", "valid_t", "radius")
    ja = [jnp.asarray(p[k]) for k in args]
    ta = [torch.from_numpy(np.array(p[k]).view(np.int32) if p[k].dtype == np.uint32
                           else np.array(p[k])) for k in args]
    if variant == "angles":
        ja_ang = dict(angle_q=jnp.asarray(p["angle_q"]), angle_t=jnp.asarray(p["angle_t"]))
        ta_ang = dict(angle_q=torch.from_numpy(p["angle_q"]), angle_t=torch.from_numpy(p["angle_t"]))
    else:
        ja_ang = ta_ang = {}
    j = jm.match_by_window(*ja, **ja_ang, **kw)
    t = tm.match_by_window(*ta, **ta_ang, **kw)
    assert int(np.asarray(j.valid).sum()) > 20, "vacuous scenario"
    np.testing.assert_array_equal(np.asarray(j.valid), t.valid.numpy())
    np.testing.assert_array_equal(np.asarray(j.idx), t.idx.numpy())
    np.testing.assert_array_equal(np.asarray(j.dist), t.dist.numpy())


@pytest.mark.parametrize("ratio,mutual", [(None, False), (0.9, False), (0.7, True)])
def test_masked_best_match_and_resolution_match_jax(ratio, mutual):
    p = _near_duplicates(11)
    dist_j = jm.hamming_matrix(jnp.asarray(p["desc_q"]), jnp.asarray(p["desc_t"]))
    mask = np.random.default_rng(12).random(np.asarray(dist_j).shape) > 0.3
    mj = jm.masked_best_match(dist_j, jnp.asarray(mask), max_dist=tm.TH_LOW, ratio=ratio, mutual=mutual)
    mj = jm.resolve_duplicate_targets(mj, p["desc_t"].shape[0])
    dist_t = torch.from_numpy(np.asarray(dist_j).copy())
    mt = tm.masked_best_match(dist_t, torch.from_numpy(mask), max_dist=tm.TH_LOW, ratio=ratio,
                              mutual=mutual)
    mt = tm.resolve_duplicate_targets(mt, p["desc_t"].shape[0])
    np.testing.assert_array_equal(np.asarray(mj.idx), mt.idx.numpy())
    np.testing.assert_array_equal(np.asarray(mj.valid), mt.valid.numpy())


def test_rotation_consistency_mask_matches_jax():
    rng = np.random.default_rng(5)
    q = 300
    idx = rng.integers(0, 200, q)
    valid = rng.random(q) > 0.2
    ang_q = rng.uniform(-np.pi, np.pi, q).astype(np.float32)
    ang_t = rng.uniform(-np.pi, np.pi, 200).astype(np.float32)
    # a dominant rotation so the histogram has clear winners
    ang_q[: q // 2] = (ang_t[idx[: q // 2]] + 0.4).astype(np.float32)
    dist = rng.integers(0, 100, q).astype(np.int32)
    mj = jm.MatchResult(jnp.asarray(np.where(valid, idx, -1).astype(np.int32)),
                        jnp.asarray(dist), jnp.asarray(valid))
    mt = tm.MatchResult(torch.from_numpy(np.where(valid, idx, -1)), torch.from_numpy(dist),
                        torch.from_numpy(valid))
    a = jm.rotation_consistency_mask(jnp.asarray(ang_q), jnp.asarray(ang_t), mj)
    b = tm.rotation_consistency_mask(torch.from_numpy(ang_q), torch.from_numpy(ang_t), mt)
    np.testing.assert_array_equal(np.asarray(a), b.numpy())

"""Train a DBoW2-style hierarchical ORB vocabulary (counterpart of the JAX
package's `apps/train_vocabulary.py`).

The reference relies on a pretrained ~1M-node ORBvoc (k=10, L=6,
perfect/include/ORBVocabulary.h) that its snapshot does not ship. This
app builds a vocabulary the same way DBoW2's `create` does (hierarchical
binary k-means, k-majority) over a corpus of ORB descriptors from frames
of the synthetic world, computes TF-IDF weights, and saves it in the
engine's binary vocabulary format (io/vocabulary.save_binary, which both
packages' `load_binary` read). The clustering is numpy, a copy of the
JAX app's; the descriptors (`frontend/extractor.extract`) and the
quantization for the TF-IDF weights (`io/vocabulary.quantize`) run on
the device.

Usage:
  python -m orb_slam2_ssd_semantic_tpu_torch.apps.train_vocabulary \
      --frames 120 --k 10 --depth 4 --out checkpoints/orbvoc_synth.npz
"""

from __future__ import annotations

import argparse
import time

import numpy as np


def _unpack_bits(packed: np.ndarray) -> np.ndarray:
    """(N, 8) uint32 -> (N, 256) uint8 bits (little-endian per word)."""
    b = packed.astype("<u4").view(np.uint8).reshape(packed.shape[0], 32)
    return np.unpackbits(b, axis=1, bitorder="little")


def _pack_bits(bits: np.ndarray) -> np.ndarray:
    """(N, 256) -> (N, 8) uint32."""
    b = np.packbits(bits.astype(np.uint8), axis=1, bitorder="little")
    return b.view("<u4").astype(np.uint32)


def _hamming(packed_a: np.ndarray, packed_b: np.ndarray) -> np.ndarray:
    """(N, 8) x (M, 8) uint32 -> (N, M) int popcounts."""
    x = packed_a[:, None, :] ^ packed_b[None, :, :]
    return np.unpackbits(
        x.view(np.uint8).reshape(x.shape[0], x.shape[1], 32), axis=2
    ).sum(2)


def binary_kmeans(packed: np.ndarray, k: int, rng, iters: int = 8):
    """DBoW2 HKmeansStep: k binary centers by bit-majority vote."""
    n = packed.shape[0]
    k = min(k, n)
    centers = packed[rng.permutation(n)[:k]]
    assign = np.zeros(n, np.int64)
    for _ in range(iters):
        d = _hamming(packed, centers)
        new_assign = d.argmin(1)
        if (new_assign == assign).all():
            break
        assign = new_assign
        bits = _unpack_bits(packed)
        for c in range(k):
            m = assign == c
            if m.any():
                centers[c] = _pack_bits(
                    (bits[m].mean(0) >= 0.5)[None, :]
                )[0]
    return centers, assign


def build_tree(packed: np.ndarray, k: int, depth: int, seed: int = 0):
    """Recursive hierarchical clustering -> io.vocabulary.Vocabulary."""
    from orb_slam2_ssd_semantic_tpu_torch.io.vocabulary import Vocabulary

    rng = np.random.default_rng(seed)
    children: list[list[int]] = [[]]
    desc = [np.zeros(8, np.uint32)]
    is_leaf = [False]

    def rec(idx: np.ndarray, node: int, level: int):
        if level == depth or len(idx) <= max(2, k // 2):
            is_leaf[node] = True
            return
        centers, assign = binary_kmeans(packed[idx], k, rng)
        for c in range(centers.shape[0]):
            sub = idx[assign == c]
            if len(sub) == 0:
                continue
            cid = len(desc)
            desc.append(centers[c])
            children.append([])
            is_leaf.append(False)
            children[node].append(cid)
            rec(sub, cid, level + 1)
        if not children[node]:
            is_leaf[node] = True

    rec(np.arange(packed.shape[0]), 0, 0)
    n = len(desc)
    ch = np.full((n, k), -1, np.int32)
    for i, c in enumerate(children):
        ch[i, : len(c)] = c
    word_id = np.full((n,), -1, np.int32)
    wc = 0
    for i in range(n):
        if is_leaf[i]:
            word_id[i] = wc
            wc += 1
    return Vocabulary(
        children=ch, desc=np.stack(desc), word_id=word_id,
        word_weight=np.ones((wc,), np.float32), k=k, depth=depth,
    )


def image_descriptors(gray, orb_cfg, device) -> np.ndarray:
    """(M, 8) uint32 descriptors of the valid ORB keypoints of one gray
    image, extracted on `device`."""
    import torch

    from orb_slam2_ssd_semantic_tpu_torch.frontend.extractor import extract

    f = extract(torch.as_tensor(np.asarray(gray, np.float32)).to(device), orb_cfg)
    return f.desc.cpu().numpy().view(np.uint32)[f.valid.cpu().numpy()]


def tfidf(vocab, per_image: list, device):
    """`vocab` with DBoW2's idf weights (setNodeWeights: idf = log(N / n_i),
    0 for a word no image holds) over the images' descriptors, each
    quantized on `device`."""
    import torch

    from orb_slam2_ssd_semantic_tpu_torch.io import vocabulary as voc

    dv = voc.to_device(vocab, device)
    n_img = len(per_image)
    df = np.zeros(vocab.n_words, np.int64)
    for d in per_image:
        if len(d) == 0:
            continue
        w = voc.quantize(dv, torch.from_numpy(np.ascontiguousarray(d).view(np.int32)).to(device),
                         torch.ones(len(d), dtype=torch.bool, device=device)).cpu().numpy()
        df[np.unique(w[w >= 0])] += 1
    idf = np.log(n_img / np.maximum(df, 1)).astype(np.float32)
    idf[df == 0] = 0.0
    return vocab._replace(word_weight=idf)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--frames", type=int, default=120)
    p.add_argument("--k", type=int, default=10)
    p.add_argument("--depth", type=int, default=4)
    p.add_argument("--max-desc", type=int, default=80000)
    p.add_argument("--out", default="checkpoints/orbvoc_synth.npz")
    p.add_argument("--device", default=None, help="torch device (default: the card)")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)

    from orb_slam2_ssd_semantic_tpu_torch import device as device_mod
    from orb_slam2_ssd_semantic_tpu_torch.config import SlamConfig
    from orb_slam2_ssd_semantic_tpu_torch.io import vocabulary as voc
    from orb_slam2_ssd_semantic_tpu_torch.io.synthetic import SyntheticSequence

    dev = device_mod.resolve(args.device)
    cfg = SlamConfig()
    t0 = time.perf_counter()

    # Corpus: ORB descriptors from many synthetic viewpoints: the
    # four-wall loop room across several texture seeds (what place
    # recognition must discriminate) plus the orbit room for variety
    # (DBoW2 trains ORBvoc from ~10k diverse real frames; this is the
    # synthetic-world equivalent).
    per_image: list[np.ndarray] = []
    sources = [
        SyntheticSequence(n_frames=args.frames, trajectory="loop",
                          loop_laps=1.0, seed=s)
        for s in (17, 23, 31, 41)
    ] + [SyntheticSequence(n_frames=args.frames // 2)]
    for seq in sources:
        for i in range(len(seq)):
            g, _ = seq.gray_depth(i)
            per_image.append(image_descriptors(g, cfg.orb, dev))
            if i % 40 == 0:
                print(f"extracted {len(per_image)} images "
                      f"({time.perf_counter()-t0:.1f}s)")
    data = np.concatenate(per_image)
    rng = np.random.default_rng(args.seed)
    if len(data) > args.max_desc:
        data = data[rng.permutation(len(data))[: args.max_desc]]
    print(f"corpus: {len(data)} descriptors from {len(seq)} frames")

    vocab = build_tree(data, args.k, args.depth, args.seed)
    print(f"tree: {vocab.children.shape[0]} nodes, {vocab.n_words} words "
          f"({time.perf_counter()-t0:.1f}s)")
    vocab = tfidf(vocab, per_image, dev)

    voc.save_binary(vocab, args.out)
    print(f"saved {args.out} ({time.perf_counter()-t0:.1f}s total)")
    return vocab


if __name__ == "__main__":
    main()

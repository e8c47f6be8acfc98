"""DBoW2 ORB vocabulary: text-format loader, binary converter, and a
device-tensor hierarchical quantizer + L1 BoW scoring (counterpart of the
JAX package's `io/vocabulary.py`).

The host parts (the `Vocabulary` arrays, text and binary load/save,
`make_random_vocabulary`, the converter CLI) are numpy, copied from the
JAX module. The device parts run on tensors: the tree walk is `depth`
batched gather + Hamming-argmin steps over all keypoints at once, and
scoring is DBoW2's L1 score on L1-normalized TF-IDF vectors,
    s(v, w) = 1 - 0.5 * || v/|v| - w/|w| ||_1,
from a dense query vector and the database's sparse per-frame
(word, weight) columns.

Node descriptors are uint32 in the file and int32 on the device (the
port's descriptor dtype): the bits are reinterpreted, never converted.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from orb_slam2_ssd_semantic_tpu_torch.ops.match import popcount32
from orb_slam2_ssd_semantic_tpu_torch.utils.tensor_ops import scatter


class Vocabulary(NamedTuple):
    children: np.ndarray  # (n_nodes, k) int32, -1 padded
    desc: np.ndarray  # (n_nodes, 8) uint32 packed node descriptors
    word_id: np.ndarray  # (n_nodes,) int32 leaf word id, -1 for inner
    word_weight: np.ndarray  # (n_words,) float32 idf weights
    k: int
    depth: int

    @property
    def n_words(self) -> int:
        return int(self.word_weight.shape[0])


def _pack_desc_bytes(b: np.ndarray) -> np.ndarray:
    """(N, 32) uint8 -> (N, 8) uint32 little-endian words (bit i of byte
    j = descriptor bit j*8+i, matching ops/orb_descriptor packing)."""
    return b.reshape(-1, 8, 4).astype(np.uint32) @ np.asarray(
        [1, 1 << 8, 1 << 16, 1 << 24], np.uint32
    )


def load_text_vocabulary(path: str) -> Vocabulary:
    """Parse the DBoW2 text format (TemplatedVocabulary::loadFromTextFile)."""
    with open(path) as f:
        header = f.readline().split()
        k, depth = int(header[0]), int(header[1])
        parents, leaves, descs, weights = [], [], [], []
        for line in f:
            parts = line.split()
            if not parts:
                continue
            parents.append(int(parts[0]))
            leaves.append(int(parts[1]))
            descs.append([int(x) for x in parts[2:34]])
            weights.append(float(parts[34]))
    n = len(parents) + 1  # + root
    children = np.full((n, k), -1, np.int32)
    child_count = np.zeros((n,), np.int32)
    desc = np.zeros((n, 8), np.uint32)
    desc[1:] = _pack_desc_bytes(np.asarray(descs, np.uint8))
    word_id = np.full((n,), -1, np.int32)
    w = []
    for i, (p, is_leaf) in enumerate(zip(parents, leaves), start=1):
        children[p, child_count[p]] = i
        child_count[p] += 1
        if is_leaf:
            word_id[i] = len(w)
            w.append(weights[i - 1])
    return Vocabulary(
        children=children,
        desc=desc,
        word_id=word_id,
        word_weight=np.asarray(w, np.float32),
        k=k,
        depth=depth,
    )


def save_text_vocabulary(vocab: Vocabulary, path: str) -> None:
    """Write the DBoW2 text format (inverse of load_text_vocabulary;
    node order = node id order, which round-trips exactly)."""
    n = vocab.children.shape[0]
    parent = np.full((n,), -1, np.int32)
    for i in range(n):
        for c in vocab.children[i]:
            if c >= 0:
                parent[c] = i
    b = vocab.desc.view(np.uint8).reshape(n, 32)  # (8,) uint32 -> 32 bytes little-endian
    with open(path, "w") as f:
        f.write(f"{vocab.k} {vocab.depth} 0 0\n")
        for i in range(1, n):
            is_leaf = 1 if vocab.word_id[i] >= 0 else 0
            w = vocab.word_weight[vocab.word_id[i]] if is_leaf else 0.0
            byts = " ".join(str(int(x)) for x in b[i])
            f.write(f"{parent[i]} {is_leaf} {byts} {w}\n")


def save_binary(vocab: Vocabulary, path: str) -> None:
    """Compact binary form (tool/text2binary.cc equivalent)."""
    np.savez_compressed(
        path,
        children=vocab.children,
        desc=vocab.desc,
        word_id=vocab.word_id,
        word_weight=vocab.word_weight,
        k=np.int32(vocab.k),
        depth=np.int32(vocab.depth),
    )


def load_binary(path: str) -> Vocabulary:
    z = np.load(path)
    return Vocabulary(
        children=z["children"],
        desc=z["desc"],
        word_id=z["word_id"],
        word_weight=z["word_weight"],
        k=int(z["k"]),
        depth=int(z["depth"]),
    )


class DeviceVocabulary(NamedTuple):
    """A vocabulary's tree on a device: what `quantize` and the scorers read."""

    children: torch.Tensor  # (n_nodes, k) int64, -1 padded
    desc: torch.Tensor  # (n_nodes, 8) int32 (the file's uint32 bits)
    word_id: torch.Tensor  # (n_nodes,) int64
    idf: torch.Tensor  # (n_words,) float32
    depth: int

    @property
    def n_words(self) -> int:
        return int(self.idf.shape[0])

    @classmethod
    def from_vocabulary(cls, vocab: Vocabulary, device) -> "DeviceVocabulary":
        return to_device(vocab, device)


def to_device(vocab: Vocabulary, device) -> DeviceVocabulary:
    return DeviceVocabulary(
        children=torch.from_numpy(vocab.children.astype(np.int64)).to(device),
        desc=torch.from_numpy(np.ascontiguousarray(vocab.desc).view(np.int32)).to(device),
        word_id=torch.from_numpy(vocab.word_id.astype(np.int64)).to(device),
        idf=torch.from_numpy(vocab.word_weight.astype(np.float32)).to(device),
        depth=vocab.depth,
    )


def quantize(vocab: DeviceVocabulary, desc: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """(N, 8) int32 packed descriptors -> (N,) int64 word ids (-1 invalid).

    `depth` steps from the root: each gathers the children of every
    keypoint's current node and moves to the one at the least Hamming
    distance (the first among equals); a leaf stays put."""
    n_nodes = vocab.desc.shape[0]
    cur = torch.zeros((desc.shape[0],), dtype=torch.int64, device=desc.device)
    for _ in range(vocab.depth):
        kids = vocab.children[cur]  # (N, k)
        kd = vocab.desc[kids.clamp(0, n_nodes - 1)]  # (N, k, 8)
        d = popcount32(torch.bitwise_xor(desc[:, None, :], kd)).sum(-1)
        d = torch.where(kids >= 0, d, torch.full_like(d, 1 << 20))
        nxt = torch.gather(kids, 1, torch.argmin(d, dim=-1, keepdim=True))[:, 0]
        cur = torch.where(nxt >= 0, nxt, cur)
    wid = vocab.word_id[cur]
    return torch.where(valid & (wid >= 0), wid, torch.full_like(wid, -1))


def bow_columns(words: torch.Tensor, idf: torch.Tensor) -> torch.Tensor:
    """Per-frame sparse BoW column with DEDUPLICATED word slots.

    words (N,) int64 (-1 invalid), idf (n_words,) -> (N,) float32: the
    first slot of each word carries its full L1-normalized TF-IDF value
    v_word; duplicate slots carry 0. So the column sums to 1 and a
    per-slot reduction visits every word exactly once."""
    n_words = idf.shape[0]
    n = words.shape[0]
    dev = words.device
    ok = words >= 0
    safe = torch.where(ok, words, torch.full_like(words, n_words))  # n_words = drop slot
    counts = scatter(torch.zeros((n_words + 1,), dtype=torch.float32, device=dev), safe, 1.0,
                     "add")
    tfidf_word = counts[:n_words] * idf  # un-normalized v per word
    norm = torch.sum(tfidf_word)
    v = tfidf_word[words.clamp(0, n_words - 1)] / torch.clamp(norm, min=1e-9)
    slot = torch.arange(n, dtype=torch.int64, device=dev)
    first = torch.full((n_words + 1,), n, dtype=torch.int64, device=dev).scatter_reduce(
        0, safe, slot, "amin")
    keep = ok & (first[safe] == slot)
    return torch.where(keep, v, torch.zeros_like(v))


def l1_scores(q_words, q_vals, db_words, db_vals, n_words: int) -> torch.Tensor:
    """DBoW2 L1 score of a query frame against F database frames.

    For L1-normalized non-negative vectors,
        s(v, w) = 1 - 0.5 * ||v - w||_1 = sum_words min(v_word, w_word).
    q_words/q_vals (N,) and db_words/db_vals (F, N) are deduplicated
    sparse columns from bow_columns. Returns (F,) scores in [0, 1]."""
    safe = torch.where(q_words >= 0, q_words, torch.full_like(q_words, n_words))
    # One nonzero value a word (the columns are deduplicated), so the sum
    # is exact in any order.
    dense = scatter(torch.zeros((n_words + 1,), dtype=torch.float32, device=q_vals.device), safe,
                    q_vals, "add")
    on = db_words >= 0
    qv = torch.where(on, dense[db_words.clamp(0, n_words - 1)], torch.zeros_like(db_vals))
    w = torch.where(on, db_vals, torch.zeros_like(db_vals))
    return torch.sum(torch.minimum(qv, w), dim=-1)


def make_random_vocabulary(
    seed: int = 0, k: int = 4, depth: int = 3, n_desc: int = 2000
) -> Vocabulary:
    """Build a small synthetic vocabulary by hierarchical k-medoids over
    random descriptors — for tests and as a named stand-in where no
    trained vocabulary file is present (the reference repo ships none
    either)."""
    rng = np.random.default_rng(seed)
    data = rng.integers(0, 256, (n_desc, 32), np.uint8)

    nodes_children: list[list[int]] = [[]]
    nodes_desc = [np.zeros(32, np.uint8)]
    nodes_parent = [-1]
    word_ids = [-1]

    def popcount_rows(a, b):
        return np.unpackbits(a ^ b[None, :], axis=1).sum(1)

    def build(idx, node, level):
        if level == depth or len(idx) <= 1:
            word_ids[node] = 0  # mark leaf; renumber later
            return
        # k-medoids-ish: pick k seeds, assign, recurse.
        seeds = idx[rng.permutation(len(idx))[: min(k, len(idx))]]
        assign = np.argmin(
            np.stack([popcount_rows(data[idx], data[s]) for s in seeds], 1), axis=1
        )
        for ci, s in enumerate(seeds):
            child_idx = idx[assign == ci]
            if len(child_idx) == 0:
                continue
            cid = len(nodes_desc)
            nodes_desc.append(data[s])
            nodes_parent.append(node)
            nodes_children.append([])
            word_ids.append(-1)
            nodes_children[node].append(cid)
            build(child_idx, cid, level + 1)

    build(np.arange(n_desc), 0, 0)
    n = len(nodes_desc)
    children = np.full((n, k), -1, np.int32)
    for i, ch in enumerate(nodes_children):
        children[i, : len(ch)] = ch
    word_id = np.full((n,), -1, np.int32)
    wc = 0
    for i in range(n):
        if word_ids[i] == 0:
            word_id[i] = wc
            wc += 1
    return Vocabulary(
        children=children,
        desc=_pack_desc_bytes(np.stack(nodes_desc)),
        word_id=word_id,
        word_weight=np.ones((wc,), np.float32),
        k=k,
        depth=depth,
    )


def convert_main(argv=None):
    """CLI mirror of the reference's tool/text2binary.cc: convert a
    DBoW2 vocabulary between text and binary formats (direction from
    file suffixes)."""
    import argparse

    p = argparse.ArgumentParser(description="vocabulary text<->binary converter")
    p.add_argument("src", help=".txt or .bin vocabulary")
    p.add_argument("dst", help=".bin or .txt output")
    args = p.parse_args(argv)
    vocab = load_binary(args.src) if args.src.endswith(".bin") \
        else load_text_vocabulary(args.src)
    if args.dst.endswith(".bin"):
        save_binary(vocab, args.dst)
    else:
        save_text_vocabulary(vocab, args.dst)
    print(f"{args.src} -> {args.dst}: {vocab.n_words} words, "
          f"k={vocab.k} depth={vocab.depth}")


if __name__ == "__main__":
    convert_main()

"""Hierarchical binary-descriptor vocabulary, the DBoW2 replacement
(counterpart of `monocular_slam_tpu/retrieval/vocabulary.py`).

A k^L tree stored level by level: level l holds k^(l+1) node descriptors in
breadth-first order (node j's children are [j*k, (j+1)*k) one level down).
The +-1 node rows are held in float32, so every descriptor-node product is
an exact float32 dot (|dot| <= 256) on the card as on the CPU. A frame's
BoW vector is a dense (V,) L1-normalized tf-idf histogram, V = k^L, so
scoring a frame against a database of frames is one broadcast over (F, V).

Training is the reference's numpy k-means (k-means++ seeding, bitwise
majority means), copied so that the same seed gives the same tree.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np
import torch

from monocular_slam_tpu_torch.utils.device import resolve_device
from monocular_slam_tpu_torch.utils.scatter import segment_sum

DEFAULT_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "default_vocab.npz")


class Vocabulary(NamedTuple):
    nodes: tuple  # per level (k^(l+1), 256) float32 +-1 rows
    weights: torch.Tensor  # (V,) float32 idf word weights
    k: int
    L: int

    @property
    def n_words(self) -> int:
        return self.k**self.L


def vocabulary_from_numpy(nodes, weights, k: int, L: int, device=None) -> Vocabulary:
    """Vocabulary from numpy level arrays (+-1 int8, (k^(l+1), 256)) and
    (V,) weights, e.g. a tree trained by the JAX package."""
    dev = resolve_device(device)
    return Vocabulary(
        nodes=tuple(torch.as_tensor(np.array(n, np.float32), device=dev) for n in nodes),
        weights=torch.as_tensor(np.array(weights, np.float32), device=dev),
        k=int(k), L=int(L),
    )


# --- training (numpy, the reference's algorithm) ----------------------------

def _hamming_np(a_pm1: np.ndarray, b_pm1: np.ndarray) -> np.ndarray:
    return (256 - a_pm1.astype(np.int32) @ b_pm1.astype(np.int32).T) // 2


def _majority_mean(desc_pm1: np.ndarray) -> np.ndarray:
    s = desc_pm1.astype(np.int32).sum(axis=0)
    return np.where(s >= 0, 1, -1).astype(np.int8)


def _kmeans_binary(rng, desc: np.ndarray, k: int, iters: int = 8):
    """k-means on +-1 descriptors with k-means++ seeding and majority means.
    Returns (centers (k, 256) int8, assign (N,))."""
    n = len(desc)
    if n <= k:
        centers = np.ones((k, 256), np.int8)
        centers[:n] = desc
        return centers, np.arange(n) % k
    first = rng.randint(n)
    centers = [desc[first]]
    d2 = _hamming_np(desc, desc[first : first + 1])[:, 0].astype(np.float64)
    for _ in range(k - 1):
        s = d2.sum()
        if s <= 0:
            nxt = rng.randint(n)
        else:
            probs = d2 / s
            probs = probs / probs.sum()
            nxt = rng.choice(n, p=probs)
        centers.append(desc[nxt])
        d2 = np.minimum(d2, _hamming_np(desc, desc[nxt : nxt + 1])[:, 0])
    centers = np.stack(centers)
    assign = None
    for _ in range(iters):
        D = _hamming_np(desc, centers)
        new_assign = D.argmin(axis=1)
        if assign is not None and (new_assign == assign).all():
            break
        assign = new_assign
        for c in range(k):
            m = assign == c
            if m.any():
                centers[c] = _majority_mean(desc[m])
    return centers, assign


def _transform_words_np(levels, k, L, desc_pm1: np.ndarray) -> np.ndarray:
    node = np.zeros(len(desc_pm1), np.int64)
    for lvl in range(L):
        base = node * k
        idx = base[:, None] + np.arange(k)[None, :]
        child = levels[lvl][idx]
        d = (256 - np.einsum("nb,nkb->nk", desc_pm1.astype(np.int32), child.astype(np.int32))) // 2
        node = base + d.argmin(axis=1)
    return node


def train(descriptors_pm1: np.ndarray, k: int = 10, L: int = 3, seed: int = 0,
          weighting: str = "tf_idf", device=None) -> Vocabulary:
    """A k^L vocabulary from (N, 256) +-1 int8 training descriptors, idf
    weights from the training corpus (one document per descriptor)."""
    rng = np.random.RandomState(seed)
    desc = np.asarray(descriptors_pm1, np.int8)
    levels = []
    groups = [desc]
    for _ in range(L):
        centers_lvl, next_groups = [], []
        for g in groups:
            centers, assign = _kmeans_binary(rng, g, k)
            centers_lvl.append(centers)
            for c in range(k):
                next_groups.append(g[assign == c] if len(g) else g)
        levels.append(np.concatenate(centers_lvl, axis=0))
        groups = next_groups
    V = k**L
    word_of = _transform_words_np(levels, k, L, desc)
    counts = np.bincount(word_of, minlength=V).astype(np.float64)
    n = max(len(desc), 1)
    w = np.log(n / np.maximum(counts, 1.0)) if weighting == "tf_idf" else np.ones(V)
    return vocabulary_from_numpy(levels, w, k, L, device)


# --- transform and scoring -----------------------------------------------------

def transform_words(voc: Vocabulary, desc_pm1: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """(N,) int64 leaf word per descriptor: L rounds of argmax of the dot
    with the current node's k children (first child on ties). Invalid
    descriptors get a word too; callers mask them through `valid`."""
    d = desc_pm1.to(torch.float32)
    node = torch.zeros(d.shape[0], dtype=torch.long, device=d.device)
    ar = torch.arange(voc.k, device=d.device)
    for lvl in range(voc.L):
        base = node * voc.k
        child = voc.nodes[lvl][base[:, None] + ar[None, :]]  # (N, k, 256)
        dots = (child * d[:, None, :]).sum(-1)
        node = base + torch.argmax(dots, dim=1)
    return node


def node_words(voc: Vocabulary, desc_pm1, valid, levels_up: int = 2) -> torch.Tensor:
    """Per-descriptor node id `levels_up` levels above the leaves (the DBoW2
    FeatureVector key)."""
    return transform_words(voc, desc_pm1, valid) // (voc.k**levels_up)


def bow_vector(voc: Vocabulary, desc_pm1: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Dense (V,) tf-idf BoW vector, L1-normalized."""
    words = transform_words(voc, desc_pm1, valid)
    tf = segment_sum(valid.to(torch.float32), words, voc.n_words)
    v = tf * voc.weights
    return v / torch.clamp(v.abs().sum(), min=1e-12)


def bow_vectors_batched(voc: Vocabulary, desc_pm1: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """`bow_vector` of B frames at once: desc_pm1 (B, N, 256), valid (B, N)
    -> (B, V), one transform and one segment sum over every frame's words."""
    B, N = valid.shape
    V = voc.n_words
    words = transform_words(voc, desc_pm1.reshape(B * N, -1), valid.reshape(-1))
    rows = torch.arange(B, device=words.device).repeat_interleave(N)
    tf = segment_sum(valid.reshape(-1).to(torch.float32), rows * V + words, B * V).reshape(B, V)
    v = tf * voc.weights
    return v / torch.clamp(v.abs().sum(-1, keepdim=True), min=1e-12)


def score_l1(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """DBoW2 L1 score 1 - 0.5 |a - b|_1 over the last dim (batched)."""
    return 1.0 - 0.5 * (a - b).abs().sum(-1)


def score_l2(a, b):
    an = a / torch.clamp(torch.linalg.norm(a, dim=-1, keepdim=True), min=1e-12)
    bn = b / torch.clamp(torch.linalg.norm(b, dim=-1, keepdim=True), min=1e-12)
    return 1.0 - 0.5 * torch.linalg.norm(an - bn, dim=-1)


def score_dot(a, b):
    return (a * b).sum(-1)


def score_chi2(a, b):
    return ((a * b) / torch.clamp(a + b, min=1e-12)).sum(-1) * 2.0


def score_bhattacharyya(a, b):
    return torch.sqrt(torch.clamp(a * b, min=0.0)).sum(-1)


def score_kl(a, b):
    eps = 1e-12
    return torch.where(a > eps, a * torch.log(torch.clamp(a, min=eps) / torch.clamp(b, min=eps)),
                       0.0).sum(-1)


SCORING = {
    "l1": score_l1, "l2": score_l2, "dot": score_dot, "chi2": score_chi2,
    "bhattacharyya": score_bhattacharyya, "kl": score_kl,
}


def score_against_database(query: torch.Tensor, database: torch.Tensor, kind: str = "l1"):
    """(D,) scores of one (V,) query against a (D, V) database."""
    return SCORING[kind](query[None, :], database)


# --- persistence ----------------------------------------------------------------

def save(path: str, voc: Vocabulary) -> None:
    np.savez_compressed(
        path, k=voc.k, L=voc.L, weights=voc.weights.cpu().numpy(),
        **{f"level_{i}": n.cpu().numpy().astype(np.int8) for i, n in enumerate(voc.nodes)},
    )


def load(path: str, device=None) -> Vocabulary:
    with np.load(path) as data:
        k, L = int(data["k"]), int(data["L"])
        return vocabulary_from_numpy([data[f"level_{i}"] for i in range(L)], data["weights"],
                                     k, L, device)


def load_default(device=None) -> Vocabulary:
    """The bundled 10^4-word (k=10, L=4) vocabulary, a byte-identical copy
    of the JAX package's `default_vocab.npz`, on `device` (default: the
    card)."""
    return load(DEFAULT_PATH, device)

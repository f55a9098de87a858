"""Bag-of-binary-words vocabulary, the DBoW2 replacement.

Port of trackingbench_slam_tpu/bow/vocabulary.py. The tree is a complete
k-ary array: level l holds k^l nodes in one (k^l, 8) table of descriptor
words, child c of node i at level l is node i*k + c at level l+1, and empty
clusters inherit their parent's centre. `transform` descends all
descriptors at once (gather, XOR, popcount, argmin with the first minimum
winning); a BowVector is a dense L1-normalized tf-idf vector, or, for large
vocabularies, a sorted sparse (words, weights) pair scored by a sorted
merge. Image similarity is the DBoW2 L1 score.

Training is host numpy, a copy of the reference's binary hierarchical
k-medians with a bitwise-majority mean. Everything used online lives on the
vocabulary's device. Descriptors are (N, 8) int32 words carrying the uint32
bits of the reference; training also takes uint32.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from trackingbench_slam_tpu_torch.ops.fast import stable_topk
from trackingbench_slam_tpu_torch.ops.hamming import popcount32
from trackingbench_slam_tpu_torch.utils.device import resolve_device


def _popcount_np(x: np.ndarray) -> np.ndarray:
    return np.unpackbits(x.view(np.uint8), axis=-1).sum(axis=-1)


def _hamming_np(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(N, 8) x (M, 8) uint32 -> (N, M) int."""
    x = a[:, None, :] ^ b[None, :, :]
    return _popcount_np(x.reshape(x.shape[0], x.shape[1], -1))


def _majority_mean(descs: np.ndarray) -> np.ndarray:
    """Bitwise-majority 'mean' descriptor (FORB::meanValue)."""
    bits = np.unpackbits(descs.view(np.uint8), axis=-1)  # (N, 256)
    maj = (bits.sum(axis=0) * 2 >= bits.shape[0]).astype(np.uint8)
    return np.packbits(maj).view(np.uint32)


def _kmedians(descs: np.ndarray, k: int, iters: int,
              rng: np.random.RandomState) -> tuple[np.ndarray, np.ndarray]:
    """Binary k-medians. Returns (centers (k, 8), assignment (N,))."""
    n = descs.shape[0]
    if n == 0:
        return np.zeros((k, 8), np.uint32), np.zeros((0,), np.int64)
    picks = rng.choice(n, size=min(k, n), replace=False)
    centers = descs[picks].copy()
    if len(picks) < k:
        centers = np.concatenate(
            [centers, np.tile(descs[picks[0]], (k - len(picks), 1))])
    assign = np.zeros(n, np.int64)
    for _ in range(iters):
        d = _hamming_np(descs, centers)
        assign = d.argmin(axis=1)
        for c in range(k):
            sel = descs[assign == c]
            if sel.shape[0] > 0:
                centers[c] = _majority_mean(sel)
    return centers, assign


def as_uint32(descs) -> np.ndarray:
    """Host copy of descriptors as (N, 8) uint32, from numpy (uint32 or
    int32 bits) or a tensor of int32 bits."""
    if isinstance(descs, torch.Tensor):
        descs = descs.detach().cpu().numpy()
    return np.ascontiguousarray(descs).view(np.uint32)


def _as_int32_tensor(table: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(table).view(np.int32)
                            .copy()).to(device)


@dataclasses.dataclass(frozen=True)
class Vocabulary:
    """Device-resident vocabulary."""

    levels: tuple              # (k^l, 8) int32 tensors, l = 1..L
    word_weights: torch.Tensor  # (k^L,) idf weights
    branching: int
    depth: int
    levels_up: int

    @property
    def num_words(self) -> int:
        return self.branching ** self.depth

    @property
    def device(self) -> torch.device:
        return self.word_weights.device

    def node_level(self) -> int:
        return max(self.depth - self.levels_up, 1)


def train(descs, branching: int = 8, depth: int = 4, levels_up: int = 2,
          kmedians_iters: int = 8, seed: int = 0, weight_corpus=None,
          device=None) -> Vocabulary:
    """Hierarchical k-medians from a training descriptor set ((N, 8), see
    `as_uint32`), then idf weights from `weight_corpus` (default: descs).
    The vocabulary lives on `device` (CUDA unless given)."""
    dev = resolve_device(device)
    descs = as_uint32(descs)
    rng = np.random.RandomState(seed)
    k, L = branching, depth
    level_tables = []
    groups = [np.arange(descs.shape[0])]
    parent_desc = [_majority_mean(descs) if descs.shape[0] else
                   np.zeros(8, np.uint32)]
    for lvl in range(1, L + 1):
        table = np.zeros((k ** lvl, 8), np.uint32)
        new_groups, new_parent = [], []
        for i, idx in enumerate(groups):
            sub = descs[idx]
            centers, assign = _kmedians(sub, k, kmedians_iters, rng)
            for c in range(k):
                sel = idx[assign == c] if sub.shape[0] else idx[:0]
                if sub.shape[0] == 0:
                    centers[c] = parent_desc[i]
                table[i * k + c] = centers[c]
                new_groups.append(sel)
                new_parent.append(centers[c])
        level_tables.append(_as_int32_tensor(table, dev))
        groups, parent_desc = new_groups, new_parent

    voc = Vocabulary(levels=tuple(level_tables),
                     word_weights=torch.ones((k ** L,), dtype=torch.float32,
                                             device=dev),
                     branching=k, depth=L, levels_up=levels_up)
    corpus = descs if weight_corpus is None else as_uint32(weight_corpus)
    if corpus.shape[0]:
        words, _ = transform(voc, _as_int32_tensor(corpus, dev),
                             torch.ones((corpus.shape[0],), dtype=torch.bool,
                                        device=dev))
        counts = np.bincount(words.cpu().numpy(), minlength=k ** L)
        n_img = max(1, corpus.shape[0] // 256)
        idf = np.log(n_img / np.maximum(counts / 256.0, 1e-3) + 1.0)
        voc = dataclasses.replace(voc, word_weights=torch.as_tensor(
            idf, dtype=torch.float32, device=dev))
    return voc


def transform(voc: Vocabulary, descs: torch.Tensor, valid: torch.Tensor):
    """Descend all descriptors: (word_id (N,), node_id (N,)) int32, -1 for
    invalid entries; node_id is `levels_up` above the leaves."""
    k = voc.branching
    n = descs.shape[0]
    idx = torch.zeros((n,), dtype=torch.int64, device=descs.device)
    node_at = idx
    node_level = voc.node_level()
    kids = torch.arange(k, device=descs.device)
    for lvl, table in enumerate(voc.levels, start=1):
        child_base = idx * k
        cand = table[child_base[:, None] + kids[None, :]]      # (N, k, 8)
        d = popcount32(cand ^ descs[:, None, :]).sum(-1)        # (N, k)
        idx = child_base + torch.argmin(d, dim=-1)
        if lvl == node_level:
            node_at = idx
    neg = torch.full_like(idx, -1)
    return (torch.where(valid, idx, neg).to(torch.int32),
            torch.where(valid, node_at, neg).to(torch.int32))


def bow_vector(voc: Vocabulary, word_ids: torch.Tensor,
               valid: torch.Tensor) -> torch.Tensor:
    """Dense L1-normalized tf-idf BowVector."""
    W = voc.num_words
    tf = torch.zeros((W,), dtype=torch.float32,
                     device=word_ids.device).index_add(
        0, word_ids.clamp(0, W - 1).long(), valid.float())
    v = tf * voc.word_weights
    n = torch.abs(v).sum()
    return v / torch.where(n < 1e-9, torch.ones_like(n), n)


# --- scoring on dense L1-normalized vectors (DBoW2 ScoringObject family)

def score_l1(v1, v2):
    """DBoW2 L1 score in [0, 1]: 1 - 0.5 |v1 - v2|_1."""
    return 1.0 - 0.5 * torch.abs(v1 - v2).sum(-1)


def score_l2(v1, v2):
    return 1.0 - 0.5 * torch.sqrt(torch.clamp(((v1 - v2) ** 2).sum(-1),
                                              min=0.0))


def score_dot(v1, v2):
    return (v1 * v2).sum(-1)


def score_bhattacharyya(v1, v2):
    return torch.sqrt(torch.clamp(v1 * v2, min=0.0)).sum(-1)


def score_chi_square(v1, v2):
    num = (v1 - v2) ** 2
    den = v1 + v2
    return 1.0 - 0.5 * torch.where(den > 1e-9, num / den,
                                   torch.zeros_like(num)).sum(-1)


def score_kl(v1, v2):
    """KL divergence (lower = more similar)."""
    eps = 1e-9
    return torch.where(v1 > eps,
                       v1 * torch.log(torch.clamp(v1, min=eps)
                                      / torch.clamp(v2, min=eps)),
                       torch.zeros_like(v1)).sum(-1)


# --- persistence

def save_vocabulary(voc: Vocabulary, path: str) -> None:
    """npz with the tree and the content hash of the BRIEF pattern the
    descriptors were made with."""
    from trackingbench_slam_tpu_torch.ops.orb import pattern_id
    np.savez_compressed(
        path, branching=voc.branching, depth=voc.depth,
        levels_up=voc.levels_up,
        word_weights=voc.word_weights.cpu().numpy(),
        descriptor_pattern_id=np.asarray(pattern_id()),
        **{f"level_{i}": as_uint32(t) for i, t in enumerate(voc.levels)})


def load_vocabulary(path: str, device=None) -> Vocabulary:
    """Load `save_vocabulary`'s npz (the JAX package's format too); refuses
    a vocabulary trained under another BRIEF pattern."""
    from trackingbench_slam_tpu_torch.ops.orb import pattern_id
    dev = resolve_device(device)
    z = np.load(path)
    if "descriptor_pattern_id" in z:
        saved = str(z["descriptor_pattern_id"])
        if saved != pattern_id():
            raise ValueError(
                f"vocabulary {path} was trained with BRIEF pattern {saved}, "
                f"active pattern is {pattern_id()}")
    depth = int(z["depth"])
    return Vocabulary(
        levels=tuple(_as_int32_tensor(z[f"level_{i}"], dev)
                     for i in range(depth)),
        word_weights=torch.as_tensor(z["word_weights"], dtype=torch.float32,
                                     device=dev),
        branching=int(z["branching"]), depth=depth,
        levels_up=int(z["levels_up"]))


def save_vocabulary_text(voc: Vocabulary, path: str,
                         scoring: int = 0, weighting: int = 0) -> None:
    """The DBoW2 ORBvoc.txt text format: header `k L scoring weighting`,
    then one line per non-root node in BFS order, `parent_id is_leaf b0..b31
    weight`; leaves carry the idf weights."""
    k, L = voc.branching, voc.depth
    weights = voc.word_weights.cpu().numpy()
    with open(path, "w") as f:
        f.write(f"{k} {L} {scoring} {weighting}\n")
        level_base = [0]
        acc = 1
        for lvl in range(1, L + 1):
            level_base.append(acc)
            acc += k ** lvl
        for lvl in range(1, L + 1):
            table = as_uint32(voc.levels[lvl - 1]).view(np.uint8)
            table = table.reshape(k ** lvl, 32)
            for j in range(k ** lvl):
                parent = 0 if lvl == 1 else level_base[lvl - 1] + j // k
                is_leaf = 1 if lvl == L else 0
                w = float(weights[j]) if lvl == L else 0.0
                bs = " ".join(str(int(b)) for b in table[j])
                f.write(f"{parent} {is_leaf} {bs} {w}\n")


def load_vocabulary_text(path: str, levels_up: int = 2,
                         device=None) -> Vocabulary:
    """Load a DBoW2 text vocabulary from a local file into the dense-levels
    layout. Incomplete trees are densified: missing child slots repeat the
    first real sibling (placed first, so argmin ties resolve to the real
    node) and early leaves are propagated down as their own sole child."""
    dev = resolve_device(device)
    with open(path) as f:
        k, L, _scoring, _weighting = (int(float(x))
                                      for x in f.readline().split()[:4])
        parents, leaf_flags, descs, weights = [], [], [], []
        for line in f:
            parts = line.split()
            if len(parts) < 35:
                continue
            parents.append(int(parts[0]))
            leaf_flags.append(int(float(parts[1])))
            descs.append([int(x) for x in parts[2:34]])
            weights.append(float(parts[34]))
    n = len(parents)
    children = [[] for _ in range(n + 1)]
    for i in range(n):
        children[parents[i]].append(i + 1)  # ids are 1-based, root = 0
    desc_of = np.zeros((n + 1, 32), np.uint8)
    desc_of[1:] = np.asarray(descs, np.uint8)
    weight_of = np.zeros((n + 1,), np.float32)
    weight_of[1:] = np.asarray(weights, np.float32)

    level_tables = [np.zeros((k ** lvl, 32), np.uint8)
                    for lvl in range(1, L + 1)]
    word_weights = np.zeros((k ** L,), np.float32)
    frontier = {0: 0}
    for lvl in range(1, L + 1):
        table = level_tables[lvl - 1]
        nxt = {}
        for slot, nid in frontier.items():
            kids = children[nid]
            if not kids or (lvl > 1 and leaf_flags[nid - 1] == 1):
                kids = [nid]
            fill = (kids + [kids[0]] * k)[:k]
            for c, kid in enumerate(fill):
                dslot = slot * k + c
                table[dslot] = desc_of[kid]
                if c < len(kids):
                    nxt[dslot] = kid
                    if lvl == L:
                        word_weights[dslot] = weight_of[kid]
        frontier = nxt
    return Vocabulary(
        levels=tuple(_as_int32_tensor(t.view(np.uint32).reshape(-1, 8), dev)
                     for t in level_tables),
        word_weights=torch.as_tensor(word_weights, device=dev),
        branching=k, depth=L, levels_up=levels_up)


# --- sparse BowVectors for large vocabularies: a sorted (S,) word-id array
# (num_words as the sentinel) and its L1-normalized tf-idf weights. The L1
# score of two L1-normalized vectors is the sum over shared words of
# min(w1, w2), taken by a searchsorted merge.

class SparseBow(NamedTuple):
    words: torch.Tensor    # (S,) int32 sorted ascending, sentinel num_words
    weights: torch.Tensor  # (S,) float32, 0 on sentinel rows


def sparse_bow_vector(voc: Vocabulary, word_ids: torch.Tensor,
                      valid: torch.Tensor) -> SparseBow:
    """Sparse BowVector of width N = the feature capacity (exact)."""
    W = voc.num_words
    N = word_ids.shape[0]
    dev = word_ids.device
    w = torch.where(valid & (word_ids >= 0), word_ids,
                    torch.full_like(word_ids, W))
    sw = torch.sort(w).values
    first = torch.cat([torch.ones((1,), dtype=torch.bool, device=dev),
                       sw[1:] != sw[:-1]])
    seg = torch.cumsum(first.to(torch.int64), 0) - 1
    # each distinct word lands at its segment; repeats go to a dropped slot
    words = torch.full((N + 1,), W, dtype=torch.int32, device=dev).scatter(
        0, torch.where(first, seg, torch.full_like(seg, N)), sw)[:N]
    tf = torch.zeros((N,), dtype=torch.float32, device=dev).index_add(
        0, seg, (sw < W).float())
    wt = tf * voc.word_weights[words.clamp(0, W - 1).long()]
    wt = torch.where(words < W, wt, torch.zeros_like(wt))
    n = torch.abs(wt).sum()
    return SparseBow(words=words,
                     weights=wt / torch.where(n < 1e-9, torch.ones_like(n),
                                              n))


def score_l1_sparse(a: SparseBow, b_words: torch.Tensor,
                    b_weights: torch.Tensor) -> torch.Tensor:
    """L1 score against one (S,) entry (a scalar) or a (D, S) batch
    ((D,) scores)."""
    single = b_words.dim() == 1
    bw = (b_words[None] if single else b_words).contiguous()
    bwt = b_weights[None] if single else b_weights
    q = a.words.expand(bw.shape[0], -1).contiguous()
    pos = torch.searchsorted(bw, q).clamp(0, bw.shape[1] - 1)
    hit = torch.gather(bw, 1, pos) == q
    s = torch.where(hit, torch.minimum(a.weights, torch.gather(bwt, 1, pos)),
                    torch.zeros_like(bwt)).sum(-1)
    return s[0] if single else s


def recent_mask(capacity: int, used: int, exclude_recent: int, device):
    """(capacity,) bool: the live entries, less the `exclude_recent` most
    recently added (the ring wraps at capacity)."""
    idxs = torch.arange(capacity, device=device)
    mask = idxs < min(used, capacity)
    if exclude_recent > 0 and used > 0:
        recent = torch.tensor([(used - 1 - j) % capacity
                               for j in range(min(exclude_recent, used))],
                              device=device)
        mask = mask & ~(idxs[None, :] == recent[:, None]).any(0)
    return mask


class SparseBowDatabase:
    """Place-recognition database over sparse BowVectors: memory
    O(capacity * S), independent of the vocabulary size."""

    def __init__(self, voc: Vocabulary, width: int, capacity: int = 1024):
        self.voc = voc
        self.capacity = capacity
        self.width = width
        self.words = torch.full((capacity, width), voc.num_words,
                                dtype=torch.int32, device=voc.device)
        self.weights = torch.zeros((capacity, width), dtype=torch.float32,
                                   device=voc.device)
        self.used = 0

    def add(self, v: SparseBow) -> int:
        i = self.used % self.capacity
        self.words = self.words.index_copy(
            0, torch.tensor([i], device=self.words.device), v.words[None])
        self.weights = self.weights.index_copy(
            0, torch.tensor([i], device=self.words.device), v.weights[None])
        self.used += 1
        return i

    def query(self, v: SparseBow, top_k: int = 5, exclude_recent: int = 0):
        scores = score_l1_sparse(v, self.words, self.weights)
        mask = recent_mask(self.capacity, self.used, exclude_recent,
                           scores.device)
        vals, idx = stable_topk(torch.where(mask, scores,
                                            torch.full_like(scores, -1.0)),
                                top_k)
        return idx, vals


class BowDatabase:
    """Place-recognition database over dense BowVectors (DBoW2
    TemplatedDatabase behaviour): (capacity, num_words) float32."""

    def __init__(self, voc: Vocabulary, capacity: int = 1024):
        self.voc = voc
        self.capacity = capacity
        self.vectors = torch.zeros((capacity, voc.num_words),
                                   dtype=torch.float32, device=voc.device)
        self.used = 0

    def add(self, v: torch.Tensor) -> int:
        i = self.used % self.capacity
        self.vectors = self.vectors.index_copy(
            0, torch.tensor([i], device=self.vectors.device), v[None])
        self.used += 1
        return i

    def query(self, v: torch.Tensor, top_k: int = 5,
              exclude_recent: int = 0):
        """(indices (top_k,), scores (top_k,)); exclude_recent masks the
        most recently added entries; ties go to the lower index."""
        scores = score_l1(self.vectors, v[None, :])
        mask = recent_mask(self.capacity, self.used, exclude_recent,
                           scores.device)
        vals, idx = stable_topk(torch.where(mask, scores,
                                            torch.full_like(scores, -1.0)),
                                top_k)
        return idx, vals

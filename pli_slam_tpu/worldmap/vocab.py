"""Place recognition: LSH bag-of-words scoring, fully on-device.

JAX replacement for the DBoW2 vocabulary + KeyFrameDatabase
stack (reference: Thirdparty/DBoW2/DBoW2/TemplatedVocabulary.h —
k-means tree `transform`; src/KeyFrameDatabase.cc —
`DetectNBestCandidates` :806, `DetectRelocalizationCandidates*`,
dual point/line inverted files `KeyFrameDatabase.h:109-113`).

Design inversion: DBoW2 walks a learned 6-level k-means tree per
descriptor and scores through inverted files — pointer-chasing that is
hostile to XLA. Here a descriptor's "word" is its sign pattern under
`n_bits` fixed random hyperplanes (LSH): one [N, 256] x [256, n_bits]
int8 matmul + bit packing. A keyframe's BoW vector is the normalized
word histogram; database queries are ONE [K, W] x [W] matvec over the
histogram matrix — the dense equivalent of inverted-file scoring, and
faster than maintaining the files at these scales (K <= 512, W = 4096).

Both modalities get vocabularies (points + lines) like the reference's
dual ORBvoc/LSDvoc, and scores can be combined (the reference's dormant
joint gating, KeyFrameDatabase.cc:1091 — active here).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

_HI = jax.lax.Precision.HIGHEST


def _hyperplanes(seed: int, n_bits: int, dim: int = 256) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.normal(size=(dim, n_bits)).astype(np.float32)


@dataclasses.dataclass(frozen=True)
class Vocabulary:
    """Fixed LSH vocabulary: n_bits hyperplanes -> 2**n_bits words."""

    n_bits: int = 12  # 4096 words
    seed: int = 17

    @property
    def n_words(self) -> int:
        return 1 << self.n_bits

    def planes(self) -> jax.Array:
        return jnp.asarray(_hyperplanes(self.seed, self.n_bits))

    def words(self, desc: jax.Array, valid: jax.Array) -> jax.Array:
        """±1 int8 descriptors [N, 256] -> word ids [N] int32 (-1 invalid)."""
        proj = jnp.einsum(
            "nd,dw->nw", desc.astype(jnp.float32), self.planes(), precision=_HI
        )
        bits = (proj >= 0).astype(jnp.int32)
        weights = (1 << jnp.arange(self.n_bits, dtype=jnp.int32))[None, :]
        ids = jnp.sum(bits * weights, axis=-1)
        return jnp.where(valid, ids, -1)

    def bow(self, desc: jax.Array, valid: jax.Array) -> jax.Array:
        """Normalized word histogram [n_words] float32 (the BowVector)."""
        ids = self.words(desc, valid)
        hist = jnp.zeros(self.n_words).at[jnp.maximum(ids, 0)].add(
            valid.astype(jnp.float32)
        )
        return hist / jnp.maximum(jnp.linalg.norm(hist), 1e-9)


@dataclasses.dataclass(frozen=True)
class TrainedVocabulary:
    """Learned flat vocabulary: word centroids from binary k-means
    (k-majority) over training descriptors + IDF weights.

    The reference ships learned ORBvoc/LSDvoc k-means TREES
    (Thirdparty/DBoW2/DBoW2/TemplatedVocabulary.h, loaded at
    src/System.cc:84-86); the tree exists to cheapen nearest-centroid
    lookup on CPU. On a matrix unit a FLAT argmax-dot over all W centroids is
    one [N,256]x[256,W] int8 matmul (~1.3 GOP at production budgets) —
    no tree needed, identical quantization semantics, plus the same
    TF-IDF weighting DBoW2 applies.

    Same interface as `Vocabulary` (words/bow/n_words) so it drops into
    the Tracker and BowDatabase unchanged.
    """

    centroids: np.ndarray  # [W, 256] int8 ±1
    idf: np.ndarray  # [W] float32

    @property
    def n_words(self) -> int:
        return self.centroids.shape[0]

    def words(self, desc: jax.Array, valid: jax.Array) -> jax.Array:
        dots = jnp.einsum(
            "nd,wd->nw", desc.astype(jnp.int32), jnp.asarray(self.centroids, jnp.int32)
        )
        ids = jnp.argmax(dots, axis=-1).astype(jnp.int32)
        return jnp.where(valid, ids, -1)

    def bow(self, desc: jax.Array, valid: jax.Array) -> jax.Array:
        ids = self.words(desc, valid)
        hist = jnp.zeros(self.n_words).at[jnp.maximum(ids, 0)].add(
            valid.astype(jnp.float32)
        )
        hist = hist * jnp.asarray(self.idf)
        return hist / jnp.maximum(jnp.linalg.norm(hist), 1e-9)

    def save(self, path: str):
        np.savez_compressed(path, centroids=self.centroids, idf=self.idf)

    @staticmethod
    def load(path: str) -> "TrainedVocabulary":
        d = np.load(path)
        return TrainedVocabulary(centroids=d["centroids"], idf=d["idf"])


def train_vocabulary(
    desc_sets: list[np.ndarray], n_words: int = 1024, iters: int = 10, seed: int = 0
) -> TrainedVocabulary:
    """Binary k-means (k-majority) vocabulary training.

    `desc_sets`: per-image ±1 int8 descriptor arrays (only valid rows).
    Centroid update = sign of member sum (the binary mean, what DBoW2's
    `meanValue` computes for FORB); assignment = max dot (min Hamming).
    IDF from per-image word occurrence, as in DBoW2's TF_IDF weighting.
    """
    rng = np.random.default_rng(seed)
    all_desc = np.concatenate([d for d in desc_sets if len(d)], axis=0)
    n = all_desc.shape[0]
    cent = all_desc[rng.choice(n, size=min(n_words, n), replace=False)].astype(np.int8)
    if cent.shape[0] < n_words:  # degenerate tiny training set: pad by resample
        extra = all_desc[rng.choice(n, size=n_words - cent.shape[0])]
        cent = np.concatenate([cent, extra.astype(np.int8)], axis=0)
    d32 = all_desc.astype(np.int32)
    for _ in range(iters):
        dots = d32 @ cent.astype(np.int32).T  # [N, W]
        assign = np.argmax(dots, axis=1)
        sums = np.zeros((n_words, 256), np.int64)
        np.add.at(sums, assign, d32)
        counts = np.bincount(assign, minlength=n_words)
        new = np.where(sums >= 0, 1, -1).astype(np.int8)
        # empty clusters: re-seed from random descriptors
        empty = counts == 0
        if empty.any():
            new[empty] = all_desc[rng.choice(n, size=int(empty.sum()))]
        cent = new
    # IDF over the training images
    n_imgs = len(desc_sets)
    df = np.zeros(n_words, np.float64)
    for d in desc_sets:
        if not len(d):
            continue
        a = np.argmax(d.astype(np.int32) @ cent.astype(np.int32).T, axis=1)
        df[np.unique(a)] += 1
    idf = np.log(max(n_imgs, 1) / (1.0 + df)).clip(min=0.0).astype(np.float32)
    # uniform fallback if everything is common (tiny training sets)
    if not np.any(idf > 0):
        idf[:] = 1.0
    return TrainedVocabulary(centroids=cent, idf=idf)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class BowDatabase:
    """Dense BoW matrix per keyframe — the inverted-file equivalent."""

    hist_pt: jax.Array  # [K, W] point-word histograms (L2-normalized)
    hist_ln: jax.Array  # [K, W] line-word histograms
    valid: jax.Array  # [K] bool

    @staticmethod
    def empty(capacity: int, n_words: int) -> "BowDatabase":
        return BowDatabase(
            hist_pt=jnp.zeros((capacity, n_words)),
            hist_ln=jnp.zeros((capacity, n_words)),
            valid=jnp.zeros(capacity, bool),
        )

    def add(self, slot, bow_pt: jax.Array, bow_ln: jax.Array) -> "BowDatabase":
        return BowDatabase(
            hist_pt=self.hist_pt.at[slot].set(bow_pt),
            hist_ln=self.hist_ln.at[slot].set(bow_ln),
            valid=self.valid.at[slot].set(True),
        )


def query(
    db: BowDatabase,
    bow_pt: jax.Array,
    bow_ln: jax.Array,
    exclude_mask: jax.Array,
    n_best: int = 3,
    line_weight: float = 0.3,
    covis: jax.Array | None = None,
    group_size: int = 10,
):
    """Top-n_best candidate keyframes by combined point+line similarity.

    (reference: DetectNBestCandidates semantics with the joint
    point+line gating of DetectLoopCandidatesWithLine applied live.)

    With `covis` (a [K, K] covisibility-weight matrix), scores are
    accumulated over each candidate's top-`group_size` covisible
    neighbors before ranking, and the best individual keyframe of each
    winning group is returned — the reference's group accumulation in
    DetectNBestCandidates (src/KeyFrameDatabase.cc:806), the standard
    defense against perceptual aliasing: a single look-alike keyframe
    elsewhere cannot outrank a run of genuinely revisited ones, because
    the true site's neighbors all score while the alias stands alone.

    Returns (slots [n_best] int32, scores [n_best]).
    """
    score = (
        jnp.einsum("kw,w->k", db.hist_pt, bow_pt, precision=_HI)
        + line_weight * jnp.einsum("kw,w->k", db.hist_ln, bow_ln, precision=_HI)
    )
    score = jnp.where(db.valid & ~exclude_mask, score, -1.0)
    if covis is None:
        top_scores, top_idx = jax.lax.top_k(score, n_best)
        return top_idx.astype(jnp.int32), top_scores

    K = score.shape[0]
    s = jnp.maximum(score, 0.0)  # excluded/invalid contribute nothing
    w = jnp.where(covis > 0, covis.astype(jnp.float32), -1.0)
    w = jnp.where(jnp.eye(K, dtype=bool), -1.0, w)  # self handled separately
    g = min(group_size, K - 1)
    thr = jax.lax.top_k(w, max(g, 1))[0][:, -1:]  # [K,1] g-th largest weight
    nb = (w >= jnp.maximum(thr, 1e-9)) & (w > 0)
    acc = s + jnp.einsum("kj,j->k", nb.astype(s.dtype), s, precision=_HI)
    acc = jnp.where(score > -0.5, acc, -1.0)  # anchor must be a candidate
    top_acc, anchors = jax.lax.top_k(acc, n_best)
    # best individual member of each winning group (reference pBestScKF)
    member = nb[anchors] | jax.nn.one_hot(anchors, K, dtype=bool)
    member_s = jnp.where(member & (score > -0.5)[None], s[None], -1.0)
    best = jnp.argmax(member_s, axis=1).astype(jnp.int32)
    best_s = jnp.take_along_axis(member_s, best[:, None], axis=1)[:, 0]
    slots = jnp.where(top_acc > 0, best, -1)
    # dedup: overlapping groups can elect the same keyframe
    eq_prev = (slots[:, None] == slots[None, :]) & (
        jnp.arange(n_best)[None, :] < jnp.arange(n_best)[:, None]
    )
    dup = jnp.any(eq_prev & (slots[:, None] >= 0), axis=1)
    slots = jnp.where(dup, -1, slots)
    scores = jnp.where(slots >= 0, best_s, -1.0)
    return slots, scores

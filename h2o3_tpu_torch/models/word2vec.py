"""Word2Vec — the port of ``h2o3_tpu/models/word2vec.py``.

Skip-gram word embeddings (``hex/word2vec/Word2Vec.java``) trained, as in
the JAX package, by synchronous minibatch SGD with negative sampling in
place of the reference's Hogwild hierarchical softmax.

The host does what the JAX package's host does, on its ``default_rng``
draw for draw: the vocabulary (``min_word_freq``), the NA-separated
sentences, the subsampling keep-probabilities (``sent_sample_rate``), the
unigram^0.75 negative table, the initial vectors, each epoch's pairs
(``_make_pairs``: subsampling and dynamic windows, interleaved draws), the
shuffle and the epoch's negatives, so the pairs and negatives are the JAX
package's. ``find_synonyms`` and ``transform`` run on the host too.

The device runs each step (``_sgd_step``) in float32 and updates the
[V, D] input and output vectors in place. The JAX package averages each
word's gradients over its occurrences in the batch with two scatter-adds;
here the scatter is a stable sort of the word ids, then a sum of each
word's rows in batch order (``torch.segment_reduce``; the counts are an
integer ``index_add_``, exact in any order). It adds in the JAX package's
order (a word's context rows before its negative rows, each in batch
order) and, unlike a float ``index_add_``, which adds with atomics on the
card, it gives the same bits on every run: a seeded fit is reproducible
on the card.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from h2o3_tpu_torch.frame.frame import ColType, Column, Frame
from h2o3_tpu_torch.models.data_info import DataInfo
from h2o3_tpu_torch.models.framework import Model, ModelBuilder, ModelParameters


@dataclass
class Word2VecParameters(ModelParameters):
    vec_size: int = 100
    window_size: int = 5
    epochs: int = 5
    min_word_freq: int = 5
    init_learning_rate: float = 0.025
    sent_sample_rate: float = 1e-3
    negative_samples: int = 5
    batch_size: int = 8192
    word_model: str = "skip_gram"  # skip_gram (CBOW not in reference either)


def _averaged_update(E: torch.Tensor, idx: torch.Tensor, grads: torch.Tensor,
                     lr: torch.Tensor) -> None:
    """``E -= lr * g / max(n, 1)`` in place, where g[i] sums the rows of
    ``grads`` whose ``idx`` is i and n[i] counts them: a stable sort of
    ``idx``, then each word's rows summed in their order. Every shape is
    known before the step runs, so the step needs no host sync."""
    order = torch.argsort(idx, stable=True)
    n = torch.zeros(E.shape[0], dtype=torch.int64, device=E.device)
    n.index_add_(0, idx, torch.ones_like(idx))
    g = torch.segment_reduce(grads[order], "sum", lengths=n, axis=0, unsafe=True)
    E -= lr * g / torch.clamp(n, min=1).to(E.dtype)[:, None]


def _sgd_step(W: torch.Tensor, C: torch.Tensor, center: torch.Tensor,
              context: torch.Tensor, negs: torch.Tensor, lr: torch.Tensor) -> torch.Tensor:
    """One negative-sampling step; updates W and C ([V, D] input and output
    vectors) in place and returns the batch loss. center/context: [B];
    negs: [B, K]."""
    w = W[center]  # [B, D]
    cpos = C[context]  # [B, D]
    cneg = C[negs]  # [B, K, D]

    pos_score = torch.einsum("bd,bd->b", w, cpos)
    neg_score = torch.einsum("bd,bkd->bk", w, cneg)
    gpos = torch.sigmoid(pos_score) - 1.0  # dL/dscore
    gneg = torch.sigmoid(neg_score)  # [B, K]

    grad_w = gpos[:, None] * cpos + torch.einsum("bk,bkd->bd", gneg, cneg)
    grad_cpos = gpos[:, None] * w
    grad_cneg = gneg[:, :, None] * w[:, None, :]

    # per-word gradient averaging: a batch holds many pairs per word, and
    # summing their updates (sequential SGD x batch duplicates) diverges
    D = W.shape[1]
    _averaged_update(W, center, grad_w, lr)
    _averaged_update(C, torch.cat([context, negs.reshape(-1)]),
                     torch.cat([grad_cpos, grad_cneg.reshape(-1, D)]), lr)
    return -torch.mean(F.logsigmoid(pos_score) + F.logsigmoid(-neg_score).sum(dim=1))


class Word2VecModel(Model):
    algo_name = "word2vec"

    def __init__(self, params, data_info=None, device: torch.device = None) -> None:
        super().__init__(params, data_info or DataInfo([], None, False, False, "skip"),
                         device)
        self.vocab: Dict[str, int] = {}
        self.words: List[str] = []
        self.vectors: Optional[np.ndarray] = None  # [V, D]
        self.epochs_run: int = 0
        self.losses: List[float] = []

    @property
    def is_classifier(self) -> bool:
        return False

    def word_vector(self, word: str) -> Optional[np.ndarray]:
        i = self.vocab.get(word)
        return None if i is None else self.vectors[i]

    def find_synonyms(self, word: str, count: int = 10) -> Dict[str, float]:
        """Cosine-nearest words (reference Word2VecModel.findSynonyms)."""
        v = self.word_vector(word)
        if v is None:
            return {}
        V = self.vectors
        sims = (V @ v) / (np.linalg.norm(V, axis=1) * np.linalg.norm(v) + 1e-12)
        order = np.argsort(-sims)
        out: Dict[str, float] = {}
        for i in order:
            if self.words[i] == word:
                continue
            out[self.words[i]] = float(sims[i])
            if len(out) >= count:
                break
        return out

    def transform(self, frame: Frame, aggregate_method: str = "none") -> Frame:
        """Words -> vectors; ``aggregate_method='average'`` pools each
        NA-separated sentence (reference Word2VecModel.transform)."""
        col = frame.col(0)
        words = _string_values(col)
        D = self.vectors.shape[1]
        vecs = np.zeros((len(words), D))
        known = np.zeros(len(words), dtype=bool)
        for i, w in enumerate(words):
            j = self.vocab.get(w) if w is not None else None
            if j is not None:
                vecs[i] = self.vectors[j]
                known[i] = True
        if aggregate_method == "none":
            cols = [
                Column(f"V{d + 1}", np.where(known, vecs[:, d], np.nan), ColType.NUM)
                for d in range(D)
            ]
            return Frame(cols)
        # average per sentence (NA row = separator)
        sent_vecs: List[np.ndarray] = []
        acc, cnt = np.zeros(D), 0
        for i, w in enumerate(words):
            if w is None:
                sent_vecs.append(acc / cnt if cnt else np.full(D, np.nan))
                acc, cnt = np.zeros(D), 0
            elif known[i]:
                acc, cnt = acc + vecs[i], cnt + 1
        if cnt or not sent_vecs:
            sent_vecs.append(acc / cnt if cnt else np.full(D, np.nan))
        S = np.stack(sent_vecs)
        return Frame([Column(f"V{d + 1}", S[:, d], ColType.NUM) for d in range(D)])

    def _predict_raw(self, frame: Frame) -> np.ndarray:
        raise NotImplementedError("Word2Vec transforms frames; use .transform()")


class Word2Vec(ModelBuilder):
    algo_name = "word2vec"

    def __init__(self, params: Optional[Word2VecParameters] = None, **kw) -> None:
        super().__init__(params or Word2VecParameters(**kw))

    def _validate(self, frame: Frame) -> None:
        super()._validate(frame)
        if frame.ncols != 1:
            raise ValueError("Word2Vec expects a single (string) column of words")

    def _fit(self, frame: Frame, valid: Optional[Frame],
             device: torch.device) -> Word2VecModel:
        p: Word2VecParameters = self.params
        words = _string_values(frame.col(0))
        # vocab with min frequency (reference min_word_freq)
        freq: Dict[str, int] = {}
        for w in words:
            if w is not None:
                freq[w] = freq.get(w, 0) + 1
        vocab_words = sorted([w for w, c in freq.items() if c >= p.min_word_freq])
        vocab = {w: i for i, w in enumerate(vocab_words)}
        V = len(vocab)
        if V == 0:
            raise ValueError("no words meet min_word_freq")

        # sentences of word ids
        sentences: List[List[int]] = [[]]
        for w in words:
            if w is None:
                if sentences[-1]:
                    sentences.append([])
            else:
                i = vocab.get(w)
                if i is not None:
                    sentences[-1].append(i)
        if not sentences[-1]:
            sentences.pop()

        counts = np.array([freq[w] for w in vocab_words], dtype=np.float64)
        total = counts.sum()
        # subsampling keep-probability (word2vec sent_sample_rate formula)
        keep_p = np.minimum(
            (np.sqrt(counts / (p.sent_sample_rate * total)) + 1)
            * (p.sent_sample_rate * total) / np.maximum(counts, 1),
            1.0,
        ) if p.sent_sample_rate > 0 else np.ones(V)
        # unigram^0.75 negative-sampling table
        neg_p = counts**0.75
        neg_p /= neg_p.sum()

        rng = np.random.default_rng(p.actual_seed())
        D = p.vec_size
        W = torch.from_numpy(((rng.random((V, D)) - 0.5) / D).astype(np.float32)).to(device)
        C = torch.zeros((V, D), dtype=torch.float32, device=device)

        model = Word2VecModel(p, device=device)
        model.vocab = vocab
        model.words = vocab_words

        total_steps = max(p.epochs, 1)
        for epoch in range(p.epochs):
            centers, contexts = _make_pairs(sentences, p.window_size, keep_p, rng)
            if len(centers) == 0:
                break
            lr = p.init_learning_rate * max(1.0 - epoch / max(p.epochs, 1), 1e-4)
            order = rng.permutation(len(centers))
            bs = min(p.batch_size, len(centers))
            # whole batches only, as the JAX package takes them (a ragged
            # tail would recompile there); the shuffle re-covers dropped
            # pairs across epochs
            n_batches = max(len(centers) // bs, 1)
            order = order[: n_batches * bs]
            # all negatives for the epoch in one draw (unigram^0.75)
            negs_e = rng.choice(
                V, size=(len(order), p.negative_samples), p=neg_p
            ).astype(np.int32)
            ctr = torch.from_numpy(centers[order].astype(np.int64)).to(device)
            ctx = torch.from_numpy(contexts[order].astype(np.int64)).to(device)
            neg = torch.from_numpy(negs_e.astype(np.int64)).to(device)
            lr_t = torch.tensor(lr, dtype=torch.float32, device=device)
            losses = torch.stack([
                _sgd_step(W, C, ctr[s: s + bs], ctx[s: s + bs], neg[s: s + bs], lr_t)
                for s in range(0, len(order), bs)
            ]).cpu().numpy()
            # the epoch's mean loss summed in float64 in step order, as the
            # JAX package sums its per-step floats
            ep_loss = 0.0
            for v in losses:
                ep_loss += float(v)
            model.losses.append(ep_loss / max(len(losses), 1))
            model.epochs_run = epoch + 1
            if self.job:
                self.job.update((epoch + 1) / total_steps)
        model.vectors = W.cpu().numpy().astype(np.float64)
        return model


def _make_pairs(
    sentences: List[List[int]], window: int, keep_p: np.ndarray, rng
) -> Tuple[np.ndarray, np.ndarray]:
    centers: List[int] = []
    contexts: List[int] = []
    for sent in sentences:
        ids = [i for i in sent if rng.random() < keep_p[i]]
        n = len(ids)
        for pos, c in enumerate(ids):
            b = rng.integers(1, window + 1)  # dynamic window like word2vec.c
            for off in range(-b, b + 1):
                j = pos + off
                if off != 0 and 0 <= j < n:
                    centers.append(c)
                    contexts.append(ids[j])
    return np.asarray(centers, dtype=np.int32), np.asarray(contexts, dtype=np.int32)


def _string_values(col: Column) -> List[Optional[str]]:
    """Column -> python words; NA -> None (sentence separator)."""
    if col.is_string():
        return [None if v is None else str(v) for v in col.data]
    if col.is_categorical():
        return [None if c < 0 else col.domain[c] for c in col.data]
    raise ValueError("Word2Vec needs a string or categorical column")

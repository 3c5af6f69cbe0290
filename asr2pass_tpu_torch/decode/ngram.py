"""N-gram language model: training (ARPA) + backoff scoring.

Port copy of the JAX package's decode/ngram.py (host code, unchanged).

Role of the reference's SRILM + TLG.fst toolchain (utils/ngram_tools/
train_compile_ngram.sh builds an arpa then compiles TLG.fst): here the LM
is trained in-process (Witten-Bell smoothing — robust with no tuning),
written/read as standard ARPA, and scored with backoff states directly; the
decoder composes it with the lexicon on the fly (decode/lm_decoder.py), so
no offline FST compilation step is needed.
"""
from __future__ import annotations

import math
from collections import defaultdict
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

BOS, EOS, UNK = "<s>", "</s>", "<unk>"
_LOG10 = math.log(10.0)


class NgramLM:
    """Backoff n-gram LM. States are word-tuple histories."""

    def __init__(self, order: int = 3):
        self.order = order
        # logprob / backoff in log10 (ARPA convention)
        self.logp: Dict[tuple, float] = {}
        self.backoff: Dict[tuple, float] = {}
        self.vocab: set = set()

    # -- scoring --------------------------------------------------------
    def score(self, history: tuple, word: str) -> float:
        """log10 P(word | history) with backoff."""
        if word not in self.vocab:
            word = UNK
        return self._score_backed(tuple(history[-(self.order - 1):]), word)

    def _score_backed(self, h: tuple, word: str) -> float:
        """Katz-style backoff walk: P(w|h) = P_seen or bow(h)*P(w|h')."""
        total_bow = 0.0
        while True:
            ng = h + (word,)
            if ng in self.logp:
                return total_bow + self.logp[ng]
            if not h:
                return total_bow + self.logp.get((word,), -7.0)
            total_bow += self.backoff.get(h, 0.0)
            h = h[1:]

    def next_state(self, history: tuple, word: str) -> tuple:
        if word not in self.vocab:
            word = UNK
        h = (history + (word,))[-(self.order - 1):]
        # truncate to longest known context
        while h and h not in self.backoff and len(h) > 1 \
                and h not in self.logp:
            h = h[1:]
        return h

    def sentence_logp(self, words: Sequence[str]) -> float:
        h: tuple = (BOS,)
        total = 0.0
        for w in list(words) + [EOS]:
            total += self.score(h, w)
            h = self.next_state(h, w)
        return total

    # -- training (Witten-Bell) -----------------------------------------
    @classmethod
    def train(cls, sentences: Iterable[Sequence[str]], order: int = 3
              ) -> "NgramLM":
        lm = cls(order)
        counts = [defaultdict(int) for _ in range(order + 1)]
        for sent in sentences:
            words = [BOS] + list(sent) + [EOS]
            for n in range(1, order + 1):
                for i in range(len(words) - n + 1):
                    ng = tuple(words[i: i + n])
                    if n == 1 and ng == (BOS,):
                        continue
                    counts[n][ng] += 1
        lm.vocab = {ng[0] for ng in counts[1]} | {UNK, BOS, EOS}
        # context totals + distinct successor counts
        for n in range(1, order + 1):
            ctx_total = defaultdict(int)
            ctx_types = defaultdict(int)
            for ng, c in counts[n].items():
                ctx_total[ng[:-1]] += c
                ctx_types[ng[:-1]] += 1
            for ng, c in counts[n].items():
                ctx = ng[:-1]
                t_, ty = ctx_total[ctx], ctx_types[ctx]
                # Witten-Bell: lambda = T/(T+Ty) to observed events
                p = c / (t_ + ty)
                lm.logp[ng] = math.log10(max(p, 1e-12))
            for ctx in ctx_total:
                if n < order:
                    t_, ty = ctx_total[ctx], ctx_types[ctx]
                    lm.backoff[ctx] = math.log10(max(ty / (t_ + ty), 1e-12))
        # unseen unigram mass for <unk>
        if (UNK,) not in lm.logp:
            lm.logp[(UNK,)] = -7.0
        return lm

    # -- ARPA IO ---------------------------------------------------------
    def save_arpa(self, path: str):
        by_order = defaultdict(list)
        for ng in self.logp:
            by_order[len(ng)].append(ng)
        with open(path, "w", encoding="utf-8") as f:
            f.write("\\data\\\n")
            for n in range(1, self.order + 1):
                f.write(f"ngram {n}={len(by_order[n])}\n")
            for n in range(1, self.order + 1):
                f.write(f"\n\\{n}-grams:\n")
                for ng in sorted(by_order[n]):
                    line = f"{self.logp[ng]:.6f}\t{' '.join(ng)}"
                    if ng in self.backoff:
                        line += f"\t{self.backoff[ng]:.6f}"
                    f.write(line + "\n")
            f.write("\n\\end\\\n")

    @classmethod
    def load_arpa(cls, path: str) -> "NgramLM":
        lm = cls(1)
        section = 0
        max_order = 1
        with open(path, encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                if line.startswith("\\") and "-grams:" in line:
                    section = int(line[1: line.index("-")])
                    max_order = max(max_order, section)
                    continue
                if line.startswith("\\"):
                    section = 0
                    continue
                if section:
                    parts = line.split("\t")
                    if len(parts) < 2:
                        parts = line.split()
                        parts = [parts[0], " ".join(parts[1: 1 + section])] \
                            + parts[1 + section:]
                    ng = tuple(parts[1].split())
                    lm.logp[ng] = float(parts[0])
                    if len(parts) > 2:
                        lm.backoff[ng] = float(parts[2])
        lm.order = max_order
        lm.vocab = {ng[0] for ng in lm.logp if len(ng) == 1} | {UNK}
        return lm


def interpolate(lm_a: NgramLM, lm_b: NgramLM, weight_a: float = 0.5
                ) -> NgramLM:
    """Static interpolation of two LMs (merge_ngram.sh role): the union of
    n-grams scored as log10(w*Pa + (1-w)*Pb) under each model's backoff."""
    out = NgramLM(max(lm_a.order, lm_b.order))
    out.vocab = lm_a.vocab | lm_b.vocab
    all_ngrams = set(lm_a.logp) | set(lm_b.logp)
    for ng in all_ngrams:
        h, w = ng[:-1], ng[-1]
        pa = 10 ** lm_a._score_backed(h, w) if lm_a.logp else 0.0
        pb = 10 ** lm_b._score_backed(h, w) if lm_b.logp else 0.0
        out.logp[ng] = math.log10(max(weight_a * pa + (1 - weight_a) * pb,
                                      1e-12))
    for ctx in set(lm_a.backoff) | set(lm_b.backoff):
        out.backoff[ctx] = math.log10(max(
            0.5 * 10 ** lm_a.backoff.get(ctx, -99)
            + 0.5 * 10 ** lm_b.backoff.get(ctx, -99), 1e-12))
    return out

"""LM beam decoder: on-the-fly L∘G token passing with hotword bias.

Port copy of the JAX package's decode/lm_decoder.py (host code,
unchanged): the plain version of native/bindings.NativeLmDecoder.

Role of the reference's WFST stack (#16/#17 in SURVEY.md §2): there,
per-token AM log-probs are fed as "frames" into a patched Kaldi
LatticeFasterOnlineDecoder over a precompiled TLG.fst, with an Aho-Corasick
bias LM consulted during token expansion (wfst-decoder.cpp:27-92,
bias-lm.cpp, third_party/kaldi/decoder/lattice-faster-decoder.cc:803-815).

Here the same search runs over a *dynamic* composition: a lexicon prefix
trie (L: AM units -> words) composed on the fly with the backoff n-gram LM
(G) — no offline FST compilation, same hypothesis space. Each beam token
carries (trie node, LM history, bias state); word-end arcs add the scaled
LM score; every AM unit consults the ContextGraph bias exactly as the
patched kaldi token passing does.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from asr2pass_tpu_torch.decode.context_graph import ContextGraph
from asr2pass_tpu_torch.decode.ngram import NgramLM, BOS

_LN10 = math.log(10.0)


class Lexicon:
    """word -> AM-unit sequence trie (TLG's L). For Chinese the units are
    the characters themselves; English words map to BPE pieces
    (lexicon.txt TSV: 'word unit1 unit2 ...', vocab.cpp:66-85)."""

    def __init__(self):
        self.root: Dict = {}

    @classmethod
    def from_file(cls, path: str) -> "Lexicon":
        lex = cls()
        with open(path, encoding="utf-8") as f:
            for line in f:
                parts = line.split()
                if len(parts) >= 2:
                    lex.add(parts[0], parts[1:])
        return lex

    @classmethod
    def from_words(cls, words) -> "Lexicon":
        """Chinese char-level lexicon: each word spelled by its chars."""
        lex = cls()
        for w in words:
            lex.add(w, list(w))
        return lex

    def add(self, word: str, units: Sequence[str]):
        node = self.root
        for u in units:
            node = node.setdefault(u, {})
        node.setdefault("\0", []).append(word)


@dataclass
class _Hyp:
    words: tuple
    lm_state: tuple
    trie: Dict
    bias_state: object
    score: float
    pending: tuple      # AM units consumed since last word boundary

    def key(self):
        return (self.words, self.lm_state, id(self.trie), self.pending)


class LmDecoder:
    """Per-utterance beam decode over token-posterior rows.

    Matches the Decoder interface role (src/decoder.h): start_utterance /
    accept_rows (Search) / finalize (FinalizeDecode)."""

    def __init__(self, lm: NgramLM, lexicon: Lexicon,
                 lm_weight: float = 0.5, beam: int = 16,
                 am_topk: int = 8, bias: Optional[ContextGraph] = None,
                 oov_penalty: float = -14.0):
        self.lm = lm
        self.lexicon = lexicon
        self.lm_weight = lm_weight
        self.beam = beam
        self.am_topk = am_topk
        self.bias = bias
        self.oov_penalty = oov_penalty
        self.start_utterance()

    def start_utterance(self):
        self.hyps: List[_Hyp] = [
            _Hyp(words=(), lm_state=(BOS,), trie=self.lexicon.root,
                 bias_state=None, score=0.0, pending=())
        ]

    def set_bias(self, bias: Optional[ContextGraph]):
        """LoadHwsRes/UnloadHwsRes role (wfst-decoder.cpp:223-241)."""
        self.bias = bias

    def accept_rows(self, log_probs: np.ndarray, id_to_token) -> None:
        """log_probs: [U, V] per-fired-token log-posteriors (the "frames"
        of AcceptLoglikes, wfst-decoder.cpp:27-57)."""
        for row in log_probs:
            self._advance(row, id_to_token)

    def _advance(self, row: np.ndarray, id_to_token):
        k = min(self.am_topk, row.shape[0])
        cand = (np.argpartition(row, -k)[-k:] if k < row.shape[0]
                else np.arange(row.shape[0]))
        new: Dict[tuple, _Hyp] = {}
        for hyp in self.hyps:
            for tok_id in cand:
                tok = id_to_token(int(tok_id))
                am = float(row[int(tok_id)])
                if tok in ("<s>", "</s>", "<blank>", "<unk>"):
                    continue
                bias_state, bias_delta = hyp.bias_state, 0.0
                if self.bias is not None:
                    bias_state, bias_delta, _ = self.bias.get_next_state(
                        hyp.bias_state, tok)
                base = hyp.score + am + bias_delta
                nxt = hyp.trie.get(tok)
                if nxt is not None:
                    # continue inside the lexicon
                    if "\0" in nxt:
                        # word completion arc(s)
                        for word in nxt["\0"]:
                            lm_s = self.lm.score(hyp.lm_state, word) * _LN10
                            h2 = _Hyp(
                                words=hyp.words + (word,),
                                lm_state=self.lm.next_state(hyp.lm_state,
                                                            word),
                                trie=self.lexicon.root,
                                bias_state=bias_state,
                                score=base + self.lm_weight * lm_s,
                                pending=(),
                            )
                            self._push(new, h2)
                    if any(k != "\0" for k in nxt):
                        h2 = _Hyp(words=hyp.words, lm_state=hyp.lm_state,
                                  trie=nxt, bias_state=bias_state,
                                  score=base, pending=hyp.pending + (tok,))
                        self._push(new, h2)
                else:
                    # OOV unit: emit pending + unit as raw text with penalty
                    word = "".join(hyp.pending) + tok
                    lm_s = self.lm.score(hyp.lm_state, word) * _LN10 \
                        if word in self.lm.vocab else self.oov_penalty
                    h2 = _Hyp(words=hyp.words + (word,),
                              lm_state=self.lm.next_state(hyp.lm_state, word),
                              trie=self.lexicon.root, bias_state=bias_state,
                              score=base + self.lm_weight * lm_s,
                              pending=())
                    self._push(new, h2)
        self.hyps = sorted(new.values(), key=lambda h: h.score,
                           reverse=True)[: self.beam]
        if not self.hyps:
            self.start_utterance()

    @staticmethod
    def _push(new: Dict[tuple, _Hyp], h: _Hyp):
        k = h.key()
        if k not in new or new[k].score < h.score:
            new[k] = h

    def finalize(self) -> str:
        """Best path; dangling lexicon prefixes flush as raw units and the
        bias retracts partial matches (FinalizeDecode +
        UpdateFinalContext roles)."""
        best: Optional[Tuple[float, tuple]] = None
        for hyp in self.hyps:
            score = hyp.score
            if self.bias is not None:
                score += self.bias.final_retract(hyp.bias_state)
            words = hyp.words + ((("".join(hyp.pending)),)
                                 if hyp.pending else ())
            if best is None or score > best[0]:
                best = (score, words)
        if best is None:
            return ""
        return "".join(best[1])

    def decode(self, log_probs: np.ndarray, id_to_token) -> str:
        self.start_utterance()
        self.accept_rows(log_probs, id_to_token)
        return self.finalize()

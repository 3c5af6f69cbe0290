"""Punctuation tokenizer: text -> punc-model token ids.

Port copy of the JAX package's text/punc_tokenizer.py. Role of CTokenizer
(onnxruntime/src/tokenizer.{h,cpp}): yaml/json token tables, Chinese
segmentation, per-char fallback, punc id<->symbol maps.
Where the reference uses jieba for Chinese word segmentation, we use greedy
longest-match against the model vocabulary (same effect for vocabulary
words; per-char fallback otherwise) — no vendored dictionary needed.
"""
from __future__ import annotations

import json
from typing import Dict, List, Sequence, Tuple

import yaml

# com-define.h:125-136
UNKNOWN_INDEX = 0
NOTPUNC_INDEX = 1
COMMA_INDEX = 2
PERIOD_INDEX = 3
QUESTION_INDEX = 4
DUN_INDEX = 5
DEFAULT_PUNC_LIST = ["<unk>", "_", "，", "。", "？", "、"]


def _is_ascii(ch: str) -> bool:
    return ord(ch) < 128


class PuncTokenizer:
    def __init__(self, tokens: Sequence[str],
                 punc_list: Sequence[str] = DEFAULT_PUNC_LIST,
                 unk: str = "<unk>", max_word_len: int = 8):
        self.token2id: Dict[str, int] = {t: i for i, t in enumerate(tokens)}
        self.punc_list = list(punc_list)
        self.unk_id = self.token2id.get(unk, 0)
        self.max_word_len = max_word_len

    @classmethod
    def from_file(cls, path: str, **kw) -> "PuncTokenizer":
        if str(path).endswith(".json"):
            with open(path, encoding="utf-8") as f:
                tokens = json.load(f)
        else:
            with open(path, encoding="utf-8") as f:
                cfg = yaml.safe_load(f)
            tokens = cfg["token_list"] if isinstance(cfg, dict) else cfg
        return cls(tokens, **kw)

    def id2punc(self, i: int) -> str:
        return self.punc_list[i] if 0 <= i < len(self.punc_list) else "_"

    def is_punc(self, s: str) -> bool:
        return s in self.punc_list[COMMA_INDEX:]

    def tokenize(self, text: str) -> Tuple[List[str], List[int]]:
        """Split into ascii words (whitespace) + greedy-longest Chinese
        vocabulary words with per-char fallback. Returns (tokens, ids)."""
        tokens: List[str] = []
        i, n = 0, len(text)
        while i < n:
            ch = text[i]
            if ch.isspace():
                i += 1
                continue
            if _is_ascii(ch):
                j = i
                while j < n and _is_ascii(text[j]) and not text[j].isspace():
                    j += 1
                tokens.append(text[i:j])
                i = j
                continue
            # greedy longest vocabulary match
            best = 1
            for l in range(min(self.max_word_len, n - i), 1, -1):
                if text[i: i + l] in self.token2id:
                    best = l
                    break
            tokens.append(text[i: i + best])
            i += best
        ids = [self.token2id.get(t, self.token2id.get(t.lower(), self.unk_id))
               for t in tokens]
        return tokens, ids

"""Token table + detokenizers.

Re-implements the reference Vocab semantics (onnxruntime/src/vocab.cpp):
tokens.json / config.yaml token_list loading, and the two detokenizers —
``to_string`` (Vector2StringV2: drop specials, join `@@` BPE, space rules
between English words) including the *stateful streaming* behaviour where a
space is inserted when consecutive chunks both end/start with complete
English words (vocab.cpp:164-210, `last_is_complete_english_` at :177).
"""
from __future__ import annotations

import json
from typing import Iterable, List, Sequence

import yaml

SPECIALS = {"<s>", "</s>", "<blank>", "<unk>", "<pad>", "<sos>", "<eos>"}


def _is_english_token(tok: str) -> bool:
    return all(ord(c) < 128 for c in tok) and len(tok) > 0


class Vocab:
    def __init__(self, tokens: Sequence[str], lang: str = "zh"):
        self.tokens = list(tokens)
        self.lang = lang
        self.token2id = {t: i for i, t in enumerate(self.tokens)}
        # streaming detokenizer state (vocab.cpp:177)
        self.last_is_complete_english = False

    def __len__(self):
        return len(self.tokens)

    @classmethod
    def from_file(cls, path: str, lang: str = "zh") -> "Vocab":
        if str(path).endswith(".json"):
            with open(path, encoding="utf-8") as f:
                tokens = json.load(f)
        else:
            with open(path, encoding="utf-8") as f:
                cfg = yaml.safe_load(f)
            tokens = cfg["token_list"] if isinstance(cfg, dict) else cfg
        return cls(tokens, lang)

    def id2token(self, i: int) -> str:
        return self.tokens[i] if 0 <= i < len(self.tokens) else "<unk>"

    def ids_to_tokens(self, ids: Iterable[int]) -> List[str]:
        out = []
        for i in ids:
            t = self.id2token(int(i))
            if t in SPECIALS:
                continue
            out.append(t)
        return out

    def reset_streaming(self):
        self.last_is_complete_english = False

    def to_string(self, ids: Iterable[int], streaming: bool = False) -> str:
        """Detokenize (Vector2StringV2 semantics):
        - `@@`-suffixed BPE pieces join with the next token
        - `▁`-prefixed (en-bpe) pieces start a new space-separated word
        - a space separates consecutive full English words
        - Chinese chars concatenate directly
        When streaming=True, carries English-boundary state across calls.
        """
        toks = self.ids_to_tokens(ids)
        parts: List[str] = []
        pending_bpe = False  # previous token ended with @@
        prev_english = (self.last_is_complete_english if streaming else False)
        for t in toks:
            if t.startswith("▁"):  # en-bpe sentencepiece marker
                word = t[1:]
                if parts:
                    parts.append(" ")
                parts.append(word)
                prev_english = True
                pending_bpe = False
                continue
            is_en = _is_english_token(t)
            core = t[:-2] if t.endswith("@@") else t
            if is_en:
                if not pending_bpe and prev_english:
                    parts.append(" ")
                parts.append(core)
                pending_bpe = t.endswith("@@")
                prev_english = not pending_bpe
            else:
                parts.append(t)
                pending_bpe = False
                prev_english = False
        if streaming:
            self.last_is_complete_english = prev_english
        return "".join(parts)

    def to_char_list(self, ids: Iterable[int]) -> List[str]:
        """Vector2String: raw token list with specials removed (used by the
        timestamp aligner, paraformer.cpp:399-404)."""
        return self.ids_to_tokens(ids)


def make_test_vocab(n: int = 64) -> Vocab:
    """Deterministic vocab for unit tests and the launcher's demo mode:
    specials + CJK block."""
    tokens = ["<blank>", "<s>", "</s>", "<unk>"]
    i = 0
    while len(tokens) < n:
        tokens.append(chr(0x4E00 + i))
        i += 1
    return Vocab(tokens)

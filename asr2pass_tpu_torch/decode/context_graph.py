"""Hotword context graph: prefix trie with Aho-Corasick-style fallback.

Port copy of the JAX package's decode/context_graph.py (host code, unchanged).

Role of context_graph.cpp (WeNet-style): hotwords over vocab symbols form a
prefix tree; each matched token adds an incremental boost
(score_per_char × UTF-8 char count); falling off a partial match returns to
the start and *retracts* the accumulated boost (escape arcs with negative
cumulative score, context_graph.cpp:33-93). `get_next_state` is the exact
decoder-side interface (:95-118).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple


class _Node:
    __slots__ = ("children", "score", "total", "is_end")

    def __init__(self):
        self.children: Dict[str, "_Node"] = {}
        self.score = 0.0      # incremental score on entering this node
        self.total = 0.0      # cumulative score from root
        self.is_end = False


class ContextGraph:
    def __init__(self, context_score: float = 3.0):
        self.context_score = context_score
        self.root = _Node()

    def build(self, hotwords: Dict[str, float], symbol_splitter=None):
        """hotwords: {phrase: boost-per-char or None}. symbol_splitter maps
        a phrase to its token sequence (default: greedy per-char for CJK,
        whitespace words for latin — context_graph.cpp:120-159 splits
        against the symbol table)."""
        for phrase, boost in hotwords.items():
            toks = (symbol_splitter(phrase) if symbol_splitter
                    else self._default_split(phrase))
            if not toks:
                continue
            per_tok = (boost if boost else self.context_score)
            node = self.root
            for tok in toks:
                if tok not in node.children:
                    child = _Node()
                    # incremental score x character count of the token
                    # (context_graph.cpp scores per UTF-8 character)
                    child.score = per_tok * len(tok)
                    child.total = node.total + child.score
                    node.children[tok] = child
                node = node.children[tok]
            node.is_end = True
        return self

    @staticmethod
    def _default_split(phrase: str) -> List[str]:
        toks: List[str] = []
        word = ""
        for ch in phrase:
            if ord(ch) < 128:
                if ch.isspace():
                    if word:
                        toks.append(word)
                        word = ""
                else:
                    word += ch
            else:
                if word:
                    toks.append(word)
                    word = ""
                toks.append(ch)
        if word:
            toks.append(word)
        return toks

    def get_next_state(self, state: Optional[_Node], token: str
                       ) -> Tuple[Optional[_Node], float, bool]:
        """(state, token) -> (next_state, score_delta, matched_full_word).

        Mismatch mid-path retracts the accumulated boost (escape arc with
        -state.total); a full-word match keeps the boost and returns to
        root (context_graph.cpp:95-118)."""
        node = state or self.root
        if token in node.children:
            nxt = node.children[token]
            delta = nxt.score
            if nxt.is_end and not nxt.children:
                return self.root, delta, True
            return nxt, delta, nxt.is_end
        # mismatch: retract; maybe re-enter from root with this token
        retract = -node.total
        if token in self.root.children:
            nxt = self.root.children[token]
            if nxt.is_end and not nxt.children:
                return self.root, retract + nxt.score, True
            return nxt, retract + nxt.score, nxt.is_end
        return self.root, retract, False

    def final_retract(self, state: Optional[_Node]) -> float:
        """End-of-decode: retract any dangling partial match
        (UpdateFinalContext role, ctc-prefix-decoder.cpp:292-299)."""
        node = state or self.root
        return -node.total

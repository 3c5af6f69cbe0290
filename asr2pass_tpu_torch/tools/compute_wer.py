#!/usr/bin/env python3
"""WER/CER scorer (utils/compute-wer.py equivalent).

Port of the JAX package's tools/compute_wer.py. Tokenization matches the
reference scorer (utils/compute-wer.py:15-64): CJK characters score as
units (CER), latin words as words (WER), tags like <noise> strip,
case-folds, punctuation drops. Alignment is Levenshtein with per-op
counts (Calculator.calculate role, :86-225), through the native library's
a2p_edit_align (native/bindings.edit_align). The Python DP is its plain
version (align_plain, for the tests); a failure of the native call
raises instead of falling back to it.

CLI: python -m asr2pass_tpu_torch.tools.compute_wer ref.txt hyp.txt
     (kaldi text format: "utt-id token token ...")
"""
from __future__ import annotations

import re
import sys
from dataclasses import dataclass, field
from typing import Dict, List, Tuple


def _is_cjk(ch: str) -> bool:
    cp = ord(ch)
    return (0x4E00 <= cp <= 0x9FFF or 0x3400 <= cp <= 0x4DBF
            or 0xF900 <= cp <= 0xFAFF or 0x3040 <= cp <= 0x30FF
            or 0xAC00 <= cp <= 0xD7AF)


_TAG_RE = re.compile(r"<[^>]+>")


def tokenize(text: str, case_sensitive: bool = False) -> List[str]:
    """CJK chars as units, latin words as words; tags and punctuation
    dropped."""
    text = _TAG_RE.sub(" ", text)
    if not case_sensitive:
        text = text.lower()
    out: List[str] = []
    word = ""
    for ch in text:
        if _is_cjk(ch):
            if word:
                out.append(word)
                word = ""
            out.append(ch)
        elif ch.isalnum() or ch in "'-":
            word += ch
        else:
            if word:
                out.append(word)
                word = ""
    if word:
        out.append(word)
    return out


@dataclass
class WerStats:
    ref_len: int = 0
    sub: int = 0
    dele: int = 0
    ins: int = 0
    sentences: int = 0
    errors_by_word: Dict[str, int] = field(default_factory=dict)

    @property
    def errors(self) -> int:
        return self.sub + self.dele + self.ins

    @property
    def wer(self) -> float:
        return self.errors / self.ref_len if self.ref_len else 0.0


def align(ref: List[str], hyp: List[str]) -> Tuple[List[int], int]:
    """Levenshtein ops (0=match 1=sub 2=del 3=ins) + distance, by the
    native library (align_plain is its plain version)."""
    from asr2pass_tpu_torch.native import bindings

    sym: Dict[str, int] = {}
    a = [sym.setdefault(tok, len(sym)) for tok in ref]
    b = [sym.setdefault(tok, len(sym)) for tok in hyp]
    return bindings.edit_align(a, b)


def align_plain(ref: List[str], hyp: List[str]) -> Tuple[List[int], int]:
    """The Python DP, with the native library's tie order on backtrack:
    match, substitution, deletion, insertion."""
    n, m = len(ref), len(hyp)
    dp = [[0] * (m + 1) for _ in range(n + 1)]
    for i in range(n + 1):
        dp[i][0] = i
    for j in range(m + 1):
        dp[0][j] = j
    for i in range(1, n + 1):
        for j in range(1, m + 1):
            dp[i][j] = min(dp[i - 1][j - 1] + (ref[i - 1] != hyp[j - 1]),
                           dp[i - 1][j] + 1, dp[i][j - 1] + 1)
    ops: List[int] = []
    i, j = n, m
    while i > 0 or j > 0:
        if (i > 0 and j > 0 and dp[i][j] == dp[i - 1][j - 1]
                and ref[i - 1] == hyp[j - 1]):
            ops.append(0)
            i, j = i - 1, j - 1
        elif i > 0 and j > 0 and dp[i][j] == dp[i - 1][j - 1] + 1:
            ops.append(1)
            i, j = i - 1, j - 1
        elif i > 0 and dp[i][j] == dp[i - 1][j] + 1:
            ops.append(2)
            i -= 1
        else:
            ops.append(3)
            j -= 1
    return ops[::-1], dp[n][m]


def score_pair(ref_text: str, hyp_text: str,
               stats: WerStats = None) -> Tuple[WerStats, dict]:
    stats = stats or WerStats()
    ref = tokenize(ref_text)
    hyp = tokenize(hyp_text)
    ops, _ = align(ref, hyp)
    sub = sum(1 for o in ops if o == 1)
    dele = sum(1 for o in ops if o == 2)
    ins = sum(1 for o in ops if o == 3)
    stats.ref_len += len(ref)
    stats.sub += sub
    stats.dele += dele
    stats.ins += ins
    stats.sentences += 1
    line = {"ref": ref, "hyp": hyp, "sub": sub, "del": dele, "ins": ins,
            "wer": (sub + dele + ins) / len(ref) if ref else 0.0}
    return stats, line


def load_trn(path: str) -> Dict[str, str]:
    out = {}
    with open(path, encoding="utf-8") as f:
        for line in f:
            parts = line.strip().split(None, 1)
            if not parts:
                continue
            out[parts[0]] = parts[1] if len(parts) > 1 else ""
    return out


def main(argv=None):
    argv = argv or sys.argv[1:]
    if len(argv) < 2:
        print(__doc__)
        return 1
    refs = load_trn(argv[0])
    hyps = load_trn(argv[1])
    stats = WerStats()
    for utt, ref in refs.items():
        hyp = hyps.get(utt, "")
        stats, line = score_pair(ref, hyp, stats)
        print(f"{utt} WER {line['wer']*100:.2f}% "
              f"S={line['sub']} D={line['del']} I={line['ins']}")
    print(f"Overall -> WER {stats.wer*100:.2f}% "
          f"[{stats.errors}/{stats.ref_len}] "
          f"S={stats.sub} D={stats.dele} I={stats.ins} "
          f"sentences={stats.sentences}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

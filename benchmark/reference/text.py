"""Host text stages, plain: detokenization of the benchmark's vocabulary,
CIF-peak timestamps (a frozen copy of the port's
text/timestamps.timestamp_from_peaks, which follows the reference
runtime's TimestampOnnx), and the CT-Transformer's window loop and text
assembly (following the port's runtime/punc.Punctuator.add_punc).

These stages run on what the program served (its token ids, upsampled
alphas and punctuation classes), so that the text and timestamps it
returned can be checked letter for letter; the served values themselves
are checked against the plain networks elsewhere.
"""
from __future__ import annotations

from typing import Callable, List, Sequence, Tuple

import numpy as np

SPECIALS = {"<s>", "</s>", "<blank>", "<unk>", "<pad>", "<sos>", "<eos>"}
PUNC_LIST = ["<unk>", "_", "，", "。", "？", "、"]
UNKNOWN, NOTPUNC, COMMA, PERIOD, QUESTION, DUN = range(6)

START_END_THRESHOLD = 5.0
MAX_TOKEN_DURATION = 30.0
TIME_RATE = 10.0 * 6 / 1000 / 3  # 60 ms LFR frame, 3x upsampled predictor


def timestamp_from_peaks(us_alphas: Sequence[float],
                         us_cif_peak: Sequence[float],
                         char_list: List[str],
                         begin_time_ms: float = 0.0,
                         total_offset: float = 0.0
                         ) -> Tuple[List[str], List[List[float]],
                                    List[List[float]]]:
    """Returns (char_list_with_sil, all timestamps s, token-only timestamps
    s) — the TimestampOnnx outputs."""
    char_list = list(char_list)
    if not char_list:
        return [], [], []
    if char_list and char_list[-1] == "</s>":
        char_list = char_list[:-1]
    if not char_list:
        return [], [], []
    cif_peak = list(us_cif_peak)
    num_frames = len(cif_peak)
    fire_place = [i + total_offset for i, p in enumerate(cif_peak)
                  if p > 1.0 - 1e-4]
    if len(fire_place) != len(char_list) + 1:
        # alpha-rescale fallback: renormalize alphas to fire exactly
        # #tokens+1 times, re-run the integrate pass (util.cpp:872-904)
        total = float(sum(us_alphas))
        scale = total / (len(char_list) + 1)
        if scale == 0:
            return [], [], []
        cif_peak = []
        s = 0.0
        for a in us_alphas:
            a = a / scale
            s += a
            cif_peak.append(s)
            if s >= 1.0 - 1e-4:
                s -= 1.0 - 1e-4
        idx = len(cif_peak) - 1
        while s >= 1.0 - 1e-4 and idx >= 0:
            if cif_peak[idx] < 1.0 - 1e-4:
                cif_peak[idx] = s
                s -= 1.0 - 1e-4
            idx -= 1
        fire_place = [i + total_offset for i, p in enumerate(cif_peak)
                      if p > 1.0 - 1e-4]
    if not fire_place:
        return [], [], []

    new_chars: List[str] = []
    ts: List[List[float]] = []
    if fire_place[0] > START_END_THRESHOLD:
        new_chars.append("<sil>")
        ts.append([0.0, fire_place[0] * TIME_RATE])
    num_peak = len(fire_place)
    for i in range(num_peak - 1):
        if i >= len(char_list):
            break
        new_chars.append(char_list[i])
        if (i == num_peak - 2 or MAX_TOKEN_DURATION < 0
                or fire_place[i + 1] - fire_place[i] < MAX_TOKEN_DURATION):
            ts.append([fire_place[i] * TIME_RATE,
                       fire_place[i + 1] * TIME_RATE])
        else:
            split = fire_place[i] + MAX_TOKEN_DURATION
            ts.append([fire_place[i] * TIME_RATE, split * TIME_RATE])
            ts.append([split * TIME_RATE, fire_place[i + 1] * TIME_RATE])
            new_chars.append("<sil>")
    if not ts:
        return [], [], []
    if num_frames - fire_place[-1] > START_END_THRESHOLD:
        end = (num_frames + fire_place[-1]) / 2.0
        ts[-1][1] = end * TIME_RATE
        ts.append([end * TIME_RATE, num_frames * TIME_RATE])
        new_chars.append("<sil>")
    else:
        ts[-1][1] = num_frames * TIME_RATE
    if begin_time_ms:
        for pair in ts:
            pair[0] += begin_time_ms / 1000.0
            pair[1] += begin_time_ms / 1000.0
    token_ts = [pair for ch, pair in zip(new_chars, ts) if ch != "<sil>"]
    return new_chars, ts, token_ts


def detok(ids: Sequence[int], tokens: Sequence[str]) -> List[str]:
    """Token strings of ids, specials dropped (the benchmark's
    vocabularies hold single CJK characters, which join without spaces)."""
    out = []
    for i in ids:
        t = tokens[int(i)] if 0 <= int(i) < len(tokens) else "<unk>"
        if t not in SPECIALS:
            out.append(t)
    return out


def peaks(us_alphas: np.ndarray, threshold: float) -> np.ndarray:
    """The integrate trace of the upsampled alphas in float32, reset by
    the threshold each time it reaches it."""
    integ = np.float32(0.0)
    thr = np.float32(threshold)
    out = np.zeros(len(us_alphas), np.float32)
    for i, a in enumerate(np.asarray(us_alphas, np.float32)):
        new = np.float32(integ + a)
        integ = np.float32(new - thr) if new >= thr else new
        out[i] = new
    return out


def stamps_ms(chars: List[str], us_alphas: np.ndarray, us_peaks,
              offset_ms: int) -> List[List[int]]:
    """A segment's token timestamps in ms on the file's clock."""
    _, _, token_ts = timestamp_from_peaks(list(us_alphas), list(us_peaks),
                                          list(chars))
    # a token past the timestamps' end takes [0, 0], as the program's
    # post-processing gives it
    merged = [token_ts[i] if i < len(token_ts) else [0.0, 0.0]
              for i in range(len(chars))]
    off = offset_ms / 1000.0
    return [[int(1000 * (b + off)), int(1000 * (e + off))]
            for b, e in merged]


def tokenize(text: str, token2id: dict, max_word_len: int = 8
             ) -> Tuple[List[str], List[int]]:
    """ASCII words by whitespace, else greedy longest vocabulary words
    with a per-character fallback."""
    tokens: List[str] = []
    i, n = 0, len(text)
    while i < n:
        ch = text[i]
        if ch.isspace():
            i += 1
            continue
        if ord(ch) < 128:
            j = i
            while j < n and ord(text[j]) < 128 and not text[j].isspace():
                j += 1
            tokens.append(text[i:j])
            i = j
            continue
        best = 1
        for ln in range(min(max_word_len, n - i), 1, -1):
            if text[i: i + ln] in token2id:
                best = ln
                break
        tokens.append(text[i: i + best])
        i += best
    unk = token2id.get("<unk>", 0)
    return tokens, [token2id.get(t, token2id.get(t.lower(), unk))
                    for t in tokens]


def punc_windows(tokens: List[str], ids: List[int], token_len: int,
                 pop_limit: int, decide: Callable[[int, List[int]],
                                                  List[int]]):
    """The offline window loop: windows of token_len words with the words
    after the last sentence end carried into the next; a window with no
    sentence end and over pop_limit words ends at its last comma. decide(
    window index, window ids) returns the classes of a window. Returns
    (words, classes, [window ids])."""
    total = max(1, -(-len(ids) // token_len))
    remain_ids: List[int] = []
    remain_str: List[str] = []
    out_t: List[str] = []
    out_p: List[int] = []
    windows = []
    for bi in range(total):
        w_ids = remain_ids + ids[bi * token_len: (bi + 1) * token_len]
        w_str = remain_str + tokens[bi * token_len: (bi + 1) * token_len]
        windows.append(list(w_ids))
        punc = list(decide(bi, w_ids))
        if bi < total - 1:
            end, comma = -1, -1
            for i in range(len(punc) - 2, 0, -1):
                if punc[i] in (PERIOD, QUESTION):
                    end = i
                    break
                if comma < 0 and punc[i] == COMMA:
                    comma = i
            if end < 0 and comma > 0 and len(w_str) > pop_limit:
                end = comma
                punc[end] = PERIOD
            remain_str, remain_ids = w_str[end + 1:], w_ids[end + 1:]
            w_str, punc = w_str[: end + 1], punc[: end + 1]
        out_t.extend(w_str)
        out_p.extend(punc)
    return out_t, out_p, windows


def punctuated(words: List[str], classes: List[int]) -> str:
    """Words with their marks, a space between ASCII words, and a
    sentence-final period forced."""
    parts: List[str] = []
    for i, (w, c) in enumerate(zip(words, classes)):
        if i > 0 and ord(words[i - 1][0]) < 128 and ord(w[0]) < 128:
            parts.append(" ")
        parts.append(w)
        if c not in (NOTPUNC, UNKNOWN):
            parts.append(PUNC_LIST[c] if 0 <= c < len(PUNC_LIST) else "_")
    if parts:
        if parts[-1] in (PUNC_LIST[COMMA], PUNC_LIST[DUN]):
            parts[-1] = PUNC_LIST[PERIOD]
        elif parts[-1] not in (PUNC_LIST[PERIOD], PUNC_LIST[QUESTION]):
            parts.append(PUNC_LIST[PERIOD])
    return "".join(parts)

"""CTC decoding: greedy collapse + prefix beam search with hotword boost.

Greedy matches SenseVoiceSmall::CTCSearch (sensevoice-small.cpp:323-377):
skip blanks and repeats, strip the meta prefix, `▁`->space join. The prefix
beam search is the WeNet-derived algorithm of ctc-prefix-decoder.cpp:
157-263 — per-prefix (blank, non-blank) probabilities, two-stage pruning,
per-prefix viterbi times for timestamps, and context-graph hotword scoring
(UpdateContext role, :280-299).

Port copy of the JAX package's decode/ctc.py, host code. The pruned beam
runs in the native library (native/src/ctc_beam.cc) by default, as the
JAX package's serving path does; the Python spec
(_prefix_beam_over_frames) is the plain version, taken only with
use_native=False.
"""
from __future__ import annotations

import math
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import numpy as np

from asr2pass_tpu_torch.decode.context_graph import ContextGraph

NEG_INF = -float("inf")


def ctc_greedy(logits: np.ndarray, length: int, blank_id: int = 0,
               skip_first: int = 0) -> Tuple[List[int], List[int]]:
    """[T, V] logits -> (ids, frame_times). skip_first strips meta tokens."""
    ids: List[int] = []
    times: List[int] = []
    prev = -1
    best = np.argmax(logits[:length], axis=-1)
    for t in range(skip_first, length):
        tok = int(best[t])
        if tok != blank_id and tok != prev:
            ids.append(tok)
            times.append(t - skip_first)
        prev = tok
    return ids, times


def _log_add(a: float, b: float) -> float:
    if a == NEG_INF:
        return b
    if b == NEG_INF:
        return a
    m = max(a, b)
    return m + math.log1p(math.exp(min(a, b) - m))


class _PrefixScore:
    __slots__ = ("pb", "pnb", "ctx_state", "ctx_score", "times_b", "times_nb",
                 "cur_token_prob")

    def __init__(self):
        self.pb = NEG_INF       # prob ending in blank
        self.pnb = NEG_INF      # prob ending in non-blank
        self.ctx_state = None
        self.ctx_score = 0.0
        self.times_b: List[int] = []
        self.times_nb: List[int] = []
        self.cur_token_prob = NEG_INF

    @property
    def total(self) -> float:
        return _log_add(self.pb, self.pnb)

    def score_with_ctx(self) -> float:
        return self.total + self.ctx_score

    def times(self) -> List[int]:
        return self.times_b if self.pb > self.pnb else self.times_nb


def ctc_prefix_beam_search(
    log_probs: np.ndarray,
    length: int,
    beam: int = 10,
    first_beam: int = 64,
    blank_id: int = 0,
    context: Optional[ContextGraph] = None,
    id_to_token=None,
) -> List[Tuple[List[int], float, List[int]]]:
    """[T, V] log-probs -> n-best [(ids, score, times)].

    first_beam = per-frame candidate tokens (first prune); beam = kept
    prefixes (second prune) — the TopK pair of ctc-prefix-decoder.cpp.
    """
    frames = []
    for t in range(length):
        row = log_probs[t]
        cand = np.argpartition(row, -first_beam)[-first_beam:] \
            if first_beam < row.shape[0] else np.arange(row.shape[0])
        frames.append([(int(tok), float(row[tok])) for tok in cand])
    return _prefix_beam_over_frames(frames, beam, blank_id, context,
                                    id_to_token)


def ctc_prefix_beam_search_pruned(
    cand_ids: np.ndarray,
    cand_logp: np.ndarray,
    length: int,
    beam: int = 10,
    blank_id: int = 0,
    context: Optional[ContextGraph] = None,
    id_to_token=None,
    token2id=None,
    use_native: bool = True,
) -> List[Tuple[List[int], float, List[int]]]:
    """Prefix beam over PRE-PRUNED per-frame candidates ([T, k] ids +
    log-probs): the first prune runs on the device
    (parallel/ctc_shard.py), so only k candidates per frame reach the
    host instead of the [T, V] row. Equivalent to ctc_prefix_beam_search
    with first_beam = k.

    use_native=True (the serving path) runs the C++ beam, an exact
    mirror of _prefix_beam_over_frames that releases the interpreter
    lock; its hotword bias keys the context trie by unit id, so a context
    needs `token2id`. use_native=False runs the Python spec, which keys
    the trie by token string through `id_to_token` (same reachability).
    """
    if use_native:
        if context is not None and token2id is None:
            raise ValueError("the native beam keys the context trie by "
                             "unit id: pass token2id with the context")
        return _native_pruned_beam(cand_ids, cand_logp, length, beam,
                                   blank_id, context, token2id)
    frames = [[(int(cand_ids[t, j]), float(cand_logp[t, j]))
               for j in range(cand_ids.shape[1])]
              for t in range(length)]
    return _prefix_beam_over_frames(frames, beam, blank_id, context,
                                    id_to_token)


def _native_pruned_beam(cand_ids, cand_logp, length, beam, blank_id,
                        context, token2id):
    from asr2pass_tpu_torch.native import bindings

    trie = None
    if context is not None:
        # the serialized trie, cached on the (immutable, shared) graph and
        # keyed by the identity of the vocabulary's token2id
        cache = getattr(context, "_a2p_trie", None)
        if cache is None or cache[0] is not token2id:
            cache = (token2id,
                     bindings.serialize_context_trie(context, token2id))
            context._a2p_trie = cache
        trie = cache[1]
    return bindings.ctc_beam_decode(np.asarray(cand_ids),
                                    np.asarray(cand_logp, np.float32),
                                    length, beam=beam, blank_id=blank_id,
                                    trie=trie)


def _prefix_beam_over_frames(frames, beam, blank_id, context, id_to_token):
    root = _PrefixScore()
    root.pb = 0.0
    beams: Dict[tuple, _PrefixScore] = {(): root}
    for t, cands in enumerate(frames):
        next_beams: Dict[tuple, _PrefixScore] = defaultdict(_PrefixScore)
        for prefix, ps in beams.items():
            for tok, p in cands:
                if p < -12.0 and tok != blank_id:
                    continue
                if tok == blank_id:
                    ns = next_beams[prefix]
                    ns.pb = _log_add(ns.pb, ps.total + p)
                    if not ns.times_b:
                        ns.times_b = ps.times()
                    ns.ctx_state = ps.ctx_state
                    ns.ctx_score = ps.ctx_score
                elif prefix and tok == prefix[-1]:
                    # repeat: extends the same token (non-blank path) or
                    # starts a new one (after blank)
                    ns = next_beams[prefix]
                    ns.pnb = _log_add(ns.pnb, ps.pnb + p)
                    ns.ctx_state = ps.ctx_state
                    ns.ctx_score = ps.ctx_score
                    if p > ns.cur_token_prob:
                        ns.cur_token_prob = p
                        ns.times_nb = list(ps.times_nb)
                        if ns.times_nb:
                            ns.times_nb[-1] = t
                    np_prefix = prefix + (tok,)
                    ns2 = next_beams[np_prefix]
                    ns2.pnb = _log_add(ns2.pnb, ps.pb + p)
                    _extend_ctx(ns2, ps, tok, context, id_to_token)
                    if p > ns2.cur_token_prob:
                        ns2.cur_token_prob = p
                        ns2.times_nb = ps.times() + [t]
                else:
                    np_prefix = prefix + (tok,)
                    ns = next_beams[np_prefix]
                    ns.pnb = _log_add(ns.pnb, ps.total + p)
                    _extend_ctx(ns, ps, tok, context, id_to_token)
                    if p > ns.cur_token_prob:
                        ns.cur_token_prob = p
                        ns.times_nb = ps.times() + [t]
        beams = dict(sorted(next_beams.items(),
                            key=lambda kv: kv[1].score_with_ctx(),
                            reverse=True)[:beam])
    out = []
    for prefix, ps in beams.items():
        score = ps.score_with_ctx()
        if context is not None:
            score += context.final_retract(ps.ctx_state)
        out.append((list(prefix), score, ps.times()))
    out.sort(key=lambda x: x[1], reverse=True)
    return out


def _extend_ctx(ns: _PrefixScore, ps: _PrefixScore, tok: int,
                context: Optional[ContextGraph], id_to_token):
    if context is None or id_to_token is None:
        return
    if ns.ctx_state is None and ns.ctx_score == 0.0:
        state, delta, _ = context.get_next_state(ps.ctx_state,
                                                 id_to_token(tok))
        ns.ctx_state = state
        ns.ctx_score = ps.ctx_score + delta

#!/usr/bin/env python3
"""Compile lexicon + n-gram LM into a TLG.fst decoding graph.

Port copy of the JAX package's tools/build_tlg.py (host code; the same
output files, byte for byte).

Role of the reference's utils/ngram_tools/train_compile_ngram.sh +
make_decode_graph.sh (SRILM + OpenFST offline pipeline): produces
`TLG.fst` (OpenFST vector format, readable by both our native runtime and
stock OpenFST), `words.txt`, and `tokens.txt` in the output dir — the
artifact set FunASRWfstDecoderInit expects (funasrruntime.cpp:836-894).

Graph structure (dynamic L∘G, built directly):
  * G: one state per n-gram history; word arcs weight -logp(word|h);
    epsilon backoff arcs weight -backoff(h); finals score </s>.
  * L: each word arc expands into its lexicon unit chain; the first arc
    carries ilabel=unit+1, olabel=word_id, and the G weight.

Usage:
  python -m asr2pass_tpu_torch.tools.build_tlg --arpa lm.arpa \
      --lexicon lexicon.txt --out graph_dir
  (--lexicon omitted -> char-level lexicon over the LM vocabulary)
"""
from __future__ import annotations

import argparse
import os
import sys
from typing import Dict, List, Sequence, Tuple

from asr2pass_tpu_torch.decode.fst_io import FstBuilder
from asr2pass_tpu_torch.decode.ngram import NgramLM

BOS, EOS = "<s>", "</s>"


def build_tlg(lm: NgramLM, word_units: Dict[str, Sequence[str]],
              out_dir: str, ctc_blank: str = None):
    """word_units: word -> AM unit sequence (the L lexicon).

    ctc_blank: when given (the blank unit's token string, e.g.
    "<blank>"), the graph gets the CTC frame-synchronous topology — a
    blank self-loop on every state and a repeat self-loop on every arc
    destination — so frame-level CTC posteriors decode directly (the
    graph the reference's WfstDecoder::CtcSearch drives for SenseVoice,
    wfst-decoder.cpp:95-145: every frame's row is accepted and the T
    layer absorbs blanks/repeats). Without it the graph expects one row
    per emitted token (the Paraformer path)."""
    os.makedirs(out_dir, exist_ok=True)
    words = sorted(w for w in word_units if w not in (BOS, EOS))
    word_ids = {w: i + 1 for i, w in enumerate(words)}  # 0 = eps
    units = sorted({u for us in word_units.values() for u in us})
    unit_ids = {u: i + 1 for i, u in enumerate(units)}  # ilabel = idx + 1

    b = FstBuilder()
    states: Dict[tuple, int] = {}

    def state_of(h: tuple) -> int:
        if h not in states:
            states[h] = b.new_state()
        return states[h]

    # histories = every context that predicts something
    hists = {()} | {ng[:-1] for ng in lm.logp} | set(lm.backoff)
    hists = {h for h in hists if len(h) < lm.order}
    # the BOS history is only a valid start if predictions exist FROM it
    # (order >= 2); a unigram LM predicts from () — starting at a
    # (BOS,) state with no outgoing arcs would dead-end the whole graph
    start_h = (BOS,) if (BOS,) in hists else ()
    # start state: fresh state with an eps arc into the BOS history so
    # FstBuilder's fixed start (state 0) maps cleanly
    b.add_arc(b.start, 0, 0, 0.0, state_of(start_h))

    for ng, logp in lm.logp.items():
        w = ng[-1]
        h = ng[:-1]
        if h not in hists:
            continue
        if w == EOS:
            b.set_final(state_of(h), -logp)
            continue
        if w == BOS or w not in word_ids:
            continue
        nh = lm.next_state(h, w)
        # land on the longest suffix that actually predicts something:
        # a history with no continuations would be a dead state (e.g.
        # EVERY word under a unigram LM, where next_state reports
        # ('w',) but only () exists)
        while nh and nh not in hists:
            nh = nh[1:]
        src = state_of(h)
        dst = state_of(nh)
        toks = [unit_ids[u] for u in word_units[w] if u in unit_ids]
        if not toks:
            continue
        # expand the word into its unit chain (the L composition)
        cur = src
        for i, t in enumerate(toks):
            last = i == len(toks) - 1
            nxt = dst if last else b.new_state()
            b.add_arc(cur, t, word_ids[w] if i == 0 else 0,
                      -logp if i == 0 else 0.0, nxt)
            cur = nxt
    # backoff epsilon arcs
    for h, bow in lm.backoff.items():
        if len(h) >= lm.order or h not in hists or not h:
            continue
        b.add_arc(state_of(h), 0, 0, -bow, state_of(h[1:]))
    # make sure every history can reach the unigram state even without an
    # explicit backoff entry (weight 0 fallback), incl. (BOS,)
    for h in hists:
        if h and h not in lm.backoff:
            b.add_arc(state_of(h), 0, 0, 0.0, state_of(h[1:]))
    # states with no </s> score: final via unigram fallback
    if (EOS,) in lm.logp:
        b.set_final(state_of(()), -lm.logp[(EOS,)])

    if ctc_blank is not None:
        # CTC topology (the Eesen-style T layer): each unit emission gets
        # its own "emitting" state r that absorbs repeat frames of THAT
        # unit only; a blank (or an eps hop to the next different-unit
        # arc) closes the token. Keying repeats per ARC — not per
        # destination state — is what makes this a valid CTC graph: a
        # destination reached by several units must not absorb other
        # units' frames, and a unit re-emitted after a blank is a NEW
        # token that pays its LM arc, never a free repeat.
        # Known approximation: the eps arc r->dst permits same-unit
        # re-emission without an intervening blank (which strict CTC
        # collapses); it only ever over-accepts, and the blank-separated
        # path scores identically or better for peaked posteriors.
        blank_il = len(units) + 1
        unit_ids[ctc_blank] = blank_il
        n0 = len(b.arcs)
        for src in range(n0):
            kept = []
            for il, ol, w, dst in list(b.arcs[src]):
                if il == 0:
                    kept.append((il, ol, w, dst))
                    continue
                r = b.new_state()
                kept.append((il, ol, w, r))       # the emission frame
                b.add_arc(r, il, 0, 0.0, r)       # repeat frames (same u)
                b.add_arc(r, blank_il, 0, 0.0, dst)   # blank closes it
                b.add_arc(r, 0, 0, 0.0, dst)      # straight to next token
            b.arcs[src] = kept
        for s in range(n0):
            b.add_arc(s, blank_il, 0, 0.0, s)     # inter-token blanks

    b.write(os.path.join(out_dir, "TLG.fst"))
    with open(os.path.join(out_dir, "words.txt"), "w",
              encoding="utf-8") as f:
        f.write("<eps> 0\n")
        for w, i in word_ids.items():
            f.write(f"{w} {i}\n")
    with open(os.path.join(out_dir, "tokens.txt"), "w",
              encoding="utf-8") as f:
        f.write("<eps> 0\n")
        for u, i in unit_ids.items():
            f.write(f"{u} {i}\n")
    return out_dir


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--arpa", required=True)
    p.add_argument("--lexicon", help="TSV: word unit1 unit2 ... "
                                     "(default: char-level over LM vocab)")
    p.add_argument("--out", required=True)
    p.add_argument("--ctc-blank", default=None,
                   help="build the CTC frame-synchronous topology (blank"
                        " + repeat self-loops) with this blank token, "
                        "e.g. '<blank>' — for SenseVoice/CTC decoding")
    args = p.parse_args(argv)
    lm = NgramLM.load_arpa(args.arpa)
    if args.lexicon:
        word_units = {}
        with open(args.lexicon, encoding="utf-8") as f:
            for line in f:
                parts = line.split()
                if len(parts) >= 2:
                    word_units[parts[0]] = parts[1:]
    else:
        word_units = {w: list(w) for w in lm.vocab
                      if w not in (BOS, EOS, "<unk>")}
    build_tlg(lm, word_units, args.out, ctc_blank=args.ctc_blank)
    print(f"TLG graph -> {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

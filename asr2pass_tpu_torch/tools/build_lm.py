#!/usr/bin/env python3
"""n-gram LM + lexicon builder (utils/ngram_tools equivalent).

Port copy of the JAX package's tools/build_lm.py (host code; the same
output files, byte for byte).

Trains a word n-gram on a text corpus (one sentence per line, Chinese
segmented greedily against the corpus vocabulary or pre-segmented by
spaces), writes ARPA + lexicon.txt (word -> AM-unit spelling) for the LM
beam decoder (decode/lm_decoder.py), replacing the SRILM + compile-TLG.fst
toolchain (train_compile_ngram.sh).

CLI: python -m asr2pass_tpu_torch.tools.build_lm corpus.txt outdir \
        [--order 3] [--interpolate other.arpa --weight 0.5]
"""
from __future__ import annotations

import argparse
import os
import sys


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("corpus")
    p.add_argument("outdir")
    p.add_argument("--order", type=int, default=3)
    p.add_argument("--char-level", action="store_true",
                   help="treat every CJK char as a word")
    p.add_argument("--interpolate", default="",
                   help="second ARPA to interpolate with")
    p.add_argument("--weight", type=float, default=0.5)
    args = p.parse_args(argv)

    from asr2pass_tpu_torch.decode.ngram import NgramLM, interpolate

    sentences = []
    with open(args.corpus, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            if " " in line and not args.char_level:
                words = line.split()
            else:
                # char-level fallback: CJK per char, latin runs as words
                words, cur = [], ""
                for ch in line:
                    if ord(ch) < 128 and not ch.isspace():
                        cur += ch
                    else:
                        if cur:
                            words.append(cur)
                            cur = ""
                        if not ch.isspace():
                            words.append(ch)
                if cur:
                    words.append(cur)
            sentences.append(words)

    lm = NgramLM.train(sentences, order=args.order)
    if args.interpolate:
        lm = interpolate(lm, NgramLM.load_arpa(args.interpolate),
                         args.weight)
    os.makedirs(args.outdir, exist_ok=True)
    arpa = os.path.join(args.outdir, "lm.arpa")
    lm.save_arpa(arpa)
    # lexicon: word -> char spelling (AM units)
    lex_path = os.path.join(args.outdir, "lexicon.txt")
    with open(lex_path, "w", encoding="utf-8") as f:
        for w in sorted(lm.vocab):
            if w.startswith("<"):
                continue
            units = list(w) if any(ord(c) > 127 for c in w) else [w]
            f.write(f"{w} {' '.join(units)}\n")
    print(f"wrote {arpa} ({len(lm.logp)} n-grams) and {lex_path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

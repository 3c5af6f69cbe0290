#!/usr/bin/env python3
"""One-command CER harness: transcribe an scp and score it against
reference text.

Port of the JAX package's tools/eval_cer.py (the methodology of the
reference's clients/python/asr_check.py:10-30 and
utils/compute-wer.py:86-225):

  # in-process (no server): the offline recognizer over a wav.scp
  python -m asr2pass_tpu_torch.tools.eval_cer --scp wav.scp --ref text \\
      --model-dir DIR [--vad-dir DIR] [--punc-dir DIR] [--itn] \\
      [--svs-dir DIR] [--device cuda|cpu] [--max-cer 5.0] [--out r.json]

  # against a RUNNING server (the port's, the JAX package's or the
  # reference's: all speak the same protocol)
  python -m asr2pass_tpu_torch.tools.eval_cer --scp wav.scp --ref text \\
      --server ws://host:10095 [--mode offline]

Inputs: kaldi layouts, wav.scp lines "utt /path.wav" and reference lines
"utt transcript...". Output: per-utt CER lines, an overall line, an
optional JSON report, and exit code 1 when --max-cer is exceeded. The
in-process path runs on the card unless --device cpu (the JAX package's
--cpu).
"""
from __future__ import annotations

import argparse
import json
import sys
import time

from asr2pass_tpu_torch.tools.transcribe import add_device_arg, read_scp


def _hyps_in_process(args, utts):
    """Transcribe through the in-process offline pipeline, made by
    tools/transcribe.build_recognizer as the transcribe CLI makes it."""
    from asr2pass_tpu_torch.frontend.audio import load_audio_file
    from asr2pass_tpu_torch.tools.transcribe import build_recognizer

    rec = build_recognizer(args)
    hyps = {}
    total_audio = 0.0
    for name, wav in utts:
        wave = load_audio_file(wav, args.fs)
        res = rec.transcribe(wave, use_itn=args.itn)
        hyps[name] = res.text
        total_audio += res.snippet_time
    return hyps, total_audio


def _hyps_server(args, utts):
    import asyncio

    from asr2pass_tpu_torch.tools.asr_client import transcribe_file

    async def run():
        hyps = {}
        total = 0.0
        for name, wav in utts:
            hyps[name], audio_s = await transcribe_file(
                args.server, wav, mode=args.mode, use_itn=args.itn)
            total += audio_s
        return hyps, total

    return asyncio.run(run())


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--scp", required=True, help="wav.scp (utt /path.wav)")
    p.add_argument("--ref", required=True,
                   help="reference transcripts (utt text...)")
    p.add_argument("--model-dir", default="",
                   help="offline Paraformer model dir (in-process path)")
    p.add_argument("--svs-dir", default="",
                   help="SenseVoice model dir instead of --model-dir")
    p.add_argument("--vad-dir", default="")
    p.add_argument("--punc-dir", default="")
    p.add_argument("--itn", action="store_true")
    p.add_argument("--server", default="",
                   help="score a RUNNING server (ws://host:port) instead "
                        "of the in-process pipeline")
    p.add_argument("--mode", default="offline",
                   help="server mode (offline/2pass)")
    p.add_argument("--fs", type=int, default=16000)
    p.add_argument("--out", default="", help="write a JSON report here")
    p.add_argument("--hyp-out", default="",
                   help="write hypotheses as kaldi text here")
    p.add_argument("--max-cer", type=float, default=None,
                   help="exit 1 if overall CER%% exceeds this gate")
    add_device_arg(p)
    args = p.parse_args(argv)
    if not args.server and not args.model_dir and not args.svs_dir:
        p.error("need --model-dir, --svs-dir or --server")

    from asr2pass_tpu_torch.tools.compute_wer import (WerStats, load_trn,
                                                      score_pair)

    utts = read_scp(args.scp)
    refs = load_trn(args.ref)
    t0 = time.time()
    if args.server:
        hyps, total_audio = _hyps_server(args, utts)
    else:
        hyps, total_audio = _hyps_in_process(args, utts)
    wall = time.time() - t0

    if args.hyp_out:
        with open(args.hyp_out, "w", encoding="utf-8") as f:
            for name, _ in utts:
                f.write(f"{name}\t{hyps.get(name, '')}\n")

    stats = WerStats()
    per_utt = []
    for name, _ in utts:
        ref = refs.get(name)
        if ref is None:
            print(f"{name} SKIPPED (no reference)")
            continue
        stats, line = score_pair(ref, hyps.get(name, ""), stats)
        per_utt.append({"utt": name, "cer": round(line["wer"] * 100, 2),
                        "sub": line["sub"], "del": line["del"],
                        "ins": line["ins"]})
        print(f"{name} CER {line['wer']*100:.2f}% S={line['sub']} "
              f"D={line['del']} I={line['ins']}")
    cer = stats.wer * 100
    print(f"Overall -> CER {cer:.2f}% [{stats.errors}/{stats.ref_len}] "
          f"S={stats.sub} D={stats.dele} I={stats.ins} "
          f"sentences={stats.sentences} "
          f"({total_audio:.1f}s audio in {wall:.1f}s)")
    if args.out:
        with open(args.out, "w", encoding="utf-8") as f:
            json.dump({"cer": round(cer, 3), "errors": stats.errors,
                       "ref_len": stats.ref_len, "sub": stats.sub,
                       "del": stats.dele, "ins": stats.ins,
                       "sentences": stats.sentences,
                       "audio_s": round(total_audio, 1),
                       "wall_s": round(wall, 1),
                       "per_utt": per_utt}, f, ensure_ascii=False,
                      indent=1)
    if args.max_cer is not None and cer > args.max_cer:
        print(f"FAIL: CER {cer:.2f}% > gate {args.max_cer:.2f}%")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Data cleaning pipeline: segment long audio, transcribe, CER-filter.

Counterpart of the JAX package's tools/segment_filter.py, over this
package's OfflineRecognizer (on the card unless --device cpu). Role of
run_seg_asr_filter.sh (SURVEY.md §2.3 #37): long recordings are
VAD-segmented, each segment transcribed, and segments kept only when the
hypothesis agrees with a reference transcript (or a second model's output)
within the reference's gates: insertions+deletions < 2 and CER <= 30%
(run_seg_asr_filter.sh:104-116). Outputs kaldi-format data
(wav.scp/text/utt2spk/segments) for training pipelines.

CLI: python -m asr2pass_tpu_torch.tools.segment_filter --scp wav.scp
        --model-dir DIR [--vad-dir DIR] [--ref-text text]
        [--cross-model-dir DIR] [--device cuda|cpu] --output-dir out/
"""
from __future__ import annotations

import argparse
import os
import sys

from asr2pass_tpu_torch.tools.transcribe import add_device_arg


def filter_segments(recognizer, wave, fs: int, ref_texts=None,
                    cross_recognizer=None,
                    max_ins_del: int = 2, max_cer: float = 0.30):
    """Segment + transcribe + gate. Two gating sources:

    * ref_texts: list aligned to segments (reference transcripts), or
    * cross_recognizer: a SECOND model transcribes the same segments and
      the primary hypothesis is gated against it — the reference's
      WhisperX-vs-Paraformer two-model cross-check
      (run_seg_asr_filter.sh:104-116); here typically SenseVoice vs
      Paraformer.

    Gates: insertions+deletions < max_ins_del and CER <= max_cer.
    Returns [(start_ms, end_ms, text, cer)] of kept segments."""
    from asr2pass_tpu_torch.tools.compute_wer import score_pair

    res = recognizer.transcribe(wave)
    kept = []
    segs = res.segments
    seg_audio = [wave[s * fs // 1000: e * fs // 1000] for s, e in segs]
    outs = recognizer.asr.recognize_batch(seg_audio)
    cross_texts = None
    if cross_recognizer is not None:
        cross_texts = [t for t, _ in
                       cross_recognizer.asr.recognize_batch(seg_audio)]
    for i, ((text, _), (s, e)) in enumerate(zip(outs, segs)):
        dur = (e - s) / 1000.0
        if dur < 0.5 or dur > 40.0:   # duration gate (stage 3)
            continue
        gate = None
        if cross_texts is not None:
            gate = cross_texts[i]
        elif ref_texts is not None and i < len(ref_texts):
            gate = ref_texts[i]
        if gate is not None:
            _, line = score_pair(gate, text)
            ins_del = line["ins"] + line["del"]
            if ins_del >= max_ins_del or line["wer"] > max_cer:
                continue
            kept.append((s, e, text, line["wer"]))
        else:
            kept.append((s, e, text, 0.0))
    return kept


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--scp", required=True)
    p.add_argument("--model-dir", required=True)
    p.add_argument("--vad-dir", default="")
    p.add_argument("--output-dir", required=True)
    p.add_argument("--ref-text", default="",
                   help="kaldi text file for CER gating")
    p.add_argument("--cross-model-dir", default="",
                   help="second-opinion model dir (e.g. a converted "
                        "SenseVoice): segments are kept only when both "
                        "models agree within the gates — the "
                        "run_seg_asr_filter.sh two-model cross-check")
    p.add_argument("--fs", type=int, default=16000)
    add_device_arg(p)
    args = p.parse_args(argv)

    from types import SimpleNamespace

    from asr2pass_tpu_torch.frontend.audio import load_audio_file
    from asr2pass_tpu_torch.tools.compute_wer import load_trn
    from asr2pass_tpu_torch.tools.transcribe import build_recognizer

    def recognizer(model_dir):
        # build_recognizer's argument names
        return build_recognizer(SimpleNamespace(
            model_dir=model_dir, vad_dir=args.vad_dir, punc_dir="",
            itn=False, device=args.device))

    rec = recognizer(args.model_dir)
    cross = (recognizer(args.cross_model_dir) if args.cross_model_dir
             else None)
    refs = load_trn(args.ref_text) if args.ref_text else {}
    os.makedirs(args.output_dir, exist_ok=True)
    with open(args.scp, encoding="utf-8") as scp, \
            open(os.path.join(args.output_dir, "wav.scp"), "w") as oscp, \
            open(os.path.join(args.output_dir, "text"), "w",
                 encoding="utf-8") as otext, \
            open(os.path.join(args.output_dir, "segments"), "w") as oseg, \
            open(os.path.join(args.output_dir, "utt2spk"), "w") as ospk:
        for line in scp:
            parts = line.strip().split()
            if not parts:
                continue
            name, path = (parts[0], parts[1]) if len(parts) > 1 \
                else (os.path.basename(parts[0]), parts[0])
            wave = load_audio_file(path, args.fs)
            ref = [refs[name]] * 1000 if name in refs else None
            kept = filter_segments(rec, wave, args.fs, ref_texts=ref,
                                   cross_recognizer=cross)
            oscp.write(f"{name}\t{path}\n")
            for s, e, text, cer in kept:
                utt = f"{name}_{s:08d}_{e:08d}"
                otext.write(f"{utt}\t{text}\n")
                oseg.write(f"{utt} {name} {s/1000:.2f} {e/1000:.2f}\n")
                ospk.write(f"{utt} {name}\n")
    print(f"wrote filtered data to {args.output_dir}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Bulk transcription: wav.scp -> per-wav transcripts, in-process.

Port of the JAX package's tools/transcribe.py (run_transcribe_audio.sh
plus the client fan-out, without a server round trip): loads the
offline pipeline once and runs each file of the scp through
OfflineRecognizer.transcribe (bucket-batched pass 2 over its VAD
segments). Runs on the card unless --device cpu.

CLI: python -m asr2pass_tpu_torch.tools.transcribe --scp wav.scp \\
        --model-dir DIR [--svs-dir DIR] [--vad-dir DIR] [--punc-dir DIR] \\
        [--itn] [--device cuda|cpu] --output-dir out/
"""
from __future__ import annotations

import argparse
import os
import sys
import time


def build_recognizer(args):
    """Offline pipeline from model-dir CLI args (shared by transcribe and
    tools/eval_cer): Paraformer (--model-dir) or SenseVoice (--svs-dir)
    pass 2, each composing with --vad-dir/--punc-dir/--itn the same way,
    on args.device (default the card)."""
    from asr2pass_tpu_torch.runtime import model_zoo
    from asr2pass_tpu_torch.runtime.offline_api import OfflineRecognizer

    device = getattr(args, "device", "cuda")
    if getattr(args, "svs_dir", ""):
        from asr2pass_tpu_torch.runtime.sensevoice_asr import (
            SenseVoiceOffline)

        b = model_zoo.load_svs_bundle(args.svs_dir)
        asr = SenseVoiceOffline(b.params, b.cfg, b.vocab, cmvn=b.cmvn,
                                device=device)
    else:
        from asr2pass_tpu_torch.runtime.offline_asr import ParaformerOffline

        b = model_zoo.load_offline_bundle(args.model_dir)
        asr = ParaformerOffline(b.params, b.cfg, b.vocab, cmvn=b.cmvn,
                                device=device)
    vad_params = vad_cfg = vad_cmvn = None
    if args.vad_dir:
        vad_params, vad_cfg, vad_cmvn = model_zoo.load_vad_dir(args.vad_dir)
        if vad_cmvn[0] is None:
            vad_cmvn = None
    punc = None
    if args.punc_dir:
        from asr2pass_tpu_torch.runtime.punc import Punctuator

        punc = Punctuator(*model_zoo.load_punc_dir(args.punc_dir),
                          device=device)
    itn = None
    if args.itn:
        from asr2pass_tpu_torch.text.itn import ChineseITN

        itn = ChineseITN()
    return OfflineRecognizer(asr, vad_params=vad_params, vad_cfg=vad_cfg,
                             vad_cmvn=vad_cmvn, punc=punc, itn=itn)


def read_scp(path: str):
    """[(name, path)] of a wav.scp: "utt /path.wav" lines, or a bare path
    named by its file name."""
    utts = []
    with open(path, encoding="utf-8") as f:
        for line in f:
            parts = line.strip().split()
            if not parts:
                continue
            utts.append((parts[0], parts[1]) if len(parts) > 1
                        else (os.path.basename(parts[0]), parts[0]))
    return utts


def add_device_arg(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", default="cuda",
                   help="run the models on this device (default the card; "
                        "cpu for the plain PyTorch path)")


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--scp", required=True)
    p.add_argument("--model-dir", default="")
    p.add_argument("--svs-dir", default="",
                   help="SenseVoice model dir instead of --model-dir")
    p.add_argument("--vad-dir", default="")
    p.add_argument("--punc-dir", default="")
    p.add_argument("--itn", action="store_true")
    p.add_argument("--output-dir", required=True)
    p.add_argument("--fs", type=int, default=16000)
    add_device_arg(p)
    args = p.parse_args(argv)
    if not args.model_dir and not args.svs_dir:
        p.error("need --model-dir or --svs-dir")

    from asr2pass_tpu_torch.frontend.audio import load_audio_file

    rec = build_recognizer(args)
    os.makedirs(args.output_dir, exist_ok=True)
    text_path = os.path.join(args.output_dir, "text")
    total_audio = 0.0
    t0 = time.time()
    with open(text_path, "w", encoding="utf-8") as out:
        for name, path in read_scp(args.scp):
            wave = load_audio_file(path, args.fs)
            res = rec.transcribe(wave)
            total_audio += res.snippet_time
            out.write(f"{name}\t{res.text}\n")
            with open(os.path.join(args.output_dir, f"{name}.asr.txt"),
                      "w", encoding="utf-8") as f:
                f.write(res.text + "\n")
    dt = time.time() - t0
    rtf = total_audio / dt if dt else 0.0
    print(f"transcribed {total_audio:.1f}s audio in {dt:.1f}s "
          f"({rtf:.1f}x realtime) -> {text_path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The Paraformer family: bulk transcription through the program's
OfflineRecognizer over ParaformerOffline (the timestamp model, with the
hotword block), the FSMN-VAD and the offline CT-Transformer; and its
comparison with the plain networks.
"""
from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

from benchmark.families import common
from benchmark.lib import flops, weights
from benchmark.reference import config as ref_config
from benchmark.reference import frontend, nets, text
from benchmark.traffic import bulk_files

CALIBRATION_SEED = 20260417


def asr_cfg(mod, node: dict):
    return mod.ParaformerConfig(
        frontend=common.frontend(mod, node["frontend"]),
        encoder=common.encoder_cfg(mod, node["encoder"]),
        decoder=mod.DecoderConfig(**node["decoder"]),
        predictor=mod.PredictorConfig(**node["predictor"]),
        vocab_size=node["vocab_size"], use_hotword=node["use_hotword"])


class Family:
    def __init__(self, node: dict):
        self.node = node
        self.cfg = asr_cfg(ref_config, node["asr"])
        self.vcfg = common.vad_cfg(ref_config, node["vad"])
        self.pcfg = common.punc_cfg(ref_config, node["punc"])
        self.tokens = common.asr_tokens(self.cfg.vocab_size)
        self.ptokens = common.punc_tokens(self.pcfg.vocab_size, self.tokens)
        self.recorder = common.Recorder()
        self.rec = None
        self.weights_s = 0.0

    # -- weights -------------------------------------------------------
    def weights(self, seed: int, device):
        """The three models' state dicts, drawn from the seed, CIF's
        output bias set to the configuration's firing rate."""
        sd = weights.make(weights.paraformer(self.cfg), seed, "asr", device)
        self.calibrate(sd, device)
        return (sd, common.vad_weights(self.node, self.vcfg, seed, device),
                common.punc_weights(self.pcfg, seed, device))

    def calibrate(self, sd, device):
        """Random weights fire CIF at a rate set by chance (0.17 to 0.59
        tokens an LFR frame over six seeds), which sets the decoder's and
        the punctuation's work, and past T/2 the program's token buffer.
        A trained model fires about once in three frames: the bias of the
        alphas' output is set so that the plain network's mean alpha over
        a fixed 10 s burst is the configuration's `cif_rate`."""
        g = torch.Generator(device=device)
        g.manual_seed(CALIBRATION_SEED)
        wave = bulk_files.synth(10.0, g, device).float().cpu().numpy()
        means, vars_ = common.cmvn(self.node["cmvn"],
                                   self.cfg.frontend.lfr_dim)
        p = self.cfg.predictor
        sd["predictor.out.b"].zero_()
        with torch.inference_mode():
            feats = frontend.offline_feats(wave, self.cfg.frontend, means,
                                           vars_, device)
            enc = nets.sanm_encoder(nets.P(sd)("encoder"), feats,
                                    self.cfg.encoder.attention_heads)
            h = torch.relu(nets.context_conv(nets.P(sd)("predictor")("conv"),
                                             enc, p.l_order, p.r_order) + enc)
            z = (h @ sd["predictor.out.w"])[:, 0].double().cpu().numpy()
        lo, hi = -40.0, 40.0
        for _ in range(80):
            b = (lo + hi) / 2
            a = np.maximum(p.smooth_factor / (1 + np.exp(-(z + b)))
                           - p.noise_threshold, 0.0)
            lo, hi = (b, hi) if a.mean() < self.node["cif_rate"] else (lo, b)
        sd["predictor.out.b"].fill_((lo + hi) / 2)

    # -- the program ---------------------------------------------------
    def build(self, seed: int, device):
        """The program's recognizer on the seed's weights; returns
        transcribe(samples) -> OfflineResult."""
        from asr2pass_tpu_torch import config as pcfg_mod
        from asr2pass_tpu_torch.runtime import offline_api
        from asr2pass_tpu_torch.runtime.offline_asr import ParaformerOffline
        from asr2pass_tpu_torch.runtime.punc import Punctuator
        from asr2pass_tpu_torch.text.punc_tokenizer import PuncTokenizer
        from asr2pass_tpu_torch.text.vocab import Vocab

        t0 = time.perf_counter()
        sd_asr, sd_vad, sd_punc = self.weights(seed, device)
        self.weights_s = time.perf_counter() - t0
        n = self.node
        asr = ParaformerOffline(
            sd_asr, asr_cfg(pcfg_mod, n["asr"]), Vocab(self.tokens),
            cmvn=common.cmvn(n["cmvn"], self.cfg.frontend.lfr_dim),
            device=device)
        punc = Punctuator(sd_punc, common.punc_cfg(pcfg_mod, n["punc"]),
                          PuncTokenizer(self.ptokens), device=device)
        rec = offline_api.OfflineRecognizer(
            asr, vad_params=sd_vad, vad_cfg=common.vad_cfg(pcfg_mod, n["vad"]),
            vad_cmvn=common.cmvn(n["vad"]["cmvn"], self.vcfg.input_dim),
            punc=punc, itn=None, vad_tail_sil=n["vad"]["max_end_sil"],
            vad_max_len=n["vad"]["max_single_segment"])
        asr.finish_batch = self.recorder.on_finish(self._unpack)(
            asr.finish_batch)
        punc._infer = self.recorder.on_infer(punc._infer)
        asr.recognize_batch = common.ranged("bench.asr", asr.recognize_batch)
        punc.add_punc = common.ranged("bench.punc", punc.add_punc)
        self.rec = rec
        self._vad = offline_api.vad_segments_offline
        offline_api.vad_segments_offline = common.ranged("bench.vad",
                                                         self._vad)
        return lambda samples: rec.transcribe(samples, use_itn=False)

    def free(self):
        from asr2pass_tpu_torch.runtime import offline_api

        offline_api.vad_segments_offline = self._vad
        self.rec = None

    def _unpack(self, pending, fetched) -> Dict[int, dict]:
        """finish_batch's host arrays: served ids, counts, the token
        buffer's size, the true LFR length and the upsampled alphas."""
        out = {}
        for rec in pending["records"]:
            arrays = [np.asarray(x) for x in
                      fetched[rec["off"]: rec["off"] + rec["n"]]]
            ids, counts = arrays[:2]
            for k, i in enumerate(rec["idxs"]):
                t = int(rec["lens"][k])
                c = int(counts[k])
                out[i] = {"ids": ids[k, :c].copy(), "cap": ids.shape[1],
                          "t": t}
                if self.cfg.predictor.use_timestamp:
                    out[i]["us"] = arrays[2][k, : 3 * t].copy()
        return out

    def _reach(self) -> int:
        """How many tokens before a changed embedding the decoder's
        centred FSMN memories carry the change (right taps x blocks)."""
        dec = self.cfg.decoder
        left = (dec.kernel_size - 1 if dec.sanm_shift is None
                else (dec.kernel_size - 1) // 2 + dec.sanm_shift)
        return (dec.kernel_size - 1 - left) * dec.num_blocks

    # -- FLOPs ---------------------------------------------------------
    def flops(self, served: common.Served) -> float:
        total = common.vad_punc_flops(served, self.vcfg, self.pcfg)
        for seg in served.segments.values():
            total += flops.paraformer(self.cfg, seg["t"], len(seg["ids"]))
        return total

    # -- the comparison ------------------------------------------------
    def check(self, files: List[common.Served], seed: int, device,
              read: common.Readings):
        """Every served file of the sample against the plain networks."""
        sd_asr, sd_vad, sd_punc = self.weights(seed, device)
        means, vars_ = common.cmvn(self.node["cmvn"],
                                   self.cfg.frontend.lfr_dim)
        thr = self.cfg.predictor.threshold - 1e-4
        for served in files:
            segs = common.check_vad(served, sd_vad, self.vcfg,
                                    self.node["vad"], device)
            read.worst("vad_off", segs != served.result.segments)
            if segs != served.result.segments:
                continue
            parts, stamps = [], []
            for i, (s, e) in enumerate(segs):
                got = served.segments.get(i)
                if got is None:
                    read.add("token_count_off", 1)
                    continue
                wave = served.samples[s * 16: e * 16]
                with torch.inference_mode():
                    feats = frontend.offline_feats(
                        wave, self.cfg.frontend, means, vars_, device)
                    ref = nets.paraformer(sd_asr, self.cfg, feats,
                                          max_tokens=got["cap"])
                self._compare(got, ref, read)
                chars = text.detok(got["ids"], self.tokens)
                if chars:
                    parts.append("".join(chars))
                    if "us" in got:
                        stamps += text.stamps_ms(
                            chars, got["us"], text.peaks(got["us"], thr), s)
            asr_text = "".join(parts)
            want = (common.check_punc(served, sd_punc, self.pcfg, asr_text,
                                    {t: i for i, t in
                                     enumerate(self.ptokens)}, read)
                    if asr_text else "")
            read.worst("text_off", want != served.result.text
                       or stamps != served.result.timestamps)

    def _compare(self, got: dict, ref: nets.ParaformerOut,
                 read: common.Readings):
        """Counts, then each served token's gap below the plain logits'
        best. A count that differs is excused only where the plain
        running sum came within the configuration's `cif_tie` of the
        threshold, one near tie a token; then the tokens whose logits
        cannot reach the tie through the decoder's memory are compared."""
        logits = ref.logits.float()
        count = logits.shape[0]
        ids = torch.as_tensor(got["ids"], device=logits.device).long()
        read.least("cif_margin", ref.margin)
        keep = count
        if len(ids) != count:
            ties = [j for dist, j in ref.near if dist < self.node["cif_tie"]]
            if len(ties) < abs(len(ids) - count):
                read.add("token_count_off", 1)
                return
            read.add("count_at_tie", 1)
            keep = max(0, min(ties) - self._reach())
        if keep:
            served = logits[:keep].gather(-1, ids[:keep, None])[:, 0]
            read.worst("argmax_gap",
                       float((logits[:keep].max(-1).values - served).max()))
        if keep < count:
            return
        if ref.us_alphas is None:
            return
        us_ref = ref.us_alphas.float().cpu().numpy()
        scale = max(float(np.abs(us_ref).max()), 1e-12)
        read.worst("us_alpha_err",
                   float(np.abs(got["us"] - us_ref).max()) / scale)

    def control(self, waves: List[np.ndarray], seed: int, device,
                read: common.Readings):
        """The reference in TF32 in the program's place, on the segments
        of each file: its own counts, argmax tokens and upsampled alphas
        read as served ones."""
        sd_asr, sd_vad, sd_punc = self.weights(seed, device)
        means, vars_ = common.cmvn(self.node["cmvn"],
                                   self.cfg.frontend.lfr_dim)
        tok2id = {t: i for i, t in enumerate(self.ptokens)}
        for wave in waves:
            parts = []
            for s, e in common.check_vad(common.Served(wave), sd_vad,
                                         self.vcfg, self.node["vad"], device):
                seg = wave[s * 16: e * 16]
                with torch.inference_mode():
                    feats = frontend.offline_feats(
                        seg, self.cfg.frontend, means, vars_, device)
                    ref = nets.paraformer(sd_asr, self.cfg, feats)
                    with common.tf32():
                        low = nets.paraformer(sd_asr, self.cfg, feats)
                got = {"ids": low.logits.argmax(-1).cpu().numpy()}
                if low.us_alphas is not None:
                    got["us"] = low.us_alphas.float().cpu().numpy()
                self._compare(got, ref, read)
                parts.append("".join(text.detok(got["ids"], self.tokens)))
            common.punc_control(sd_punc, self.pcfg, "".join(parts), tok2id,
                                read)

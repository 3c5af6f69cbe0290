"""The SenseVoice family: bulk transcription through the program's
OfflineRecognizer over SenseVoiceOffline (greedy CTC) and the FSMN-VAD;
and its comparison with the plain network.

Greedy CTC serves collapsed ids, not frames, so a served token sequence
is read under the plain network's logits through its best alignment: the
frame labelling that collapses to it (repeats merged, blanks dropped)
whose widest gap below a frame's best logit is least.
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


def asr_cfg(mod, node: dict):
    return mod.SenseVoiceConfig(
        frontend=common.frontend(mod, node["frontend"]),
        encoder=common.encoder_cfg(mod, node["encoder"]),
        vocab_size=node["vocab_size"])


def alignment_gap(gaps: np.ndarray, ids: np.ndarray, blank: int,
                  labels: np.ndarray) -> float:
    """The least, over frame labellings that collapse to `ids`, of the
    widest gap. gaps [T, S]: each frame's gap for the labels of the
    extended sequence `labels` (blank, id1, blank, ..., idU, blank)."""
    t_len, s_len = gaps.shape
    if t_len == 0:
        return 0.0 if len(ids) == 0 else np.inf
    cost = np.full(s_len, np.inf)
    cost[0] = gaps[0, 0]
    if s_len > 1:
        cost[1] = gaps[0, 1]
    # a skip over a blank is allowed between two different labels
    skip = np.zeros(s_len, bool)
    skip[2:] = (labels[2:] != blank) & (labels[2:] != labels[:-2])
    for t in range(1, t_len):
        prev = cost.copy()
        prev[1:] = np.minimum(prev[1:], cost[:-1])
        prev[2:] = np.where(skip[2:], np.minimum(prev[2:], cost[:-2]),
                            prev[2:])
        cost = np.maximum(prev, gaps[t])
    return float(min(cost[-1], cost[-2] if s_len > 1 else np.inf))


class Family:
    def __init__(self, node: dict):
        self.node = node
        self.cfg = asr_cfg(ref_config, node["asr"])
        self.tp_blocks = node["asr"]["tp_blocks"]
        self.vcfg = common.vad_cfg(ref_config, node["vad"])
        self.tokens = common.asr_tokens(self.cfg.vocab_size)
        self.lid = dict(self.cfg.lid_pairs)[node["lang"]]
        self.tn = dict(self.cfg.textnorm_pairs)[node["textnorm"]]
        self.recorder = common.Recorder()
        self.rec = None
        self.weights_s = 0.0

    def weights(self, seed: int, device):
        return (weights.make(weights.sensevoice(self.cfg, self.tp_blocks),
                             seed, "asr", device),
                common.vad_weights(self.node, self.vcfg, seed, device))

    def build(self, seed: int, device):
        from asr2pass_tpu_torch import config as pcfg_mod
        from asr2pass_tpu_torch.runtime import offline_api
        from asr2pass_tpu_torch.runtime.sensevoice_asr import \
            SenseVoiceOffline
        from asr2pass_tpu_torch.text.vocab import Vocab

        t0 = time.perf_counter()
        sd_asr, sd_vad = self.weights(seed, device)
        self.weights_s = time.perf_counter() - t0
        n = self.node
        asr = SenseVoiceOffline(
            sd_asr, asr_cfg(pcfg_mod, n["asr"]), Vocab(self.tokens),
            cmvn=common.cmvn(n["cmvn"], self.cfg.frontend.lfr_dim),
            lang=n["lang"], use_itn_token=n["textnorm"] == "withitn",
            device=device)
        rec = offline_api.OfflineRecognizer(
            asr, vad_params=sd_vad, vad_cfg=common.vad_cfg(pcfg_mod, n["vad"]),
            vad_cmvn=common.cmvn(n["vad"]["cmvn"], self.vcfg.input_dim),
            punc=None, itn=None, vad_tail_sil=n["vad"]["max_end_sil"],
            vad_max_len=n["vad"]["max_single_segment"])
        asr.finish_batch = self.recorder.on_finish(self._unpack)(
            asr.finish_batch)
        asr.recognize_batch = common.ranged("bench.asr", asr.recognize_batch)
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
        """finish_batch's host arrays: served ids, the meta positions'
        argmax and the true length."""
        out = {}
        for rec in pending["records"]:
            ids, counts, meta, lengths = (np.asarray(x) for x in
                                          fetched[rec["off"]: rec["off"] + 4])
            for k, i in enumerate(rec["idxs"]):
                c = int(counts[k])
                out[i] = {"ids": ids[k, :c].copy(), "meta": meta[k].copy(),
                          "t": int(lengths[k]) - nets.NUM_META}
        return out

    def flops(self, served: common.Served) -> float:
        total = common.vad_punc_flops(served, self.vcfg, None)
        for seg in served.segments.values():
            total += flops.sensevoice(self.cfg, seg["t"], self.tp_blocks)
        return total

    def check(self, files: List[common.Served], seed: int, device,
              read: common.Readings):
        sd_asr, sd_vad = self.weights(seed, device)
        for served in files:
            segs = common.check_vad(served, sd_vad, self.vcfg,
                                    self.node["vad"], device)
            read.worst("vad_off", segs != served.result.segments)
            if segs != served.result.segments:
                continue
            parts = []
            for i, (s, e) in enumerate(segs):
                got = served.segments.get(i)
                if got is None:
                    read.add("token_count_off", 1)
                    continue
                logits = self._logits(sd_asr, served.samples[s * 16: e * 16],
                                      device)
                self._compare(got, logits, read)
                parts.append("".join(text.detok(got["ids"], self.tokens)))
            read.worst("text_off", "".join(parts) != served.result.text)

    def _logits(self, sd_asr, wave, device) -> torch.Tensor:
        means, vars_ = common.cmvn(self.node["cmvn"],
                                   self.cfg.frontend.lfr_dim)
        with torch.inference_mode():
            feats = frontend.offline_feats(wave, self.cfg.frontend, means,
                                           vars_, device)
            return nets.sensevoice(sd_asr, self.cfg, feats, self.lid,
                                   self.tn).float()

    def _compare(self, got: dict, logits: torch.Tensor,
                 read: common.Readings):
        m = nets.NUM_META
        best = logits.max(-1).values
        meta = torch.as_tensor(got["meta"], device=logits.device).long()
        meta_gap = best[:m] - logits[:m].gather(-1, meta[:, None])[:, 0]
        ids = np.asarray(got["ids"], np.int64)
        blank = self.cfg.blank_id
        labels = np.full(2 * len(ids) + 1, blank, np.int64)
        labels[1::2] = ids
        frames = logits[m:]
        gaps = (best[m:, None] - frames[:, torch.as_tensor(
            labels, device=logits.device)]).cpu().numpy()
        read.worst("argmax_gap", max(float(meta_gap.max()),
                                    alignment_gap(gaps, ids, blank, labels)))

    def control(self, waves: List[np.ndarray], seed: int, device,
                read: common.Readings):
        """The reference in TF32 in the program's place: its greedy ids
        read through the fp32 logits."""
        sd_asr, sd_vad = self.weights(seed, device)
        for wave in waves:
            for s, e in common.check_vad(common.Served(wave), sd_vad,
                                         self.vcfg, self.node["vad"], device):
                seg = wave[s * 16: e * 16]
                ref = self._logits(sd_asr, seg, device)
                with common.tf32():
                    low = self._logits(sd_asr, seg, device)
                am = low.argmax(-1).cpu().numpy()
                keep = [am[t] for t in range(nets.NUM_META, len(am))
                        if am[t] != self.cfg.blank_id
                        and (t == nets.NUM_META or am[t] != am[t - 1])]
                self._compare({"ids": np.asarray(keep, np.int64),
                               "meta": am[: nets.NUM_META]}, ref, read)

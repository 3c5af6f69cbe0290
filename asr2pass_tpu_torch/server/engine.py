"""Server-side model registry + per-connection session factory.

Counterpart of asr2pass_tpu/server/engine.py (ServerModels), with the
fields of the ported modules only: the offline (pass-2) and streaming
(pass-1) Paraformers, FSMN-VAD, punctuation, ITN, server-side hotwords
and the device. Models are built once, on the device, and shared
read-only; each websocket connection gets its own TwoPassSession
(per-connection VAD/ASR/punc caches), mirroring TpassOnlineStream-per-
connection (websocket-server-2pass.h:49-65). SenseVoice, LM/TLG
rescoring, the hotword compiler and model parallelism come with later
slices (ROADMAP queue 1 items 14, 15, 16, 18).
"""
from __future__ import annotations

import dataclasses
import threading
from collections import OrderedDict
from dataclasses import dataclass
from typing import Any, Optional

import numpy as np
from torch import nn

from asr2pass_tpu_torch.config import ParaformerConfig, PuncConfig, VadConfig
from asr2pass_tpu_torch.models import ct_transformer, fsmn_vad, paraformer
from asr2pass_tpu_torch.runtime.asr_stream import ParaformerOnlineStream
from asr2pass_tpu_torch.runtime.offline_api import OfflineRecognizer
from asr2pass_tpu_torch.runtime.offline_asr import ParaformerOffline
from asr2pass_tpu_torch.runtime.punc import Punctuator
from asr2pass_tpu_torch.runtime.two_pass import TwoPassSession
from asr2pass_tpu_torch.runtime.vad_stream import FsmnVadStream
from asr2pass_tpu_torch.text.vocab import Vocab
from asr2pass_tpu_torch.utils import fp32_products, resolve_device


def _on_device(params, build, device):
    """A module (moved to `device`) or a state dict (built there once)."""
    if params is None:
        return None
    if isinstance(params, nn.Module):
        return params.to(device).eval().requires_grad_(False)
    return build(params)


@dataclass
class ServerModels:
    """Everything loaded at server start (initAsr/FunTpassInit role).
    The *_params fields take modules or state dicts (as model_zoo's
    loaders return them); construction turns each into one module on
    `device` (default the card; device="cpu" for the plain PyTorch
    path), which every session, recognizer and the engine share."""

    asr_params: Any
    asr_cfg: ParaformerConfig
    vocab: Vocab
    asr_cmvn: Any = None
    online_params: Any = None          # defaults to asr_params (2pass share)
    online_cfg: Optional[ParaformerConfig] = None
    vad_params: Any = None
    vad_cfg: Optional[VadConfig] = None
    vad_cmvn: Any = None
    punc_params: Any = None
    punc_cfg: Optional[PuncConfig] = None
    punc_tokenizer: Any = None
    itn: Any = None
    # server-side hotwords merged with per-connection ones
    server_hotwords: Any = None
    device: Any = "cuda"

    def __post_init__(self):
        self.device = dev = resolve_device(self.device)
        fp32_products()
        self.asr_params = _on_device(
            self.asr_params,
            lambda sd: paraformer.from_state_dict(sd, self.asr_cfg, dev), dev)
        self.online_params = _on_device(
            self.online_params,
            lambda sd: paraformer.from_state_dict(
                sd, self.online_cfg or self.asr_cfg, dev), dev)
        self.vad_params = _on_device(
            self.vad_params,
            lambda sd: fsmn_vad.from_state_dict(sd, self.vad_cfg, dev), dev)
        self.punc_params = _on_device(
            self.punc_params,
            lambda sd: ct_transformer.from_state_dict(sd, self.punc_cfg, dev),
            dev)
        self._res_lock = threading.RLock()
        self._offline_rec_cache: "OrderedDict" = OrderedDict()

    def _punctuator(self) -> Optional[Punctuator]:
        if self.punc_params is None:
            return None
        return Punctuator(self.punc_params, self.punc_cfg,
                          self.punc_tokenizer, device=self.device)

    def compile_hotwords(self, hotwords: dict) -> Optional[np.ndarray]:
        """hotword dict {word: score} -> [N, D] NN embeddings
        (CompileHotwordEmbedding role, paraformer.cpp:592-693). Without a
        hotword model this is None, as in the JAX package; the port has
        no hotword compiler yet (ROADMAP queue 1 item 15)."""
        return None

    def create_session(self, mode: str = "2pass",
                       vad_tail_sil: Optional[int] = None,
                       vad_max_len: Optional[int] = None,
                       hw_emb: Optional[np.ndarray] = None,
                       use_itn: bool = True,
                       chunk_size=None) -> TwoPassSession:
        if self.vad_params is None:
            raise ValueError("2pass/online needs a VAD model")
        vad = FsmnVadStream(
            self.vad_params, self.vad_cfg, cmvn=self.vad_cmvn, online=True,
            max_end_sil=vad_tail_sil, max_single_segment=vad_max_len,
            device=self.device)
        online = None
        if mode != "offline":
            ocfg = self.online_cfg or self.asr_cfg
            if chunk_size is not None \
                    and tuple(chunk_size) != tuple(ocfg.chunk_size):
                # per-connection chunk geometry (the reference plumbs the
                # first message's chunk_size into the online config,
                # websocket-server-2pass.cpp:424-523)
                ocfg = dataclasses.replace(ocfg, chunk_size=tuple(chunk_size))
            oparams = (self.online_params if self.online_params is not None
                       else self.asr_params)
            online = ParaformerOnlineStream(
                oparams, ocfg, Vocab(self.vocab.tokens, self.vocab.lang),
                cmvn=self.asr_cmvn, device=self.device)
        offline = None
        if mode != "online":
            offline = ParaformerOffline(self.asr_params, self.asr_cfg,
                                        self.vocab, cmvn=self.asr_cmvn,
                                        device=self.device)
        return TwoPassSession(
            vad, online, offline, punc=self._punctuator(), itn=self.itn,
            mode=mode, hw_emb=hw_emb, use_itn=use_itn)

    def create_offline_recognizer(self, vad_tail_sil: int = 800,
                                  vad_max_len: int = 60000,
                                  hotwords: Optional[dict] = None
                                  ) -> OfflineRecognizer:
        """Offline (whole-file) recognizer with VAD, punctuation and ITN.
        `hotwords` select LM and SenseVoice biasing in the JAX package,
        neither of which is ported yet."""
        asr = ParaformerOffline(self.asr_params, self.asr_cfg, self.vocab,
                                cmvn=self.asr_cmvn, device=self.device)
        return OfflineRecognizer(
            asr, vad_params=self.vad_params, vad_cfg=self.vad_cfg,
            vad_cmvn=self.vad_cmvn, punc=self._punctuator(), itn=self.itn,
            vad_tail_sil=vad_tail_sil, vad_max_len=vad_max_len)

    def offline_recognizer_cached(self, vad_tail_sil: int = 800,
                                  vad_max_len: int = 60000,
                                  hotwords: Optional[dict] = None,
                                  max_cached: int = 32
                                  ) -> OfflineRecognizer:
        """Per-request offline recognizer, cached by its option tuple —
        the server must NOT rebuild recognizers on every offline upload.
        LRU-bounded so a hostile stream of unique hotword sets cannot grow
        memory unboundedly."""
        key = (vad_tail_sil, vad_max_len,
               tuple(sorted(hotwords.items())) if hotwords else None)
        with self._res_lock:
            rec = self._offline_rec_cache.get(key)
            if rec is not None:
                self._offline_rec_cache.move_to_end(key)
                return rec
        rec = self.create_offline_recognizer(
            vad_tail_sil=vad_tail_sil, vad_max_len=vad_max_len,
            hotwords=hotwords)
        with self._res_lock:
            self._offline_rec_cache[key] = rec
            while len(self._offline_rec_cache) > max_cached:
                self._offline_rec_cache.popitem(last=False)
        return rec

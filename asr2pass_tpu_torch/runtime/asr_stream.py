"""Host wrapper of one streaming-ASR stream (pass 1).

Counterpart of the JAX package's runtime/asr_stream.py: feeds raw samples
through the streaming front-end, assembles `center`-frame chunks and
drives the batched online step with B=1. The state lives on the model's
device; each chunk brings back its token ids and count in one copy.
"""
from __future__ import annotations

from typing import List, Mapping, Union

import numpy as np
import torch
from torch import nn

from asr2pass_tpu_torch.config import ParaformerConfig
from asr2pass_tpu_torch.models import paraformer, paraformer_online
from asr2pass_tpu_torch.runtime.streaming_frontend import StreamingFrontend
from asr2pass_tpu_torch.text.vocab import Vocab
from asr2pass_tpu_torch.utils import fp32_products, resolve_device


class ParaformerOnlineStream:
    """params: a Paraformer module or its state dict; it runs on `device`
    (default the card; device="cpu" for the plain PyTorch path)."""

    def __init__(self, params: Union[nn.Module, Mapping[str, torch.Tensor]],
                 cfg: ParaformerConfig, vocab: Vocab, cmvn=None,
                 device="cuda"):
        self.device = resolve_device(device)
        fp32_products()
        if isinstance(params, nn.Module):
            self.params = params.to(self.device).eval().requires_grad_(False)
        else:
            self.params = paraformer.from_state_dict(params, cfg,
                                                     self.device)
        self.cfg = cfg
        self.vocab = vocab
        means, vars_ = (cmvn if cmvn is not None else (None, None))
        self.frontend = StreamingFrontend(cfg.frontend, means, vars_,
                                          device=self.device)
        self.state = paraformer_online.init_state(self.params, cfg, 1)
        self._pending = np.zeros((0, cfg.frontend.lfr_dim), np.float32)

    def reset(self):
        self.frontend.reset()
        self.state = paraformer_online.init_state(self.params, self.cfg, 1)
        self._pending = self._pending[:0]
        self.vocab.reset_streaming()

    def _run_chunk(self, feats: np.ndarray, is_final: bool) -> List[int]:
        center = self.cfg.chunk_size[1]
        n = feats.shape[0]
        padded = np.zeros((1, center, self.cfg.frontend.lfr_dim), np.float32)
        padded[0, :n] = feats
        dev = self.device
        self.state, ids, counts = paraformer_online.step(
            self.params, self.cfg, self.state,
            torch.from_numpy(padded).to(dev),
            torch.tensor([n], dtype=torch.int32, device=dev),
            torch.tensor([is_final], device=dev))
        # one device-to-host copy: the count, then the ids
        row = torch.cat([counts[:1], ids[0]]).cpu().tolist()
        return row[1: 1 + row[0]]

    def accept(self, samples: np.ndarray, is_final: bool = False) -> str:
        """Feed samples; returns the new partial text of this call."""
        center = self.cfg.chunk_size[1]
        feats = self.frontend.accept(samples, is_final)
        if feats.shape[0]:
            self._pending = np.concatenate([self._pending, feats])
        ids: List[int] = []
        while self._pending.shape[0] >= center:
            ids.extend(self._run_chunk(self._pending[:center], False))
            self._pending = self._pending[center:]
        if is_final:
            ids.extend(self._run_chunk(self._pending, True))
            self._pending = self._pending[:0]
            text = self.vocab.to_string(ids, streaming=True)
            self.reset()
            return text
        return self.vocab.to_string(ids, streaming=True)

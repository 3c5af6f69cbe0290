"""Punctuation restoration: offline windows + streaming cache.

Counterpart of the JAX package's runtime/punc.py: the model runs on the
device over ids padded to a 10-token bucket, and the class ids come back
to the host in one copy a window. Host-side orchestration around the
CT-Transformer model:
  * offline — 20-token mini-sentence windows with RemainIDs/RemainStr carry
    split at the last 。/？, comma-promotion past the 200-token cache limit,
    English spacing, forced sentence-final period
    (ct-transformer.cpp:39-155)
  * streaming — prepends the un-terminated cache sentence, builds the
    VadMask so cache tokens cannot attend to new text, skips re-emitting
    cached tokens, re-caches text after the last sentence end, and drops a
    trailing punctuation so partial sentences keep growing
    (ct-transformer-online.cpp:40-152)
Spans (runtime/metrics): punc.window around each window's model call,
punc.fetch around its one copy to the host.
"""
from __future__ import annotations

from typing import List, Mapping, Tuple, Union

import numpy as np
import torch
from torch import nn

from asr2pass_tpu_torch.config import PuncConfig
from asr2pass_tpu_torch.models import ct_transformer
from asr2pass_tpu_torch.runtime.metrics import GLOBAL as METRICS
from asr2pass_tpu_torch.text.punc_tokenizer import (
    COMMA_INDEX,
    DUN_INDEX,
    NOTPUNC_INDEX,
    PERIOD_INDEX,
    QUESTION_INDEX,
    UNKNOWN_INDEX,
    PuncTokenizer,
)
from asr2pass_tpu_torch.utils import fp32_products, resolve_device

_NO_EMIT = (NOTPUNC_INDEX, UNKNOWN_INDEX)

_BUCKET = 10


class Punctuator:
    """params: a CtTransformer module or its state dict, run on `device`
    (default the card; device="cpu" for the plain PyTorch path)."""

    def __init__(self, params: Union[nn.Module, Mapping[str, torch.Tensor]],
                 cfg: PuncConfig, tokenizer: PuncTokenizer, device="cuda"):
        self.device = resolve_device(device)
        fp32_products()
        if isinstance(params, nn.Module):
            self.params = params.to(self.device).eval().requires_grad_(False)
        else:
            self.params = ct_transformer.from_state_dict(params, cfg,
                                                         self.device)
        self.cfg = cfg
        self.tok = tokenizer

    # -- model call -------------------------------------------------------
    @torch.inference_mode()
    def _infer(self, ids: List[int], cache_size: int = 0) -> List[int]:
        n = len(ids)
        if n == 0:
            return []
        with METRICS.stage("punc.window"):
            bucket = -(-n // _BUCKET) * _BUCKET
            arr = np.zeros((1, bucket), np.int64)
            arr[0, :n] = ids
            am = np.ones((bucket, bucket), np.float32)
            am[:n, :n] = ct_transformer.vad_mask(n, cache_size)
            dev = self.device
            logits = ct_transformer.apply(
                self.params, self.cfg, torch.from_numpy(arr).to(dev),
                torch.tensor([n], device=dev), torch.from_numpy(am).to(dev))
            classes = logits[0, :n].argmax(dim=-1)
            with METRICS.stage("punc.fetch"):
                return classes.cpu().tolist()

    # -- shared window loop ----------------------------------------------
    def _windows(self, tokens: List[str], ids: List[int],
                 cache_size: int = 0
                 ) -> Tuple[List[str], List[int]]:
        """Run the 20-token mini-sentence loop; returns (all window tokens
        in order, their punc ids)."""
        tl = self.cfg.token_len
        total = max(1, -(-len(ids) // tl))
        remain_ids: List[int] = []
        remain_str: List[str] = []
        out_tokens: List[str] = []
        out_punc: List[int] = []
        for bi in range(total):
            w_ids = remain_ids + ids[bi * tl: (bi + 1) * tl]
            w_str = remain_str + tokens[bi * tl: (bi + 1) * tl]
            punc = self._infer(w_ids, cache_size if bi == 0 else 0)
            if bi < total - 1:
                sent_end = -1
                last_comma = -1
                for i in range(len(punc) - 2, 0, -1):
                    if punc[i] in (PERIOD_INDEX, QUESTION_INDEX):
                        sent_end = i
                        break
                    if last_comma < 0 and punc[i] == COMMA_INDEX:
                        last_comma = i
                if (sent_end < 0 and last_comma > 0
                        and len(w_str) > self.cfg.cache_pop_trigger_limit):
                    sent_end = last_comma
                    punc[sent_end] = PERIOD_INDEX
                remain_str = w_str[sent_end + 1:]
                remain_ids = w_ids[sent_end + 1:]
                w_str = w_str[: sent_end + 1]
                punc = punc[: sent_end + 1]
            out_tokens.extend(w_str)
            out_punc.extend(punc)
        return out_tokens, out_punc

    # -- offline ----------------------------------------------------------
    def add_punc(self, text: str, lang: str = "zh") -> str:
        """Offline punctuation (AddPunc, ct-transformer.cpp:39-155)."""
        if not text:
            return text
        tokens, ids = self.tok.tokenize(text)
        if not tokens:
            return text
        out_tokens, out_punc = self._windows(tokens, ids)
        parts: List[str] = []
        for i, (t, p) in enumerate(zip(out_tokens, out_punc)):
            if (i > 0 and ord(out_tokens[i - 1][0]) < 128
                    and ord(t[0]) < 128):
                parts.append(" ")
            parts.append(t)
            if p not in _NO_EMIT:
                parts.append(self.tok.id2punc(p))
        # force sentence-final period
        if parts:
            last = parts[-1]
            if last in (self.tok.id2punc(COMMA_INDEX),
                        self.tok.id2punc(DUN_INDEX)):
                parts[-1] = self.tok.id2punc(PERIOD_INDEX)
            elif last not in (self.tok.id2punc(PERIOD_INDEX),
                              self.tok.id2punc(QUESTION_INDEX)):
                parts.append(self.tok.id2punc(PERIOD_INDEX))
        result = "".join(parts)
        if lang == "en-bpe":
            for zh, en in zip(["，", "。", "、", "？"], [",", ".", ",", "?"]):
                result = result.replace(zh, en)
        return result

    # -- streaming --------------------------------------------------------
    def add_punc_streaming(self, text: str, cache: List[str]) -> str:
        """Streaming punctuation with cache carry; mutates `cache` in place
        (AddPunc-with-cache, ct-transformer-online.cpp:40-152)."""
        cache_text = "".join(cache)
        if (cache_text and ord(cache_text[-1]) < 128
                and text and ord(text[0]) < 128):
            cache_text += " "
        full = cache_text + text
        if not full:
            return ""
        tokens, ids = self.tok.tokenize(full)
        if not tokens:
            return ""
        cache_words = len(self.tok.tokenize("".join(cache))[0]) if cache else 0
        out_tokens, out_punc = self._windows(tokens, ids, cache_words)
        # assemble, skipping cached tokens
        words: List[str] = []
        for i, (t, p) in enumerate(zip(out_tokens, out_punc)):
            tt = t
            if (ord(t[0]) < 128 and i + 1 < len(out_tokens)
                    and ord(out_tokens[i + 1][0]) < 128):
                tt = t + " "
            if i >= cache_words:
                words.append(tt)
                if p not in _NO_EMIT:
                    words.append(self.tok.id2punc(p))
        # cache = words after the last sentence end
        sent_end = -1
        for i in range(len(out_punc) - 2, 0, -1):
            if out_punc[i] in (PERIOD_INDEX, QUESTION_INDEX):
                sent_end = i
                break
        cache[:] = out_tokens[sent_end + 1:]
        # drop a trailing punc so the partial sentence keeps growing
        if words and self.tok.is_punc(words[-1]):
            words = words[:-1]
        return "".join(words)

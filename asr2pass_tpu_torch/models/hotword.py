"""Hotword embedding compiler (the model_eb equivalent).

Counterpart of the JAX package's models/hotword.py. Role of
Paraformer::CompileHotwordEmbedding (paraformer.cpp:592-693): each
hotword is tokenized to AM-unit ids (chars for Chinese; seg-dict/BPE or
<unk> for English words), padded to max length 10, run through an
embedding + LSTM, and the output row at the word's last position becomes
its [D] embedding; the matrix of all hotwords conditions the decoder's
bias cross-attention (sanm_decoder's hotword block). Row 0 is the null
row, the bias attention's no-op target: learned (`null`) where the
weights carry one, else derived as the reference does, by running one
<s> entry (id 1, length 1) in the same batch.

The compile is one batched forward on the module's device: an embedding
lookup, the LSTM's loop over the 10 positions, one gather.
"""
from __future__ import annotations

from typing import List, Mapping, Optional

import numpy as np
import torch
from torch import nn

from asr2pass_tpu_torch.config import HotwordConfig
from asr2pass_tpu_torch.models.layers import (Embedding, Lstm, embedding,
                                              lstm_apply)
from asr2pass_tpu_torch.utils import resolve_device


class Hotword(nn.Module):
    """embed [vocab, embed_dim], lstm (embed_dim -> hidden_dim) and, in
    models trained with one, the learned null row [hidden_dim]."""

    def __init__(self, vocab_size: int, embed_dim: int, hidden_dim: int,
                 learned_null: bool = True, generator=None, device=None):
        super().__init__()
        self.embed = Embedding(vocab_size, embed_dim, generator=generator,
                               device=device)
        self.lstm = Lstm(embed_dim, hidden_dim, generator=generator,
                         device=device)
        self.null = None
        if learned_null:
            null = torch.empty(hidden_dim, device=device)
            self.null = nn.Parameter(null.normal_(generator=generator)
                                     * 0.02)


def init(cfg: HotwordConfig, generator: Optional[torch.Generator] = None,
         device="cuda", learned_null: bool = True) -> Hotword:
    """Random weights with the shapes and distributions of the JAX init
    (N(0, 0.02) table and null row, uniform LSTM). learned_null=False
    gives the layout of a converted checkpoint, which has no null row."""
    dev = resolve_device(device)
    with torch.no_grad():
        return Hotword(cfg.vocab_size, cfg.embed_dim, cfg.hidden_dim,
                       learned_null, generator=generator, device=dev)


def from_state_dict(state_dict: Mapping[str, torch.Tensor],
                    device="cuda") -> Hotword:
    """Inference module on `device` holding `state_dict` (as
    model_zoo.load_offline_bundle returns it in hotword_params). The
    sizes come from the weights, as the JAX compiler reads them from its
    parameter tree; the null row exists iff the weights carry it."""
    dev = resolve_device(device)
    vocab, embed_dim = state_dict["embed.table"].shape
    model = Hotword(vocab, embed_dim, state_dict["lstm.wh.w"].shape[0],
                    learned_null="null" in state_dict, device="meta")
    model.load_state_dict(state_dict, assign=True)
    return model.to(dev).eval().requires_grad_(False)


def tokenize_hotword(word: str, vocab, seg_dict=None,
                     max_len: int = 10) -> List[int]:
    """Hotword -> AM unit ids: per-char for CJK; seg-dict BPE pieces (or
    whole-token / <unk>) for latin words (paraformer.cpp:602-640)."""
    ids: List[int] = []
    latin = ""

    def flush_latin():
        nonlocal latin
        if not latin:
            return
        if seg_dict is not None:
            for piece in seg_dict.get_tokens(latin):
                ids.append(vocab.token2id.get(piece,
                                              vocab.token2id.get("<unk>", 0)))
        else:
            ids.append(vocab.token2id.get(latin,
                                          vocab.token2id.get("<unk>", 0)))
        latin = ""

    for ch in word:
        if ord(ch) < 128:
            if ch.isspace():
                flush_latin()
            else:
                latin += ch
        else:
            flush_latin()
            ids.append(vocab.token2id.get(ch,
                                          vocab.token2id.get("<unk>", 0)))
    flush_latin()
    return ids[:max_len]


@torch.inference_mode()
def compile_hotwords(params: Hotword, cfg: HotwordConfig, words: List[str],
                     vocab, seg_dict=None) -> Optional[np.ndarray]:
    """[N hotwords] -> [N+1, D] float32 embeddings on the host (row 0 =
    null), or None for no words. One forward on the module's device."""
    if not words:
        return None
    # a converted model_eb checkpoint carries no learned null row; the
    # reference derives it by running the compiler on a single <s> entry
    # (id 1, length 1) in the hotword batch (paraformer.cpp:645-649), as
    # row 0 here. The bias cross-attention has no positional encoding
    # over hotword rows, so the row's place does not matter.
    derive_null = params.null is None
    n = len(words) + (1 if derive_null else 0)
    ids = np.zeros((n, cfg.max_hotword_len), np.int64)
    lens = np.zeros(n, np.int64)
    off = 0
    if derive_null:
        ids[0, 0] = 1
        lens[0] = 1
        off = 1
    for i, w in enumerate(words):
        toks = tokenize_hotword(w, vocab, seg_dict, cfg.max_hotword_len)
        if not toks:
            toks = [0]
        ids[off + i, : len(toks)] = toks
        lens[off + i] = len(toks)
    dev = params.embed.table.device
    hs = lstm_apply(params.lstm,
                    embedding(params.embed, torch.from_numpy(ids).to(dev)))
    last = torch.from_numpy(lens - 1).to(dev)
    rows = hs[torch.arange(n, device=dev), last]          # [N, H]
    if not derive_null:
        rows = torch.cat([params.null[None, :], rows], dim=0)
    return rows.float().cpu().numpy()


class SegDict:
    """English word -> BPE token list (seg_dict TSV,
    seg_dict.cpp:39-47 role)."""

    def __init__(self, path: Optional[str] = None):
        self.map = {}
        if path:
            with open(path, encoding="utf-8") as f:
                for line in f:
                    parts = line.rstrip("\n").split("\t")
                    if len(parts) == 2:
                        self.map[parts[0]] = parts[1].split()

    def get_tokens(self, word: str) -> List[str]:
        return self.map.get(word.lower(), [word.lower()])

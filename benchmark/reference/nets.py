"""Plain PyTorch forwards of the models the benchmark serves: the SAN-M
encoder, the CIF predictor with its bicif timestamp head, the Paraformer
decoder, SenseVoice's CTC model, the FSMN-VAD net and the CT-Transformer.

Each forward runs one utterance at its true length (batch 1, no padding,
no bucket), in float32, with attention as two einsums and a softmax. The
math follows the published FunASR models as the port's models/ package
writes them down; the parameter names are the port's state-dict keys, so
one state dict made by the benchmark feeds the program and this file. It
imports nothing of the program.

A parameter tree here is a plain dict of tensors, read through `P`:
P(sd, "encoder.rest.3.att.qkv")["w"] is sd["encoder.rest.3.att.qkv.w"].
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

Tensor = torch.Tensor
NUM_META = 4   # SenseVoice's lid, emotion, event and textnorm positions


class P:
    """A view of the state dict under a key prefix."""

    def __init__(self, sd: Dict[str, Tensor], prefix: str = ""):
        self.sd = sd
        self.prefix = prefix

    def __call__(self, name) -> "P":
        return P(self.sd, f"{self.prefix}{name}.")

    def __getitem__(self, key: str) -> Tensor:
        return self.sd[self.prefix + key]

    def has(self, key: str) -> bool:
        return self.prefix + key in self.sd

    def count(self, name: str) -> int:
        """Number of entries of the list `name` (keys name.<i>.*)."""
        head = f"{self.prefix}{name}."
        idx = {k[len(head):].split(".", 1)[0] for k in self.sd
               if k.startswith(head)}
        return len({i for i in idx if i.isdigit()})


# -- primitives --------------------------------------------------------------

def dense(p: P, x: Tensor) -> Tensor:
    y = x @ p["w"]
    return y + p["b"] if p.has("b") else y


def layer_norm(p: P, x: Tensor, eps: float = 1e-5) -> Tensor:
    mean = x.mean(dim=-1, keepdim=True)
    var = (x - mean).square().mean(dim=-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * p["g"] + p["b"]


def posenc(length: int, depth: int, device) -> Tensor:
    """1-based sinusoidal positions, [sin | cos] over depth/2 scales."""
    inc = math.log(10000.0) / (depth // 2 - 1)
    inv = torch.exp(torch.arange(depth // 2, dtype=torch.float32,
                                 device=device) * -inc)
    pos = torch.arange(1, length + 1, dtype=torch.float32, device=device)
    s = pos[:, None] * inv[None, :]
    return torch.cat([torch.sin(s), torch.cos(s)], dim=-1)


def memory(taps: Tensor, x: Tensor, left: int) -> Tensor:
    """FSMN memory over [T, D]: x + sum_k taps[k] * x[t + k - left], with
    zeros outside the utterance."""
    kernel = taps.shape[0]
    t = x.shape[0]
    pad = F.pad(x, (0, 0, left, kernel - 1 - left))
    out = torch.zeros_like(x)
    for k in range(kernel):
        out = out + pad[k: k + t] * taps[k]
    return x + out


def attend(q: Tensor, k: Tensor, v: Tensor, heads: int,
           allowed: Optional[Tensor] = None) -> Tensor:
    """Multi-head attention over [Tq, D], [Tk, D]: softmax(q k^T / sqrt(d))
    v per head. allowed [Tq, Tk] (1 = may attend) is the punctuation
    model's VadMask."""
    tq, d = q.shape
    dk = d // heads
    qh = q.reshape(tq, heads, dk).transpose(0, 1)
    kh = k.reshape(-1, heads, dk).transpose(0, 1)
    vh = v.reshape(-1, heads, dk).transpose(0, 1)
    s = torch.einsum("htd,hsd->hts", qh, kh) / math.sqrt(dk)
    if allowed is not None:
        s = s.masked_fill(allowed[None] <= 0, -1e30)
    w = torch.softmax(s, dim=-1)
    return torch.einsum("hts,hsd->htd", w, vh).transpose(0, 1).reshape(tq, d)


def ffn(p: P, x: Tensor) -> Tensor:
    return dense(p("w2"), torch.relu(dense(p("w1"), x)))


# -- SAN-M encoder ------------------------------------------------------------

def sanm_block(p: P, x: Tensor, heads: int, residual: bool,
               allowed: Optional[Tensor] = None) -> Tensor:
    """Pre-norm SAN-M block: self-attention plus the FSMN memory of the
    values, then the feed-forward, each with its residual."""
    h = layer_norm(p("ln1"), x)
    qkv = dense(p("att")("qkv"), h)
    d = qkv.shape[-1] // 3
    q, k, v = qkv.split(d, dim=-1)
    taps = p("att")("fsmn")["taps"]
    mem = memory(taps, v, (taps.shape[0] - 1) // 2)
    a = dense(p("att")("out"), attend(q, k, v, heads, allowed)) + mem
    x = x + a if residual else a
    return x + ffn(p("ffn"), layer_norm(p("ln2"), x))


def sanm_encoder(p: P, feats: Tensor, heads: int,
                 allowed: Optional[Tensor] = None) -> Tensor:
    """[T, D_in] features -> [T, D]: scaled by sqrt(D), plus positions,
    the blocks, the final norm."""
    d_in = feats.shape[-1]
    d = p("after_norm")["g"].shape[0]
    x = feats * math.sqrt(d) + posenc(feats.shape[0], d_in, feats.device)
    x = sanm_block(p("first"), x, heads, d_in == d, allowed)
    for i in range(p.count("rest")):
        x = sanm_block(p("rest")(i), x, heads, True, allowed)
    return layer_norm(p("after_norm"), x)


# -- CIF predictor and the timestamp head -------------------------------------

def context_conv(p: P, x: Tensor, l_order: int, r_order: int) -> Tensor:
    kernel = l_order + r_order + 1
    pad = F.pad(x, (0, 0, l_order, r_order))
    t = x.shape[0]
    out = sum(pad[k: k + t] @ p["w"][k] for k in range(kernel))
    return out + p["b"]


def alphas(p: P, enc: Tensor, pcfg) -> Tensor:
    h = torch.relu(context_conv(p("conv"), enc, pcfg.l_order, pcfg.r_order)
                   + enc)
    a = torch.sigmoid(dense(p("out"), h))[:, 0]
    return torch.relu(a * pcfg.smooth_factor - pcfg.noise_threshold)


def fire(enc: Tensor, alpha: Tensor, threshold: float, tail: float
         ) -> Tuple[Tensor, float, List[tuple]]:
    """Integrate-and-fire over one utterance with the tail weight
    appended after its last frame: the fired embeddings [U, D], the
    smallest distance of the running sum from the threshold (how near a
    fire came to flipping), and the near ties: (distance, tokens fired
    before that step) for each step within 1e-3 of the threshold."""
    t, d = enc.shape
    hs = torch.cat([enc, enc.new_zeros(1, d)])
    # the running sum in float32 on the host, in the device's order
    al = torch.cat([alpha, alpha.new_full((1,), tail)]).float().cpu()
    integ = torch.zeros((), dtype=torch.float32)
    frame = enc.new_zeros(d)
    out: List[Tensor] = []
    margin = math.inf
    near: List[tuple] = []
    for i in range(t + 1):
        new = integ + al[i]
        dist = abs(float(new) - threshold)
        margin = min(margin, dist)
        if dist < 1e-3:
            near.append((dist, len(out)))
        if float(new) >= threshold:
            out.append(frame + float(threshold - integ) * hs[i])
            integ = new - threshold
            frame = float(integ) * hs[i]
        else:
            integ = new
            frame = frame + float(al[i]) * hs[i]
    emb = torch.stack(out) if out else enc.new_zeros(0, d)
    return emb, margin, near


def lstm(p: P, xs: Tensor) -> Tensor:
    """[T, Din] -> [T, H]; gates i, f, g, o; `wh` has no bias."""
    wh = p("wh")["w"]
    h = xs.new_zeros(wh.shape[0])
    c = torch.zeros_like(h)
    gx = dense(p("wx"), xs)
    hs = []
    for i in range(xs.shape[0]):
        g_i, g_f, g_g, g_o = (gx[i] + h @ wh).chunk(4)
        c = torch.sigmoid(g_f) * c + torch.sigmoid(g_i) * torch.tanh(g_g)
        h = torch.sigmoid(g_o) * torch.tanh(c)
        hs.append(h)
    return torch.stack(hs) if hs else xs.new_zeros(0, wh.shape[0])


def upsampled_alphas(p: P, enc: Tensor, pcfg, token_num: int) -> Tensor:
    """The bicif head: conv, 3x transposed conv, BLSTM, sigmoid; rescaled
    to sum to the token count. [T * upsample]."""
    t, d = enc.shape
    up = pcfg.upsample_times
    h = torch.relu(context_conv(p("conv"), enc, pcfg.l_order, pcfg.r_order))
    y = torch.einsum("td,kde->tke", h, p("us_cnn")["w"]).reshape(t * up, d)
    y = y + p("us_cnn")["b"]
    fw = lstm(p("blstm")("fw"), y)
    bw = lstm(p("blstm")("bw"), y.flip(0)).flip(0)
    a = torch.sigmoid(dense(p("us_out"), torch.cat([fw, bw], -1)))[:, 0]
    a = torch.relu(a * pcfg.smooth_factor2 - pcfg.noise_threshold2)
    return a * (token_num / a.sum().clamp_min(1e-6))


# -- Paraformer decoder -------------------------------------------------------

def cross(p: P, x: Tensor, mem: Tensor, heads: int) -> Tensor:
    q = dense(p("q"), x)
    k, v = dense(p("kv"), mem).split(q.shape[-1], dim=-1)
    return dense(p("out"), attend(q, k, v, heads))


def decoder(p: P, emb: Tensor, enc: Tensor, dcfg) -> Tensor:
    """FunASR DecoderLayerSANM blocks (feed-forward first, then the causal
    FSMN memory, one residual; then cross-attention), the `decoders3`
    tail without residual, the final norm and the vocab head: [U, V]."""
    heads = dcfg.attention_heads
    kernel = dcfg.kernel_size
    left = (kernel - 1 if dcfg.sanm_shift is None
            else (kernel - 1) // 2 + dcfg.sanm_shift)
    x = emb
    for i in range(p.count("blocks")):
        b = p("blocks")(i)
        h = layer_norm(b("ln2"), ffn(b("ffn"), layer_norm(b("ln1"), x)))
        x = x + memory(b("fsmn")["taps"], h, left)
        x = x + cross(b("cross"), layer_norm(b("ln3"), x), enc, heads)
    x = ffn(p("tail")("ffn"), layer_norm(p("tail")("ln1"), x))
    return dense(p("out"), layer_norm(p("after_norm"), x))


class ParaformerOut:
    def __init__(self, logits, us_alphas, margin, near):
        self.logits = logits          # [U, V]
        self.us_alphas = us_alphas    # [3T] or None
        self.margin = margin          # CIF's nearest approach
        self.near = near              # CIF's near ties (fire's)


def paraformer(sd: Dict[str, Tensor], cfg, feats: Tensor,
               max_tokens: Optional[int] = None) -> ParaformerOut:
    """One utterance [T, 560] -> its logits over the fired tokens, the
    first max_tokens of them where the recognizer states such a buffer."""
    p = P(sd)
    enc = sanm_encoder(p("encoder"), feats, cfg.encoder.attention_heads)
    a = alphas(p("predictor"), enc, cfg.predictor)
    emb, margin, near = fire(enc, a, cfg.predictor.threshold,
                             cfg.predictor.tail_threshold)
    if max_tokens is not None:
        emb = emb[:max_tokens]
    logits = decoder(p("decoder"), emb, enc, cfg.decoder)
    us = None
    if cfg.predictor.use_timestamp:
        us = upsampled_alphas(p("predictor"), enc, cfg.predictor,
                              emb.shape[0])
    return ParaformerOut(logits, us, margin, near)


# -- SenseVoice ---------------------------------------------------------------

def sensevoice(sd: Dict[str, Tensor], cfg, feats: Tensor, lid: int,
               tn: int) -> Tensor:
    """[T, 560] -> CTC logits [4 + T, V] over [lid, 2 queries, textnorm |
    frames]: the SAN-M encoder, the tp stack, the CTC head."""
    p = P(sd)
    x = torch.cat([sd["lid_embed"][lid][None], sd["query_embed"],
                   sd["tn_embed"][tn][None], feats])
    heads = cfg.encoder.attention_heads
    enc = sanm_encoder(p("encoder"), x, heads)
    if p.count("tp.rest"):
        for i in range(p.count("tp.rest")):
            enc = sanm_block(p("tp")("rest")(i), enc, heads, True)
        enc = layer_norm(p("tp")("norm"), enc)
    return dense(p("ctc"), enc)


# -- FSMN-VAD -----------------------------------------------------------------

def fsmn_vad(sd: Dict[str, Tensor], feats: Tensor) -> Tensor:
    """[T, 400] -> softmax posteriors [T, 248]: in-affines and ReLU, causal
    FSMN blocks (projection, memory of `lorder` taps with its inner
    residual, affine, ReLU), out-affines, softmax."""
    p = P(sd)
    x = torch.relu(dense(p("in2"), dense(p("in1"), feats)))
    for i in range(p.count("blocks")):
        b = p("blocks")(i)
        taps = b["taps"]
        proj = dense(b("proj"), x)
        x = torch.relu(dense(b("affine"), memory(taps, proj,
                                                 taps.shape[0] - 1)))
    return torch.softmax(dense(p("out2"), dense(p("out1"), x)), dim=-1)


# -- CT-Transformer -----------------------------------------------------------

def vad_mask(size: int, vad_pos: int) -> Tensor:
    """Rows 0..vad_pos-2 (cached words) may not attend to columns >=
    vad_pos (new text)."""
    m = torch.ones(size, size)
    if 0 < vad_pos < size:
        m[: vad_pos - 1, vad_pos:] = 0.0
    return m


def ct_transformer(sd: Dict[str, Tensor], cfg, ids: List[int],
                   cache_size: int = 0) -> Tensor:
    """Word ids -> punctuation logits [n, classes]."""
    p = P(sd)
    dev = sd["embed.table"].device
    x = sd["embed.table"][torch.tensor(ids, device=dev)]
    allowed = vad_mask(len(ids), cache_size).to(dev)
    h = sanm_encoder(p("encoder"), x, cfg.attention_heads, allowed)
    return dense(p("out"), h)

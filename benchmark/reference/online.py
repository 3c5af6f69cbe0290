"""The 2pass service's streaming side, plain: the VAD decision automaton fed
the windows a stream was fed in, the 2pass splitter (a frozen copy of the
port's runtime/audio_splitter.py), streaming Paraformer pass 1 fed chunk by
chunk, and the streaming punctuation of pass-2 texts.

Pass 1 follows the streaming model as the port's
models/paraformer_online.step computes it, without its caches and without
batching across streams:
- each chunk's window is rebuilt from the utterance's own feature history
  (`lookback + lookahead` frames before the chunk's new frames, zeros
  before the utterance's first frame);
- CIF fires once over the concatenation of the utterance's emit-region
  frames (the window positions each chunk emits), with the tail weight
  after the final chunk's, so no integrate is carried between chunks;
- the decoder runs once over the utterance's whole token history with
  its causal FSMN memory recomputed from the first token; each token's
  cross-attention reads the window of the chunk that fired it.
The chunking itself (how many new frames each step took, and which step
was final) is an input: it depends on when audio reached the service.

Departures of the published streaming model that the port makes, and
that this file copies so that the two can be compared:
- the window is scaled by sqrt(d) twice, once with the position encoding
  of the new frames and once inside the encoder (ROADMAP queue 3, "copied
  from the reference");
- the zero history before an utterance's first frame is attended to as
  valid window frames;
- the window's SAN-M memory is centred inside the window, and the
  decoder's memory is fully causal (kernel - 1 left taps);
- the alphas' context convolution reads zeros past the window's last
  frame (the port reads the final norm of zero rows, equal where that
  norm's bias is zero, as in the benchmark's weights).

Everything runs in float32, with TF32 off (float32_products(), which
the caller runs first), at each utterance's true length. It imports
nothing of the program.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from benchmark.reference import nets, text
from benchmark.reference import vad as ref_vad
from benchmark.reference.e2e_vad import E2EVadStateMachine
from benchmark.reference.frontend import StreamingFrontend

Tensor = torch.Tensor


def float32_products() -> None:
    """Matrix products and convolutions in float32, not TF32: the
    precision this reference is computed in."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# -- pass 1 -------------------------------------------------------------------

def schedule(rows: int, center: int) -> List[Tuple[int, bool]]:
    """The chunking of an utterance of `rows` frames when every chunk is
    decided before the next arrives: `center` new frames a step, the
    remainder (up to `center`) in the final step."""
    out = []
    while rows > center:
        out.append((center, False))
        rows -= center
    out.append((rows, True))
    return out


def window_encoder(p: nets.P, window: Tensor, heads: int) -> Tensor:
    """One chunk's window [W, D_in] -> [W, D]: scaled by sqrt(D) (the
    second time), the SAN-M blocks, the final norm; no position encoding
    here (the new frames carry theirs)."""
    d_in = window.shape[-1]
    d = p("after_norm")["g"].shape[0]
    x = window * math.sqrt(d)
    x = nets.sanm_block(p("first"), x, heads, d_in == d)
    for i in range(p.count("rest")):
        x = nets.sanm_block(p("rest")(i), x, heads, True)
    return nets.layer_norm(p("after_norm"), x)


def windows(p: nets.P, cfg, feats: Tensor,
            steps: Sequence[Tuple[int, bool]]) -> List[tuple]:
    """Each step's window through the encoder, with the window positions
    it emits: [(encoder output [W, D], lo, hi)]. The new frames carry
    their 1-based absolute positions and the first sqrt(D) scaling."""
    lookback, _center, lookahead = cfg.chunk_size
    cache = lookback + lookahead
    t, d_in = feats.shape
    x = (feats * math.sqrt(cfg.encoder.output_size)
         + nets.posenc(t, d_in, feats.device))
    hist = torch.cat([x.new_zeros(cache, d_in), x])
    out, pos = [], 0
    for n, final in steps:
        enc = window_encoder(p("encoder"), hist[pos: pos + cache + n],
                             cfg.encoder.attention_heads)
        out.append((enc, max(cache - pos, lookback),
                    cache + n if final else lookback + n))
        pos += n
    return out


def streaming_decoder(p: nets.P, emb: Tensor, mems: List[Tensor],
                      chunk_of: Sequence[int], dcfg) -> Tensor:
    """The decoder over one utterance's tokens [U, D] with a causal FSMN
    memory (kernel - 1 left taps, zeros before the first token) and each
    token's cross-attention over the window of its chunk: [U, V]."""
    heads = dcfg.attention_heads
    left = dcfg.kernel_size - 1
    groups = {}
    for j, k in enumerate(chunk_of):
        groups.setdefault(k, []).append(j)
    x = emb
    for i in range(p.count("blocks")):
        b = p("blocks")(i)
        h = nets.layer_norm(b("ln2"), nets.ffn(b("ffn"),
                                               nets.layer_norm(b("ln1"), x)))
        x = x + nets.memory(b("fsmn")["taps"], h, left)
        q = nets.layer_norm(b("ln3"), x)
        att = torch.zeros_like(x)
        for k, rows in groups.items():
            idx = torch.tensor(rows, device=x.device)
            att[idx] = nets.cross(b("cross"), q[idx], mems[k], heads)
        x = x + att
    x = nets.ffn(p("tail")("ffn"), nets.layer_norm(p("tail")("ln1"), x))
    return nets.dense(p("out"), nets.layer_norm(p("after_norm"), x))


@dataclass
class Pass1:
    """One utterance's pass 1: the logits of its fired tokens [U, V], the
    tokens each step fired, CIF's nearest approach to the threshold and
    its near ties (as nets.fire gives them), and whether the final step's
    tail weight fired a token."""
    logits: Tensor
    counts: List[int]
    margin: float
    near: List[tuple]
    tail_fired: bool


def _fire_steps(alpha: np.ndarray, threshold: float) -> np.ndarray:
    """For each position of the concatenated alphas, the tokens fired up
    to and including it: nets.fire's running sum in float32."""
    integ = np.float32(0.0)
    thr = np.float32(threshold)
    fired = np.zeros(len(alpha), np.int64)
    n = 0
    for i, a in enumerate(alpha.astype(np.float32)):
        new = np.float32(integ + a)
        if new >= thr:
            n += 1
            integ = np.float32(new - thr)
        else:
            integ = new
        fired[i] = n
    return fired


def pass1(sd, cfg, feats: Tensor, steps: Sequence[Tuple[int, bool]]
          ) -> Pass1:
    """Streaming pass 1 over one utterance's LFR+CMVN features [T, D_in],
    taken in `steps` (new frames, final) whose counts sum to T; the last
    step is final (it emits the lookahead frames and the tail weight)."""
    p = nets.P(sd)
    final = steps[-1][1]
    mems, hs, als, owners = [], [], [], []
    for k, (enc, lo, hi) in enumerate(windows(p, cfg, feats, steps)):
        a = nets.alphas(p("predictor"), enc, cfg.predictor)
        mems.append(enc)
        hs.append(enc[lo:hi])
        als.append(a[lo:hi])
        owners += [k] * max(hi - lo, 0)
    enc_cat = torch.cat(hs)
    alpha = torch.cat(als)
    tail = cfg.predictor.tail_threshold if final else 0.0
    emb, margin, near = nets.fire(enc_cat, alpha, cfg.predictor.threshold,
                                  tail)
    al = torch.cat([alpha, alpha.new_full((1,), tail)]).float().cpu().numpy()
    fired = _fire_steps(al, cfg.predictor.threshold)
    owners.append(len(steps) - 1)           # the tail belongs to the last
    counts = [0] * len(steps)
    chunk_of = []
    before = 0
    for i, k in enumerate(owners):
        new = int(fired[i]) - before
        counts[k] += new
        chunk_of += [k] * new
        before = int(fired[i])
    logits = (streaming_decoder(p("decoder"), emb, mems, chunk_of,
                                cfg.decoder)
              if emb.shape[0] else emb.new_zeros(0, cfg.vocab_size))
    tail_fired = bool(final and len(fired) > 1 and fired[-1] > fired[-2])
    return Pass1(logits, counts, margin, near, tail_fired)


# -- the VAD fed a stream's windows -------------------------------------------

@torch.inference_mode()
def vad_events(sd, cfg, samples: np.ndarray, windows: Sequence[Tuple[int,
                                                                     bool]],
               cmvn, max_end_sil: int, max_single_segment: int, device
               ) -> List[List[List[int]]]:
    """The automaton's events for each window of one stream, fed as the
    stream was: windows are (samples, final) in order, and every window
    reaches the automaton, with the feature rows the streaming front-end
    completed in it (none, sometimes)."""
    fe = StreamingFrontend(cfg.frontend, cmvn[0], cmvn[1], device=device)
    parts, rows, at = [], [], 0
    for n, final in windows:
        part = samples[at: at + n]
        at += n
        parts.append((part, final))
        rows.append(fe.accept(part, final))
    allrows = np.concatenate(rows) if rows else np.zeros((0, 1), np.float32)
    probs = (nets.fsmn_vad(sd, torch.as_tensor(allrows, device=device)
                           ).cpu().numpy() if len(allrows)
             else np.zeros((0, cfg.output_dim), np.float32))
    sm = E2EVadStateMachine(ref_vad.options(cfg))
    out, k = [], 0
    for (part, final), r in zip(parts, rows):
        p = probs[k: k + len(r)]
        k += len(r)
        out.append(sm(p, part, is_final=final, online=True,
                      max_end_sil=max_end_sil,
                      max_single_segment_time=max_single_segment,
                      speech_noise_thres=cfg.speech_noise_thres))
    return out


# -- the 2pass splitter (frozen copy of the port's) ---------------------------

@dataclass
class AudioFrame:
    data: np.ndarray
    is_final: bool = False
    global_start: int = 0   # ms
    global_end: int = 0     # ms


class TwoPassSplitter:
    """VAD events -> online chunks of the open speech region (pass 1,
    final-flagged at the utterance's end) and whole segments (pass 2),
    with 2 s of audio kept before an open segment."""

    def __init__(self, sample_rate: int = 16000, retention_s: float = 2.0):
        self.seg_sample = sample_rate // 1000
        self.retention = int(sample_rate * retention_s)
        self.all_samples = np.zeros(0, np.float32)
        self.offset = 0
        self.speech_start = -1
        self.speech_offline_start = -1
        self.speech_end = 0

    def _slice_ms(self, start_ms: int, end_ms: int) -> np.ndarray:
        a = max(start_ms * self.seg_sample, self.offset)
        b = max(min(end_ms * self.seg_sample,
                    self.offset + len(self.all_samples)), a)
        return self.all_samples[a - self.offset: b - self.offset].copy()

    def feed(self, samples, events, chunk_len: int):
        online: List[AudioFrame] = []
        offline: List[AudioFrame] = []
        self.all_samples = np.concatenate(
            [self.all_samples, np.asarray(samples, np.float32)])
        self.speech_end += len(samples) // self.seg_sample
        step_ms = chunk_len // self.seg_sample

        def push(final_end_ms: Optional[int] = None):
            if self.speech_start == -1:
                return
            end = final_end_ms if final_end_ms is not None else self.speech_end
            while self.speech_start < end:
                remaining = end - self.speech_start
                if final_end_ms is None and remaining < step_ms:
                    break
                take = min(step_ms, remaining)
                fin = (final_end_ms is not None
                       and self.speech_start + take >= end)
                online.append(AudioFrame(
                    self._slice_ms(self.speech_start,
                                   self.speech_start + take), fin,
                    self.speech_start, self.speech_start + take))
                self.speech_start += take

        if not events:
            push()
        for s, e in events:
            if s != -1 and e != -1:
                data = self._slice_ms(s, e)
                online.append(AudioFrame(data.copy(), True, s, e))
                offline.append(AudioFrame(data, True, s, e))
                self.speech_start = self.speech_offline_start = -1
            elif s != -1:
                self.speech_start = self.speech_offline_start = s
                push()
            elif e != -1:
                if self.speech_start == -1 or self.speech_offline_start == -1:
                    self.speech_start = max(self.speech_start, 0)
                    self.speech_offline_start = max(
                        self.speech_offline_start, 0)
                offline.append(AudioFrame(
                    self._slice_ms(self.speech_offline_start, e), True,
                    self.speech_offline_start, e))
                if e > self.speech_start:
                    push(final_end_ms=e)
                else:
                    online.append(AudioFrame(np.zeros(0, np.float32), True,
                                             self.speech_start, e))
                self.speech_start = self.speech_offline_start = -1
        if self.speech_offline_start == -1:
            if len(self.all_samples) > self.retention:
                erase = len(self.all_samples) - self.retention
                self.all_samples = self.all_samples[erase:]
                self.offset += erase
        else:
            keep = (self.speech_offline_start * self.seg_sample
                    - self.offset)
            if keep > self.retention:
                erase = keep - self.retention
                self.all_samples = self.all_samples[erase:]
                self.offset += erase
        return online, offline


def split(samples: np.ndarray, windows, events, chunk_len: int,
          sample_rate: int = 16000):
    """One stream through the splitter, window by window: (the utterances
    pass 1 takes, each the concatenation of its online chunks, and the
    segments pass 2 takes as (start ms, end ms, samples))."""
    sp = TwoPassSplitter(sample_rate)
    utts, segs, cur, at = [], [], [], 0
    for (n, _final), ev in zip(windows, events):
        on, off = sp.feed(samples[at: at + n], ev, chunk_len)
        at += n
        for fr in on:
            cur.append(fr.data)
            if fr.is_final:
                utts.append(np.concatenate(cur))
                cur = []
        segs += [(fr.global_start, fr.global_end, fr.data) for fr in off]
    return utts, segs


# -- streaming punctuation ---------------------------------------------------

def punc_streaming(asr_text: str, cache: List[str], tok2id: dict,
                   token_len: int, pop_limit: int,
                   decide: Callable[[int, List[int], int], List[int]]) -> str:
    """One pass-2 text punctuated after the connection's cached words
    (those after its last sentence end), as the service's streaming
    punctuation does: the cached words lead the first window, which they
    may not attend past; the words returned are the new ones, with a
    trailing mark dropped so the sentence can grow; `cache` is updated in
    place. decide(window index, ids, cached words) gives a window's
    classes."""
    cache_text = "".join(cache)
    if (cache_text and ord(cache_text[-1]) < 128 and asr_text
            and ord(asr_text[0]) < 128):
        cache_text += " "
    full = cache_text + asr_text
    if not full:
        return ""
    tokens, ids = text.tokenize(full, tok2id)
    if not tokens:
        return ""
    cached = len(text.tokenize("".join(cache), tok2id)[0]) if cache else 0
    words, classes, _ = text.punc_windows(
        tokens, ids, token_len, pop_limit,
        lambda bi, w_ids: decide(bi, w_ids, cached if bi == 0 else 0))
    out: List[str] = []
    for i, (w, c) in enumerate(zip(words, classes)):
        if (ord(w[0]) < 128 and i + 1 < len(words)
                and ord(words[i + 1][0]) < 128):
            w = w + " "
        if i >= cached:
            out.append(w)
            if c not in (text.NOTPUNC, text.UNKNOWN):
                out.append(text.PUNC_LIST[c] if 0 <= c < len(text.PUNC_LIST)
                           else "_")
    end = -1
    for i in range(len(classes) - 2, 0, -1):
        if classes[i] in (text.PERIOD, text.QUESTION):
            end = i
            break
    cache[:] = words[end + 1:]
    if out and out[-1] in text.PUNC_LIST[2:]:
        out = out[:-1]
    return "".join(out)

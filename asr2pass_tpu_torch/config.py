"""Configuration dataclasses of the Paraformer, FSMN-VAD,
CT-Transformer punctuation, SenseVoice and hotword-compiler models (port
copy).

Counterpart of the JAX package's config.py: the front-end, encoder, decoder,
predictor, VAD, punctuation, SenseVoice and hotword configs, the
reference-layout config.yaml loaders (load_svs_yaml is the JAX
package's runtime/model_zoo.load_svs_yaml) and the presets. Same fields, same defaults, same yaml keys, so
one model directory serves both packages.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Sequence

import yaml

@dataclass(frozen=True)
class FrontendConfig:
    """Kaldi-compatible fbank + LFR front-end knobs.

    Matches the knf::FbankOptions setup (paraformer.cpp:24-31: dither=0,
    povey window default, energy_floor=0) and the LFR/CMVN stage
    (paraformer.cpp:421-461).
    """

    fs: int = 16000
    window: str = "hamming"        # reference asr configs use hamming
    n_mels: int = 80
    frame_length_ms: int = 25
    frame_shift_ms: int = 10
    dither: float = 0.0
    lfr_m: int = 7
    lfr_n: int = 6
    preemphasis: float = 0.97
    remove_dc_offset: bool = True
    low_freq: float = 20.0
    high_freq: float = 0.0          # <=0 means offset from nyquist
    snip_edges: bool = True
    scale_input: float = 32768.0    # waveform is multiplied by 32768 first

    @property
    def frame_length(self) -> int:
        return self.fs * self.frame_length_ms // 1000

    @property
    def frame_shift(self) -> int:
        return self.fs * self.frame_shift_ms // 1000

    @property
    def n_fft(self) -> int:
        n = 1
        while n < self.frame_length:
            n *= 2
        return n

    @property
    def lfr_dim(self) -> int:
        return self.n_mels * self.lfr_m


@dataclass(frozen=True)
class EncoderConfig:
    """SAN-M encoder (self-attention + FSMN memory branch)."""

    input_size: int = 560           # n_mels * lfr_m
    output_size: int = 512
    num_blocks: int = 50
    attention_heads: int = 4
    linear_units: int = 2048
    kernel_size: int = 11           # FSMN memory kernel
    sanm_shift: int = 0
    dropout_rate: float = 0.1


@dataclass(frozen=True)
class DecoderConfig:
    """Paraformer parallel decoder: FSMN self-blocks + cross-attn.

    sanm_shift: None (default) = fully-causal FSMN (left = kernel-1) in the
    offline path, matching the streaming cache semantics — the in-repo
    convention so one trained model serves both paths. Converted FunASR
    offline checkpoints set it from config.yaml (`sanm_shfit`, typically 0
    -> centered window), matching the graph the reference runs as ONNX.
    """

    num_blocks: int = 16
    attention_heads: int = 4
    linear_units: int = 2048
    kernel_size: int = 11           # fsmn_lorder = kernel_size - 1
    sanm_shift: Optional[int] = None
    dropout_rate: float = 0.1

    @property
    def fsmn_lorder(self) -> int:
        return self.kernel_size - 1


@dataclass(frozen=True)
class PredictorConfig:
    """CIF predictor (continuous integrate-and-fire)."""

    idim: int = 512
    l_order: int = 1
    r_order: int = 1
    threshold: float = 1.0
    tail_threshold: float = 0.45
    # post-sigmoid shaping: alphas = relu(sigmoid(.)*smooth - noise)
    # (FunASR CifPredictorV2/V3 smooth_factor / noise_threshold)
    smooth_factor: float = 1.0
    noise_threshold: float = 0.0
    # bicif timestamp predictor (3x upsampled alphas) — only timestamp models
    upsample_times: int = 3
    use_timestamp: bool = False
    smooth_factor2: float = 0.25
    noise_threshold2: float = 0.01


@dataclass(frozen=True)
class ParaformerConfig:
    frontend: FrontendConfig = field(default_factory=FrontendConfig)
    encoder: EncoderConfig = field(default_factory=EncoderConfig)
    decoder: DecoderConfig = field(default_factory=DecoderConfig)
    predictor: PredictorConfig = field(default_factory=PredictorConfig)
    vocab_size: int = 8404
    use_hotword: bool = False
    lang: str = "zh"
    # streaming chunk layout [lookback, center, lookahead] in LFR frames
    chunk_size: Sequence[int] = (5, 10, 5)

    @property
    def chunk_samples(self) -> int:
        """Raw samples per online chunk: center * frame_shift * lfr_n
        (paraformer-online.cpp:112 → 9600 for [5,10,5] @16k)."""
        return (
            self.chunk_size[1]
            * self.frontend.frame_shift
            * self.frontend.lfr_n
        )


@dataclass(frozen=True)
class VadConfig:
    """FSMN-VAD NN + decision options (e2e-vad.h:79-138 defaults)."""

    frontend: FrontendConfig = field(
        default_factory=lambda: FrontendConfig(lfr_m=5, lfr_n=1)
    )
    input_dim: int = 400            # 80 * lfr_m(5)
    proj_dim: int = 128
    fsmn_layers: int = 4
    lorder: int = 20                # left context of FSMN (cache 19 + current)
    rorder: int = 0
    hidden_dim: int = 250
    output_dim: int = 248
    cache_frames: int = 19          # per-layer streaming cache [128, 19]
    # decision options
    sample_rate: int = 16000
    detect_mode: int = 1
    max_end_silence_time: int = 800
    max_start_silence_time: int = 3000
    window_size_ms: int = 200
    sil_to_speech_time_thres: int = 150
    speech_to_sil_time_thres: int = 150
    speech_2_noise_ratio: float = 1.0
    do_extend: int = 1
    lookback_time_start_point: int = 200
    lookahead_time_end_point: int = 100
    max_single_segment_time: int = 15000
    snr_thres: float = -100.0
    noise_frame_num_used_for_snr: int = 100
    decibel_thres: float = -100.0
    speech_noise_thres: float = 0.6
    fe_prior_thres: float = 1e-4
    sil_pdf_ids: Sequence[int] = (0,)
    frame_in_ms: int = 10
    frame_length_ms: int = 25


@dataclass(frozen=True)
class PuncConfig:
    """CT-Transformer punctuation restoration."""

    vocab_size: int = 272727
    embed_dim: int = 256
    att_dim: int = 256
    num_blocks: int = 4
    attention_heads: int = 8
    linear_units: int = 1024
    kernel_size: int = 11
    sanm_shift: int = 0
    num_classes: int = 6            # _  ，  。  ？  、  ！ (com-define.h:125-136)
    token_len: int = 20             # mini-batch window (ct-transformer.cpp:46)
    cache_pop_trigger_limit: int = 200


@dataclass(frozen=True)
class SenseVoiceConfig:
    """SenseVoice-small multilingual CTC model."""

    frontend: FrontendConfig = field(default_factory=FrontendConfig)
    encoder: EncoderConfig = field(
        default_factory=lambda: EncoderConfig(
            input_size=560, output_size=512, num_blocks=50
        )
    )
    vocab_size: int = 25055
    # meta prefix tokens (sensevoice-small.cpp:596-642)
    lid_pairs: tuple = (("auto", 0), ("zh", 3), ("en", 4), ("yue", 7),
                        ("ja", 11), ("ko", 12), ("nospeech", 13))
    textnorm_pairs: tuple = (("withitn", 14), ("woitn", 15))
    blank_id: int = 0
    # detok/punc joining style for the offline pipeline (ParaformerConfig
    # .lang counterpart); SenseVoice output text carries its own spacing
    lang: str = "zh"

    @property
    def lid_dict(self) -> dict:
        return dict(self.lid_pairs)

    @property
    def textnorm_dict(self) -> dict:
        return dict(self.textnorm_pairs)


@dataclass(frozen=True)
class HotwordConfig:
    """Hotword embedding compiler (model_eb: paraformer.cpp:592-693)."""

    vocab_size: int = 8404
    embed_dim: int = 512
    hidden_dim: int = 512
    num_layers: int = 1
    max_hotword_len: int = 10


def _merge(cls, node: Optional[dict], **extra):
    if node is None:
        node = {}
    names = {f.name for f in dataclasses.fields(cls)}
    kw = {k: v for k, v in node.items() if k in names}
    kw.update(extra)
    return cls(**kw)


def load_paraformer_yaml(path: str) -> ParaformerConfig:
    """Load a reference-layout config.yaml into a ParaformerConfig.

    Reads the same keys the reference consumes (paraformer.cpp:202-241):
    frontend_conf{window,n_mels,frame_length,frame_shift,lfr_m,lfr_n,fs},
    encoder_conf{output_size,num_blocks,...}, decoder_conf{num_blocks,
    kernel_size,...}, predictor_conf{threshold,tail_threshold}.
    """
    with open(path) as f:
        cfg = yaml.safe_load(f)
    fe = cfg.get("frontend_conf", {})
    frontend = _merge(
        FrontendConfig,
        {
            "fs": fe.get("fs", 16000),
            "window": fe.get("window", "hamming"),
            "n_mels": fe.get("n_mels", 80),
            "frame_length_ms": fe.get("frame_length", 25),
            "frame_shift_ms": fe.get("frame_shift", 10),
            "lfr_m": fe.get("lfr_m", 7),
            "lfr_n": fe.get("lfr_n", 6),
            "dither": fe.get("dither", 0.0),
        },
    )
    enc = _merge(
        EncoderConfig,
        cfg.get("encoder_conf", {}),
        input_size=frontend.n_mels * frontend.lfr_m,
    )
    dec_node = dict(cfg.get("decoder_conf") or {})
    # FunASR configs spell the key `sanm_shfit` (sic); honor both spellings
    if "sanm_shfit" in dec_node:
        dec_node["sanm_shift"] = dec_node.pop("sanm_shfit")
    # key present (FunASR dirs always write it) -> FunASR window semantics;
    # absent (our own bundles may omit it) -> in-repo causal convention
    dec = _merge(DecoderConfig, dec_node,
                 sanm_shift=dec_node.get("sanm_shift"))
    pred = _merge(
        PredictorConfig, cfg.get("predictor_conf", {}), idim=enc.output_size
    )
    vocab_size = cfg.get("vocab_size", 8404)
    tl = cfg.get("token_list")
    if isinstance(tl, list):
        vocab_size = len(tl)
    return ParaformerConfig(
        frontend=frontend,
        encoder=enc,
        decoder=dec,
        predictor=pred,
        vocab_size=vocab_size,
        lang=cfg.get("lang", "zh"),
    )


def load_svs_yaml(path: str) -> SenseVoiceConfig:
    """SenseVoice model-dir config.yaml -> SenseVoiceConfig: the
    frontend_conf and encoder_conf keys of load_paraformer_yaml, plus
    vocab_size, blank_id, lid_pairs, textnorm_pairs and lang."""
    with open(path) as f:
        node = yaml.safe_load(f) or {}
    fe = node.get("frontend_conf", {})
    frontend = FrontendConfig(
        fs=fe.get("fs", 16000), window=fe.get("window", "hamming"),
        n_mels=fe.get("n_mels", 80),
        frame_length_ms=fe.get("frame_length", 25),
        frame_shift_ms=fe.get("frame_shift", 10),
        lfr_m=fe.get("lfr_m", 7), lfr_n=fe.get("lfr_n", 6))
    enc = node.get("encoder_conf", {})
    encoder = EncoderConfig(
        input_size=frontend.n_mels * frontend.lfr_m,
        output_size=enc.get("output_size", 512),
        num_blocks=enc.get("num_blocks", 50),
        attention_heads=enc.get("attention_heads", 4),
        linear_units=enc.get("linear_units", 2048),
        kernel_size=enc.get("kernel_size", 11))
    kw = {}
    if node.get("lid_pairs"):
        kw["lid_pairs"] = tuple(tuple(p) for p in node["lid_pairs"])
    if node.get("textnorm_pairs"):
        kw["textnorm_pairs"] = tuple(tuple(p)
                                     for p in node["textnorm_pairs"])
    return SenseVoiceConfig(
        frontend=frontend, encoder=encoder,
        vocab_size=node.get("vocab_size", 25055),
        blank_id=node.get("blank_id", 0),
        lang=node.get("lang", "zh"), **kw)


def load_punc_yaml(path: str) -> PuncConfig:
    """Punc model-dir config.yaml -> PuncConfig.

    Reads the dims the reference consumes when building the punc session
    (ct-transformer.cpp:31-54 parses the same yaml family): encoder_conf
    attention_heads/linear_units/num_blocks/kernel_size/output_size,
    vocab from an embedded token_list, num_classes from punc_list.
    Absent keys keep the CT-Transformer defaults."""
    with open(path) as f:
        node = yaml.safe_load(f) or {}
    return punc_cfg_from_node(node)


def punc_cfg_from_node(node: dict) -> PuncConfig:
    enc = node.get("encoder_conf") or {}
    kw = {}
    for k in ("attention_heads", "linear_units", "num_blocks",
              "kernel_size"):
        if k in enc:
            kw[k] = int(enc[k])
    if "sanm_shfit" in enc:            # FunASR spelling (sic)
        kw["sanm_shift"] = int(enc["sanm_shfit"])
    elif "sanm_shift" in enc:
        kw["sanm_shift"] = int(enc["sanm_shift"])
    d = enc.get("output_size")
    if d:
        kw["att_dim"] = int(d)
        kw["embed_dim"] = int(d)
    tl = node.get("token_list")
    if isinstance(tl, list):
        kw["vocab_size"] = len(tl)
    elif node.get("vocab_size"):
        kw["vocab_size"] = int(node["vocab_size"])
    pl = node.get("punc_list")
    if isinstance(pl, list) and pl:
        kw["num_classes"] = len(pl)
    return PuncConfig(**kw)


def load_vad_yaml(path: str) -> VadConfig:
    """VAD model-dir config.yaml -> VadConfig.

    Reads the keys the reference consumes (fsmn-vad.cpp:31-47):
    frontend_conf{fs, n_mels, frame_length, frame_shift, window, lfr_*}
    and model_conf{max_end_silence_time, max_single_segment_time,
    speech_noise_thres, ...}; sil_pdf_ids and the NN dims when present.
    Unlisted keys keep the e2e-vad.h defaults."""
    with open(path) as f:
        node = yaml.safe_load(f) or {}
    fe = node.get("frontend_conf") or {}
    mc = node.get("model_conf") or {}
    enc = node.get("encoder_conf") or {}
    frontend = FrontendConfig(
        fs=fe.get("fs", 16000), window=fe.get("window", "hamming"),
        n_mels=fe.get("n_mels", 80),
        frame_length_ms=fe.get("frame_length", 25),
        frame_shift_ms=fe.get("frame_shift", 10),
        lfr_m=fe.get("lfr_m", 5), lfr_n=fe.get("lfr_n", 1),
        dither=fe.get("dither", 0.0))
    kw = {}
    for k in ("detect_mode", "max_end_silence_time",
              "max_start_silence_time", "window_size_ms",
              "sil_to_speech_time_thres", "speech_to_sil_time_thres",
              "speech_2_noise_ratio", "do_extend",
              "lookback_time_start_point", "lookahead_time_end_point",
              "max_single_segment_time", "snr_thres",
              "noise_frame_num_used_for_snr", "decibel_thres",
              "speech_noise_thres"):
        if k in mc:
            kw[k] = mc[k]
    if "sil_pdf_ids" in mc:
        kw["sil_pdf_ids"] = tuple(int(i) for i in mc["sil_pdf_ids"])
    for yk, ck in (("proj_dim", "proj_dim"),
                   ("linear_dim", "hidden_dim"),
                   ("output_dim", "output_dim"),
                   ("fsmn_layers", "fsmn_layers"),
                   ("lorder", "lorder"), ("rorder", "rorder")):
        if yk in enc:
            kw[ck] = int(enc[yk])
    if "lorder" in kw:
        kw.setdefault("cache_frames", kw["lorder"] - 1)
    return VadConfig(frontend=frontend,
                     input_dim=frontend.n_mels * frontend.lfr_m,
                     sample_rate=frontend.fs, **kw)


# ---------------------------------------------------------------------------
# Canonical model presets (sizes match the published FunASR model family the
# reference downloads from ModelScope; see funasr-wss-server-2pass.cpp:195-502)
# ---------------------------------------------------------------------------

def paraformer_large(vocab_size: int = 8404, timestamp: bool = False,
                     hotword: bool = False) -> ParaformerConfig:
    return ParaformerConfig(
        predictor=PredictorConfig(use_timestamp=timestamp),
        vocab_size=vocab_size,
        use_hotword=hotword,
    )


def paraformer_large_online(vocab_size: int = 8404) -> ParaformerConfig:
    return ParaformerConfig(
        encoder=EncoderConfig(num_blocks=50),
        decoder=DecoderConfig(num_blocks=16),
        vocab_size=vocab_size,
    )


def paraformer_tiny(vocab_size: int = 64) -> ParaformerConfig:
    """Small config for unit tests / CI on CPU."""
    return ParaformerConfig(
        frontend=FrontendConfig(),
        encoder=EncoderConfig(input_size=560, output_size=64, num_blocks=2,
                              attention_heads=2, linear_units=128),
        decoder=DecoderConfig(num_blocks=2, attention_heads=2,
                              linear_units=128),
        predictor=PredictorConfig(idim=64),
        vocab_size=vocab_size,
    )


def vad_default() -> VadConfig:
    return VadConfig()


def punc_tiny(vocab_size: int = 128) -> PuncConfig:
    return PuncConfig(vocab_size=vocab_size, embed_dim=32, att_dim=32,
                      num_blocks=2, attention_heads=2, linear_units=64)


def sensevoice_small(vocab_size: int = 25055) -> SenseVoiceConfig:
    return SenseVoiceConfig(vocab_size=vocab_size)


def sensevoice_tiny(vocab_size: int = 64) -> SenseVoiceConfig:
    return SenseVoiceConfig(
        encoder=EncoderConfig(input_size=560, output_size=64, num_blocks=2,
                              attention_heads=2, linear_units=128),
        vocab_size=vocab_size,
    )

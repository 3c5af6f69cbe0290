"""Model configuration dataclasses: a frozen copy of the dataclasses of the
port's config.py (the same fields and defaults), so that the reference
reads the sizes of a configuration file without importing the program.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Sequence


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

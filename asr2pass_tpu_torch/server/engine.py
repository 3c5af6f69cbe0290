"""Server-side model registry + per-connection session factory.

Counterpart of the JAX package's server/engine.py (ServerModels), with the
fields of the ported modules: the offline (pass-2) and streaming
(pass-1) Paraformers, FSMN-VAD, punctuation, ITN, the hotword compiler
and its seg_dict, SenseVoice as the pass-2 alternative, server-side
hotwords and the device. Models are built once, on the device, and
shared read-only; each websocket connection gets its own TwoPassSession
(per-connection VAD/ASR/punc caches), mirroring TpassOnlineStream-per-
connection (websocket-server-2pass.h:49-65).

Several cards (torch.distributed, one process a rank, each building the
same ServerModels): with tp_mesh the pass-2 model of each role ("asr",
"svs") is sharded once, at first use, and every recognizer gets that
shard (the JAX package's _tp_params cache); with sp_mesh the offline
recognizers (uploads and the engine's lane) run segments past
sp_threshold sequence-parallel, as in the JAX package. The two combine:
the Paraformer role's offline recognizers then take both meshes (the
TP shard, with its encoder gathered whole for the SP segments), the
SenseVoice role only tp_mesh, as in the JAX package. Either mesh makes
a fan-out (server/fanout.py): rank 0's recognizers that hold a mesh send
each pass-2 call to the other ranks, which serve_worker(models) replays.
Pass 1, the VAD, punctuation and the hotword compiler stay whole on
rank 0's card.

LM rescoring (the TLG role): either an ARPA LM with its lexicon, decoded
by the native lexicon-trie x n-gram beam (NativeLmDecoder; the Python
LmDecoder only with lm_native=False), or a compiled TLG graph dir
decoded by TlgDecoder (FunASRWfstDecoderInit, funasrruntime.cpp:836-894).
The tables and graphs load once, when the models are built, and every
connection shares them: a connection without hotwords shares the base
NativeLmDecoder, one with hotwords gets a clone with its own bias, and a
TlgDecoder (which keeps per-utterance state) is made per connection or
request. A graph for the SenseVoice role must have the CTC topology
(build_tlg --ctc-blank); building the models raises otherwise. Nothing
falls back: a graph or LM that does not load raises.
"""
from __future__ import annotations

import dataclasses
import threading
from collections import OrderedDict
from dataclasses import dataclass
from typing import Any, Optional

import numpy as np
from torch import nn

from asr2pass_tpu_torch.config import (HotwordConfig, ParaformerConfig,
                                       PuncConfig, SenseVoiceConfig,
                                       VadConfig)
from asr2pass_tpu_torch.decode.context_graph import ContextGraph
from asr2pass_tpu_torch.decode.lm_decoder import LmDecoder
from asr2pass_tpu_torch.decode.tlg import TlgDecoder, TlgGraph
from asr2pass_tpu_torch.models import (ct_transformer, fsmn_vad, hotword,
                                       paraformer, sensevoice)
from asr2pass_tpu_torch.native.bindings import NativeLmDecoder
from asr2pass_tpu_torch.parallel.sharding import shard_params
from asr2pass_tpu_torch.runtime.asr_stream import ParaformerOnlineStream
from asr2pass_tpu_torch.runtime.offline_api import OfflineRecognizer
from asr2pass_tpu_torch.runtime.offline_asr import ParaformerOffline
from asr2pass_tpu_torch.runtime.punc import Punctuator
from asr2pass_tpu_torch.runtime.sensevoice_asr import SenseVoiceOffline
from asr2pass_tpu_torch.runtime.two_pass import TwoPassSession
from asr2pass_tpu_torch.runtime.vad_stream import FsmnVadStream
from asr2pass_tpu_torch.server.fanout import Fanout
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
    # the hotword compiler (a Hotword module or its state dict, as
    # model_zoo.load_offline_bundle returns it in hotword_params)
    hotword_params: Any = None
    hotword_cfg: Optional[HotwordConfig] = None
    seg_dict: Any = None               # EN word -> BPE pieces (SegDict)
    # SenseVoice (svs) pass-2 alternative (MODEL_SVS role)
    svs_params: Any = None
    svs_cfg: Optional[SenseVoiceConfig] = None
    svs_vocab: Any = None
    svs_cmvn: Any = None
    # SVS decode mode: beam > 1 switches every SVS decode to the pruned
    # CTC prefix beam; hotworded connections get a context-graph-biased
    # beam regardless (greedy has no bias hook: the reference's split
    # between CTCSearch and CtcPrefixBeamSearch,
    # sensevoice-small.cpp:323-440)
    svs_beam: int = 0
    # n-gram LM rescoring: lm (decode/ngram.NgramLM) + lexicon
    # (decode/lm_decoder.Lexicon), or tlg_dir (TLG.fst, words.txt,
    # tokens.txt); lm_native=False takes the Python LmDecoder
    lm: Any = None
    lexicon: Any = None
    tlg_dir: Any = None
    lm_weight: float = 0.5
    lm_native: bool = True
    # server-side hotwords merged with per-connection ones
    server_hotwords: Any = None
    device: Any = "cuda"
    # sequence parallelism for very long offline segments: a DeviceMesh
    # over every rank with an sp_axis axis; segments longer than
    # sp_threshold LFR frames run the encoder time-sharded over it
    # (parallel/sequence.py). None = one card.
    sp_mesh: Any = None
    sp_axis: str = "sp"
    sp_threshold: int = 4096
    # tensor parallelism for the pass-2 model: a ("dp", "tp") DeviceMesh
    # (parallel/sharding.make_mesh); the recognizers run its shard
    tp_mesh: Any = None

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
        self.hotword_params = _on_device(
            self.hotword_params,
            lambda sd: hotword.from_state_dict(sd, dev), dev)
        self.svs_params = _on_device(
            self.svs_params,
            lambda sd: sensevoice.from_state_dict(sd, self.svs_cfg, dev), dev)
        self._res_lock = threading.RLock()
        self._offline_rec_cache: "OrderedDict" = OrderedDict()
        # each role's shard over tp_mesh, built once: a recognizer per
        # connection must not hold a copy of its own
        self._tp_shard_cache = {}
        self.fanout = None
        if self.tp_mesh is not None or self.sp_mesh is not None:
            self.fanout = Fanout()
        # the LM resources, loaded once per vocabulary role ("asr", "svs"):
        # a TLG graph's input-label map, and the native decoder's unit
        # ids, differ between the Paraformer and SenseVoice vocabularies
        self._tlg_graphs = {}
        self._lm_bases = {}
        roles = [r for r, m in (("asr", self.asr_params),
                                ("svs", self.svs_params)) if m is not None]
        for role in roles:
            if self.tlg_dir is not None:
                self._tlg_graph(role)
            elif (role == "asr" and self.lm_native and self.lm is not None
                  and self.lexicon is not None):
                self._lm_base(role)

    def _punctuator(self) -> Optional[Punctuator]:
        if self.punc_params is None:
            return None
        return Punctuator(self.punc_params, self.punc_cfg,
                          self.punc_tokenizer, device=self.device)

    def compile_hotwords(self, hotwords: dict) -> Optional[np.ndarray]:
        """hotword dict {word: score} -> [N+1, D] NN embeddings, row 0
        the null row (CompileHotwordEmbedding role,
        paraformer.cpp:592-693); None without a hotword model or words."""
        if self.hotword_params is None or not hotwords:
            return None
        return hotword.compile_hotwords(
            self.hotword_params, self.hotword_cfg or HotwordConfig(),
            list(hotwords.keys()), self.vocab, seg_dict=self.seg_dict)

    def svs_context_graph(self, hotwords: Optional[dict]
                          ) -> Optional[ContextGraph]:
        """Hotword dict -> ContextGraph for SenseVoice CTC-beam biasing.
        The reference attaches hotwords to SVS through the context graph
        inside CtcPrefixBeamSearch (sensevoice-small.cpp:392-440), not
        through NN embeddings."""
        if not hotwords:
            return None
        return ContextGraph().build(
            {str(w): float(s) for w, s in hotwords.items()})

    @property
    def has_lm(self) -> bool:
        return self.tlg_dir is not None or (self.lm is not None
                                            and self.lexicon is not None)

    def _role_vocab(self, which: str) -> Vocab:
        return (self.svs_vocab or self.vocab) if which == "svs" \
            else self.vocab

    def _tlg_graph(self, which: str) -> TlgGraph:
        """The TLG graph of a vocabulary role, loaded once. The
        SenseVoice role's must have the CTC topology: its decodes run
        over CTC frames (ADVICE's server/engine.py:147 finding)."""
        with self._res_lock:
            graph = self._tlg_graphs.get(which)
            if graph is None:
                vocab = self._role_vocab(which)
                graph = TlgGraph(self.tlg_dir, vocab.token2id)
                blank = vocab.id2token(self.svs_cfg.blank_id) \
                    if which == "svs" else None
                if blank is not None and not graph.is_ctc(blank):
                    raise ValueError(
                        f"--lm-dir {self.tlg_dir}: SenseVoice decodes CTC "
                        f"frames and needs a graph built with build_tlg "
                        f"--ctc-blank (no {blank!r} unit in its "
                        "tokens.txt)")
                self._tlg_graphs[which] = graph
        return graph

    def _lm_base(self, which: str) -> NativeLmDecoder:
        """The native LM decoder over this role's vocabulary, built once;
        clones share its tables."""
        with self._res_lock:
            base = self._lm_bases.get(which)
            if base is None:
                base = self._lm_bases[which] = NativeLmDecoder(
                    self.lm, self.lexicon, self._role_vocab(which).token2id,
                    lm_weight=self.lm_weight)
        return base

    def _make_lm_decoder(self, hotwords: Optional[dict] = None,
                         which: str = "asr"):
        """A decoder for one connection or request with these hotwords,
        or None without an LM: a TlgDecoder over the shared graph; else
        the shared native decoder (no hotwords) or a clone of it biased
        by the hotwords; the Python LmDecoder when lm_native is off."""
        if self.tlg_dir is not None:
            return TlgDecoder(self._tlg_graph(which),
                              self._role_vocab(which).token2id,
                              lm_weight=self.lm_weight, hotwords=hotwords)
        if self.lm is None or self.lexicon is None:
            return None
        if not self.lm_native:
            bias = (ContextGraph().build(
                {w: float(s) for w, s in hotwords.items()})
                if hotwords else None)
            return LmDecoder(self.lm, self.lexicon,
                             lm_weight=self.lm_weight, bias=bias)
        base = self._lm_base(which)
        return base.clone(hotwords) if hotwords else base

    def _svs_lm_decoder(self, hotwords: Optional[dict] = None):
        """SenseVoice's rescoring: only a TLG graph (with the CTC
        topology) qualifies; the trie LM decoder takes one row a token
        and stays the Paraformer's."""
        if self.tlg_dir is None:
            return None
        return self._make_lm_decoder(hotwords, which="svs")

    def release_lm_decoder(self, dec) -> None:
        """Free what _make_lm_decoder made for one connection: a
        TlgDecoder or a clone. The shared base decoder stays."""
        if isinstance(dec, TlgDecoder) or (
                isinstance(dec, NativeLmDecoder)
                and dec not in self._lm_bases.values()):
            dec.close()

    def _tp_params(self, which: str, module):
        """This rank's shard of a role's pass-2 module over tp_mesh, built
        once and shared (the module itself without tp_mesh)."""
        if self.tp_mesh is None:
            return module
        with self._res_lock:
            local = self._tp_shard_cache.get(which)
            if local is None:
                local = self._tp_shard_cache[which] = shard_params(
                    module, self.tp_mesh)
        return local

    def _pass2(self, use_svs: bool, svs_lang: str, svs_itn: bool,
               hotwords: Optional[dict], sp: bool = False,
               worker: bool = False):
        """The pass-2 recognizer: SenseVoice when asked for and loaded,
        else the offline Paraformer (sequence-parallel with sp, when
        sp_mesh is set); with the LM decoder for these hotwords when an
        LM is loaded. On rank 0 of a mesh it reaches the other ranks
        through the fan-out; a worker's (serve_worker) has none."""
        shard = dict(tp_mesh=self.tp_mesh,
                     presharded=self.tp_mesh is not None)
        if use_svs and self.svs_params is not None:
            rec = SenseVoiceOffline(
                self._tp_params("svs", self.svs_params), self.svs_cfg,
                self.svs_vocab or self.vocab,
                cmvn=self.svs_cmvn, lang=svs_lang, use_itn_token=svs_itn,
                context=self.svs_context_graph(hotwords),
                beam=self.svs_beam,
                lm_decoder=None if worker else self._svs_lm_decoder(hotwords),
                device=self.device, **shard)
        else:
            if sp and self.sp_mesh is not None:
                shard.update(sp_mesh=self.sp_mesh, sp_axis=self.sp_axis,
                             sp_threshold=self.sp_threshold)
            rec = ParaformerOffline(
                self._tp_params("asr", self.asr_params), self.asr_cfg,
                self.vocab, cmvn=self.asr_cmvn,
                lm_decoder=None if worker else self._make_lm_decoder(
                    hotwords),
                device=self.device, **shard)
        if not worker and (rec.tp_mesh is not None
                           or getattr(rec, "sp_mesh", None) is not None):
            # only a recognizer that holds a mesh issues collectives: the
            # whole-model ones (SenseVoice and sessions' Paraformer on an
            # sp server) run on rank 0 alone
            rec.fanout = self.fanout
        return rec

    def worker_recognizer(self, role: str, sp: bool):
        """The recognizer a worker rank replays rank 0's calls of a role
        on (server/fanout.serve_worker): no LM decoder, context or fan-out
        of its own; the calls carry what decides the device work."""
        return self._pass2(role == "svs", "auto", True, None, sp=sp,
                           worker=True)

    def create_session(self, mode: str = "2pass",
                       vad_tail_sil: Optional[int] = None,
                       vad_max_len: Optional[int] = None,
                       hw_emb: Optional[np.ndarray] = None,
                       use_itn: bool = True, svs_lang: str = "auto",
                       svs_itn: bool = True, use_svs: bool = False,
                       hotwords: Optional[dict] = None,
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
            offline = self._pass2(use_svs, svs_lang, svs_itn, hotwords)
        return TwoPassSession(
            vad, online, offline, punc=self._punctuator(), itn=self.itn,
            mode=mode, hw_emb=hw_emb, use_itn=use_itn)

    def create_offline_recognizer(self, vad_tail_sil: int = 800,
                                  vad_max_len: int = 60000,
                                  use_svs: bool = False,
                                  svs_lang: str = "auto",
                                  svs_itn: bool = True,
                                  hotwords: Optional[dict] = None
                                  ) -> OfflineRecognizer:
        """Offline (whole-file) recognizer with VAD, punctuation and ITN;
        SenseVoice as pass 2 with use_svs, biased by `hotwords` through
        its context graph. A Paraformer takes hotword embeddings per
        transcribe call instead. With an LM loaded, pass 2 rescores with
        a decoder biased by `hotwords` (the reference's offline server
        makes a WFST decoder per connection, websocket-server.cpp:
        173-176)."""
        return OfflineRecognizer(
            self._pass2(use_svs, svs_lang, svs_itn, hotwords, sp=True),
            vad_params=self.vad_params, vad_cfg=self.vad_cfg,
            vad_cmvn=self.vad_cmvn, punc=self._punctuator(), itn=self.itn,
            vad_tail_sil=vad_tail_sil, vad_max_len=vad_max_len)

    def offline_recognizer_cached(self, vad_tail_sil: int = 800,
                                  vad_max_len: int = 60000,
                                  use_svs: bool = False,
                                  svs_lang: str = "auto",
                                  svs_itn: bool = True,
                                  hotwords: Optional[dict] = None,
                                  max_cached: int = 32
                                  ) -> OfflineRecognizer:
        """Per-request offline recognizer, cached by its option tuple —
        the server must NOT rebuild recognizers on every offline upload.
        LRU-bounded so a hostile stream of unique hotword sets cannot grow
        memory unboundedly.

        With an LM loaded, a recognizer is built per request: a
        TlgDecoder (and the Python LmDecoder) keeps per-utterance state,
        so two uploads decoding at once on one cached recognizer would
        interleave it. That costs little: the graph, the LM tables and
        the models underneath are built once."""
        if self.has_lm:
            return self.create_offline_recognizer(
                vad_tail_sil=vad_tail_sil, vad_max_len=vad_max_len,
                use_svs=use_svs, svs_lang=svs_lang, svs_itn=svs_itn,
                hotwords=hotwords)
        key = (vad_tail_sil, vad_max_len, use_svs, svs_lang, svs_itn,
               tuple(sorted(hotwords.items())) if hotwords else None)
        with self._res_lock:
            rec = self._offline_rec_cache.get(key)
            if rec is not None:
                self._offline_rec_cache.move_to_end(key)
                return rec
        rec = self.create_offline_recognizer(
            vad_tail_sil=vad_tail_sil, vad_max_len=vad_max_len,
            use_svs=use_svs, svs_lang=svs_lang, svs_itn=svs_itn,
            hotwords=hotwords)
        with self._res_lock:
            self._offline_rec_cache[key] = rec
            while len(self._offline_rec_cache) > max_cached:
                self._offline_rec_cache.popitem(last=False)
        return rec

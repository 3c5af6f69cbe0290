"""TLG.fst decoding graphs: load once, decode per utterance.

Counterpart of the JAX package's decode/tlg.py. Reference deployments
ship `TLG.fst` with `words.txt` and `tokens.txt` (built by
utils/ngram_tools/train_compile_ngram.sh) and decode through WfstDecoder
(onnxruntime/src/wfst-decoder.cpp:27-92). Here the graph loads through
the native FST reader (native/src/fst.cc) and decodes with the native
token passer (native/src/tlg_decoder.cc), with the per-connection hotword
bias and n-best output (wfst-decoder.cpp:149-179 role). Graphs built by
tools/build_tlg.py have the same format, so they work both ways.

Symbols: the graph's input labels are the units of `tokens.txt` (0 is
epsilon), its output labels the words of `words.txt`, both in kaldi's
"symbol id" line format. A decoder takes log-prob rows indexed by input
label: `TlgGraph.gather_rows` makes them from rows over the acoustic
vocabulary (a unit outside it gets -1e9), on whatever device the rows
are, so a recognizer copies [n, labels] rows to the host instead of
[n, vocabulary] ones.

A graph built with `build_tlg --ctc-blank` has the blank unit among its
tokens: that is its CTC frame-synchronous topology (`TlgGraph.is_ctc`),
the only one that can decode SenseVoice's frame rows.
"""
from __future__ import annotations

import os
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from asr2pass_tpu_torch.native.bindings import (NativeAcBias, NativeFst,
                                                NativeTlgFstDecoder)

MISSING_LOGP = -1e9       # the log-prob of a graph unit outside the vocabulary


def read_symbols(path: str) -> Dict[str, int]:
    out: Dict[str, int] = {}
    with open(path, encoding="utf-8") as f:
        for line in f:
            parts = line.split()
            if len(parts) >= 2:
                out[parts[0]] = int(parts[1])
    return out


class TlgGraph:
    """A TLG graph dir loaded once and shared read-only by every
    connection (FunASRWfstDecoderInit, funasrruntime.cpp:836-894;
    production graphs are hundreds of MB): the graph, its symbol tables
    and the map from input label to acoustic token id (-1 where the unit
    is not in the vocabulary). Per-utterance state lives in TlgDecoder.
    Raises FileNotFoundError without TLG.fst, words.txt or tokens.txt,
    and ValueError for a TLG.fst the reader refuses."""

    def __init__(self, graph_dir: str, token2id: Dict[str, int]):
        self.graph_dir = str(graph_dir)
        paths = {n: os.path.join(self.graph_dir, n)
                 for n in ("TLG.fst", "words.txt", "tokens.txt")}
        missing = [n for n, p in paths.items() if not os.path.isfile(p)]
        if missing:
            raise FileNotFoundError(f"TLG graph dir {graph_dir} lacks "
                                    f"{', '.join(missing)}")
        self.fst = NativeFst(paths["TLG.fst"])
        self.word_syms = read_symbols(paths["words.txt"])
        self.id2word = {i: w for w, i in self.word_syms.items()}
        self.tok_syms = read_symbols(paths["tokens.txt"])
        self.gather = np.full(max(self.tok_syms.values(), default=0) + 1,
                              -1, np.int64)
        for unit, il in self.tok_syms.items():
            if unit in token2id:
                self.gather[il] = token2id[unit]
        self._on_device = {}
        self._lock = threading.Lock()

    def is_ctc(self, blank_token: str) -> bool:
        """Whether the graph has the CTC topology of `build_tlg
        --ctc-blank`: the blank unit is one of its tokens."""
        return blank_token in self.tok_syms

    def gather_rows(self, log_probs: torch.Tensor) -> torch.Tensor:
        """[..., V] vocabulary rows -> [..., labels] rows, on their
        device."""
        dev = log_probs.device
        with self._lock:
            idx = self._on_device.get(dev)
            if idx is None:
                g = torch.as_tensor(self.gather, device=dev)
                idx = self._on_device[dev] = (g.clamp(min=0), g < 0)
        take, missing = idx
        return log_probs.index_select(-1, take).masked_fill(missing,
                                                            MISSING_LOGP)


class TlgDecoder:
    """The recognizers' lm_decoder contract (start_utterance, then
    decode(log_probs, id_to_token) -> text) over a TLG graph. Pass a
    loaded TlgGraph to share it across connections: a decoder then costs
    only its hotword bias and its search state. One decoder decodes one
    utterance at a time; close() frees its native handles."""

    def __init__(self, graph: "TlgGraph | str", token2id: Dict[str, int],
                 lm_weight: float = 0.5, beam: float = 16.0,
                 max_active: int = 2000,
                 hotwords: Optional[Dict[str, float]] = None):
        if not isinstance(graph, TlgGraph):
            graph = TlgGraph(graph, token2id)
        self.graph = graph
        self.id2word = graph.id2word
        bias = None
        if hotwords:
            words, scores = [], []
            for w, s in hotwords.items():
                ils = [graph.tok_syms.get(c) for c in w]
                if ils and all(i is not None for i in ils):
                    words.append(ils)
                    # a boost per symbol, as the AC bias LM spreads it
                    scores.append(float(s) / len(ils))
            if words:
                bias = NativeAcBias(words, scores)
        self._bias = bias
        self._dec = NativeTlgFstDecoder(graph.fst, beam=beam,
                                        max_active=max_active,
                                        ac_scale=1.0, lm_scale=lm_weight,
                                        bias=bias)

    def close(self):
        self._dec.close()
        if self._bias is not None:
            self._bias.close()

    def start_utterance(self):
        self._dec.start_utterance()

    def accept_ilabel_rows(self, rows: np.ndarray) -> None:
        """Feed [n, labels] rows (gather_rows' output) incrementally
        (AcceptLoglikes + AdvanceDecoding, wfst-decoder.cpp:27-57)."""
        self._dec.steps(rows)

    def accept_rows(self, log_probs: np.ndarray) -> None:
        """Feed [n, V] vocabulary rows incrementally; read partial_text()
        between calls, finish with decode_nbest or decode."""
        rows = torch.from_numpy(np.ascontiguousarray(log_probs, np.float32))
        self.accept_ilabel_rows(self.graph.gather_rows(rows).numpy())

    def partial_text(self) -> str:
        """The best hypothesis mid-utterance (partial best path)."""
        return self._words(self._dec.partial())

    def _words(self, word_ids: List[int]) -> str:
        return "".join(self.id2word.get(w, "") for w in word_ids)

    def nbest(self, n: int = 1) -> List[Tuple[str, float]]:
        """[(text, cost)] best-first over what was fed."""
        return [(self._words(w), c) for w, c in self._dec.nbest(n)]

    def decode_nbest(self, log_probs: np.ndarray, n: int = 1
                     ) -> List[Tuple[str, float]]:
        """Feed [U, V] vocabulary rows, return [(text, cost)]
        best-first."""
        self.accept_rows(log_probs)
        return self.nbest(n)

    def decode(self, log_probs: np.ndarray, id_to_token=None) -> str:
        res = self.decode_nbest(log_probs, 1)
        return res[0][0] if res else ""

    def decode_ilabel_rows(self, rows: np.ndarray) -> str:
        """decode() over rows already in input-label order."""
        self.accept_ilabel_rows(rows)
        res = self.nbest(1)
        return res[0][0] if res else ""

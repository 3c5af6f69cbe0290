"""OpenFST binary-format I/O in pure Python (StdArc / tropical weights).

Port copy of the JAX package's decode/fst_io.py (host code, unchanged).

Writes the `vector` format that OpenFST's `StdVectorFst::Read` (and our
native fst.cc loader) accepts, so artifacts we build — TLG decoding graphs
from tools/build_tlg.py, ITN grammars from text/itn_fst_build.py — are
interchangeable with reference deployments (the reference loads these at
onnxruntime/src/itn-processor.cpp:31-37 and via FunASRWfstDecoderInit).

Format (studied from the public OpenFST sources; re-implemented):
  header: int32 magic 2125659606, string fsttype, string arctype,
          int32 version, int32 flags, uint64 properties, int64 start,
          int64 numstates, int64 numarcs       (strings: int32 len + bytes)
  vector body, per state: float final_weight, int64 narcs,
          then per arc: int32 ilabel, int32 olabel, float weight,
          int32 nextstate
Non-final states store +inf as the final weight.
"""
from __future__ import annotations

import math
import struct
from typing import Dict, List, Optional, Tuple

MAGIC = 2125659606
SYMBOL_TABLE_MAGIC = 2125658996   # OpenFST symbol-table.cc
INF = math.inf

# arcs[state] = list of (ilabel, olabel, weight, nextstate)
Arcs = List[List[Tuple[int, int, float, int]]]


def write_vector_fst(path: str, start: int, arcs: Arcs,
                     finals: Dict[int, float]):
    """finals: state -> final weight (0.0 for plain acceptance)."""
    n_states = len(arcs)
    n_arcs = sum(len(a) for a in arcs)
    with open(path, "wb") as f:
        f.write(struct.pack("<i", MAGIC))
        for s in ("vector", "standard"):
            b = s.encode()
            f.write(struct.pack("<i", len(b)))
            f.write(b)
        # version 2, flags 0, properties: kExpanded|kMutable (0x3) is what
        # a freshly built VectorFst reports at minimum; readers only gate
        # on magic/type
        f.write(struct.pack("<iiQqqq", 2, 0, 0x3, start, n_states, n_arcs))
        for s in range(n_states):
            w = finals.get(s, INF)
            f.write(struct.pack("<f", w))
            f.write(struct.pack("<q", len(arcs[s])))
            for il, ol, wt, nxt in arcs[s]:
                f.write(struct.pack("<iifi", il, ol, wt, nxt))


def read_fst(path: str):
    """Reads vector-format StdArc FSTs (for tests / inspection). Returns
    (start, arcs, finals)."""
    with open(path, "rb") as f:
        data = f.read()
    off = 0

    def take(fmt):
        nonlocal off
        vals = struct.unpack_from("<" + fmt, data, off)
        off += struct.calcsize("<" + fmt)
        return vals

    (magic,) = take("i")
    if magic != MAGIC:
        raise ValueError("not an OpenFST file")
    strs = []
    for _ in range(2):
        (n,) = take("i")
        strs.append(data[off:off + n].decode())
        off += n
    fsttype, arctype = strs
    if fsttype != "vector" or arctype != "standard":
        raise ValueError(f"unsupported fst/arc type: {fsttype}/{arctype}")
    _ver, flags = take("ii")
    (_props,) = take("Q")
    start, n_states, _n_arcs = take("qqq")

    def skip_symbol_table():
        nonlocal off
        (magic,) = take("i")
        if magic != SYMBOL_TABLE_MAGIC:
            raise ValueError("corrupt embedded symbol table")
        (n,) = take("i")          # name
        off += n
        take("q")                 # available_key
        (count,) = take("q")
        for _ in range(count):
            (n,) = take("i")      # symbol
            off += n
            take("q")             # key

    # embedded symbol tables (FstHeader flags 0x1/0x2) precede the states
    if flags & 0x1:
        skip_symbol_table()
    if flags & 0x2:
        skip_symbol_table()
    arcs: Arcs = []
    finals: Dict[int, float] = {}
    for s in range(n_states):
        (w,) = take("f")
        if w != INF:
            finals[s] = w
        (na,) = take("q")
        state_arcs = []
        for _ in range(na):
            il, ol, wt, nxt = take("iifi")
            state_arcs.append((il, ol, wt, nxt))
        arcs.append(state_arcs)
    return start, arcs, finals


class FstBuilder:
    """Tiny mutable FST builder for grammar/graph compilation."""

    def __init__(self):
        self.arcs: Arcs = []
        self.finals: Dict[int, float] = {}
        self.start = self.new_state()

    def new_state(self) -> int:
        self.arcs.append([])
        return len(self.arcs) - 1

    def add_arc(self, src: int, il: int, ol: int, w: float, dst: int):
        self.arcs[src].append((il, ol, float(w), dst))

    def set_final(self, state: int, w: float = 0.0):
        self.finals[state] = float(w)

    def add_string(self, src: int, ils: List[int], ols: List[int],
                   w: float = 0.0) -> int:
        """Chain of arcs transducing ils -> ols (padded with epsilons to
        the longer side); weight on the first arc. Returns the end state."""
        n = max(len(ils), len(ols))
        if n == 0:
            return src
        cur = src
        for i in range(n):
            nxt = self.new_state()
            self.add_arc(cur, ils[i] if i < len(ils) else 0,
                         ols[i] if i < len(ols) else 0,
                         w if i == 0 else 0.0, nxt)
            cur = nxt
        return cur

    def write(self, path: str):
        write_vector_fst(path, self.start, self.arcs, self.finals)

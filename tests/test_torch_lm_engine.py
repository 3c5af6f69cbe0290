"""LM and TLG rescoring and FST ITN through the port's StreamEngine and
websocket server, against the JAX package's on the CPU (the recognizers
and ServerModels: tests/test_torch_lm_serving.py).

Weights come from the JAX `init` (paraformer_tiny with the timestamp
head, VadConfig(), punc_tiny) and reach the port through
`params_from_jax`; the LM, its graphs and the toy ITN grammars (over
every unit of the test vocabulary, two in three rewritten to digits)
are tests/torch_parity.lm_test_dirs'. Per-stream finals, timestamps and
partials must be equal.
"""
import time

import numpy as np
import pytest
import torch

from asr2pass_tpu import config as jconfig
from asr2pass_tpu.decode.lm_decoder import Lexicon as JLexicon
from asr2pass_tpu.runtime import engine as jengine
from asr2pass_tpu.runtime import model_zoo as jzoo
from asr2pass_tpu.server.engine import ServerModels as JServerModels
from asr2pass_tpu.server.ws_server import AsrWsServer as JAsrWsServer
from asr2pass_tpu.text.itn import FstITN as JFstITN
from asr2pass_tpu.text.punc_tokenizer import PuncTokenizer as JTokenizer
from asr2pass_tpu.text.vocab import make_test_vocab
from asr2pass_tpu_torch import config as tconfig
from asr2pass_tpu_torch.decode.lm_decoder import Lexicon
from asr2pass_tpu_torch.native import bindings as tnb
from asr2pass_tpu_torch.runtime import model_zoo
from asr2pass_tpu_torch.runtime.engine import StreamEngine
from asr2pass_tpu_torch.runtime.model_zoo import params_from_jax
from asr2pass_tpu_torch.server.engine import ServerModels
from asr2pass_tpu_torch.server.run_server import build_models, parser
from asr2pass_tpu_torch.server.ws_server import AsrWsServer
from asr2pass_tpu_torch.text.punc_tokenizer import PuncTokenizer as TTokenizer
from asr2pass_tpu_torch.text.vocab import Vocab as TVocab
from test_torch_server import _reference_replay, _summary
from test_torch_server import _serve as serve_ws
from torch_parity import LM_REWRITE, lm_test_dirs, lm_trees, speechy

VOCAB = make_test_vocab(64)
PUNC_TOKENS = ["<blank>", "<unk>"] + [chr(0x4E00 + i) for i in range(200)]
LM_WEIGHT = 1.5         # strong enough that the LM changes tiny models' texts


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Tiny models gain nothing from torch's full CPU thread pool, and the
    tier-1 run has six test processes on the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def lm_dirs(tmp_path_factory):
    return lm_test_dirs(tmp_path_factory.mktemp("lm"))


@pytest.fixture(scope="module")
def trees():
    return lm_trees()


# -- the engine --------------------------------------------------------------

def _engine_pair(trees, lm_dirs, kind):
    lex = Lexicon.from_file(lm_dirs["arpa"] + "/lexicon.txt")
    jlex = JLexicon.from_file(lm_dirs["arpa"] + "/lexicon.txt")
    pj, pt = jconfig.punc_tiny(300), tconfig.punc_tiny(300)
    lm_kw = (dict(tlg_dir=lm_dirs["tlg"]) if kind == "tlg"
             else dict(lm=lm_dirs["lm"], lexicon=lex))
    jlm_kw = (dict(tlg_dir=lm_dirs["tlg"]) if kind == "tlg"
              else dict(lm=lm_dirs["jlm"], lexicon=jlex))
    jm = JServerModels(
        asr_params=trees["asr"], asr_cfg=trees["jcfg"], vocab=VOCAB,
        vad_params=trees["vad"], vad_cfg=jconfig.VadConfig(),
        punc_params=trees["punc"], punc_cfg=pj,
        punc_tokenizer=JTokenizer(PUNC_TOKENS), lm_weight=LM_WEIGHT,
        **jlm_kw)
    tm = ServerModels(
        asr_params=params_from_jax(trees["asr"]), asr_cfg=trees["tcfg"],
        vocab=TVocab(VOCAB.tokens), vad_params=params_from_jax(trees["vad"]),
        vad_cfg=tconfig.VadConfig(), punc_params=params_from_jax(
            trees["punc"]), punc_cfg=pt,
        punc_tokenizer=TTokenizer(PUNC_TOKENS), lm_weight=LM_WEIGHT,
        device="cpu", **lm_kw)
    return jm, tm


def _drive_engine(eng, waves, opens):
    """tests/test_torch_engine.py's driver: 9600-sample messages, one a
    stream a tick, then ticks until drained."""
    sids = [eng.open(**o) for o in opens]
    out = {sid: [] for sid in sids}
    for off in range(0, max(len(w) for w in waves), 9600):
        for sid, w in zip(sids, waves):
            if off < len(w):
                eng.feed(sid, w[off: off + 9600],
                         is_final=off + 9600 >= len(w))
        eng.step()
        for sid in sids:
            out[sid] += eng.poll(sid)
    deadline = time.time() + 120
    while time.time() < deadline and not (
            all(eng.drained(s) for s in sids) and not eng.has_inflight()):
        eng.step()
        for sid in sids:
            out[sid] += eng.poll(sid)
        time.sleep(0.005)
    for sid in sids:
        out[sid] += eng.poll(sid)
    return sids, [[(r["text"], r.get("timestamp")) for r in out[s]
                   if r["mode"] == "2pass-offline"] for s in sids]


@pytest.mark.parametrize("kind,tick", [("arpa", {}),
                                       ("tlg", dict(pass2_async=True))])
def test_engine_with_lm_slots_matches_jax(trees, lm_dirs, kind, tick):
    """Three streams, one with hotwords: the finals and timestamps of
    JAX's engine with the same LM; the hotworded slot holds its own
    decoder (a clone of the shared native one, or its own TlgDecoder),
    which a reopen and shutdown() free."""
    jm, tm = _engine_pair(trees, lm_dirs, kind)
    waves = [speechy(s, 80 + i) for i, s in enumerate((2.0, 1.4, 2.6))]
    hot = {lm_dirs["words"][1] + lm_dirs["words"][2]: 12}
    opens = [dict(hotwords=hot), dict(), dict()]
    jeng = jengine.StreamEngine(jm, capacity=4, **tick)
    _, want = _drive_engine(jeng, waves, opens)
    jeng.shutdown()
    eng = StreamEngine(tm, capacity=4, **tick)
    sids, got = _drive_engine(eng, waves, opens)
    assert got == want and all(f for f in got)
    decs = [eng.slots[s].lm_decoder for s in sids]
    if kind == "arpa":
        assert decs[1] is decs[2] is tm._lm_bases["asr"]
        assert decs[0] is not decs[1]
    else:
        assert len({id(d) for d in decs}) == 3
    eng.close(sids[0])
    eng.open()                        # takes the first free slot again
    with pytest.raises(RuntimeError, match="closed"):
        decs[0].start_utterance() if kind == "tlg" else decs[0].decode(
            np.zeros((1, 64), np.float32), VOCAB.id2token)
    eng.shutdown()
    if kind == "arpa":
        assert isinstance(decs[1].decode(np.zeros((1, 64), np.float32),
                                         VOCAB.id2token), str)
    else:
        with pytest.raises(RuntimeError, match="closed"):
            decs[1].start_utterance()


# -- the server --------------------------------------------------------------

@pytest.fixture(scope="module")
def served_dirs(trees, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dirs")
    jzoo.save_offline_bundle(str(tmp / "asr"), trees["asr"], trees["jcfg"],
                             VOCAB.tokens)
    model_zoo.save_vad_dir(str(tmp / "vad"), params_from_jax(trees["vad"]),
                           tconfig.VadConfig())
    model_zoo.save_punc_dir(str(tmp / "punc"), params_from_jax(trees["punc"]),
                            tconfig.punc_tiny(300), PUNC_TOKENS)
    return tmp


_LM_REPLAYS = {
    "2pass_tlg": ("2pass", "tlg", {}),
    "offline_arpa": ("offline", "arpa", {}),
    "engine_arpa": ("2pass", "arpa", dict(use_engine=True,
                                          engine_capacity=4)),
}


@pytest.mark.parametrize("case", list(_LM_REPLAYS))
def test_replay_with_lm_and_fst_itn_matches_jax(trees, lm_dirs, served_dirs,
                                                case):
    """The reference client's replay against the port's server launched
    with --lm-dir and --itn-dir and against the JAX server with the same
    LM and FstITN: equal finals, timestamps and partials; the finals
    carry the grammar's digits and none of the units it rewrites; the
    native library decoded every final and normalized it."""
    mode, kind, kw = _LM_REPLAYS[case]
    d = served_dirs
    args = parser().parse_args([
        "--model-dir", str(d / "asr"), "--vad-dir", str(d / "vad"),
        "--punc-dir", str(d / "punc"), "--lm-dir", lm_dirs[kind],
        "--lm-weight", str(LM_WEIGHT), "--itn-dir", lm_dirs["itn"],
        "--device", "cpu"])
    port = build_models(args)
    jlex = JLexicon.from_file(lm_dirs["arpa"] + "/lexicon.txt")
    jm = JServerModels(
        asr_params=trees["asr"], asr_cfg=trees["jcfg"], vocab=VOCAB,
        vad_params=trees["vad"], vad_cfg=jconfig.VadConfig(),
        punc_params=trees["punc"], punc_cfg=jconfig.punc_tiny(300),
        punc_tokenizer=JTokenizer(PUNC_TOKENS), lm_weight=LM_WEIGHT,
        itn=JFstITN(lm_dirs["itn"] + "/zh_itn_tagger.fst",
                    lm_dirs["itn"] + "/zh_itn_verbalizer.fst"),
        **(dict(tlg_dir=lm_dirs["tlg"]) if kind == "tlg"
           else dict(lm=lm_dirs["jlm"], lexicon=jlex)))
    rng = np.random.default_rng(7)
    x = np.concatenate([speechy(1.2, 90), np.zeros(9600, np.float32),
                        speechy(1.0, 91)])
    audio = (np.clip(x + 0.001 * rng.standard_normal(len(x)), -1, 1)
             * 32767).astype("<i2").tobytes()
    msgs = {}
    tnb.reset_call_counts()
    for name, cls, m in (("port", AsrWsServer, port),
                         ("jax", JAsrWsServer, jm)):
        msgs[name] = serve_ws(m, lambda server, port: _reference_replay(
            port, mode, "w", audio), server_cls=cls, **kw)
        if name == "port":
            calls = tnb.call_counts()
    partial, finals = _summary(msgs["port"])
    assert _summary(msgs["jax"]) == (partial, finals)
    texts = "".join(t for _, t, _ in finals)
    assert finals and texts
    assert set(texts) & set(LM_REWRITE.values())
    assert not set(texts) & set(LM_REWRITE)
    n = len(finals)
    key = "tlg_nbest" if kind == "tlg" else "lm_decode"
    assert calls[key] >= n and calls["fst_transduce"] >= 2 * n



# -- chip_smoke.py 10c's finals gate ------------------------------------------

def _decode(rows, best, second, gap):
    return {"dec": 0, "rows": rows, "nbest": [(best, 10.0),
                                              (second, 10.0 + gap)]}


@pytest.mark.parametrize("case,agree", [
    ("equal", True), ("near_tie", True), ("gap_too_wide", False),
    ("not_each_others_second", False), ("same_tlg_text", False),
    ("missing_decode", False), ("no_finals", False)])
def test_finals_gate_accepts_only_near_ties(case, agree):
    """chip_smoke.finals_agree: a connection's finals against a session's
    agree when equal, or where each differing final's TLG decision is a
    swap of the two best paths whose gaps sum within twice the summed
    largest row difference (rows differing by 1e-5 over 4 rows allow
    8e-5); anything else fails."""
    import chip_smoke

    rng = np.random.default_rng(0)
    rows = rng.standard_normal((4, 6)).astype(np.float32)
    near = rows + np.float32(1e-5)
    e = [_decode(rows, "ab", "cd", 0.5), _decode(rows, "xy", "xz", 3e-5)]
    s = [_decode(rows, "ab", "cd", 0.5), _decode(near, "xz", "xy", 0.0)]
    got, want = ["AB。", "XY。"], ["AB。", "XZ。"]
    if case == "equal":
        want = got
    elif case == "gap_too_wide":
        e[1] = _decode(rows, "xy", "xz", 1e-3)
    elif case == "not_each_others_second":
        s[1] = _decode(near, "xz", "qq", 0.0)
    elif case == "same_tlg_text":
        s[1] = _decode(near, "xy", "xz", 0.0)
    elif case == "missing_decode":
        s = s[:1]
    elif case == "no_finals":
        got = want = []
    assert chip_smoke.finals_agree(got, want, e, s)[0] is agree

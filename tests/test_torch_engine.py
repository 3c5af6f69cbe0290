"""The port's StreamEngine against the JAX package's on the CPU: the
fused VAD and pass-1 steps, whole engines under three ticks, and the
slot lifecycle of tests/test_engine.py on the port.

Weights come from the JAX `init` (paraformer_tiny, VadConfig(), punc_tiny)
and reach the port through `params_from_jax`; audio is made with numpy
from a seed. Tolerances: the fused steps run fbank as fp32 products in
another summation order than XLA, which moves a few low log-mel bins by
up to a few 1e-4 (tests/test_torch_frontend.py: atol 1e-3); the mel
history and the pending-feature ring (CMVN scales it by <= 0.4) are
held to that, the silence posteriors and the VAD caches to VAD_ATOL,
the pass-1 state to the model tolerance of tests/test_torch_streaming.py
(1e-4) except its feature cache, which holds those features scaled by
sqrt(d) and is held to the mel tolerance scaled the same way. The int16
audio ring, token ids and counts must be equal, and whole engines must
give equal per-stream finals, timestamps and partial text.
"""
import dataclasses
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asr2pass_tpu import config as jconfig
from asr2pass_tpu.models import ct_transformer as jct
from asr2pass_tpu.models import fsmn_vad as jvad
from asr2pass_tpu.models import hotword as jhw
from asr2pass_tpu.models import paraformer_online as jonline
from asr2pass_tpu.runtime import engine as jengine
from asr2pass_tpu.server.engine import ServerModels as JServerModels
from asr2pass_tpu.text.itn import ChineseITN as JITN
from asr2pass_tpu.text.punc_tokenizer import PuncTokenizer as JTokenizer
from asr2pass_tpu.text.vocab import make_test_vocab
from asr2pass_tpu_torch import config as tconfig
from asr2pass_tpu_torch.frontend.audio import quantize_pcm
from asr2pass_tpu_torch.models import fsmn_vad as tvad
from asr2pass_tpu_torch.models import paraformer_online as tonline
from asr2pass_tpu_torch.runtime import engine as tengine
from asr2pass_tpu_torch.runtime.engine import EngineAtCapacity, StreamEngine
from asr2pass_tpu_torch.runtime.model_zoo import params_from_jax
from asr2pass_tpu_torch.runtime.streaming_frontend import StreamingFrontend
from asr2pass_tpu_torch.server.engine import ServerModels
from asr2pass_tpu_torch.text.itn import ChineseITN as TITN
from asr2pass_tpu_torch.text.punc_tokenizer import PuncTokenizer as TTokenizer
from asr2pass_tpu_torch.text.vocab import Vocab as TVocab
from torch_parity import (bursty, jax_params, port_model, svs_tree,
                          tiny_cfgs)

MEL_ATOL = 1e-3
VAD_ATOL = 1e-4
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)
PUNC_TOKENS = ["<blank>", "<unk>"] + [chr(0x4E00 + i) for i in range(200)]


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Tiny models gain nothing from torch's full CPU thread pool, and the
    tier-1 run has six test processes on the machine's cores: two threads
    a process keep the other files' timing-sensitive tests unstarved."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
RING = 1 << 17


def _wave(seed, seconds=2.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(int(16000 * seconds)) * 0.1).astype(
        np.float32)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


# -- the fused VAD step ------------------------------------------------------

def _vad_cfgs(lfr_m, lfr_n):
    if (lfr_m, lfr_n) == (5, 1):
        return jconfig.VadConfig(), tconfig.VadConfig()
    kw = dict(input_dim=80 * lfr_m, proj_dim=32, fsmn_layers=2,
              hidden_dim=48, output_dim=16)
    return (jconfig.VadConfig(frontend=jconfig.FrontendConfig(
                lfr_m=lfr_m, lfr_n=lfr_n), **kw),
            tconfig.VadConfig(frontend=tconfig.FrontendConfig(
                lfr_m=lfr_m, lfr_n=lfr_n), **kw))


@pytest.mark.parametrize("lfr_m,lfr_n", [(5, 1), (5, 2), (7, 3)])
def test_fused_vad_step_matches_jax(lfr_m, lfr_n):
    """Capacity 4, slots 0 and 2 active with different chunkings (slot 2
    starts 3200 samples before the ring end, so its windows wrap), slots
    1 and 3 idle; each tick's inputs are the engine's host accounting.
    Posteriors of the emitted rows, mel history and caches within
    tolerance; the int16 ring bit-equal."""
    jcfg, tcfg = _vad_cfgs(lfr_m, lfr_n)
    tree = jax.tree.map(np.asarray, jvad.init(jax.random.PRNGKey(3), jcfg))
    model = tvad.from_state_dict(params_from_jax(tree), tcfg, "cpu")
    fcfg = tcfg.frontend
    cap = 4
    jstep, _, max_new = jengine._fused_vad_step(jcfg.frontend, cap, (0,),
                                                RING)
    tstep, _, t_max_new = tengine._fused_vad_step(
        fcfg, cap, (0,), RING, torch.device("cpu"))
    assert t_max_new == max_new
    rng = np.random.default_rng(lfr_m * 10 + lfr_n)
    d = fcfg.lfr_dim
    means = rng.uniform(-12, -8, d).astype(np.float32)
    vars_ = rng.uniform(0.2, 0.4, d).astype(np.float32)
    plans = {0: [3200, 5000, 160, 7040, 9000, 6000],
             2: [3200, 9600, 9600, 800, 4000, 9600]}
    waves = {sid: quantize_pcm(rng.standard_normal(sum(p)) * 0.1)
             for sid, p in plans.items()}
    st = {sid: dict(fe=StreamingFrontend(fcfg, device="cpu"), abs=0,
                    total=0, nxt=0, off=0) for sid in plans}
    st[2]["abs"] = RING - 3200
    jhist = jnp.zeros((cap, fcfg.lfr_m - 1, fcfg.n_mels), jnp.float32)
    jcaches = jvad.init_caches(jcfg, cap)
    jring = jnp.zeros((cap, RING), jnp.int16)
    thist = torch.zeros(cap, fcfg.lfr_m - 1, fcfg.n_mels)
    tcaches = tvad.init_caches(tcfg, cap, "cpu")
    tring = torch.zeros(cap, RING, dtype=torch.int16)
    left = (fcfg.lfr_m - 1) // 2
    emitted = 0
    for tick in range(6):
        w = np.zeros((cap, max_new), np.int16)
        ints = np.zeros((8, cap), np.int64)
        for sid, s in st.items():
            n = plans[sid][tick]
            piece = waves[sid][s["off"]: s["off"] + n]
            s["off"] += n
            final = tick == 5
            buf, nf = s["fe"].stage(piece)
            w[sid, :n] = (piece * 32768.0).astype(np.int16)
            tot = s["total"] + nf
            if final:
                upto = -(-tot // fcfg.lfr_n)
                s["fe"].reset()
            else:
                upto = max((tot - 1 - (fcfg.lfr_m - 1) + left)
                           // fcfg.lfr_n + 1, 0)
            upto = max(upto, s["nxt"])
            ints[:, sid] = (nf, s["nxt"], tot, upto - s["nxt"], final,
                            s["abs"] % RING, n,
                            (s["abs"] - (len(buf) - n)) % RING)
            s["abs"] += n
            s["total"], s["nxt"] = (0, 0) if final else (tot, upto)
        j = [jnp.asarray(r.astype(np.int32)) for r in ints]
        jsil, jhist, jcaches, jring = jstep(
            tree, jnp.asarray(means), jnp.asarray(vars_), jnp.asarray(w),
            j[0], j[1], j[2], j[3], j[4].astype(bool), jhist, jcaches,
            jring, j[5], j[6], j[7])
        r = _t(ints)
        tsil, thist, tcaches = tstep(
            model, _t(means), _t(vars_), _t(w), r[0], r[1], r[2], r[3],
            r[4], thist, tcaches, tring, r[5], r[6], r[7])
        np.testing.assert_array_equal(tring.numpy(), np.asarray(jring))
        for sid in st:
            k = int(ints[3, sid])
            emitted += k
            np.testing.assert_allclose(tsil[sid, :k].numpy(),
                                       np.asarray(jsil)[sid, :k],
                                       rtol=0, atol=VAD_ATOL)
        np.testing.assert_allclose(thist.numpy(), np.asarray(jhist),
                                   rtol=0, atol=MEL_ATOL)
        for a, b in zip(tcaches, jcaches):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                       atol=VAD_ATOL)
    assert emitted > 0


# -- the fused pass-1 step ---------------------------------------------------

def test_fused_p1_step_matches_jax():
    """Capacity 4, slots 0 and 2 stage speech from a random int16 audio
    ring (slot 2's range wraps the ring end) through the engine's host
    accounting, round by round, until each utterance's final chunk is
    consumed. Ids and counts equal; state, mel history and the
    pending-feature ring within tolerance."""
    jcfg, tcfg = tiny_cfgs()
    tree = jax_params(jcfg, 0)
    model = port_model(tree, tcfg)
    cap = 4
    (jstep, need, hist_n, ring_n, k_max) = jengine._fused_p1_step(
        jcfg, cap, RING)
    tstep, t_need, t_hist, t_ring_n, t_kmax = tengine._fused_p1_step(
        tcfg, cap, RING, torch.device("cpu"))
    assert (t_need, t_hist, t_ring_n, t_kmax) == (need, hist_n, ring_n,
                                                  k_max)
    fcfg = tcfg.frontend
    rng = np.random.default_rng(9)
    audio = (rng.standard_normal((cap, RING)) * 3000).astype(np.int16)
    d = fcfg.lfr_dim
    means = rng.uniform(-12, -8, d).astype(np.float32)
    vars_ = rng.uniform(0.2, 0.4, d).astype(np.float32)
    center = tcfg.chunk_size[1]
    shift, flen = fcfg.frame_shift, fcfg.frame_length
    lfr_m, lfr_n = fcfg.lfr_m, fcfg.lfr_n
    left = (lfr_m - 1) // 2
    max_stage = (k_max - 2) * lfr_n * shift
    slots = {0: dict(start=0, left=40000), 2: dict(start=RING - 7000,
                                                  left=31000)}
    for s in slots.values():
        s.update(cursor=s["start"], residual=0, total=0, win=0, ring_w=0,
                 ring_r=0, flush_at=None, done=False)
    jstate = jonline.init_state(tree, jcfg, cap)
    tstate = tonline.init_state(model, tcfg, cap)
    jmh = jnp.zeros((cap, hist_n, fcfg.n_mels), jnp.float32)
    jpr = jnp.zeros((cap, ring_n, d), jnp.float32)
    tmh = torch.zeros(cap, hist_n, fcfg.n_mels)
    tpr = torch.zeros(cap, ring_n, d)
    jaudio = jnp.asarray(audio)
    n_tok = 0
    for _ in range(60):
        ints = np.zeros((10, cap), np.int64)
        for sid, s in slots.items():
            if s["left"] and s["flush_at"] is None:
                take = min(s["left"], max_stage)
                fin = take == s["left"]
                s["left"] -= take
                lbuf = s["residual"] + take
                n = (lbuf - flen) // shift + 1 if lbuf >= flen else 0
                ints[0, sid] = s["cursor"] % RING
                s["cursor"] += n * shift
                s["residual"] = 0 if fin else lbuf - n * shift
                tot = s["total"] + n
                if fin:
                    upto = -(-tot // lfr_n)
                else:
                    upto = max((tot - 1 - (lfr_m - 1) + left) // lfr_n + 1,
                               s["win"])
                ints[1:5, sid] = (n, s["win"], tot, upto - s["win"])
                ints[6, sid] = s["ring_w"] % ring_n
                s["ring_w"] += upto - s["win"]
                if fin:
                    ints[5, sid] = 1
                    s["total"], s["win"] = 0, 0
                    s["flush_at"] = s["ring_w"]
                else:
                    s["total"], s["win"] = tot, upto
            else:
                ints[2, sid], ints[3, sid] = s["win"], s["total"]
                ints[6, sid] = s["ring_w"] % ring_n
            cnt = 0
            if s["flush_at"] is not None:
                if s["flush_at"] - s["ring_r"] <= center:
                    cnt = s["flush_at"] - s["ring_r"]
                    ints[9, sid] = 1
                    s["flush_at"] = None
                    s["done"] = True
                else:
                    cnt = center
            elif s["ring_w"] - s["ring_r"] >= center:
                cnt = center
            ints[7, sid] = s["ring_r"] % ring_n
            ints[8, sid] = cnt
            s["ring_r"] += cnt
        j = [jnp.asarray(r.astype(np.int32)) for r in ints]
        jstate, jids, jn, jmh, jpr = jstep(
            tree, jnp.asarray(means), jnp.asarray(vars_), jstate, jaudio,
            j[0], j[1], j[2], j[3], j[4], j[5].astype(bool), j[6], j[7],
            j[8], j[9].astype(bool), jmh, jpr)
        r = _t(ints)
        tstate, tids, tn, tmh = tstep(
            model, _t(means), _t(vars_), tstate, _t(audio), *r, tmh, tpr)
        np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
        for b in range(cap):
            k = int(tn[b])
            np.testing.assert_array_equal(tids[b, :k].numpy(),
                                          np.asarray(jids)[b, :k])
        n_tok += int(tn.sum())
        for name in tonline.OnlineState._fields:
            # the feature cache holds the CMVN features scaled by sqrt(d):
            # the mel tolerance, scaled the same way
            tol = (dict(rtol=0, atol=MEL_ATOL * tcfg.encoder.output_size
                        ** 0.5) if name == "feats_cache" else MODEL_TOL)
            np.testing.assert_allclose(
                getattr(tstate, name).numpy(),
                np.asarray(getattr(jstate, name)), **tol)
        np.testing.assert_allclose(tmh.numpy(), np.asarray(jmh), rtol=0,
                                   atol=MEL_ATOL)
        np.testing.assert_allclose(tpr.numpy(), np.asarray(jpr), rtol=0,
                                   atol=MEL_ATOL)
        if all(s["done"] for s in slots.values()):
            break
    assert all(s["done"] for s in slots.values())
    assert n_tok > 0


# -- whole engines, port against JAX -------------------------------------------

@pytest.fixture(scope="module")
def parity_models():
    """(JAX ServerModels, port ServerModels): paraformer_tiny with the
    bicif timestamp head for both passes, VadConfig(), punc_tiny, ITN."""
    jcfg, tcfg = tiny_cfgs(timestamp=True)
    tree = jax_params(jcfg, 0)
    vad_tree = jax.tree.map(np.asarray, jvad.init(jax.random.PRNGKey(1),
                                                  jconfig.VadConfig()))
    pj, pt = jconfig.punc_tiny(300), tconfig.punc_tiny(300)
    punc_tree = jax.tree.map(np.asarray, jct.init(jax.random.PRNGKey(2), pj))
    vocab = make_test_vocab(jcfg.vocab_size)
    jm = JServerModels(
        asr_params=tree, asr_cfg=jcfg, vocab=vocab,
        vad_params=vad_tree, vad_cfg=jconfig.VadConfig(),
        punc_params=punc_tree, punc_cfg=pj,
        punc_tokenizer=JTokenizer(PUNC_TOKENS), itn=JITN())
    tm = ServerModels(
        asr_params=params_from_jax(tree), asr_cfg=tcfg,
        vocab=TVocab(vocab.tokens), vad_params=params_from_jax(vad_tree),
        vad_cfg=tconfig.VadConfig(), punc_params=params_from_jax(punc_tree),
        punc_cfg=pt, punc_tokenizer=TTokenizer(PUNC_TOKENS), itn=TITN(),
        device="cpu")
    return jm, tm


_STREAMS = (2.0, 1.4, 2.6)
_TICKS = {
    "default": {},
    "fused_fetch": dict(fused_fetch=True, pass2_async=True),
    "upload_overlap": dict(fused_fetch=True, pass2_async=True,
                           upload_overlap=True, decide_async=True),
}


def _serve(eng, waves, opens=None):
    """Streams in 9600-sample messages, one message per stream a tick,
    then ticks until every stream is drained; opens[i] are stream i's
    open() options. Returns per stream (concatenated partials, [(final
    text, timestamps)])."""
    sids = [eng.open(**(opens[i] if opens else {}))
            for i in range(len(waves))]
    out = {sid: [] for sid in sids}
    n = max(len(w) for w in waves)
    for off in range(0, n, 9600):
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
        assert eng.drained(sid)
    eng.shutdown()
    return [("".join(r["text"] for r in out[s]
                     if r["mode"] == "2pass-online"),
             [(r["text"], r.get("timestamp")) for r in out[s]
              if r["mode"] == "2pass-offline"]) for s in sids]


@pytest.mark.parametrize("tick", list(_TICKS))
def test_engine_matches_jax(parity_models, tick):
    jm, tm = parity_models
    waves = [_wave(50 + i, s) for i, s in enumerate(_STREAMS)]
    ref = _serve(jengine.StreamEngine(jm, capacity=4, **_TICKS[tick]),
                 waves)
    got = _serve(StreamEngine(tm, capacity=4, **_TICKS[tick]), waves)
    assert got == ref
    for partial, finals in ref:
        assert partial and finals and all(ts for _, ts in finals)


HW_CFG = dict(vocab_size=64, embed_dim=32, hidden_dim=64)


@pytest.fixture(scope="module")
def hw_parity_models():
    """(JAX ServerModels, port ServerModels) of parity_models' kind with
    the hotword block and a converted hotword compiler (no null row)."""
    jcfg, tcfg = tiny_cfgs(timestamp=True, hotword=True)
    tree = jax_params(jcfg, 0)
    hw = jax.tree.map(np.asarray, jhw.init(jax.random.PRNGKey(5),
                                           jconfig.HotwordConfig(**HW_CFG)))
    hw = {"embed": hw["embed"], "lstm": hw["lstm"]}
    vad_tree = jax.tree.map(np.asarray, jvad.init(jax.random.PRNGKey(1),
                                                  jconfig.VadConfig()))
    pj, pt = jconfig.punc_tiny(300), tconfig.punc_tiny(300)
    punc_tree = jax.tree.map(np.asarray, jct.init(jax.random.PRNGKey(2), pj))
    vocab = make_test_vocab(jcfg.vocab_size)
    jm = JServerModels(
        asr_params=tree, asr_cfg=jcfg, vocab=vocab,
        vad_params=vad_tree, vad_cfg=jconfig.VadConfig(),
        punc_params=punc_tree, punc_cfg=pj,
        punc_tokenizer=JTokenizer(PUNC_TOKENS), itn=JITN(),
        hotword_params=hw, hotword_cfg=jconfig.HotwordConfig(**HW_CFG))
    tm = ServerModels(
        asr_params=params_from_jax(tree), asr_cfg=tcfg,
        vocab=TVocab(vocab.tokens), vad_params=params_from_jax(vad_tree),
        vad_cfg=tconfig.VadConfig(), punc_params=params_from_jax(punc_tree),
        punc_cfg=pt, punc_tokenizer=TTokenizer(PUNC_TOKENS), itn=TITN(),
        hotword_params=params_from_jax(hw),
        hotword_cfg=tconfig.HotwordConfig(**HW_CFG), device="cpu")
    return jm, tm


def _hotword_opens(models):
    t = models.vocab.id2token
    lists = [{t(10) + t(11): 20, t(30): 20}, None,
             {t(12 + i) + t(40 + i): 20 for i in range(6)}]
    return [dict(hw_emb=models.compile_hotwords(h) if h else None,
                 hotwords=h) for h in lists]


@pytest.mark.parametrize("tick", ["default", "fused_fetch"])
def test_engine_hotwords_match_jax(hw_parity_models, tick):
    """Three streams, two of them with compiled hotword embeddings in two
    hotword-count buckets: JAX's finals, timestamps and partials, and
    every pass-2 forward carries embeddings only for hotworded rows."""
    jm, tm = hw_parity_models
    waves = [_wave(60 + i, s) for i, s in enumerate(_STREAMS)]
    ref = _serve(jengine.StreamEngine(jm, capacity=4, **_TICKS[tick]),
                 waves, _hotword_opens(jm))
    eng = StreamEngine(tm, capacity=4, **_TICKS[tick])
    fwd, seen = eng.offline.asr._forward, []

    def spy(feats, lens, hw_batch=None, hw_lens=None):
        seen.append((len([n for n in lens if n]), list(hw_lens or [])))
        return fwd(feats, lens, hw_batch, hw_lens)

    eng.offline.asr._forward = spy
    got = _serve(eng, waves, _hotword_opens(tm))
    assert got == ref
    for partial, finals in ref:
        assert partial and finals and all(ts for _, ts in finals)
    real = [(n, lens) for n, lens in seen if n]
    assert any(lens for _, lens in real) and any(not lens for _, lens in real)
    assert all(not lens or all(lens[:n]) for n, lens in real)


SVS_TOKENS = make_test_vocab(64).tokens


@pytest.fixture(scope="module")
def svs_parity_models(parity_models):
    """parity_models with SenseVoice (sensevoice_tiny with a 2-block tp
    stack) as pass 2."""
    jm, tm = parity_models
    tree = svs_tree(2, seed=3)
    rng = np.random.default_rng(8)
    cmvn = (rng.uniform(-12, -8, 560).astype(np.float32),
            rng.uniform(0.2, 0.4, 560).astype(np.float32))
    jsvs = dataclasses.replace(
        jm, svs_params=tree, svs_cfg=jconfig.sensevoice_tiny(),
        svs_vocab=make_test_vocab(64), svs_cmvn=cmvn)
    tsvs = dataclasses.replace(
        tm, asr_params=tm.asr_params, svs_params=params_from_jax(tree),
        svs_cfg=tconfig.sensevoice_tiny(), svs_vocab=TVocab(SVS_TOKENS),
        svs_cmvn=cmvn)
    return jsvs, tsvs


@pytest.mark.parametrize("tick", ["default", "fused_fetch"])
def test_engine_sensevoice_matches_jax(svs_parity_models, tick):
    """SenseVoice pass 2 with per-slot svs_lang, svs_itn and a hotword
    context graph on one slot: JAX's finals and partials."""
    jm, tm = svs_parity_models
    waves = [_wave(70 + i, s) for i, s in enumerate(_STREAMS)]
    t = tm.svs_vocab.id2token
    opens = [dict(svs_lang="en", svs_itn=False),
             dict(svs_lang="zh", hotwords={t(7) + t(8): 60}),
             dict()]
    ref = _serve(jengine.StreamEngine(jm, capacity=4, **_TICKS[tick]),
                 waves, opens)
    eng = StreamEngine(tm, capacity=4, **_TICKS[tick])
    assert isinstance(eng.offline.asr, tengine.SenseVoiceOffline)
    got = _serve(eng, waves, opens)
    assert got == ref
    assert all(partial and finals for partial, finals in ref)
    assert any(text for _, finals in ref for text, _ in finals)


# -- the slot lifecycle (tests/test_engine.py on the port) -------------------

@pytest.fixture(scope="module")
def models():
    jcfg, tcfg = tiny_cfgs()
    tree = jax_params(jcfg, 0)
    vad_tree = jax.tree.map(np.asarray, jvad.init(jax.random.PRNGKey(1),
                                                  jconfig.VadConfig()))
    return ServerModels(
        asr_params=params_from_jax(tree), asr_cfg=tcfg,
        vocab=TVocab(make_test_vocab(tcfg.vocab_size).tokens),
        vad_params=params_from_jax(vad_tree), vad_cfg=tconfig.VadConfig(),
        device="cpu")


def _drive(engine, sid, wave, step_ms=600):
    out = []
    step = int(16000 * step_ms / 1000)
    for off in range(0, len(wave), step):
        engine.feed(sid, wave[off: off + step],
                    is_final=off + step >= len(wave))
        engine.step()
        out.extend(engine.poll(sid))
    for _ in range(3):  # drain
        engine.step()
        out.extend(engine.poll(sid))
    return out


def _drive_collect(eng, sid, wave, extra_steps=6):
    out = []
    for off in range(0, len(wave), 9600):
        eng.feed(sid, wave[off: off + 9600],
                 is_final=off + 9600 >= len(wave))
        eng.step()
        out.extend(eng.poll(sid))
    for _ in range(extra_steps):
        eng.step()
        out.extend(eng.poll(sid))
    return out


def _drain(eng, sid, out, timeout=60):
    deadline = time.time() + timeout
    while (not (eng.drained(sid) and not eng.has_inflight())
           and time.time() < deadline):
        eng.step()
        out.extend(eng.poll(sid))
        time.sleep(0.01)
    out.extend(eng.poll(sid))


def _texts(results, mode):
    return "".join(r["text"] for r in results if r["mode"] == mode)


def _session_results(session, wave, step_ms=600):
    out = []
    step = int(16000 * step_ms / 1000)
    for off in range(0, len(wave), step):
        res = session.feed(wave[off: off + step],
                           is_final=off + step >= len(wave))
        if res.partial:
            out.append({"mode": "2pass-online", "text": res.partial})
        if res.final_text:
            out.append({"mode": "2pass-offline", "text": res.final_text})
    return out


def test_engine_single_stream_produces_both_passes(models):
    eng = StreamEngine(models, capacity=4)
    sid = eng.open()
    res = _drive(eng, sid, _wave(0))
    modes = {r["mode"] for r in res}
    assert "2pass-online" in modes
    assert "2pass-offline" in modes
    eng.close(sid)
    eng.shutdown()


def test_engine_streams_are_isolated(models):
    """Two concurrent streams through the batched state produce exactly
    what each produces alone."""
    w1, w2 = _wave(1), _wave(2, seconds=1.5)
    solo = []
    for w in (w1, w2):
        eng = StreamEngine(models, capacity=4)
        solo.append(_drive(eng, eng.open(), w))
        eng.shutdown()
    both = StreamEngine(models, capacity=4)
    a, b = both.open(), both.open()
    ra, rb = [], []
    step = 9600
    for off in range(0, max(len(w1), len(w2)), step):
        if off < len(w1):
            both.feed(a, w1[off: off + step], is_final=off + step >= len(w1))
        if off < len(w2):
            both.feed(b, w2[off: off + step], is_final=off + step >= len(w2))
        both.step()
        ra.extend(both.poll(a))
        rb.extend(both.poll(b))
    for _ in range(3):
        both.step()
        ra.extend(both.poll(a))
        rb.extend(both.poll(b))
    both.shutdown()
    for mode in ("2pass-online", "2pass-offline"):
        assert _texts(ra, mode) == _texts(solo[0], mode)
        assert _texts(rb, mode) == _texts(solo[1], mode)


def test_engine_slot_reuse(models):
    eng = StreamEngine(models, capacity=2)
    a = eng.open()
    r1 = _drive(eng, a, _wave(3))
    eng.close(a)
    b = eng.open()
    assert b == a  # slot recycled
    r2 = _drive(eng, b, _wave(3))
    eng.shutdown()
    # same audio on a recycled slot reproduces the same text
    assert _texts(r1, "2pass-online") == _texts(r2, "2pass-online")


def test_engine_frees_native_automatons(models):
    """Each slot runs the native automaton; its handle is freed when the
    slot is reopened and, for the slots still held, at shutdown."""
    from asr2pass_tpu_torch.native import bindings

    eng = StreamEngine(models, capacity=2)
    a = eng.open()
    first = eng.slots[a].sm._native
    assert isinstance(first, bindings.NativeVad)
    bindings.reset_call_counts()
    _drive(eng, a, _wave(3))
    assert bindings.call_counts()["vad_chunk"] > 0
    eng.close(a)
    assert first._handle is not None
    b = eng.open()
    assert b == a and first._handle is None
    held = [eng.slots[b].sm._native, eng.slots[eng.open()].sm._native]
    assert all(n._handle is not None for n in held)
    eng.shutdown()
    assert all(n._handle is None for n in held)


def test_engine_capacity_guard(models):
    eng = StreamEngine(models, capacity=1)
    eng.open()
    with pytest.raises(EngineAtCapacity):
        eng.open()
    eng.shutdown()


def test_engine_open_with_hotword_embeddings_raises(models):
    """Embeddings a Paraformer pass 2 cannot take are refused at open(),
    and the slot stays free: this model has no hotword block. (A model
    with the block takes them: test_engine_hotwords_match_jax.)"""
    eng = StreamEngine(models, capacity=1)
    with pytest.raises(ValueError, match="no hotword block"):
        eng.open(hw_emb=np.zeros((2, 64), np.float32))
    assert not eng.slots[0].active
    eng.shutdown()


def test_engine_no_cross_delivery_on_slot_reclaim(models):
    """Client A disconnects with a segment in the async pass-2 lane;
    client B reclaims the slot. A's transcript must NOT reach B, reclaim
    must be deferred while the segment is in flight, and no counter may
    go negative."""
    eng = StreamEngine(models, capacity=1, pass2_async=True)
    gate = threading.Event()
    orig = eng._process_segments

    def gated(pairs, settled=None):
        gate.wait(timeout=60)
        orig(pairs, settled)

    eng._process_segments = gated
    try:
        a = eng.open()
        eng.feed(a, _wave(21, seconds=2.0), is_final=True)
        old_slot = eng.slots[a]
        deadline = time.time() + 60
        while old_slot.p2_inflight == 0 and time.time() < deadline:
            eng.step()
            time.sleep(0.01)
        assert old_slot.p2_inflight > 0      # segment is in the lane
        eng.close(a)
        with pytest.raises(EngineAtCapacity):
            eng.open()
        gate.set()
        deadline = time.time() + 60
        while old_slot.p2_inflight > 0 and time.time() < deadline:
            time.sleep(0.01)
        assert old_slot.p2_inflight == 0     # exactly drained, not -1
        b = eng.open()
        assert b == a                        # slot recycled after drain
        assert eng.slots[b].gen == old_slot.gen + 1
        assert eng.poll(b) == []             # nothing cross-delivered
        assert eng.slots[b].p2_inflight == 0
        assert eng.drained(b)
    finally:
        gate.set()
        eng.shutdown()


def test_engine_pass2_error_path_decrements_captured_slot(models):
    """A poisoned pass-2 batch decrements the inflight counter of the
    slot objects captured at handoff, so drained() converges and reuse
    is clean."""
    eng = StreamEngine(models, capacity=1, pass2_async=True)
    calls = {"n": 0}

    def boom(pairs, settled=None):
        calls["n"] += 1
        raise RuntimeError("poisoned segment")

    eng._process_segments = boom
    try:
        a = eng.open()
        eng.feed(a, _wave(22, seconds=2.0), is_final=True)
        deadline = time.time() + 60
        while ((not calls["n"] or not eng.drained(a))
               and time.time() < deadline):
            eng.step()
            time.sleep(0.01)
        assert calls["n"] >= 1
        assert eng.drained(a)
        assert eng.slots[a].p2_inflight == 0
        eng.close(a)
        b = eng.open()
        assert eng.slots[b].p2_inflight == 0
        assert eng.drained(b)
    finally:
        eng.shutdown()


def test_engine_burst_feed_no_overflow(models):
    """The whole utterance delivered before the first step loses nothing
    to the per-tick VAD bucket: leftovers re-queue and later steps drain
    them."""
    wave = _wave(5, seconds=3.0)
    ticked = StreamEngine(models, capacity=2)
    ref = _drive(ticked, ticked.open(), wave)
    burst = StreamEngine(models, capacity=2)
    sid2 = burst.open()
    burst.feed(sid2, wave, is_final=True)
    out = []
    for _ in range(40):
        burst.step()
        out.extend(burst.poll(sid2))
    ticked.shutdown()
    burst.shutdown()
    assert _texts(out, "2pass-offline") == _texts(ref, "2pass-offline")


def test_engine_back_to_back_finals_one_tick(models):
    """Two utterances whose finals both land inside one tick give the
    same per-utterance results as when fed tick by tick: staging pauses
    while a flush boundary drains, so finals never merge."""
    w1, w2 = _wave(11, seconds=1.2), _wave(12, seconds=1.2)
    ref = StreamEngine(models, capacity=2)
    sid = ref.open()
    r1 = _drive(ref, sid, w1)
    ref.close(sid)
    r2 = _drive(ref, ref.open(), w2)
    eng = StreamEngine(models, capacity=2)
    sid = eng.open()
    eng.feed(sid, w1, is_final=True)
    eng.feed(sid, w2, is_final=True)
    got = []
    for _ in range(40):
        eng.step()
        got.extend(eng.poll(sid))
        if eng.drained(sid):
            break
    assert eng.drained(sid)
    ref.shutdown()
    eng.shutdown()
    assert _texts(got, "2pass-online") == (_texts(r1, "2pass-online")
                                           + _texts(r2, "2pass-online"))


@pytest.mark.parametrize("tick", [
    dict(pass2_async=True, vad_async=True),
    dict(pass2_async=True, fused_fetch=True)])
def test_engine_async_tick_matches_sync(models, tick):
    """vad_async (the decide lane fetches and decides) and fused_fetch
    (one combined fetch a tick): results and drained() converge to the
    sync engine's."""
    wave = _wave(31 if "vad_async" in tick else 33, seconds=2.0)
    sync_eng = StreamEngine(models, capacity=2)
    ref = _drive(sync_eng, sync_eng.open(), wave)
    sync_eng.shutdown()
    eng = StreamEngine(models, capacity=2, **tick)
    try:
        sid = eng.open()
        out = []
        for off in range(0, len(wave), 9600):
            eng.feed(sid, wave[off: off + 9600],
                     is_final=off + 9600 >= len(wave))
            eng.step()
            out.extend(eng.poll(sid))
        _drain(eng, sid, out)
        assert eng.drained(sid)
        assert eng.slots[sid].vd_inflight == 0
        assert _texts(out, "2pass-online") == _texts(ref, "2pass-online")
        assert _texts(out, "2pass-offline") == _texts(ref, "2pass-offline")
        assert _texts(out, "2pass-offline")
    finally:
        eng.shutdown()


def test_engine_long_stream_ring_wrap(models):
    """A 12 s stream on a 2^17-sample ring crosses the ring end: the
    capped ring write and the wrapping gathers give the TwoPassSession's
    results on the same audio."""
    wave = _wave(41, seconds=12.0)
    ref = _session_results(models.create_session(mode="2pass"), wave)
    eng = StreamEngine(models, capacity=2, ring_samples=RING)
    sid = eng.open()
    got = _drive(eng, sid, wave)
    assert eng._abs_fed[sid] > RING
    eng.shutdown()
    assert _texts(got, "2pass-online") == _texts(ref, "2pass-online")
    assert _texts(got, "2pass-offline") == _texts(ref, "2pass-offline")
    assert _texts(got, "2pass-online")


@pytest.mark.parametrize("tick", [
    dict(upload_overlap=True), dict(upload_overlap=True, decide_async=True)])
def test_upload_overlap_matches_plain_fused(models, tick):
    """The double-buffered upload (and the async decide lane) change when
    bytes move and where host work runs, not what the engine computes."""
    w = _wave(7 if len(tick) == 1 else 11, seconds=2.2)
    plain = StreamEngine(models, capacity=2, fused_fetch=True)
    sp = plain.open()
    rp = _drive_collect(plain, sp, w)
    over = StreamEngine(models, capacity=2, fused_fetch=True, **tick)
    so = over.open()
    ro = _drive_collect(over, so, w)
    for _ in range(100):
        if over.drained(so) and not over.has_inflight():
            break
        over.step()
        ro.extend(over.poll(so))
    over.shutdown()
    plain.shutdown()
    for mode in ("2pass-online", "2pass-offline"):
        assert _texts(ro, mode) == _texts(rp, mode)


def test_upload_overlap_reclaim_waits_for_staged_work(models):
    """A slot with staged-but-undispatched audio is not reclaimed: close()
    right after a feed, then open() succeeds once the staged work
    settles, and the new connection decodes cleanly."""
    eng = StreamEngine(models, capacity=1, fused_fetch=True,
                       upload_overlap=True)
    a = eng.open()
    eng.feed(a, _wave(8, seconds=0.6))
    eng.step()          # consumes the feed into the staged/next buffer
    eng.feed(a, _wave(8, seconds=0.6))
    eng.close(a)
    sid = None
    for _ in range(40):
        try:
            sid = eng.open()
            break
        except EngineAtCapacity:
            eng.step()
    assert sid is not None, "slot never reclaimed after staged work"
    res = _drive_collect(eng, sid, _wave(9))
    eng.shutdown()
    assert "2pass-online" in {r["mode"] for r in res}


def test_ring_overrun_quarantine_recovers(models):
    """A slot whose pass-1 backlog outran the device audio ring is
    quarantined (backlog dropped, device columns + detok zeroed) and the
    stream keeps serving: the next utterance decodes cleanly."""
    eng = StreamEngine(models, capacity=2, fused_fetch=True)
    a = eng.open()
    r1 = _drive_collect(eng, a, _wave(21, seconds=1.2))
    assert any(r["mode"] == "2pass-online" for r in r1)
    slot = eng.slots[a]
    jump = tengine._RING_SAMPLES + 100_000
    eng._abs_fed[a] += jump
    slot.vd_abs += jump
    slot.splitter_base += jump
    with eng._stage_lock:
        slot.p1_groups.append(
            (int(eng._abs_fed[a]) - tengine._RING_SAMPLES - 50_000, 16000,
             True))
    eng.step()                      # quarantine fires in _asr_step
    assert not slot.p1_groups
    assert slot.p1_flush_at is None
    assert slot.p1_ring_w == slot.p1_ring_r
    assert float(eng.online_state.dec_caches[:, a].abs().sum()) == 0.0
    r2 = _drive_collect(eng, a, _wave(22, seconds=1.2))
    eng.shutdown()
    assert any(r["mode"] == "2pass-online" for r in r2)


def test_engine_pass2_serves_from_ring(models, monkeypatch):
    """Fresh segments decode from the device audio ring: the lane's feats
    come from ring_frontend_device and the upload path is never taken."""
    import asr2pass_tpu_torch.runtime.offline_asr as oa
    import asr2pass_tpu_torch.runtime.streaming_frontend as sf

    calls = {"ring": 0, "upload": 0}
    real_ring, real_up = sf.ring_frontend_device, oa.offline_frontend_device

    def spy_ring(*a, **k):
        calls["ring"] += 1
        return real_ring(*a, **k)

    def spy_up(*a, **k):
        calls["upload"] += 1
        return real_up(*a, **k)

    monkeypatch.setattr(sf, "ring_frontend_device", spy_ring)
    monkeypatch.setattr(oa, "offline_frontend_device", spy_up)
    eng = StreamEngine(models, capacity=2)
    res = _drive(eng, eng.open(), _wave(31, seconds=2.5))
    eng.shutdown()
    assert any(r["mode"] == "2pass-offline" for r in res)
    assert calls["ring"] > 0
    assert calls["upload"] == 0


def test_engine_pass2_ring_fallback_equivalence(models):
    """With a ring too small for ring-served pass 2 the lane falls back
    to the upload front-end, with identical results."""
    w = _wave(33, seconds=2.5)
    ring_served = StreamEngine(models, capacity=2)
    ra = _drive(ring_served, ring_served.open(), w)
    tiny_ring = StreamEngine(models, capacity=2, ring_samples=1 << 16)
    rb = _drive(tiny_ring, tiny_ring.open(), w)
    ring_served.shutdown()
    tiny_ring.shutdown()
    for mode in ("2pass-online", "2pass-offline"):
        assert _texts(rb, mode) == _texts(ra, mode)
    assert _texts(ra, "2pass-offline")


def test_engine_vad_takes_the_config_options(models):
    """The engine's automaton takes the VAD config's options, as the
    session's FsmnVadStream does: with the energy gate at -30 dB over
    bursts between digital silence, the engine closes the same segments
    as the TwoPassSession on the same messages (the JAX engine builds
    its automaton from defaults, which ignore decibel_thres)."""
    vcfg = dataclasses.replace(models.vad_cfg, decibel_thres=-30.0)
    m = dataclasses.replace(models, vad_cfg=vcfg)
    wave = bursty(((0.4, 0), (1.6, 1), (1.2, 0), (1.3, 1), (1.0, 0)), 3)
    ref = _session_results(m.create_session(mode="2pass"), wave)
    eng = StreamEngine(m, capacity=2)
    events = []
    sid = eng.open()
    sm = eng.slots[sid].sm

    def record(*a, **kw):
        out = type(sm).__call__(sm, *a, **kw)
        events.extend(out)
        return out

    record.close = sm.close     # the engine frees the automaton it made
    eng.slots[sid].sm = record
    got = _drive(eng, sid, wave)
    eng.shutdown()
    assert sum(e != -1 for _, e in events) == 2
    assert _texts(got, "2pass-offline") == _texts(ref, "2pass-offline")
    assert len([r for r in got if r["mode"] == "2pass-offline"]) == 2

"""The port's streaming pass 1 against the plain streaming reference
(benchmark/reference/online.py) on the CPU, at a tiny width with seeded
random weights: `paraformer_online.step` with three streams of different
lengths batched in one step, and the same kind of streams through
`StreamEngine` ticks fed in 60 ms pieces (the VAD automaton, the 2pass
splitter and the pass-1 lane), each utterance held to the reference fed
the engine's own chunking.

Compared: the fired-token counts of every step, equal; the logits of the
fired tokens, to RTOL/ATOL; the final flush's tail fire; a second
utterance on a slot that served one equals a fresh stream. Planted
faults (the decoder's caches not carried, CIF's integrate dropped, the
window cache one frame short) must each fail the same comparison.
"""
import dataclasses

import numpy as np
import pytest
import torch

from asr2pass_tpu_torch import config as tc
from asr2pass_tpu_torch.models import cif, fsmn_vad, paraformer
from asr2pass_tpu_torch.models import paraformer_online as po
from asr2pass_tpu_torch.models import sanm_decoder
from asr2pass_tpu_torch.runtime.engine import StreamEngine
from asr2pass_tpu_torch.server.engine import ServerModels
from asr2pass_tpu_torch.text.vocab import Vocab
from benchmark.reference import config as rc
from benchmark.reference import frontend, online

# float32 on both sides; the port batches the streams and pads each
# window to the step's widest, so its products sum in another order:
# the logits of these runs differ by up to ~2e-6 (step) and the engine's
# features by a few 1e-4 in low log-mel bins (its fbank's summation
# order, tests/test_torch_frontend.py), scaled down by CMVN's 0.25
RTOL, ATOL = 1e-4, 1e-4
CMVN = (np.full(560, -12.0, np.float32), np.full(560, 0.25, np.float32))
VAD_CMVN = (np.full(400, -12.0, np.float32), np.full(400, 0.25, np.float32))


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _ref_cfg(obj, cls):
    """The reference's copy of a port config dataclass, field by field."""
    kw = {}
    for f in dataclasses.fields(cls):
        v = getattr(obj, f.name)
        if dataclasses.is_dataclass(v):
            v = _ref_cfg(v, type(getattr(cls(), f.name)))
        kw[f.name] = v
    return cls(**kw)


@pytest.fixture(scope="module")
def tiny():
    """paraformer_tiny with CIF's output bias at -1 (about 0.4 tokens a
    frame on these features), its state dict and the reference config."""
    cfg = tc.paraformer_tiny()
    model = paraformer.init(cfg, torch.Generator().manual_seed(3), "cpu")
    with torch.no_grad():
        model.predictor.out.b.fill_(-1.0)
    sd = {k: v.detach().clone() for k, v in model.state_dict().items()}
    return model, cfg, sd, _ref_cfg(cfg, rc.ParaformerConfig)


# -- one batched step ---------------------------------------------------------

# (stream, first frame, new frames, final) of each slot, step by step:
# A ends in a 3-frame final; B's last chunk is taken before its final
# is known, so its final step takes none; C serves C1, then C2 on the
# same slot; idle slots take a no-op step
PLAN = [[("A", 0, 10, False), ("B", 0, 10, False), ("C1", 0, 7, True)],
        [("A", 10, 10, False), ("B", 10, 10, False), ("C2", 0, 10, False)],
        [("A", 20, 3, True), ("B", 20, 10, False), ("C2", 10, 5, True)],
        [("A", 23, 0, False), ("B", 30, 0, True), ("C2", 15, 0, False)]]
ROWS = {"A": 23, "B": 30, "C1": 7, "C2": 15}


def _port_steps(model, cfg, feats):
    """PLAN through po.step; per stream [(new, final, count, logits of
    the fired tokens)]."""
    logits = []
    apply = sanm_decoder.apply_streaming

    def keep(*a, **kw):
        out = apply(*a, **kw)
        logits.append(out[0])
        return out

    got = {}
    state = po.init_state(model, cfg, 3)
    try:
        sanm_decoder.apply_streaming = keep
        for step in PLAN:
            x = torch.zeros(3, cfg.chunk_size[1], 560)
            n = torch.zeros(3, dtype=torch.long)
            fin = torch.zeros(3, dtype=torch.bool)
            for b, (name, a0, cnt, final) in enumerate(step):
                x[b, :cnt] = feats[name][a0: a0 + cnt]
                n[b], fin[b] = cnt, final
            state, _ids, counts = po.step(model, cfg, state, x, n, fin)
            for b, (name, _a0, cnt, final) in enumerate(step):
                if cnt or final:
                    k = int(counts[b])
                    got.setdefault(name, []).append(
                        (cnt, final, k, logits[-1][b, :k]))
    finally:
        sanm_decoder.apply_streaming = apply
    return got


def _mismatch(sd, rcfg, feats, steps):
    """Why one utterance's served steps differ from the reference fed the
    same chunking (None: they agree), and the reference's result."""
    ref = online.pass1(sd, rcfg, feats, [(c, f) for c, f, _, _ in steps])
    counts = [k for _, _, k, _ in steps]
    if counts != ref.counts:
        return f"counts {counts} != {ref.counts}", ref
    if ref.logits.shape[0]:
        got = torch.cat([lg for *_, lg in steps])
        if not torch.allclose(got, ref.logits, rtol=RTOL, atol=ATOL):
            err = float((got - ref.logits).abs().max())
            return f"logits off by {err}", ref
    return None, ref


def _step_results(tiny):
    model, cfg, sd, rcfg = tiny
    g = torch.Generator().manual_seed(7)
    feats = {k: torch.randn(n, 560, generator=g) for k, n in ROWS.items()}
    got = _port_steps(model, cfg, feats)
    return {name: _mismatch(sd, rcfg, feats[name], got[name])
            for name in ROWS}


def test_step_matches_reference(tiny):
    out = _step_results(tiny)
    assert {k: why for k, (why, _) in out.items()} == dict.fromkeys(ROWS)
    # the streams fire in every chunk but B's last, and a final's tail
    # weight fires in at least one of them
    assert all(c > 0 for _, ref in out.values() for c in ref.counts[:-1])
    assert any(ref.tail_fired for _, ref in out.values())


def test_reused_slot_equals_fresh_stream(tiny):
    """C2 on the slot C1 left: the port's result equals a fresh stream's
    (one stream, one slot, nothing before it)."""
    model, cfg, _sd, _rcfg = tiny
    g = torch.Generator().manual_seed(7)
    feats = {k: torch.randn(n, 560, generator=g) for k, n in ROWS.items()}
    reused = _port_steps(model, cfg, feats)["C2"]
    state = po.init_state(model, cfg, 1)
    fresh = []
    for a0, cnt, final in [(0, 10, False), (10, 5, True)]:
        x = torch.zeros(1, cfg.chunk_size[1], 560)
        x[0, :cnt] = feats["C2"][a0: a0 + cnt]
        state, ids, counts = po.step(model, cfg, state, x,
                                     torch.tensor([cnt]),
                                     torch.tensor([final]))
        fresh.append(ids[0, : int(counts[0])].tolist())
    assert [lg.argmax(-1).tolist() for *_, lg in reused] == fresh


def _caches_not_carried(monkeypatch):
    apply = sanm_decoder.apply_streaming
    monkeypatch.setattr(sanm_decoder, "apply_streaming",
                        lambda p, e, enc, caches, *a, **kw: apply(
                            p, e, enc, torch.zeros_like(caches), *a, **kw))


def _integrate_dropped(monkeypatch):
    fire = cif.fire

    def dropped(h, a, thr, state=None, **kw):
        return fire(h, a, thr, cif.CifState(
            torch.zeros_like(state.integrate), state.frame), **kw)
    monkeypatch.setattr(cif, "fire", dropped)


def _window_cache_short(monkeypatch):
    step = po.step

    def short(*a, **kw):
        state, ids, counts = step(*a, **kw)
        cache = state.feats_cache.clone()
        cache[:, 0] = 0.0
        return state._replace(feats_cache=cache), ids, counts
    monkeypatch.setattr(po, "step", short)


@pytest.mark.parametrize("fault", [_caches_not_carried, _integrate_dropped,
                                   _window_cache_short])
def test_planted_fault_fails(tiny, fault, monkeypatch):
    fault(monkeypatch)
    out = _step_results(tiny)
    assert any(why for why, _ in out.values())


# -- the engine's pass-1 lane, fed in 60 ms pieces ----------------------------

def _stream(pattern, seed):
    """16 kHz PCM-grid audio from (seconds, loud) pairs: digital silence,
    or a tone under a 4 Hz envelope plus noise (speech to the VAD's
    -30 dB energy gate)."""
    rng = np.random.default_rng(seed)
    parts = []
    for sec, loud in pattern:
        n = int(sec * 16000)
        t = np.arange(n) / 16000
        x = (0.2 * np.sin(2 * np.pi * rng.uniform(120, 250) * t)
             * 0.5 * (1 + np.sin(2 * np.pi * 4 * t))
             + 0.02 * rng.standard_normal(n)) if loud else np.zeros(n)
        parts.append(x)
    return (np.round(np.concatenate(parts) * 32768) / 32768).astype(
        np.float32)


STREAMS = [[(0.4, 0), (1.7, 1), (1.0, 0)],
           [(0.2, 0), (2.5, 1), (1.0, 0), (0.9, 1), (1.0, 0)],
           [(1.1, 1), (1.1, 0)]]


def _utterance_bounds(wave, windows, events, chunk_len):
    """[start, end) samples of each utterance pass 1 takes: its online
    chunks are contiguous, the first ending where the splitter says."""
    sp = online.TwoPassSplitter()
    out, start, at = [], None, 0
    for (n, _final), ev in zip(windows, events):
        on, _off = sp.feed(wave[at: at + n], ev, chunk_len)
        at += n
        for fr in on:
            if start is None:
                start = stop = fr.global_end * 16 - len(fr.data)
            stop += len(fr.data)
            if fr.is_final:
                out.append((start, stop))
                start = None
    return out


def test_engine_lane_matches_reference(tiny):
    model, cfg, sd, rcfg = tiny
    vcfg = dataclasses.replace(tc.VadConfig(), decibel_thres=-30.0)
    vad = fsmn_vad.init(vcfg, torch.Generator().manual_seed(4), "cpu")
    with torch.no_grad():
        vad.out2.b[0] = -20.0     # the energy gate alone segments
    vad_sd = {k: v.detach().clone() for k, v in vad.state_dict().items()}
    models = ServerModels(
        asr_params=model, asr_cfg=cfg, asr_cmvn=CMVN,
        vocab=Vocab(["<blank>", "<s>", "</s>", "<unk>"]
                    + [chr(0x4E00 + i) for i in range(60)]),
        vad_params=vad, vad_cfg=vcfg, vad_cmvn=VAD_CMVN, device="cpu")
    eng = StreamEngine(models, capacity=4, mode="online", fused_fetch=True)
    steps, windows, logits = [], {}, []
    p1_step, dispatch = eng._p1_step, eng._vad_dispatch_staged
    apply = sanm_decoder.apply_streaming

    def p1(*a):
        out = p1_step(*a)
        steps.append((a[13].clone(), a[14].clone(), out[2], logits[-1]))
        return out

    def staged(st):
        for sid, _slot, samples, final, _n in st["work"]:
            windows.setdefault(sid, []).append((len(samples), final))
        return dispatch(st)

    def keep(*a, **kw):
        out = apply(*a, **kw)
        logits.append(out[0])
        return out

    eng._p1_step, eng._vad_dispatch_staged = p1, staged
    waves = [_stream(p, 20 + i) for i, p in enumerate(STREAMS)]
    try:
        sanm_decoder.apply_streaming = keep
        sids = [eng.open() for _ in waves]
        results = {sid: [] for sid in sids}
        for off in range(0, max(map(len, waves)), 960):
            for sid, w in zip(sids, waves):
                if off < len(w):
                    eng.feed(sid, w[off: off + 960],
                             is_final=off + 960 >= len(w))
            eng.step()
            for sid in sids:
                results[sid] += eng.poll(sid)
        for _ in range(20):
            if all(eng.drained(s) for s in sids) and not eng.has_inflight():
                break
            eng.step()
            for sid in sids:
                results[sid] += eng.poll(sid)
        assert all(eng.drained(s) for s in sids)
    finally:
        sanm_decoder.apply_streaming = apply
        eng.shutdown()
    rv = _ref_cfg(vcfg, rc.VadConfig)
    utts = 0
    for sid, wave in zip(sids, waves):
        served, cur = [], []
        for count, fin, nums, lg in steps:
            if count[sid] or fin[sid]:
                k = int(nums[sid])
                cur.append((int(count[sid]), bool(fin[sid]), k, lg[sid, :k]))
                if fin[sid]:
                    served.append(cur)
                    cur = []
        assert not cur
        events = online.vad_events(
            vad_sd, rv, wave, windows[sid], VAD_CMVN,
            vcfg.max_end_silence_time,
            vcfg.max_single_segment_time, "cpu")
        audio, _segs = online.split(wave, windows[sid], events,
                                    eng.chunk_len)
        assert len(audio) == len(served) == sum(x for _, x in STREAMS[sid])
        for a, got in zip(audio, served):
            feats = frontend.offline_feats(a, rcfg.frontend, *CMVN, "cpu")
            assert sum(c for c, *_ in got) == feats.shape[0]
            why, ref = _mismatch(sd, rcfg, feats, got)
            assert why is None, why
            assert sum(ref.counts) > 0
            utts += 1
        # each partial's end_sample: the stream's sample count its chunk's
        # last LFR row needs (its last tap's frame, whole), or the
        # utterance's end for the final chunk
        ends = []
        for (start, stop), got in zip(_utterance_bounds(
                wave, windows[sid], events, eng.chunk_len), served):
            rows = 0
            for c, final, _k, lg in got:
                rows += c
                if bool((lg.argmax(-1) >= 4).any()):
                    ends.append(stop if final else
                                start + 3 * 160 + 400 + (rows - 1) * 960)
        assert [r["end_sample"] for r in results[sid]] == ends
    assert utts == 4

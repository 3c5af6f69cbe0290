"""The CUDA attention kernels (asr2pass_tpu_torch/csrc/attention_f32_sm90.cu
for float32, csrc/attention_sm90.cu for bfloat16) against the plain PyTorch
versions on the card. Skipped without a card.

Imports nothing of JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

The reference is the plain version evaluated in fp32 on the same input
values. fp32: |kernel - plain| <= 1e-4 + 1e-4 * |plain| (ops/attention.py
FP32_TOL: fp32 summed in another order, the products in 3xTF32).
bf16: the limit of ops/attention.py's bf16_reference, 2^-8 |plain| +
2^-6 sqrt(sum_j p_j^2 v_j^2) + 1e-6 (the rounding of the bf16 output, and
of P to bf16 before the P.V product, as the TPU kernels round it).
"""
import numpy as np
import pytest
import torch

from asr2pass_tpu_torch.ops import attention as att

pytestmark = pytest.mark.cuda

TOL = att.FP32_TOL    # fp32 (atol, rtol)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _mask(lens, t_len, dev):
    lens = torch.as_tensor(lens, device=dev)
    return (torch.arange(t_len, device=dev)[None, :]
            < lens[:, None]).float()


def _fp32(plain, *args):
    """plain(*args) evaluated on fp32 copies of the tensor arguments."""
    return plain(*[a.float() if torch.is_tensor(a) else a for a in args])


def _reference(kind, *args):
    """(plain version in fp32, limit) for kind "mh" (mh_flash_attention's
    arguments) or "split" (attention_plain's)."""
    if args[0].dtype == torch.bfloat16:
        return (att.mh_bf16_reference if kind == "mh"
                else att.bf16_reference)(*args)
    ref = _fp32(att.mh_attention_plain if kind == "mh"
                else att.attention_plain, *args)
    return ref, TOL[0] + TOL[1] * ref.abs()


def _share(got, ref, limit):
    """max |got - ref| / limit over the elements: at most 1 passes."""
    return ((got.float() - ref).abs() / limit).max().item()


def _within(got, ref, limit):
    share = _share(got, ref, limit)
    return share <= 1.0, share


def _check(got, ref_limit, dtype):
    """got: the kernel's output; ref_limit: (plain version in fp32, limit)."""
    torch.cuda.synchronize()
    ref, limit = ref_limit
    assert got.dtype == dtype and ref.dtype == torch.float32
    assert torch.isfinite(got).all()
    ok, share = _within(got, ref, limit)
    assert ok, share


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("heads,d,tq,tk,lens", [
    (4, 512, 300, 300, [300, 0]),
    (2, 64, 256, 256, [256, 17]),
    (4, 512, 158, 300, [300, 123]),
    (8, 256, 70, 33, [0, 33]),
    (4, 384, 300, 300, [300, 77]),   # d_head 96: the 128 instantiation
    (4, 64, 140, 260, [260, 0]),     # d_head 16: the 32 instantiation
])
def test_mh_flash_attention_kernel(dev, dtype, heads, d, tq, tk, lens):
    """Unsplit layout read in place from a fused projection (self) or
    from separate q and kv tensors (cross)."""
    gen = torch.Generator(device=dev).manual_seed(0)
    if tq == tk:
        qkv = torch.randn(2, tq, 3 * d, generator=gen, device=dev,
                          dtype=dtype)
        q, kv = qkv[..., :d], qkv[..., d:]
    else:
        q = torch.randn(2, tq, d, generator=gen, device=dev, dtype=dtype)
        kv = torch.randn(2, tk, 2 * d, generator=gen, device=dev,
                         dtype=dtype)
    mask = _mask(lens, tk, dev)
    before = att.launch_counts()["mh_flash_attention"]
    got = att.mh_flash_attention(q, kv, mask, heads)
    assert att.launch_counts()["mh_flash_attention"] == before + 1
    _check(got, _reference("mh", q, kv, mask, heads), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("entry", ["_attention_ss", "_attention_flash"])
@pytest.mark.parametrize("h,d,t_len,lens", [
    (4, 128, 300, [300, 0]),
    (2, 64, 129, [1, 129]),
    (1, 32, 64, [64, 40]),
    (2, 256, 100, [0, 0]),
    (2, 96, 300, [300, 211]),        # head dims between instantiations
    (3, 48, 257, [5, 257]),
])
def test_split_head_kernel(dev, dtype, entry, h, d, t_len, lens):
    """Split-head views of a fused projection; masked query rows are
    exactly 0."""
    gen = torch.Generator(device=dev).manual_seed(1)
    qkv = torch.randn(2, t_len, 3 * h * d, generator=gen, device=dev,
                      dtype=dtype)
    qh, kh, vh = (a.unflatten(-1, (h, d)).transpose(1, 2)
                  for a in qkv.split(h * d, dim=-1))
    mask = _mask(lens, t_len, dev)
    fn = getattr(att, entry)
    before = att.launch_counts()[entry]
    got = (fn(qh, kh, vh, mask) if entry == "_attention_flash"
           else fn(qh, kh, vh, mask, mask))
    assert att.launch_counts()[entry] == before + 1
    _check(got, _reference("split", qh, kh, vh, mask, mask), dtype)
    for i, n in enumerate(lens):
        assert (got[i, :, n:] == 0).all()


def test_cross_flash_attention_kernel(dev):
    """Tq != Tk, query rows not zeroed; a length-0 key row is finite."""
    gen = torch.Generator(device=dev).manual_seed(2)
    q = torch.randn(2, 2, 77, 64, generator=gen, device=dev)
    k, v = (torch.randn(2, 2, 300, 64, generator=gen, device=dev)
            for _ in range(2))
    mask = _mask([300, 0], 300, dev)
    got = att.cross_flash_attention(q, k, v, mask)
    _check(got, _reference("split", q, k, v, mask), torch.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_tolerance_rejects_a_dropped_key(dev, dtype):
    """Negative control of the tolerance: the plain result with each
    row's last valid key dropped (an off-by-one at the ragged edge) fails
    the check that the kernel passes; in bf16 by 10 times or more."""
    gen = torch.Generator(device=dev).manual_seed(3)
    h, d, t_len, lens = 4, 128, 1024, [1024, 611]
    qkv = torch.randn(2, t_len, 3 * h * d, generator=gen, device=dev,
                      dtype=dtype)
    qh, kh, vh = (a.unflatten(-1, (h, d)).transpose(1, 2)
                  for a in qkv.split(h * d, dim=-1))
    mask = _mask(lens, t_len, dev)
    drop = mask.clone()
    for i, n in enumerate(lens):
        drop[i, n - 1] = 0
    ref, limit = _reference("split", qh, kh, vh, mask, mask)
    got = att._attention_ss(qh, kh, vh, mask, mask)
    control = _fp32(att.attention_plain, qh, kh, vh, drop, mask).to(dtype)
    torch.cuda.synchronize()
    assert _within(got, ref, limit)[0]
    share = _share(control, ref, limit)
    assert share > (10.0 if dtype == torch.bfloat16 else 1.0), share


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_masks_with_holes(dev, dtype):
    """Masks that are not prefixes: valid keys scattered, the last valid
    key mid-row (the fp32 kernel skips the tiles after it), a row with no
    valid key (every tile runs and V is averaged over all keys)."""
    gen = torch.Generator(device=dev).manual_seed(7)
    t_len = 700
    qh, kh, vh = _fused(3, t_len, 2, 64, gen, dev, dtype)
    mask = (torch.rand(3, t_len, generator=gen, device=dev) > 0.5).float()
    mask[0, 333:] = 0
    mask[2] = 0
    got = att.cross_flash_attention(qh, kh, vh, mask)
    _check(got, _reference("split", qh, kh, vh, mask), dtype)


def test_fp32_tolerance_rejects_one_tf32_product(dev):
    """The TF32 control: the plain result with q, k, v and P rounded once
    to TF32 fails the fp32 check that the 3xTF32 kernel passes."""
    gen = torch.Generator(device=dev).manual_seed(6)
    h, d, t_len, lens = 4, 128, 1024, [1024, 0]
    qh, kh, vh = _fused(2, t_len, h, d, gen, dev, torch.float32)
    mask = _mask(lens, t_len, dev)
    ref, limit = _reference("split", qh, kh, vh, mask, mask)
    got = att._attention_ss(qh, kh, vh, mask, mask)
    control = att.attention_plain(
        qh, kh, vh, mask, mask,
        operand_round=lambda x: att.tf32_split(x)[0])
    torch.cuda.synchronize()
    assert _within(got, ref, limit)[0]
    assert _share(control, ref, limit) > 1.0


def _fused(b, t, h, d, gen, dev, dtype):
    """Split-head q, k, v views of one fused [B,T,3*H*d] projection."""
    qkv = torch.randn(b, t, 3 * h * d, generator=gen, device=dev,
                      dtype=dtype)
    return tuple(a.unflatten(-1, (h, d)).transpose(1, 2)
                 for a in qkv.split(h * d, dim=-1))


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d_head", [16, 18, 20, 48, 96, 128, 256])
@pytest.mark.parametrize("entry", ["mh_flash_attention", "_attention_ss",
                                   "_attention_flash"])
def test_kernel_every_entry_point(dev, entry, d_head, dt):
    """Both tensor-core kernels at every entry point and head dim (18 is
    a multiple of neither 8 nor 4, 20 not of 8: the padded copy), with Tq
    and Tk off the 128/64-row and 128/64/32-key tiles (Tk = 257) and a
    length-0 row, exact zeros where a q_mask is given; the unsplit layout
    as slices of a fused [B,T,3D]."""
    gen = torch.Generator(device=dev).manual_seed(4)
    name = str(dt).removeprefix("torch.")
    fn = getattr(att, entry)
    for tq, tk, lens in [(257, 257, [257, 0]), (300, 300, [0, 123]),
                         (130, 257, [200, 257])]:
        if entry == "_attention_flash" and tq != tk:
            continue
        mask = _mask(lens, tk, dev)
        before = att.launch_counts_by_dtype()[entry][name]
        if entry == "mh_flash_attention":
            heads, d = 2, 2 * d_head
            if tq == tk:
                qkv = torch.randn(2, tq, 3 * d, generator=gen, device=dev,
                                  dtype=dt)
                q, kv = qkv[..., :d], qkv[..., d:]
            else:
                q = torch.randn(2, tq, d, generator=gen, device=dev,
                                dtype=dt)
                kv = torch.randn(2, tk, 2 * d, generator=gen, device=dev,
                                 dtype=dt)
            got = fn(q, kv, mask, heads)
            _check(got, _reference("mh", q, kv, mask, heads), dt)
        else:
            qh, kh, vh = _fused(2, tk, 3, d_head, gen, dev, dt)
            if tq != tk:
                qh = _fused(2, tq, 3, d_head, gen, dev, dt)[0]
            q_mask = _mask([min(n, tq) for n in lens], tq, dev)
            got = (fn(qh, kh, vh, mask) if entry == "_attention_flash"
                   else fn(qh, kh, vh, mask, q_mask))
            _check(got, _reference("split", qh, kh, vh, mask, q_mask), dt)
            for i, n in enumerate(lens):
                assert (got[i, :, min(n, tq):] == 0).all()
        assert att.launch_counts_by_dtype()[entry][name] == before + 1


def test_bf16_kernel_copies_only_what_tma_cannot_read(dev):
    """Aligned views of a fused projection are read in place; a view
    whose base is off by one element is copied and still right; in bf16
    and in fp32."""
    gen = torch.Generator(device=dev).manual_seed(5)
    for dt in (torch.bfloat16, torch.float32):
        qh, kh, vh = _fused(2, 300, 4, 128, gen, dev, dt)
        out = torch.empty(qh.shape, dtype=qh.dtype, device=dev)
        assert att.plan_tma(qh, kh, vh, out).copied == ()
        raw = torch.randn(2, 300, 4 * 128 + 1, generator=gen, device=dev,
                          dtype=dt)
        q_odd = raw[..., 1:].unflatten(-1, (4, 128)).transpose(1, 2)
        assert att.plan_tma(q_odd, kh, vh, out).copied == ("q",)
        mask = _mask([300, 77], 300, dev)
        got = att._attention_ss(q_odd, kh, vh, mask, mask)
        _check(got, _reference("split", q_odd, kh, vh, mask, mask), dt)


def test_unsupported_input_raises(dev):
    """A CUDA tensor launches the kernel or raises: no plain fallback."""
    q = torch.randn(1, 256, 514, device=dev)
    with pytest.raises(ValueError, match="head dim"):
        att.mh_flash_attention(q, torch.randn(1, 256, 1028, device=dev),
                               torch.ones(1, 256, device=dev), 2)
    qh = torch.randn(1, 1, 256, 64, device=dev, dtype=torch.float16)
    with pytest.raises(TypeError):
        att._attention_ss(qh, qh, qh, torch.ones(1, 256, device=dev))
    qh = qh.float()
    with pytest.raises(ValueError, match="kv_mask"):
        att._attention_ss(qh, qh, qh, torch.ones(1, 255, device=dev))
    with pytest.raises(ValueError, match="not"):
        att._attention_flash(qh, qh[..., :32], qh,
                             torch.ones(1, 256, device=dev))
    with pytest.raises(ValueError, match="heads"):
        att.mh_flash_attention(torch.randn(1, 256, 128, device=dev),
                               torch.randn(1, 256, 128, device=dev),
                               torch.ones(1, 256, device=dev), 2)


def test_tiny_paraformer_card_matches_cpu(dev):
    """A tiny model at T=512 reaches the unsplit kernel in both encoder
    blocks and (Tq = 512//2+8 >= 256) both decoder blocks on the card;
    the forward agrees with the CPU's plain path."""
    from asr2pass_tpu_torch.config import paraformer_tiny
    from asr2pass_tpu_torch.models import paraformer

    cfg = paraformer_tiny()
    model = paraformer.init(cfg, torch.Generator().manual_seed(0), "cpu")
    cuda_model = paraformer.from_state_dict(model.state_dict(), cfg, dev)
    feats = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2, 512, 560)).astype(np.float32))
    lens = torch.tensor([512, 301])
    att.reset_launch_counts()
    with torch.inference_mode():
        got = paraformer.apply(cuda_model, cfg, feats.to(dev), lens.to(dev),
                               max_tokens=264)
        ref = paraformer.apply(model, cfg, feats, lens, max_tokens=264)
    assert att.launch_counts()["mh_flash_attention"] == 2 + 2
    assert torch.equal(got.token_num.cpu(), ref.token_num)
    n = int(ref.token_num.min())
    torch.testing.assert_close(got.logits[:, :n].cpu(), ref.logits[:, :n],
                               rtol=1e-4, atol=1e-4)


def _tree_on(x, dev):
    return x.device.type == torch.device(dev).type


def test_online_step_card_matches_cpu(dev):
    """paraformer_online.step at paraformer_tiny: four chunks of two
    streams (one flushed at chunk 3) on the card and on the CPU from the
    same CPU state each chunk: equal counts and ids, every state field
    within 1e-4, the card's state on the card."""
    from asr2pass_tpu_torch.config import paraformer_tiny
    from asr2pass_tpu_torch.models import paraformer, paraformer_online

    cfg = paraformer_tiny()
    model = paraformer.init(cfg, torch.Generator().manual_seed(1), "cpu")
    cuda_model = paraformer.from_state_dict(model.state_dict(), cfg, dev)
    rng = np.random.default_rng(1)
    state = paraformer_online.init_state(model, cfg, 2)
    for i, (counts, fin) in enumerate([([10, 10], [False, False]),
                                       ([10, 6], [False, True]),
                                       ([10, 10], [False, False]),
                                       ([4, 10], [True, False])]):
        feats = torch.from_numpy(rng.standard_normal(
            (2, 10, 560)).astype(np.float32))
        counts = torch.tensor(counts, dtype=torch.int32)
        fin = torch.tensor(fin)
        gs, gids, gn = paraformer_online.step(
            cuda_model, cfg, paraformer_online.OnlineState(
                *(x.to(dev) for x in state)),
            feats.to(dev), counts.to(dev), fin.to(dev))
        state, ids, n = paraformer_online.step(model, cfg, state, feats,
                                               counts, fin)
        assert all(_tree_on(x, "cuda") for x in gs)
        assert torch.equal(gn.cpu(), n)
        for b, k in enumerate(n.tolist()):
            assert torch.equal(gids[b, :k].cpu(), ids[b, :k])
        for a, r in zip(gs, state):
            torch.testing.assert_close(a.cpu(), r, rtol=1e-4, atol=1e-4)


def test_fsmn_vad_card_matches_cpu(dev):
    """fsmn_vad.apply at vad_default's widths with caches and valid_len
    on the card and on the CPU."""
    from asr2pass_tpu_torch.config import vad_default
    from asr2pass_tpu_torch.models import fsmn_vad

    cfg = vad_default()
    model = fsmn_vad.init(cfg, torch.Generator().manual_seed(2), "cpu")
    cuda_model = fsmn_vad.from_state_dict(model.state_dict(), cfg, dev)
    feats = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (3, 25, 400)).astype(np.float32))
    lens = torch.tensor([25, 11, 0])
    caches = [torch.randn(3, 19, 128, generator=torch.Generator()
                          .manual_seed(k)) for k in range(4)]
    with torch.inference_mode():
        gp, gc = fsmn_vad.apply(cuda_model, feats.to(dev),
                                [c.to(dev) for c in caches], lens.to(dev))
        p, c = fsmn_vad.apply(model, feats, caches, lens)
    torch.testing.assert_close(gp.cpu(), p, rtol=1e-5, atol=1e-5)
    for a, r in zip(gc, c):
        torch.testing.assert_close(a.cpu(), r, rtol=1e-5, atol=1e-5)


def test_offline_vad_a_file_at_a_time_on_the_card(dev):
    """One transcription of a 130.5 s file (sensevoice_tiny behind
    fsmn-vad at its widths, the silence pdf held low so that the energy
    gate segments): the VAD copies to the host once, calls the net once
    a 6000-row block and feeds the automaton a window a second, and its
    segments equal those of the 1 s FsmnVadStream loop on the card."""
    import dataclasses

    from asr2pass_tpu_torch import config
    from asr2pass_tpu_torch.models import fsmn_vad, sensevoice
    from asr2pass_tpu_torch.runtime.offline_api import OfflineRecognizer
    from asr2pass_tpu_torch.runtime.sensevoice_asr import SenseVoiceOffline
    from asr2pass_tpu_torch.runtime.vad_stream import (FsmnVadStream,
                                                       window_rows)
    from asr2pass_tpu_torch.text.vocab import Vocab

    tokens = ["<blank>", "<s>", "</s>", "<unk>"] + [
        chr(0x4E00 + i) for i in range(60)]
    g = torch.Generator().manual_seed(5)
    cfg = config.sensevoice_tiny(len(tokens))
    asr = SenseVoiceOffline(sensevoice.init(cfg, g, "cpu"), cfg,
                            Vocab(tokens), device=dev)
    vcfg = dataclasses.replace(config.vad_default(), decibel_thres=-30.0)
    vsd = fsmn_vad.init(vcfg, g, "cpu").state_dict()
    vsd["out2.b"][list(vcfg.sil_pdf_ids)] = -20.0
    rng = np.random.default_rng(5)
    wave = np.zeros(int(16000 * 130.5), np.float32)
    t = np.arange(16000 * 2) / 16000
    for start in range(1, 129, 4):
        a = 16000 * start
        wave[a: a + len(t)] = 0.3 * np.sin(
            2 * np.pi * 220 * t) + 0.02 * rng.standard_normal(len(t))
    res = OfflineRecognizer(asr, vad_params=vsd, vad_cfg=vcfg).transcribe(
        wave)
    rec = res.trace
    rows = sum(window_rows(len(wave), vcfg.frontend, 16000))
    assert rec["spans"]["vad.fetch"]["n"] == 1
    assert rec["counts"]["vad.net_calls"] == -(-rows // 6000) == 3
    assert rec["counts"]["vad.windows"] == -(-len(wave) // 16000) == 131
    stream = FsmnVadStream(vsd, vcfg, online=True, max_end_sil=800,
                           max_single_segment=60000, device=dev)
    events = []
    for off in range(0, len(wave), 16000):
        events += stream.accept(wave[off: off + 16000],
                                off + 16000 >= len(wave))
    closed = [[s, e] for s, e in zip(
        [s for s, _ in events if s != -1], [e for _, e in events if e != -1])]
    assert res.segments == closed and len(closed) == 32


def test_two_pass_session_lives_on_the_card(dev):
    """A TwoPassSession built with the default device: every model and
    state tensor on the card, before and after a few messages."""
    import dataclasses

    from asr2pass_tpu_torch.config import (paraformer_tiny, punc_tiny,
                                           vad_default)
    from asr2pass_tpu_torch.models import ct_transformer, fsmn_vad, paraformer
    from asr2pass_tpu_torch.runtime.asr_stream import ParaformerOnlineStream
    from asr2pass_tpu_torch.runtime.offline_asr import ParaformerOffline
    from asr2pass_tpu_torch.runtime.punc import Punctuator
    from asr2pass_tpu_torch.runtime.two_pass import TwoPassSession
    from asr2pass_tpu_torch.runtime.vad_stream import FsmnVadStream
    from asr2pass_tpu_torch.text.punc_tokenizer import PuncTokenizer
    from asr2pass_tpu_torch.text.vocab import Vocab

    cfg = paraformer_tiny()
    vocab = Vocab(["<blank>", "<s>", "</s>", "<unk>"]
                  + [chr(0x4E00 + i) for i in range(cfg.vocab_size - 4)])
    gen = torch.Generator(device="cuda").manual_seed(3)
    vcfg = dataclasses.replace(vad_default(), decibel_thres=-30.0)
    pcfg = punc_tiny(300)
    sess = TwoPassSession(
        FsmnVadStream(fsmn_vad.init(vcfg, gen), vcfg),
        ParaformerOnlineStream(paraformer.init(cfg, gen), cfg, vocab),
        ParaformerOffline(paraformer.init(cfg, gen), cfg, vocab),
        punc=Punctuator(ct_transformer.init(pcfg, gen), pcfg,
                        PuncTokenizer(["<blank>", "<unk>"] + [
                            chr(0x4E00 + i) for i in range(298)])))

    def tensors():
        yield from sess.vad.caches
        yield from sess.online_asr.state
        for m in (sess.vad.params, sess.online_asr.params,
                  sess.offline_asr.model, sess.punc.params):
            yield from m.parameters()

    assert all(_tree_on(x, "cuda") for x in tensors())
    rng = np.random.default_rng(3)
    wave = np.concatenate([np.zeros(8000), 0.2 * np.sin(
        np.arange(30000) * 0.07) + 0.02 * rng.standard_normal(30000),
        np.zeros(20000)]).astype(np.float32)
    for a in range(0, len(wave), 9600):
        sess.feed(wave[a: a + 9600], is_final=False)
        assert all(_tree_on(x, "cuda") for x in tensors())
    sess.feed(np.zeros(0, np.float32), is_final=True)


def _engine_texts(models, kw, waves):
    """Three streams through a StreamEngine at capacity 4: per stream the
    concatenated partials and the finals (text, timestamps)."""
    import time

    from asr2pass_tpu_torch.runtime.engine import StreamEngine

    eng = StreamEngine(models, capacity=4, **kw)
    eng.warmup()
    eng.warm_pass2_ring()
    sids = [eng.open() for _ in waves]
    out = {s: [] for s in sids}
    for off in range(0, max(len(w) for w in waves), 9600):
        for s, w in zip(sids, waves):
            if off < len(w):
                eng.feed(s, w[off: off + 9600], is_final=off + 9600 >= len(w))
        eng.step()
        for s in sids:
            out[s] += eng.poll(s)
    deadline = time.time() + 120
    while time.time() < deadline and not (
            all(eng.drained(s) for s in sids) and not eng.has_inflight()):
        eng.step()
        for s in sids:
            out[s] += eng.poll(s)
        time.sleep(0.005)
    for s in sids:
        out[s] += eng.poll(s)
    eng.shutdown()
    return [("".join(r["text"] for r in out[s] if r["mode"] == "2pass-online"),
             [(r["text"], r.get("timestamp")) for r in out[s]
              if r["mode"] == "2pass-offline"]) for s in sids]


@pytest.mark.parametrize("tick", ["default", "fused_fetch"])
def test_engine_card_matches_cpu(dev, tick):
    """The StreamEngine on the card against the same engine on the CPU,
    tiny config with the timestamp head, three streams of 2.0/1.4/2.6 s:
    equal partials, finals and timestamps."""
    import dataclasses

    from asr2pass_tpu_torch.config import VadConfig, paraformer_tiny
    from asr2pass_tpu_torch.models import fsmn_vad, paraformer
    from asr2pass_tpu_torch.server.engine import ServerModels
    from asr2pass_tpu_torch.text.vocab import make_test_vocab

    cfg = paraformer_tiny()
    cfg = dataclasses.replace(cfg, predictor=dataclasses.replace(
        cfg.predictor, use_timestamp=True))
    gen = torch.Generator().manual_seed(5)
    asr = paraformer.init(cfg, gen, "cpu").state_dict()
    vad = fsmn_vad.init(VadConfig(), gen, "cpu").state_dict()
    kw = {"default": {}, "fused_fetch": dict(fused_fetch=True,
                                             pass2_async=True)}[tick]
    rng = np.random.default_rng(7)
    waves = [(rng.standard_normal(int(16000 * s)) * 0.1).astype(np.float32)
             for s in (2.0, 1.4, 2.6)]
    res = {}
    for device in ("cpu", "cuda"):
        models = ServerModels(asr_params=asr, asr_cfg=cfg,
                              vocab=make_test_vocab(cfg.vocab_size),
                              vad_params=vad, vad_cfg=VadConfig(),
                              device=device)
        res[device] = _engine_texts(models, kw, waves)
    assert res["cuda"] == res["cpu"]
    assert all(p and f for p, f in res["cpu"])


# -- SenseVoice's shapes and the hotword compiler ------------------------------

@pytest.mark.parametrize("entry,b,h,t_len,lens", [
    # T = bucket + 4 (SenseVoice's meta rows): the last key tile holds 4
    # valid keys, and a batch-padding row attends over the 4 meta keys
    ("mh_flash_attention", 3, 4, 260, [260, 131, 4]),
    ("mh_flash_attention", 2, 4, 516, [300, 4]),
    ("mh_flash_attention", 1, 4, 1028, [1028]),
    ("_attention_ss", 2, 4, 2052, [2052, 4]),
    ("_attention_ss", 1, 4, 3076, [2000]),
    ("_attention_flash", 1, 4, 5124, [5124]),
    ("_attention_flash", 2, 4, 260, [4, 259]),
])
def test_kernel_at_sensevoice_shapes(dev, entry, b, h, t_len, lens):
    """fp32, d_head 128 (SenseVoice-small's 512 / 4): the kernel against
    its plain version within FP32_TOL."""
    gen = torch.Generator(device=dev).manual_seed(2)
    d = 128 * h
    qkv = torch.randn(b, t_len, 3 * d, generator=gen, device=dev)
    mask = _mask(lens, t_len, dev)
    before = att.launch_counts()[entry]
    if entry == "mh_flash_attention":
        q, kv = qkv[..., :d], qkv[..., d:]
        got = att.mh_flash_attention(q, kv, mask, h)
        ref = _reference("mh", q, kv, mask, h)
    else:
        qh, kh, vh = (a.unflatten(-1, (h, 128)).transpose(1, 2)
                      for a in qkv.split(d, dim=-1))
        got = (att._attention_flash(qh, kh, vh, mask)
               if entry == "_attention_flash"
               else att._attention_ss(qh, kh, vh, mask, mask))
        ref = _reference("split", qh, kh, vh, mask, mask)
    assert att.launch_counts()[entry] == before + 1
    _check(got, ref, torch.float32)


def test_sensevoice_card_matches_cpu(dev):
    """sensevoice_tiny with a 2-block tp stack at T = 256 + 4: all four
    blocks reach kernel #1 on the card; logits within 1e-4, greedy ids,
    counts and meta equal."""
    from asr2pass_tpu_torch.config import sensevoice_tiny
    from asr2pass_tpu_torch.models import sensevoice

    cfg = sensevoice_tiny()
    model = sensevoice.init(cfg, torch.Generator().manual_seed(3), "cpu",
                            tp_blocks=2)
    cuda_model = sensevoice.from_state_dict(model.state_dict(), cfg, dev)
    feats = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (3, 256, 560)).astype(np.float32))
    args = [torch.tensor(x) for x in ([256, 140, 0], [3, 4, 0],
                                      [14, 15, 14])]
    att.reset_launch_counts()
    with torch.inference_mode():
        got = sensevoice.apply(cuda_model, cfg, feats.to(dev),
                               *(a.to(dev) for a in args))
        ref = sensevoice.apply(model, cfg, feats, *args)
        g_ids = [x.cpu() for x in sensevoice.greedy_ids(got)]
        r_ids = sensevoice.greedy_ids(ref)
    assert att.launch_counts()["mh_flash_attention"] == 2 + 2
    torch.testing.assert_close(got.logits.cpu(), ref.logits, rtol=1e-4,
                               atol=1e-4)
    for a, r in zip(g_ids, r_ids):
        assert torch.equal(a, r)


def test_compile_hotwords_card_matches_cpu(dev):
    """The hotword compiler (embedding + LSTM + gather, a derived null
    row) on the card: embeddings within 1e-5 of the CPU's."""
    from asr2pass_tpu_torch.config import HotwordConfig
    from asr2pass_tpu_torch.models import hotword
    from asr2pass_tpu_torch.text.vocab import make_test_vocab

    cfg = HotwordConfig(vocab_size=64, embed_dim=32, hidden_dim=64)
    model = hotword.init(cfg, torch.Generator().manual_seed(4), "cpu",
                         learned_null=False)
    cuda_model = hotword.from_state_dict(model.state_dict(), dev)
    vocab = make_test_vocab(64)
    words = [vocab.id2token(5) + vocab.id2token(9), "hello",
             "".join(vocab.id2token(10 + i) for i in range(12))]
    got = hotword.compile_hotwords(cuda_model, cfg, words, vocab)
    ref = hotword.compile_hotwords(model, cfg, words, vocab)
    assert got.shape == ref.shape == (4, 64)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


def test_lm_rescoring_card_matches_cpu(dev, tmp_path):
    """chip_smoke.py's 10a at tiny size: 16 x 15 s through
    recognize_batch on the card and on the CPU with the native LM
    decoder (shared and a hotworded clone) and a TLG decoder whose rows
    are gathered on the card: equal texts and timestamps, and only the
    token rows of the LM items copied (equal byte counts)."""
    import dataclasses

    from asr2pass_tpu_torch.config import paraformer_tiny
    from asr2pass_tpu_torch.decode.lm_decoder import Lexicon
    from asr2pass_tpu_torch.decode.ngram import NgramLM
    from asr2pass_tpu_torch.decode.tlg import TlgDecoder
    from asr2pass_tpu_torch.models import paraformer
    from asr2pass_tpu_torch.native.bindings import NativeLmDecoder
    from asr2pass_tpu_torch.runtime.offline_asr import ParaformerOffline
    from asr2pass_tpu_torch.text.vocab import make_test_vocab
    from asr2pass_tpu_torch.tools.build_tlg import build_tlg

    cfg = paraformer_tiny()
    cfg = dataclasses.replace(cfg, predictor=dataclasses.replace(
        cfg.predictor, use_timestamp=True))
    vocab = make_test_vocab(cfg.vocab_size)
    rng = np.random.default_rng(10)
    units = vocab.tokens[4:]
    words = sorted({"".join(units[int(k)] for k in rng.integers(
        0, len(units), rng.integers(1, 3))) for _ in range(40)})
    lm = NgramLM.train([[words[int(k)] for k in rng.integers(
        0, len(words), 6)] for _ in range(200)], order=3)
    lex = Lexicon.from_words(words)
    build_tlg(lm, {w: list(w) for w in words}, str(tmp_path / "tlg"))
    model = paraformer.init(cfg, torch.Generator().manual_seed(5), "cpu")
    recs = {d: ParaformerOffline(model.state_dict(), cfg, vocab, device=d)
            for d in ("cpu", "cuda")}
    segs = [(0.1 * rng.standard_normal(16000 * 15)).astype(np.float32)
            for _ in range(16)]
    base = NativeLmDecoder(lm, lex, vocab.token2id)
    clone = base.clone({words[0] + words[1]: 10})
    out = {}
    for d, rec in recs.items():
        decs = [base] * 6 + [clone] * 5 + [
            TlgDecoder(str(tmp_path / "tlg"), vocab.token2id)
            for _ in range(5)]
        out[d] = (rec.recognize_batch(segs, lm_decoders=decs),
                  rec.lm_bytes_copied)
    assert out["cuda"] == out["cpu"]
    assert out["cpu"][1] > 0 and all(t for t, _ in out["cpu"][0])


# -- int8 products and the kernels under autograd ---------------------------

@pytest.mark.parametrize("m,k,n", [(16000, 512, 1536), (16000, 2048, 512),
                                   (5, 512, 1), (16, 512, 8404),
                                   (8, 256, 1024), (40, 70, 13)])
def test_int_mm_exact_on_the_card(dev, m, k, n):
    """torch._int_mm, zero-padded where its shape rules need it, equals
    the CPU's int32 product exactly."""
    from asr2pass_tpu_torch.ops import int8

    gen = torch.Generator().manual_seed(m + k + n)
    a = torch.randint(-127, 128, (m, k), dtype=torch.int8, generator=gen)
    b = torch.randint(-127, 128, (k, n), dtype=torch.int8, generator=gen)
    int8.reset_launch_counts()
    got = int8.int8_matmul(a.to(dev), b.to(dev))
    # the weight padded once, as a Dense holds it (w_q_mm)
    got_mm = int8.int8_matmul(a.to(dev), int8.pad_weight(b.to(dev)), n)
    assert int8.launch_shapes() == {(m, k, n): 2}
    ref = int8.int8_matmul_plain(a, b)
    assert torch.equal(got.cpu(), ref) and torch.equal(got_mm.cpu(), ref)


def test_int8_dense_card_matches_cpu(dev):
    """A w8a8 and a w8a16 dense layer: the int8 product is exact, so the
    card equals the CPU up to the fp32 scaling steps' rounding."""
    from asr2pass_tpu_torch.models.layers import Dense, dense

    for weight_only in (False, True):
        torch.manual_seed(0)
        layer = Dense(512, 8404, device="cpu")
        layer.quantize_(weight_only)
        x = torch.randn(3, 40, 512)
        with torch.no_grad():
            ref = dense(layer, x)
            got = dense(layer.to(dev), x.to(dev)).cpu()
        torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("entry", ["mh", "ss", "flash"])
def test_kernels_refuse_autograd(dev, entry):
    """With an operand that needs a gradient, each CUDA entry point raises
    instead of returning a tensor cut off from autograd; under no_grad it
    launches."""
    b, h, d = 1, 4, 64
    t_len = {"mh": 256, "ss": 3072, "flash": 5120}[entry]
    mask = _mask([t_len], t_len, dev)
    if entry == "mh":
        q = torch.randn(b, t_len, h * d, device=dev, requires_grad=True)
        kv = torch.randn(b, t_len, 2 * h * d, device=dev)
        call = lambda: att.mh_flash_attention(q, kv, mask, h)  # noqa: E731
    else:
        q = torch.randn(b, h, t_len, d, device=dev, requires_grad=True)
        k = torch.randn(b, h, t_len, d, device=dev)
        fn = att._attention_ss if entry == "ss" else att._attention_flash
        call = lambda: fn(q, k, k, mask)  # noqa: E731
    with pytest.raises(RuntimeError, match="no backward"):
        call()
    with torch.no_grad():
        assert torch.isfinite(call()).all()


def _funasr_dirs(tmp_path):
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from torch_onnx_fixtures import funasr_source_dirs

    return funasr_source_dirs(tmp_path)


def test_onnx_executor_card_matches_cpu(dev, tmp_path):
    """tools/onnx_reader.OnnxExecutor on a small exported 4-output
    Paraformer: the card against the CPU, every output within 1e-4 of its
    range (token_num is the graph's float sum of the alphas) and the
    token count, the logits' length, equal."""
    from asr2pass_tpu_torch.tools.onnx_reader import OnnxExecutor, read_onnx

    src, _ = _funasr_dirs(tmp_path)["asr_ts"]
    g = read_onnx(str(src / "model.onnx"))
    feats = np.random.default_rng(0).standard_normal((1, 30, 20)).astype(
        np.float32)
    lens = np.asarray([30])
    card = [o.cpu().numpy() for o in OnnxExecutor(g, dev)(feats, lens)]
    cpu = [o.numpy() for o in OnnxExecutor(g, "cpu")(feats, lens)]
    assert card[0].shape == cpu[0].shape
    for a, b in zip(card, cpu):
        assert np.abs(a - b).max() <= 1e-4 * max(1.0, np.abs(b).max())


def test_convert_verify_on_the_card(dev, tmp_path):
    """convert_funasr --verify --device cuda on the small exported
    Paraformer with the timestamp head, and on the VAD."""
    from asr2pass_tpu_torch.tools import convert_funasr

    dirs = _funasr_dirs(tmp_path)
    for kind, extra in (("asr_ts", ["--verify-tol", "5e-3"]), ("vad", [])):
        dst = tmp_path / f"conv_{kind}"
        assert convert_funasr.main([str(dirs[kind][0]), str(dst),
                                    "--verify", "--device", "cuda"]
                                   + extra) == 0
        assert (dst / "weights.npz").exists()


@pytest.fixture
def nccl_world_one(dev, tmp_path):
    """A world-size-1 NCCL group (the one-card form of the port's
    tensor parallelism), torn down after the test."""
    import torch.distributed as dist

    from asr2pass_tpu_torch.parallel.multihost import init_distributed
    from asr2pass_tpu_torch.parallel.sharding import make_mesh

    assert init_distributed(f"file://{tmp_path / 'rdv'}", 1, 0,
                            device="cuda", timeout_s=120)
    try:
        yield make_mesh(1, tp=1)
    finally:
        dist.destroy_process_group()


def test_tp_forward_world_one_on_the_card(nccl_world_one, dev):
    """shard_params over a 1 x 1 mesh on the card: the tensor-parallel
    forward issues its NCCL collectives, launches the kernel as often as
    the unsharded forward, and equals it bit for bit (at tp = 1 every sum
    is the unsharded one)."""
    from asr2pass_tpu_torch.config import paraformer_tiny
    from asr2pass_tpu_torch.models import paraformer
    from asr2pass_tpu_torch.parallel import comm
    from asr2pass_tpu_torch.parallel.sharding import shard_params

    cfg = paraformer_tiny()
    model = paraformer.init(cfg, torch.Generator().manual_seed(0), "cpu")
    whole = paraformer.from_state_dict(model.state_dict(), cfg, dev)
    local = shard_params(whole, nccl_world_one)
    feats = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2, 512, 560)).astype(np.float32)).to(dev)
    lens = torch.tensor([512, 301], device=dev)
    out = {}
    for name, m in (("whole", whole), ("tp", local)):
        att.reset_launch_counts()
        comm.reset_collective_counts()
        with torch.inference_mode():
            out[name] = paraformer.apply(m, cfg, feats, lens, max_tokens=264)
        out[f"{name}_launches"] = att.launch_counts()
        out[f"{name}_collectives"] = comm.collective_counts()
    assert out["tp_launches"] == out["whole_launches"]
    assert out["tp_launches"]["mh_flash_attention"] == 2 + 2
    assert out["tp_collectives"]["all_reduce"] == 2 * 2 + 2 * 2 + 1
    assert out["whole_collectives"]["all_reduce"] == 0
    assert torch.equal(out["tp"].token_num, out["whole"].token_num)
    assert torch.equal(out["tp"].logits, out["whole"].logits)


@pytest.mark.parametrize("tp", [2, 4])
def test_kernel_on_a_ranks_heads(dev, tp, monkeypatch):
    """The attention of rank 0's shard at tp 2 and 4 (its fused qkv cut by
    head, [q_0 | k_0 | v_0], as shard_params cuts it) through the unsplit
    kernel: the first H/tp heads of the whole layer's context. The fp32
    kernel's key splits follow the grid (f32_schedule), and a rank's
    heads make a smaller grid, so the two calls are held bit for bit at
    each split count that either takes (both forced to it)."""
    from asr2pass_tpu_torch.parallel.sharding import local_slice

    heads, d, t = 4, 512, 300
    g = torch.Generator(device=dev).manual_seed(tp)
    qkv = torch.randn(2, t, 3 * d, generator=g, device=dev)
    mask = _mask([t, 201], t, dev)
    part = local_slice("att.qkv.w", qkv, 2, tp, 0)
    dl = d // tp
    att.reset_launch_counts()
    mine = att.mh_flash_attention(part[..., :dl], part[..., dl:], mask,
                                  heads // tp)
    assert att.launch_counts()["mh_flash_attention"] == 1
    ref, limit = _reference("mh", part[..., :dl], part[..., dl:], mask,
                            heads // tp)
    assert _share(mine, ref, limit) <= 1
    sms = att._sm_count(dev.index or 0)
    taken = {att.f32_schedule(2, h, t, t, 128, sms).splits
             for h in (heads, heads // tp)}
    try:
        for splits in sorted(taken):
            monkeypatch.setattr(att, "f32_splits", lambda *a, s=splits: s)
            att._PLANS.clear()
            whole = att.mh_flash_attention(qkv[..., :d], qkv[..., d:], mask,
                                           heads)
            mine = att.mh_flash_attention(part[..., :dl], part[..., dl:],
                                          mask, heads // tp)
            torch.testing.assert_close(mine, whole[..., :dl], rtol=0, atol=0)
    finally:
        att._PLANS.clear()


def test_sharded_prune_world_one_on_the_card(nccl_world_one, dev):
    """ctc_first_prune_sharded over a world-size-1 tp group on the card:
    the whole prune's candidate sets, log-probs within 1e-5."""
    from asr2pass_tpu_torch.parallel.ctc_shard import (
        ctc_first_prune, ctc_first_prune_sharded)

    g = torch.Generator(device=dev).manual_seed(0)
    logits = torch.randn(2, 50, 512, generator=g, device=dev) * 2.0
    ids, lp = ctc_first_prune_sharded(logits, nccl_world_one, "tp", k=16)
    rid, rlp = ctc_first_prune(logits, k=16)
    a, oa = ids.sort(-1)
    b, ob = rid.sort(-1)
    assert torch.equal(a, b)
    torch.testing.assert_close(lp.gather(-1, oa), rlp.gather(-1, ob),
                               rtol=0, atol=1e-5)


def test_server_models_tp_world_one_on_the_card(nccl_world_one, dev):
    """ServerModels over a 1 x 1 mesh on the card: rank 0's recognizers
    run through the fan-out (its headers on a gloo group, the engine's
    ring features broadcast over NCCL), share one shard, and answer an
    upload and a 2pass session as the unsharded models do, bit for bit."""
    from asr2pass_tpu_torch.config import VadConfig, paraformer_tiny
    from asr2pass_tpu_torch.models import fsmn_vad, paraformer
    from asr2pass_tpu_torch.parallel import comm
    from asr2pass_tpu_torch.server.engine import ServerModels
    from asr2pass_tpu_torch.text.vocab import make_test_vocab

    cfg = paraformer_tiny()
    g = torch.Generator().manual_seed(0)
    kw = dict(asr_params=paraformer.init(cfg, g, "cpu").state_dict(),
              asr_cfg=cfg, vocab=make_test_vocab(cfg.vocab_size),
              vad_params=fsmn_vad.init(VadConfig(), g, "cpu").state_dict(),
              vad_cfg=VadConfig())
    whole = ServerModels(**kw)
    tp = ServerModels(tp_mesh=nccl_world_one, **kw)
    rng = np.random.default_rng(3)
    wave = (rng.standard_normal(16000 * 3) * 0.1).astype(np.float32)
    got = {}
    for name, m in (("whole", whole), ("tp", tp)):
        comm.reset_collective_counts()
        up = m.create_offline_recognizer().transcribe(wave)
        sess = m.create_session()
        finals = []
        for off in range(0, len(wave), 9600):
            res = sess.feed(wave[off: off + 9600], off + 9600 >= len(wave))
            finals.append((res.partial, res.final_text, res.timestamps))
        got[name] = ((up.text, up.timestamps), finals,
                     comm.collective_counts())
    assert got["tp"][:2] == got["whole"][:2]
    assert got["whole"][2]["broadcast"] == 0
    assert got["tp"][2]["broadcast"] == tp.fanout.broadcasts > 0
    assert list(tp._tp_shard_cache) == ["asr"]
    tp.fanout.stop()


# ---------------------------------------------------------------------------
# the fp32 kernel's schedules and its device steps (pre-pass, main kernel
# with key splits, combine) against their plain versions
# ---------------------------------------------------------------------------

# (entry, b, h, t, d, splits f32_schedule picks at 132 SMs): every split
# count the main path's shapes reach, and each ring depth (d 32 and 64: 4
# stages, 128: 2, 256: 1)
_F32_SCHEDULES = [
    ("mh", 1, 4, 256, 128, 4),      # the 2pass session's pass 2
    ("mh", 16, 4, 256, 128, 1),     # the engine lane
    ("mh", 1, 4, 1028, 128, 3),     # SenseVoice, 60 s
    ("ss", 2, 4, 3072, 128, 2),     # #2
    ("ss", 1, 4, 3076, 128, 5),     # SenseVoice, 150 s
    ("ss", 2, 2, 300, 256, 5),      # d 256: one stage, 64-row blocks
    ("ss", 2, 4, 300, 64, 5),
    ("ss", 2, 4, 300, 32, 5),
    ("ss", 1, 1, 1024, 128, 16),    # the most splits
    ("ss", 1, 1, 96, 128, 1),       # a tie keeps one split
]


@pytest.mark.parametrize("entry,b,h,t_len,d,splits", _F32_SCHEDULES)
def test_fp32_schedule_on_the_card(dev, entry, b, h, t_len, d, splits):
    """Each schedule of the fp32 kernel holds FP32_TOL against the plain
    version, with masks that have holes, a row with no valid key (V
    averaged over its Tk keys) and, in the split-head layout, q_mask rows
    that come out exactly 0."""
    gen = torch.Generator(device=dev).manual_seed(b * t_len + d)
    sched = att.f32_schedule(b, h, t_len, t_len, d,
                             att._sm_count(dev.index or 0))
    assert sched.splits == splits
    mask = (torch.rand(b, t_len, generator=gen, device=dev) > 0.3).float()
    mask[0, t_len // 3:] = 0           # the last valid key mid-row
    if b > 1:
        mask[-1] = 0                   # no valid key
    if entry == "mh":
        qkv = torch.randn(b, t_len, 3 * h * d, generator=gen, device=dev)
        q, kv = qkv[..., :h * d], qkv[..., h * d:]
        got = att.mh_flash_attention(q, kv, mask, h)
        _check(got, _reference("mh", q, kv, mask, h), torch.float32)
        return
    qh, kh, vh = _fused(b, t_len, h, d, gen, dev, torch.float32)
    got = att._attention_ss(qh, kh, vh, mask, mask)
    _check(got, _reference("split", qh, kh, vh, mask, mask), torch.float32)
    assert (got.transpose(1, 2)[mask == 0] == 0).all()


def test_fp32_image_layout_matches_the_planner(dev):
    """The kernel's tile image and ring depth, as its source computes
    them, are the planner's."""
    lib = att._library()
    for d, stages in ((32, 4), (64, 2), (96, 1), (128, 1), (256, 1)):
        assert lib.asr2pass_attention_f32_image(d, 0) == \
            att.f32_image_bytes(d)
        assert lib.asr2pass_attention_f32_image(d, 1) == stages
        assert lib.asr2pass_attention_f32_image(d, 2) == att.f32_bk(d)


@pytest.mark.parametrize("t_len,d", [(256, 128), (200, 96), (100, 256)])
def test_fp32_steps_match_their_plain_versions(dev, t_len, d):
    """The pre-pass's images equal f32_presplit_plain bit for bit on every
    tile the main kernel reads, and its tile counts f32_tiles_plain; the
    split partials match f32_partials_plain (m in log2 units within 1e-3,
    a split of masked keys only at exactly -1e30), and the combine of the
    kernel's own partials, its output."""
    gen = torch.Generator(device=dev).manual_seed(t_len)
    b, h = 3, 2
    q, k, v = (torch.randn(b, h, t_len, d, generator=gen, device=dev)
               for _ in range(3))
    mask = (torch.rand(b, t_len, generator=gen, device=dev) > 0.5).float()
    mask[0, 40:t_len - 20] = 0          # splits of masked keys only
    mask[1] = 0                         # no valid key
    _, parts = att.f32_run_steps(q, k, v, mask, mask, 1)
    torch.cuda.synchronize()
    tiles = att.f32_tiles_plain(mask, att.f32_bk(d))
    assert torch.equal(parts["tiles"], tiles)
    plain = att.f32_presplit_plain(k, v, mask)
    for bi, n in enumerate(tiles.tolist()):
        assert torch.equal(parts["images"][bi, :, :n].view(torch.int32),
                           plain[bi, :, :n].view(torch.int32))
    sched = att.f32_schedule(b, h, t_len, t_len, d,
                             att._sm_count(dev.index or 0))
    assert sched.splits > 1
    out, parts = att.f32_run_steps(q, k, v, mask, mask, 3)
    full = att._attention_ss(q, k, v, mask, mask)
    torch.cuda.synchronize()
    m, l, o = att.f32_partials_plain(q, k, v, mask, sched.splits, sched.bk)
    km, kl = parts["part_ml"][..., 0], parts["part_ml"][..., 1]
    for bi, n in enumerate(tiles.tolist()):
        per = -(-n // sched.splits)
        used = -(-n // per)
        assert ((km[:used, bi] - m[:used, bi]).abs() <= 1e-3).all()
        assert torch.equal(km[:used, bi] == -1e30, m[:used, bi] == -1e30)
        limit = 1e-4 + 1e-4 * l[:used, bi].abs()
        assert ((kl[:used, bi] - l[:used, bi]).abs() <= limit).all()
        ko = parts["part_o"][:used, bi]
        assert ((ko - o[:used, bi]).abs()
                <= 1e-4 + 1e-4 * o[:used, bi].abs()).all()
        mine = att.f32_combine_plain(km[:used, bi:bi + 1],
                                     kl[:used, bi:bi + 1],
                                     ko[:, None], mask[bi:bi + 1])
        assert torch.allclose(mine[0], full[bi], rtol=1e-5, atol=1e-6)
    assert (out == 0).all()            # the combine did not run

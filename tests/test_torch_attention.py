"""The port's attention entry points (asr2pass_tpu_torch/ops/attention.py)
against the JAX package's Pallas kernels run in interpret mode on the CPU.

On a CPU tensor each entry point runs its plain PyTorch version, so these
tests hold the plain versions (the card's oracle) to the TPU kernels'
semantics; the CUDA kernel itself is held to the plain versions on the
card (test_torch_cuda.py, chip_smoke.py).

Tolerance: rtol 2e-4, atol 2e-5, as tests/test_flash_attention.py holds
the Pallas kernels to the XLA path: fp32 softmax and two fp32 products
summed in another order over up to 512 keys.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asr2pass_tpu.ops import attention as jatt
from asr2pass_tpu_torch.ops import attention as tatt
from torch_parity import ragged_mask, t

RTOL, ATOL = 2e-4, 2e-5


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("heads,tq,tk,lens", [
    (4, 256, 256, [256, 200]),     # self-shaped
    (2, 300, 300, [300, 123]),     # ragged key tile edge
    (4, 200, 384, [384, 250]),     # cross-shaped, Tq < Tk
    (2, 264, 256, [256, 0]),       # cross, a length-0 (padding) row
    (4, 256, 256, [0, 256]),       # self, a length-0 row first
])
def test_mh_flash_attention_matches_pallas(heads, tq, tk, lens):
    """Unsplit q [B,Tq,D] / kv [B,Tk,2D] layout, merged output, padded
    query rows not zeroed. A length-0 row averages V over all keys in
    both (Tk is a multiple of the Pallas kernel's 128-key padding there,
    so the JAX kernel sees no extra zero keys)."""
    b, d = 2, 128
    rng = np.random.default_rng(5)
    q, kv = _rand(rng, b, tq, d), _rand(rng, b, tk, 2 * d)
    mask = ragged_mask(lens, tk)
    ref = np.asarray(jatt.mh_flash_attention(
        jnp.asarray(q), jnp.asarray(kv), jnp.asarray(mask), heads,
        interpret=True))
    got = tatt.mh_flash_attention(t(q), t(kv), t(mask), heads).numpy()
    assert got.shape == (b, tq, d)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("entry", ["flash_attention", "_attention_ss",
                                   "_attention_flash"])
@pytest.mark.parametrize("heads,t_len,lens", [
    (2, 256, [256, 200]),
    (2, 300, [300, 123]),
    (4, 300, [0, 300]),            # a length-0 row
])
def test_split_head_attention_matches_pallas(entry, heads, t_len, lens):
    """Split-head [B,H,T,d] self-attention with the query rows of masked
    positions zeroed: a length-0 row is exactly 0 in both."""
    b, d = 2, 64
    rng = np.random.default_rng(0)
    q, k, v = (_rand(rng, b, heads, t_len, d) for _ in range(3))
    mask = ragged_mask(lens, t_len)
    jargs = (jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
             jnp.asarray(mask))
    targs = (t(q), t(k), t(v), t(mask))
    if entry == "_attention_ss":
        ref = jatt._attention_ss(*jargs, q_mask=jargs[3], interpret=True)
        got = tatt._attention_ss(*targs, q_mask=targs[3])
    else:
        ref = getattr(jatt, entry)(*jargs, interpret=True)
        got = getattr(tatt, entry)(*targs)
    ref, got = np.asarray(ref), got.numpy()
    assert np.isfinite(got).all()
    for i, n in enumerate(lens):
        assert (got[i, :, n:] == 0).all()
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("tq,tk,lens", [(300, 512, [512, 377]),
                                        (256, 120, [120, 64]),
                                        (200, 256, [0, 256])])
def test_cross_flash_attention_matches_pallas(tq, tk, lens):
    """Split-head cross-attention (Tq != Tk): query rows are not zeroed,
    a length-0 row is finite."""
    b, h, d = 2, 2, 64
    rng = np.random.default_rng(2)
    q = _rand(rng, b, h, tq, d)
    k, v = _rand(rng, b, h, tk, d), _rand(rng, b, h, tk, d)
    mask = ragged_mask(lens, tk)
    ref = np.asarray(jatt.cross_flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(mask),
        interpret=True))
    got = tatt.cross_flash_attention(t(q), t(k), t(v), t(mask)).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)


def test_flash_attention_dispatch_by_length(monkeypatch):
    """flash_attention splits at MAX_T_SS_SPLIT like the JAX package: the
    single-shot entry point up to it, the online-softmax one past it."""
    assert tatt.MAX_T_SS_SPLIT == jatt.MAX_T_SS_SPLIT
    calls = []
    monkeypatch.setattr(tatt, "_attention_ss",
                        lambda *a, **k: calls.append("ss"))
    monkeypatch.setattr(tatt, "_attention_flash",
                        lambda *a, **k: calls.append("flash"))
    for t_len in (tatt.MAX_T_SS_SPLIT, tatt.MAX_T_SS_SPLIT + 1):
        q = torch.empty(1, 1, t_len, 8)
        tatt.flash_attention(q, q, q, torch.ones(1, t_len))
    assert calls == ["ss", "flash"]


_GATE_CASES = [(t_len, d_head, att) for t_len in
               (255, 256, 1024, 2048, 2049, 4096, 5120)
               for d_head in (16, 64, 96, 128, 256, 257, 512)
               for att in (None, "mask")]


@pytest.mark.parametrize("t_len,d_head,att", _GATE_CASES)
def test_gates_mirror_jax_gates(monkeypatch, t_len, d_head, att):
    """On a CUDA tensor the port's gates pick what the JAX gates pick on
    the TPU; on a CPU tensor they pick no kernel."""
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    monkeypatch.delenv("ASR2PASS_FLASH_ATTENTION", raising=False)
    am = None if att is None else np.ones((t_len, t_len), np.float32)
    jgates = (jatt.use_flash(t_len, d_head, am),
              jatt.use_flash_split(t_len, d_head, am),
              jatt.use_flash_cross(t_len // 2 + 8, t_len, d_head))
    for is_cuda in (True, False):
        tgates = (tatt.use_flash(t_len, d_head, am, is_cuda),
                  tatt.use_flash_split(t_len, d_head, am, is_cuda),
                  tatt.use_flash_cross(t_len // 2 + 8, t_len, d_head,
                                       is_cuda))
        assert tgates == (jgates if is_cuda else (False,) * 3)


def test_cpu_tensors_launch_nothing():
    """A CPU tensor runs the plain version and counts no launch."""
    tatt.reset_launch_counts()
    q = torch.randn(1, 256, 64)
    tatt.mh_flash_attention(q, torch.randn(1, 256, 128), torch.ones(1, 256),
                            2)
    qh = torch.randn(1, 2, 300, 32)
    tatt.flash_attention(qh, qh, qh, torch.ones(1, 300))
    tatt._attention_flash(qh, qh, qh, torch.ones(1, 300))
    assert tatt.launch_counts() == {"mh_flash_attention": 0,
                                    "_attention_ss": 0,
                                    "_attention_flash": 0}


# ---------------------------------------------------------------------------
# the bf16 limit (ops/attention.py bf16_reference) against the Pallas kernels
# in bf16: they round P to bf16 before the P.V product (per 128-key block in
# _attention_flash), as the card's tensor-core kernel does, so their share
# of the limit predicts the card's reading
# ---------------------------------------------------------------------------

def _bf16(x):
    """numpy fp32 -> (jax bf16 array, torch bf16 tensor) of equal values."""
    xj = jnp.asarray(x, jnp.bfloat16)
    return xj, torch.from_numpy(np.array(xj.astype(jnp.float32))).bfloat16()


@pytest.mark.parametrize("entry,t_len", [("mh_flash_attention", 512),
                                         ("_attention_ss", 512),
                                         ("_attention_flash", 640)])
def test_bf16_limit_holds_for_pallas_kernels(entry, t_len):
    """The Pallas kernel in bf16 (interpret mode) is within the bf16 limit
    of the port's plain version in fp32, and the plain result with each
    row's last valid key dropped fails it by 10 times or more."""
    b, h, d = 2, 2, 128
    rng = np.random.default_rng(7)
    lens = [t_len, t_len // 3]
    mask = ragged_mask(lens, t_len)
    drop = mask.copy()
    drop[[0, 1], [n - 1 for n in lens]] = 0
    tm, td = t(mask), t(drop)
    if entry == "mh_flash_attention":
        (qj, qt), (kvj, kvt) = (_bf16(_rand(rng, b, t_len, n * h * d))
                                for n in (1, 2))
        got = jatt.mh_flash_attention(qj, kvj, jnp.asarray(mask), h,
                                      interpret=True)
        ref, limit = tatt.mh_bf16_reference(qt, kvt, tm, h)
        control = tatt.mh_attention_plain(qt.float(), kvt.float(), td, h)
    else:
        (qj, qt), (kj, kt), (vj, vt) = (_bf16(_rand(rng, b, h, t_len, d))
                                        for _ in range(3))
        mj = jnp.asarray(mask)
        got = (jatt._attention_ss(qj, kj, vj, mj, q_mask=mj, interpret=True)
               if entry == "_attention_ss"
               else jatt._attention_flash(qj, kj, vj, mj, interpret=True))
        ref, limit = tatt.bf16_reference(qt, kt, vt, tm, tm)
        control = tatt.attention_plain(qt.float(), kt.float(), vt.float(),
                                       td, tm)
    got = torch.from_numpy(np.array(got.astype(jnp.float32)))
    share = ((got - ref).abs() / limit).max().item()
    control_share = ((control.bfloat16().float() - ref).abs()
                     / limit).max().item()
    assert share <= 1.0, share
    assert control_share >= 10.0, control_share


def test_attention_plain_returns_its_fp32_weights():
    """With return_weights the plain version also gives the fp32 softmax
    weights it used: rows sum to 1, masked keys get 0, and the context is
    the one it returns without them."""
    rng = np.random.default_rng(3)
    q, k, v = (t(_rand(rng, 2, 2, 5, 8)).bfloat16() for _ in range(3))
    mask = t(ragged_mask([5, 3], 5))
    out, p = tatt.attention_plain(q, k, v, mask, mask, return_weights=True)
    assert p.dtype == torch.float32 and p.shape == (2, 2, 5, 5)
    torch.testing.assert_close(p.sum(-1), torch.ones(2, 2, 5))
    assert (p[1, :, :, 3:] == 0).all()
    assert torch.equal(out, tatt.attention_plain(q, k, v, mask, mask))


def test_bf16_limit_terms():
    """The limit is 2^-8 |plain| + 2^-6 sqrt(sum_j p_j^2 v_j^2) + 1e-6
    with p the plain version's fp32 weights: one valid key gives p = 1,
    so the limit is (2^-8 + 2^-6) |v| + 1e-6; a masked-out query row
    (q_mask 0) has reference 0."""
    v = torch.tensor([[[[2.0, -4.0], [7.0, 7.0]]]])
    q = torch.zeros(1, 1, 3, 2)
    mask = torch.tensor([[1.0, 0.0]])
    ref, limit = tatt.bf16_reference(q, v, v, mask, torch.tensor(
        [[1.0, 1.0, 0.0]]))
    want = (2.0 ** -8 + 2.0 ** -6) * torch.tensor([2.0, 4.0]) + 1e-6
    torch.testing.assert_close(ref[0, 0, :2], torch.tensor([[2.0, -4.0]] * 2))
    torch.testing.assert_close(limit[0, 0, 0], want)
    assert (ref[0, 0, 2] == 0).all()


# ---------------------------------------------------------------------------
# the fp32 kernel's 3xTF32 arithmetic (ops/attention.py tf32_split), modelled
# on the CPU: each operand split as hi + lo, both rounded to TF32, and each
# product taken as lo.hi + hi.lo + hi.hi in fp32
# ---------------------------------------------------------------------------

def _f32(*bits):
    return torch.from_numpy(np.array(bits, dtype=np.uint32).view(np.float32))


def _bits(x):
    return [int(b) for b in x.numpy().view(np.uint32)]


@pytest.mark.parametrize("x,hi,lo", [
    (0x3F800000, 0x3F800000, 0x00000000),    # 1.0: exact, lo +0
    (0x3F801000, 0x3F802000, 0xBA000000),    # tie, even kept bit: away
    (0x3F803000, 0x3F804000, 0xBA000000),    # tie, odd kept bit: away
    (0xBF801000, 0xBF802000, 0x3A000000),    # negative tie: away from 0
    (0x3F800FFF, 0x3F800000, 0x3A000000),    # below the tie: down
    (0x3FFFF000, 0x40000000, 0xBA000000),    # carry into the exponent
    (0x00000000, 0x00000000, 0x00000000),    # +0
    (0x80000000, 0x80000000, 0x00000000),    # -0 keeps its sign
    (0x00000001, 0x00000000, 0x00000000),    # smallest subnormal: lost
    (0x00001000, 0x00002000, 0x80002000),    # subnormal tie: away
    (0x007FF000, 0x00800000, 0x80002000),    # subnormal up to the normals
    (0x7F7FEFFF, 0x7F7FE000, 0x79800000),    # largest that keeps hi finite
    (0x7F7FFFFF, 0x7F800000, 0xFF800000),    # largest finite: hi +inf
    (0xFF7FFFFF, 0xFF800000, 0x7F800000),    # and its negative: -inf
])
def test_tf32_split_pins_rounding(x, hi, lo):
    """tf32_split rounds as cvt.rna.tf32.f32: to nearest, ties away from
    zero, low 13 bits zero; lo is the rounded remainder."""
    got_hi, got_lo = tatt.tf32_split(_f32(x))
    assert _bits(got_hi) == [hi] and _bits(got_lo) == [lo]
    if hi & 0x7F800000 != 0x7F800000:
        assert (hi | lo) & 0x1FFF == 0


def test_tf32_split_keeps_22_bits_and_nan():
    """hi + lo is x to about 2^-22 of |x| on normal values; NaN stays
    NaN and inf stays inf in hi."""
    x = torch.from_numpy(np.random.default_rng(11).standard_normal(
        100000).astype(np.float32))
    hi, lo = tatt.tf32_split(x)
    rel = ((hi.double() + lo.double() - x.double()).abs()
           / x.double().abs()).max().item()
    assert rel <= 2.0 ** -21, rel
    nan, inf = _f32(0x7FC00000, 0x7F800000)
    assert torch.isnan(tatt.tf32_split(nan)[0]).all()
    assert torch.isinf(tatt.tf32_split(inf)[0]).all()


def _three_tf32(a, b):
    """a @ b with both operands split and three products, small first."""
    (ah, al), (bh, bl) = tatt.tf32_split(a), tatt.tf32_split(b)
    return al @ bh + ah @ bl + ah @ bh


def _attention_3xtf32(q, k, v, mask):
    """The fp32 kernel's arithmetic: both products in 3xTF32, the
    softmax in fp32, masked rows (q_mask = mask) zeroed."""
    s = _three_tf32(q, k.transpose(-1, -2)) / np.sqrt(q.shape[-1])
    s = torch.where(mask[:, None, None, :] > 0, s, torch.tensor(-1e30))
    p = torch.softmax(s, dim=-1)
    return _three_tf32(p, v) * (mask[:, None, :, None] > 0)


def test_3xtf32_holds_fp32_tol_and_one_tf32_product_does_not():
    """At a main-path-like size (d 128, Tk 1024, 2 heads, a length-0
    row), the 3xTF32 model reads at most 0.1 of FP32_TOL against the
    plain version, and the same attention with q, k, v and P rounded once
    to TF32 (one product each, the TF32 control) reads over 1."""
    rng = np.random.default_rng(12)
    b, h, t_len, d = 2, 2, 1024, 128
    q, k, v = (t(_rand(rng, b, h, t_len, d)) for _ in range(3))
    mask = t(ragged_mask([t_len, 0], t_len))
    ref = tatt.attention_plain(q, k, v, mask, mask)
    atol, rtol = tatt.FP32_TOL
    limit = atol + rtol * ref.abs()
    share = ((_attention_3xtf32(q, k, v, mask) - ref).abs() / limit).max()
    one = tatt.attention_plain(q, k, v, mask, mask,
                               operand_round=lambda x: tatt.tf32_split(x)[0])
    one_share = ((one - ref).abs() / limit).max()
    assert share <= 0.1, share
    assert one_share > 1.0, one_share


def _truncated_tf32_split(x):
    """hi rounded as tf32_split's, lo the remainder cut to TF32 (its low
    13 bits dropped), as wgmma reads a lo fed as it is."""
    hi = tatt.tf32_split(x)[0]
    lo = ((x - hi).view(torch.int32) & ~0x1FFF).view(torch.float32)
    return hi, lo


def test_3xtf32_with_truncated_lo_holds_fp32_tol():
    """The kernel's product loop feeds Q's and P's lo parts as they are
    (wgmma truncates them), against K's and V's rounded planes: at the
    main-path-like size of the test above this reads at most 0.1 of
    FP32_TOL, as the rounded split does."""
    rng = np.random.default_rng(12)
    b, h, t_len, d = 2, 2, 1024, 128
    q, k, v = (t(_rand(rng, b, h, t_len, d)) for _ in range(3))
    mask = t(ragged_mask([t_len, 0], t_len))

    def product(a, c):   # a's lo truncated, c's rounded
        (ah, al), (ch, cl) = _truncated_tf32_split(a), tatt.tf32_split(c)
        return al @ ch + ah @ cl + ah @ ch
    s = product(q, k.transpose(-1, -2)) / np.sqrt(d)
    s = torch.where(mask[:, None, None, :] > 0, s, torch.tensor(-1e30))
    got = product(torch.softmax(s, dim=-1), v) * (mask[:, None, :, None] > 0)
    ref = tatt.attention_plain(q, k, v, mask, mask)
    atol, rtol = tatt.FP32_TOL
    share = ((got - ref).abs() / (atol + rtol * ref.abs())).max()
    assert share <= 0.1, share


def test_tma_ready_fp32_counts_16_bytes_as_4_elements():
    """In fp32 TMA's 16-byte rules are 4 elements: d and the strides
    multiples of 4, the base 16-byte aligned."""
    base = torch.zeros(2, 64, 3 * 64 + 8)
    ok = base[..., :128].unflatten(-1, (2, 64)).transpose(1, 2)
    assert tatt.tma_ready(ok)
    assert not tatt.tma_ready(torch.zeros(2, 64, 2 * 64 + 2)[
        ..., :128].unflatten(-1, (2, 64)).transpose(1, 2))
    assert not tatt.tma_ready(base[..., 2:130].unflatten(-1, (2, 64))
                              .transpose(1, 2))
    assert tatt.tma_ready(base[..., 4:132].unflatten(-1, (2, 64))
                          .transpose(1, 2))
    assert not tatt.tma_ready(torch.zeros(2, 2, 64, 6))


# ---------------------------------------------------------------------------
# around the kernels, on the CPU: routing, layout planning, input checks
# ---------------------------------------------------------------------------

def test_dtype_routes_to_its_kernel():
    """float32 goes to the 3xTF32 kernel, bfloat16 to the bf16 one; each
    named source is in the package, build() compiles every csrc/*.cu into
    one library and hashes the shared header with them, and the tensor-map
    code lives once, in tma.cuh, which both kernels include."""
    assert tatt.kernel_symbol(torch.float32) == "asr2pass_attention_f32"
    assert tatt.kernel_symbol(torch.bfloat16) == "asr2pass_attention_bf16"
    for dtype in (torch.float16, torch.float64, torch.int8):
        with pytest.raises(TypeError, match="float32 or bfloat16"):
            tatt.kernel_symbol(dtype)
    names = {p.name for p in tatt.sources()}
    assert names == {"attention_f32_sm90.cu", "attention_sm90.cu", "tma.cuh"}
    for symbol, src in tatt.KERNELS.values():
        text = (tatt.CSRC.parent / src).read_text()
        assert f'extern "C" int {symbol}(' in text
        assert '#include "tma.cuh"' in text
        assert "cuTensorMapEncodeTiled" not in text
    assert "cuTensorMapEncodeTiled" in (tatt.CSRC / "tma.cuh").read_text()
    f32 = (tatt.CSRC / "attention_f32_sm90.cu").read_text()
    assert "asr2pass_attention_bf16" not in f32
    assert "0x1000u) & 0xFFFFE000u" in f32 and ".tf32.tf32" in f32


def _fused_views(b, t_len, h, d, extra=0, offset=0, dtype=torch.bfloat16):
    qkv = torch.zeros(b, t_len, 3 * h * d + extra,
                      dtype=dtype)[..., offset:offset + 3 * h * d]
    return tuple(a.unflatten(-1, (h, d)).transpose(1, 2)
                 for a in qkv.split(h * d, dim=-1))


def test_tma_plan_reads_aligned_views_in_place():
    """Split-head views of a fused [B,T,3*H*d] projection and the unsplit
    layout's [B,H,T,d_k] views (head stride d_k) need no copy, in bf16
    and in fp32."""
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v = _fused_views(2, 300, 4, 128, dtype=dtype)
        out = torch.empty(q.shape, dtype=q.dtype)
        plan = tatt.plan_tma(q, k, v, out)
        assert plan.copied == ()
        assert all(a.data_ptr() == b.data_ptr()
                   for a, b in zip(plan, (q, k, v, out)))
        qkv = torch.zeros(2, 300, 3 * 512, dtype=dtype)
        heads = [tatt._split_heads(x, 4) for x in qkv.split(512, dim=-1)]
        assert heads[0].stride() == (300 * 1536, 128, 1536, 1)
        assert tatt.plan_tma(*heads, out).copied == ()


_PLAN_CASES = ["d20", "odd_base", "odd_row_stride", "expanded",
               "odd_base_contiguous"]


@pytest.mark.parametrize("case", _PLAN_CASES
                         + [f"{c}_float32" for c in _PLAN_CASES])
def test_tma_plan_copies_what_tma_cannot_read(case):
    """A head dim that is not a multiple of 16 bytes (8 bf16, 4 fp32
    elements) pads q, k, v and the output buffer with zero columns; an
    unaligned base or stride, or a stride of 0, gets a contiguous copy of
    that operand only, also where the view is contiguous already but
    starts one element off alignment. Cases without a suffix are bf16;
    in fp32 the pad case takes d 18 (20 is a multiple of 4) and the odd
    row stride is 2 elements off (8 bytes)."""
    dtype = torch.float32 if case.endswith("_float32") else torch.bfloat16
    case = case.removesuffix("_float32")
    q, k, v = _fused_views(2, 64, 2, 32, dtype=dtype)
    out = torch.empty(q.shape, dtype=q.dtype)
    if case == "d20":
        d, dp = (20, 24) if dtype == torch.bfloat16 else (18, 20)
        q, k, v = (torch.randn(2, 2, 64, d).to(dtype) for _ in range(3))
        plan = tatt.plan_tma(q, k, v, torch.empty_like(q))
        assert plan.copied == ("q", "k", "v", "out")
        assert plan.q.shape[-1] == plan.out.shape[-1] == dp
        assert torch.equal(plan.q[..., :d], q)
        assert (plan.k[..., d:] == 0).all()
        return
    if case == "odd_base":
        q = _fused_views(2, 64, 2, 32, extra=1, offset=1, dtype=dtype)[0]
    elif case == "odd_base_contiguous":
        q = torch.arange(1 + 2 * 2 * 64 * 32, dtype=dtype)[
            1:].view(2, 2, 64, 32)
        assert q.is_contiguous()
    elif case == "odd_row_stride":
        extra = 1 if dtype == torch.bfloat16 else 2
        q = torch.zeros(2, 64, 2 * 32 + extra, dtype=dtype)[
            ..., :64].unflatten(-1, (2, 32)).transpose(1, 2)
    else:
        k = k[:, :, :1].expand(-1, -1, 64, -1)
    assert not tatt.tma_ready(q if case != "expanded" else k)
    plan = tatt.plan_tma(q, k, v, out)
    assert plan.copied == (("q",) if case != "expanded" else ("k",))
    name = plan.copied[0]
    copy = getattr(plan, name)
    assert copy.is_contiguous() and tatt.tma_ready(copy)
    assert copy.data_ptr() % tatt.TMA_ALIGN == 0
    assert torch.equal(copy, q if name == "q" else k)


def test_kernel_strides_of_length_one_dims():
    """A dim of length 1 is never stepped; it is handed to the kernels
    with the view's span, a positive multiple of 8 past every stride."""
    x = torch.empty(1, 1, 100, 40)
    st = tatt._strides(x)
    assert st[2] == 40 and st[0] == st[1] and st[0] % 8 == 0
    assert st[0] >= 100 * 40


@pytest.mark.parametrize("bad,exc,match", [
    ("float16", TypeError, "float32 or bfloat16"),
    ("mixed_dtype", TypeError, "share dtype"),
    ("column_stride", ValueError, "unit column stride"),
    ("head_dim", ValueError, "head dim"),
    ("kv_shape", ValueError, "not"),
    ("out_shape", ValueError, "not"),
    ("kv_mask", ValueError, "kv_mask"),
    ("q_mask", ValueError, "q_mask"),
])
def test_unsupported_input_is_refused(bad, exc, match):
    """check_operands, the gate in front of every launch, raises on what
    the kernels do not take (a CUDA tensor never falls back)."""
    q = torch.zeros(2, 2, 64, 32, dtype=torch.bfloat16)
    k, v, out = q.clone(), q.clone(), q.clone()
    kv_mask, q_mask = torch.ones(2, 64), None
    if bad == "float16":
        q, k, v, out = (x.half() for x in (q, k, v, out))
    elif bad == "mixed_dtype":
        k = k.float()
    elif bad == "column_stride":
        v = torch.zeros(2, 2, 64, 64, dtype=torch.bfloat16)[..., ::2]
    elif bad == "head_dim":
        q, k, v, out = (torch.zeros(2, 2, 64, 257, dtype=torch.bfloat16)
                        for _ in range(4))
    elif bad == "kv_shape":
        k = k[:, :, :, :16]
    elif bad == "out_shape":
        out = out[:, :1]
    elif bad == "kv_mask":
        kv_mask = torch.ones(2, 63)
    else:
        q_mask = torch.ones(2, 32)
    with pytest.raises(exc, match=match):
        tatt.check_operands(q, k, v, out, kv_mask, q_mask)


def test_launch_counts_by_dtype_start_at_zero():
    """Counts per entry point and dtype; CPU tensors add nothing."""
    tatt.reset_launch_counts()
    qh = torch.randn(1, 2, 300, 32).bfloat16()
    tatt.flash_attention(qh, qh, qh, torch.ones(1, 300))
    assert tatt.launch_counts_by_dtype() == {
        name: {"float32": 0, "bfloat16": 0}
        for name in ("mh_flash_attention", "_attention_ss",
                     "_attention_flash")}


def test_head_view_is_the_split_of_the_column_blocks():
    """The kernels' [B,H,T,d_k] views of the unsplit layout equal the
    plain version's head split of the same columns and share storage."""
    qkv = torch.arange(2 * 5 * 3 * 8, dtype=torch.float32).view(2, 5, 24)
    q, kv = qkv[..., :8], qkv[..., 8:]
    for view, ref in [(tatt._head_view(q, 2, 8), q),
                      (tatt._head_view(kv, 2, 8), kv[..., :8]),
                      (tatt._head_view(kv, 2, 8, 8), kv[..., 8:])]:
        assert torch.equal(view, tatt._split_heads(ref, 2))
        assert view.data_ptr() == ref.data_ptr()


# ---------------------------------------------------------------------------
# the fp32 kernel's device steps (csrc/attention_f32_sm90.cu: pre-pass, main
# kernel with key splits, combine) as their plain versions, and its
# schedule, on the CPU; tests/test_torch_cuda.py holds the kernel's own
# steps to the same plain versions on the card
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d,tk", [(128, 150), (96, 33), (32, 64), (256, 40)])
def test_f32_presplit_plain_planes_and_key_order(d, tk):
    """Each tile's image (BK = 64 keys, 32 at d 256): K hi and lo are
    tf32_split of K in the swizzled 32-column panels (element (r, c) at
    byte (c/32)*BK*128 + r*128 + ((c%32/4) ^ (r%8))*16 + (c%4)*4), the
    key states follow, then V^T hi and lo: tf32_split of V transposed, in
    panels of 32 keys, with the keys of each 8-group in the order
    0,2,4,6,1,3,5,7 (so that position t and t+4 hold the keys 2t and
    2t+1 that a thread's S columns carry); zeros past Tk and past d."""
    rng = np.random.default_rng(21)
    b, h = 2, 2
    k, v = (t(_rand(rng, b, h, tk, d)) for _ in range(2))
    mask = t(ragged_mask([tk, tk // 2], tk))
    img = tatt.f32_presplit_plain(k, v, mask)
    n = tatt.f32_instance(d)
    bk = tatt.f32_bk(d)
    assert bk == (32 if d > 128 else 64)
    plane = bk * n
    vt0 = 2 * plane + bk
    tiles = -(-tk // bk)
    assert img.shape == (b, h, tiles, tatt.f32_image_bytes(d) // 4)
    khi, klo = tatt.tf32_split(k)
    vhi, vlo = tatt.tf32_split(v)
    for j in range(bk // 8):
        for t4 in range(4):
            assert tatt.F32_VT_KEYS[8 * j + t4] == 8 * j + 2 * t4
            assert tatt.F32_VT_KEYS[8 * j + t4 + 4] == 8 * j + 2 * t4 + 1

    def k_at(r, c):   # element index of (key r, column c) in a K plane
        return ((c // 32) * bk * 128 + r * 128
                + (((c % 32) // 4) ^ (r % 8)) * 16 + (c % 4) * 4) // 4

    def vt_at(c, p):  # element index of (column c, position p) in V^T
        return ((p // 32) * n * 128 + c * 128
                + (((p % 32) // 4) ^ (c % 8)) * 16 + (p % 4) * 4) // 4

    for key in sorted({0, 1, 9, 40 % tk, tk - 1}):
        ti, r = divmod(key, bk)
        for c in (0, 5, 37 % n, d - 1):
            if c >= d:
                continue
            assert img[0, 1, ti, k_at(r, c)] == khi[0, 1, key, c]
            assert img[0, 1, ti, plane + k_at(r, c)] == klo[0, 1, key, c]
            p = tatt.F32_VT_KEYS.index(r)
            assert img[1, 0, ti, vt0 + vt_at(c, p)] == vhi[1, 0, key, c]
            assert img[1, 0, ti, vt0 + plane + vt_at(c, p)] == \
                vlo[1, 0, key, c]
    # zeros past d and past Tk, hi + lo = x to 2^-21
    last = img[:, :, -1]
    if tk % bk:
        r = tk % bk
        assert (last[..., k_at(r, 0)] == 0).all()
        assert (last[..., vt0 + vt_at(0, tatt.F32_VT_KEYS.index(r))]
                == 0).all()
    if d < n:
        assert (img[..., k_at(3, d)] == 0).all()
        assert (img[..., vt0 + vt_at(d, 3)] == 0).all()
    states = img[..., 2 * plane:vt0].reshape(b, h, tiles * bk)
    want = torch.full((b, tiles * bk), -1.0)
    want[:, :tk] = mask
    assert torch.equal(states, want[:, None].expand(b, h, -1))


def _holes(tk, pattern):
    """kv_mask rows for the split cases: 'first_last' keeps tile 0 and
    the last tile valid, every tile between them masked."""
    if pattern == "first_last":
        m = np.zeros(tk, np.float32)
        m[:5] = 1
        m[-3:] = 1
        return m
    rng = np.random.default_rng(tk)
    return (rng.random(tk) > 0.4).astype(np.float32)


@pytest.mark.parametrize("splits,tk,rows,bk", [
    (1, 200, ["len:200", "len:0"], 64),
    (3, 200, ["len:130", "len:0"], 32),   # a row with no valid key
    (4, 160, ["first_last", "len:33"], 32),   # splits of masked keys only
    (3, 260, ["first_last", "len:260"], 64),
    (5, 150, ["holes", "len:150"], 32),
    (16, 96, ["len:1", "holes"], 64),     # more splits than tiles
])
def test_f32_split_partials_combine_match_plain(splits, tk, rows, bk):
    """The main kernel's split partials (m, l, unnormalised O over each
    split's share of the tiles up to the last valid key) merged by the
    combine equal the plain version within FP32_TOL, with the masking
    contract kept: a split of masked keys only carries m = -1e30 and
    drops out, a row with no valid key averages V over its Tk keys, rows
    whose q_mask is 0 are exact zeros, an empty split holds m = -inf."""
    rng = np.random.default_rng(splits)
    b, h, tq, d = 2, 2, 40, 32
    q = t(_rand(rng, b, h, tq, d))
    k, v = (t(_rand(rng, b, h, tk, d)) for _ in range(2))
    mask = np.stack([ragged_mask([int(r[4:])], tk)[0]
                     if r.startswith("len:") else _holes(tk, r)
                     for r in rows])
    mask = t(mask)
    q_mask = t(ragged_mask([tq, tq // 3], tq))
    m, l, o = tatt.f32_partials_plain(q, k, v, mask, splits, bk)
    got = tatt.f32_combine_plain(m, l, o, q_mask)
    ref = tatt.attention_plain(q, k, v, mask, q_mask)
    atol, rtol = tatt.FP32_TOL
    assert ((got - ref).abs() <= atol + rtol * ref.abs()).all()
    assert (got[1, :, tq // 3:] == 0).all()
    tiles = tatt.f32_tiles_plain(mask, bk).tolist()
    for bi, n_t in enumerate(tiles):
        per = -(-n_t // splits)
        used = -(-n_t // per)
        assert torch.isinf(m[used:, bi]).all() and (l[used:, bi] == 0).all()
        assert torch.isfinite(m[:used, bi]).all()
        if rows[bi] == "first_last":
            assert n_t == -(-tk // bk)
            assert (m[1:used - 1, bi] == -1e30).all()
            assert (m[0, bi] > -1e30).all()
    if "len:0" in rows:
        bi = rows.index("len:0")
        assert tiles[bi] == -(-tk // bk)
        avg = v[bi].mean(dim=1, keepdim=True).expand(h, tq, d)
        nz = q_mask[bi] > 0
        assert torch.allclose(got[bi][:, nz], avg[:, nz], atol=1e-5)


_SCHEDULES = [
    # (b, h, tq, tk, d): splits and the main grid, as the H100's 132 SMs
    # give them
    ((1, 4, 256, 256, 128), 4, (8, 4, 1)),        # the 2pass session
    ((16, 4, 256, 256, 128), 1, (2, 4, 16)),      # the engine lane
    ((16, 4, 260, 260, 128), 1, (3, 4, 16)),      # SenseVoice's lane
    ((1, 4, 1028, 1028, 128), 3, (27, 4, 1)),     # SenseVoice 60 s
    ((16, 4, 1024, 1024, 128), 1, (8, 4, 16)),    # #1 self
    ((16, 4, 520, 1024, 128), 2, (10, 4, 16)),    # #1 cross
    ((2, 4, 3072, 3072, 128), 2, (48, 4, 2)),     # #2
    ((1, 4, 3076, 3076, 128), 5, (125, 4, 1)),    # SenseVoice 150 s
    ((2, 4, 5120, 5120, 128), 2, (80, 4, 2)),     # #3
    ((1, 4, 5124, 5124, 128), 4, (164, 4, 1)),    # SenseVoice 270 s
    ((2, 2, 300, 300, 256), 5, (25, 2, 2)),       # d 256: 64-row blocks
    ((2, 1, 128, 2048, 128), 16, (16, 1, 2)),     # the most splits
]


@pytest.mark.parametrize("shape,splits,grid", _SCHEDULES)
def test_f32_schedule_is_a_function_of_the_shape(shape, splits, grid):
    """f32_schedule: the key splits and grids for a shape, and a scratch
    that holds int32 tile counts, every tile's image and, where split,
    the partials, each at a 256-byte-aligned offset."""
    b, h, tq, tk, d = shape
    s = tatt.f32_schedule(*shape)
    assert (s.splits, s.grid_main) == (splits, grid)
    assert s == tatt.f32_schedule(*shape, sms=tatt.F32_SMS)
    assert s.bk == tatt.f32_bk(d) and s.tiles == -(-tk // s.bk)
    assert s.grid_presplit == (s.tiles, h, b)
    assert s.rows == (64 if d > 128 else 128)
    assert s.qblocks * s.rows >= tq > (s.qblocks - 1) * s.rows
    assert 1 <= s.splits <= min(tatt.F32_MAX_SPLITS, s.tiles)
    assert s.image_bytes == tatt.f32_image_bytes(d)
    offs = (s.off_tiles, s.off_images, s.off_part_o, s.off_part_ml,
            s.scratch_bytes)
    assert all(x % 256 == 0 for x in offs) and list(offs) == sorted(offs)
    assert s.off_images >= 4 * b
    assert s.off_part_o - s.off_images >= b * h * s.tiles * s.image_bytes
    if s.splits == 1:
        assert s.grid_combine == () and s.scratch_bytes == s.off_part_o
    else:
        assert s.off_part_ml - s.off_part_o >= s.splits * b * h * tq * d * 4
        assert s.scratch_bytes - s.off_part_ml >= s.splits * b * h * tq * 8
        assert s.grid_combine[0] * 256 >= tq * d // 4
    # a grid of many waves is not split
    assert tatt.f32_splits(16 * tatt.F32_SMS, s.tiles) == 1


def test_plan_slots_follow_the_c_block():
    """PLAN_SLOTS is csrc/tma.cuh's PlanSlot enum, slot for slot, and the
    fp32 source's tile and split constants are the planner's."""
    import re
    src = (tatt.CSRC / "tma.cuh").read_text()
    body = src[src.index("enum PlanSlot"):src.index("kSlotCount")]
    names = re.findall(r"kSlot(\w+)", body)
    assert names[:9] == ["Batch", "Heads", "Tq", "Tk", "D", "DScale",
                         "Device", "Splits", "Tiles"]
    assert names[9:] == ["Strides", "OffTiles", "Strides", "OffImages",
                         "OffPartO", "OffPartMl"]
    assert "kSlotOffTiles = kSlotStrides + 12" in body
    assert len(tatt.PLAN_SLOTS) == 9 + 12 + 4
    assert tatt.PLAN_SLOTS.index("off_tiles") == 21
    f32 = (tatt.CSRC / "attention_f32_sm90.cu").read_text()
    assert "static constexpr int BK = D <= 128 ? 64 : 32;" in f32
    assert [tatt.f32_bk(d) for d in (32, 64, 128, 256)] == [64, 64, 64, 32]
    assert f"constexpr int kMaxSplits = {tatt.F32_MAX_SPLITS};" in f32
    assert "cp.async.bulk.shared" in src and "bulk_load(" in f32


class _FakeLib:
    """Stands in for the kernels' library on the CPU: records the packed
    block of each call."""
    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def fn(block, *ptrs):
            self.calls.append((name, block, ptrs))
            return 0
        return fn


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mh_plan_packs_the_launch_once(monkeypatch, dtype):
    """The thin launch path's plan: made once per layout from the head
    views (check_operands' checks), its packed block holds the shape, the
    (batch, head, row) strides of the four views, the caller's head dim,
    and in fp32 f32_schedule's splits and scratch offsets; a kv that TMA
    cannot read in place goes through _attend's copies; a wrong shape
    raises."""
    monkeypatch.setattr(tatt, "_library", lambda: _FakeLib())
    monkeypatch.setattr(tatt, "_sm_count", lambda index: tatt.F32_SMS)
    b, tq, tk, d, heads = 2, 300, 256, 512, 4
    qkv = torch.zeros(b, tq, 3 * d, dtype=dtype)
    q, kv = qkv[..., :d], torch.zeros(b, tk, 2 * d, dtype=dtype)
    mask = torch.ones(b, tk)
    plan = tatt._mh_plan(q, kv, mask, heads)
    slots = dict(zip(tatt.PLAN_SLOTS, plan.block))
    assert (slots["batch"], slots["heads"], slots["tq"], slots["tk"],
            slots["d"], slots["d_scale"]) == (b, heads, tq, tk, 128, 128)
    views = (tatt._head_view(q, heads, d), tatt._head_view(kv, heads, d),
             tatt._head_view(kv, heads, d, d),
             tatt._head_view(torch.empty(b, tq, d), heads, d))
    for x, view in zip("qkvo", views):
        assert tuple(slots[f"stride_{x}_{y}"] for y in "bht") == \
            tatt._strides(view)
    assert plan.v_offset == d * qkv.element_size()
    assert plan.out_shape == (b, tq, d)
    if dtype == torch.float32:
        s = tatt.f32_schedule(b, heads, tq, tk, 128)
        assert plan.schedule == s and plan.scratch == s.scratch_bytes
        assert (slots["splits"], slots["tiles"], slots["off_images"],
                slots["off_part_o"], slots["off_part_ml"]) == (
            s.splits, s.tiles, s.off_images, s.off_part_o, s.off_part_ml)
    else:
        assert plan.schedule is None and plan.scratch == 0
    odd = torch.zeros(b, tk, 2 * d + 1, dtype=dtype)[..., 1:]
    assert tatt._mh_plan(q, odd, mask, heads) is tatt._VIA_ATTEND
    assert tatt._mh_plan(q, kv, mask.double(), heads) is tatt._VIA_ATTEND
    with pytest.raises(ValueError, match="heads"):
        tatt._mh_plan(q, kv[..., :d], mask, heads)
    with pytest.raises(ValueError, match="kv_mask"):
        tatt._mh_plan(q, kv, mask[:, :7], heads)

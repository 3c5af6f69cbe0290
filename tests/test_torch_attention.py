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

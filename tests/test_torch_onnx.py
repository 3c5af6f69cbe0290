"""The port's ONNX reader and executor (asr2pass_tpu_torch/tools/
onnx_reader.py) against the JAX package's, on the CPU.

The graphs are tests/torch_parity.funasr_source_dirs' exports (the
fixtures of tests/test_onnx_verify.py: 2- and 4-output Paraformer, VAD
with caches, punctuation offline and VadRealtime, the streaming pair,
SenseVoice) and hand-encoded graphs, one per op family that no export
uses. read_onnx must give equal graphs with bit-equal initializers; the
executors' float outputs must agree within 1e-5 of their range and the
integer ones exactly.
"""
import numpy as np
import pytest
import torch

from asr2pass_tpu.tools import onnx_reader as jreader
from asr2pass_tpu_torch.tools import onnx_reader as treader
from torch_parity import (FUNASR_VAD_DIMS, funasr_source_dirs, onnx_model,
                          onnx_node)

TOL = 1e-5


@pytest.fixture(scope="module")
def src_dirs(tmp_path_factory):
    return funasr_source_dirs(tmp_path_factory.mktemp("funasr"))


def _graph_inputs(kind, rng):
    """{input name: array} for each fixture graph (by declared name; the
    exporter may prune unused ones)."""
    f32 = np.float32
    if kind in ("asr", "asr_ts", "sensevoice"):
        out = {"speech": rng.standard_normal((1, 30, 20)).astype(f32)}
        if kind == "sensevoice":
            out.update(speech_lengths=np.asarray([30], np.int32),
                       language=np.asarray([3]), textnorm=np.asarray([14]))
        else:
            out["speech_lengths"] = np.asarray([30], np.int64)
        return out
    if kind == "vad":
        vd = FUNASR_VAD_DIMS
        out = {"speech": rng.standard_normal((1, 25, 40)).astype(f32)}
        for i in range(vd["layers"]):
            out[f"in_cache_{i}"] = rng.standard_normal(
                (1, vd["proj_dim"], vd["lorder"] - 1, 1)).astype(f32)
        return out
    if kind == "punc":
        return {"input": rng.integers(0, 60, (1, 24)),
                "text_lengths": np.asarray([24])}
    if kind == "punc_online":
        from asr2pass_tpu_torch.models.ct_transformer import vad_mask

        vm = vad_mask(24, 9)[None, None]
        return {"inputs": rng.integers(0, 60, (1, 24)).astype(np.int32),
                "text_lengths": np.asarray([24], np.int32),
                "vad_mask": vm, "sub_masks": vm}
    if kind == "online":
        return {"speech": rng.standard_normal((1, 20, 20)).astype(f32),
                "speech_lengths": np.asarray([20], np.int32)}
    if kind == "online_decoder":
        out = {"enc": rng.standard_normal((1, 20, 32)).astype(f32),
               "enc_len": np.asarray([20], np.int32),
               "acoustic_embeds": rng.standard_normal((1, 3, 32)
                                                      ).astype(f32),
               "acoustic_embeds_len": np.asarray([3], np.int32)}
        for i in range(2):
            out[f"in_cache_{i}"] = rng.standard_normal((1, 32, 10)
                                                       ).astype(f32)
        return out
    raise KeyError(kind)


def _assert_outputs_match(want, got):
    """JAX's outputs against the port's: floats within TOL of the
    range, the rest equal."""
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    assert len(want) == len(got)
    for w, g in zip(want, got):
        w = np.asarray(w)
        g = g.cpu().numpy()
        assert w.shape == g.shape
        if np.issubdtype(w.dtype, np.floating):
            limit = TOL * max(1.0, float(np.abs(w).max()) if w.size else 0)
            assert float(np.abs(w - g).max(initial=0.0)) <= limit
        else:
            np.testing.assert_array_equal(w, g)


def _assert_graphs_equal(jg, tg):
    assert jg.inputs == tg.inputs and jg.outputs == tg.outputs
    assert jg.input_shapes == tg.input_shapes
    assert jg.initializers.keys() == tg.initializers.keys()
    for k, v in jg.initializers.items():
        assert v.dtype == tg.initializers[k].dtype
        np.testing.assert_array_equal(v, tg.initializers[k])
    assert len(jg.nodes) == len(tg.nodes)
    for a, b in zip(jg.nodes, tg.nodes):
        assert (a.op_type, a.inputs, a.outputs, a.name) == (
            b.op_type, b.inputs, b.outputs, b.name)
        assert a.attrs.keys() == b.attrs.keys()
        for k, v in a.attrs.items():
            w = b.attrs[k]
            assert type(v) is type(w)
            if isinstance(v, np.ndarray):
                assert v.dtype == w.dtype
                np.testing.assert_array_equal(v, w)
            else:
                assert v == w


KINDS = ["asr", "asr_ts", "vad", "punc", "punc_online", "online",
         "online_decoder", "sensevoice"]


def _path(src_dirs, kind):
    if kind == "online_decoder":
        return str(src_dirs["online"][0] / "decoder.onnx")
    return str(src_dirs[kind][0] / "model.onnx")


@pytest.mark.parametrize("kind", KINDS)
def test_read_onnx_matches_jax_on_exports(src_dirs, kind):
    path = _path(src_dirs, kind)
    _assert_graphs_equal(jreader.read_onnx(path), treader.read_onnx(path))


@pytest.mark.parametrize("kind", KINDS)
def test_executor_matches_jax_on_exports(src_dirs, kind):
    path = _path(src_dirs, kind)
    jg, tg = jreader.read_onnx(path), treader.read_onnx(path)
    feeds = _graph_inputs(kind, np.random.default_rng(KINDS.index(kind)))
    args = [feeds[n] for n in jg.inputs]
    want = jreader.OnnxExecutor(jg)(*args)
    ex = treader.OnnxExecutor(tg, device="cpu")
    _assert_outputs_match(want, ex(*args))
    # a second call on the same executor gives the same outputs
    _assert_outputs_match(want, ex(*args))


# -- hand-encoded graphs, one per op family ----------------------------------

def _i64(*v):
    return np.asarray(v, np.int64)


def _op_cases():
    """name -> (nodes, {input: array}, {initializer: array}, outputs)."""
    rng = np.random.default_rng(0)
    x4 = rng.standard_normal((1, 2, 7, 9)).astype(np.float32)
    x2 = rng.standard_normal((3, 5)).astype(np.float32)
    n = onnx_node
    return {
        "pools": ([
            n("MaxPool", ["x"], ["mp"], kernel_shape=[3, 2],
              strides=[2, 1], pads=[1, 0, 1, 1]),
            n("AveragePool", ["x"], ["ap"], kernel_shape=[3, 3],
              pads=[1, 1, 1, 1]),
            n("AveragePool", ["x"], ["api"], kernel_shape=[3, 3],
              strides=[2, 2], pads=[1, 1, 1, 1], count_include_pad=1),
            n("GlobalAveragePool", ["x"], ["gp"])],
            {"x": x4}, {}, ["mp", "ap", "api", "gp"]),
        "gemm": ([
            n("Gemm", ["a", "b", "c"], ["y"], transB=1, alpha=0.5,
              beta=2.0),
            n("Gemm", ["at", "b2"], ["y2"], transA=1)],
            {"a": rng.standard_normal((3, 4)).astype(np.float32),
             "at": rng.standard_normal((4, 3)).astype(np.float32)},
            {"b": rng.standard_normal((5, 4)).astype(np.float32),
             "b2": rng.standard_normal((4, 6)).astype(np.float32),
             "c": rng.standard_normal(5).astype(np.float32)},
            ["y", "y2"]),
        "pad": ([
            n("Pad", ["x", "p", "v"], ["c"]),
            n("Pad", ["x", "p"], ["r"], mode="reflect"),
            n("Pad", ["x", "p"], ["e"], mode="edge")],
            {"x": x2}, {"p": _i64(1, 2, 2, 3),
                        "v": np.asarray(0.25, np.float32)}, ["c", "r", "e"]),
        "clip": ([
            n("Clip", ["x", "lo", "hi"], ["y"]),
            n("Clip", ["x"], ["z"], min=-0.5, max=0.75)],
            {"x": x2}, {"lo": np.asarray(-0.3, np.float32),
                        "hi": np.asarray(0.4, np.float32)}, ["y", "z"]),
        "cumsum": ([n("CumSum", ["x", "ax"], ["y"]),
                    n("CumSum", ["x", "ax0"], ["z"])],
                   {"x": x2}, {"ax": _i64(1), "ax0": np.asarray(0, np.int64)},
                   ["y", "z"]),
        "argmax": ([n("ArgMax", ["x"], ["y"], axis=1, keepdims=0),
                    n("ArgMax", ["x"], ["z"], axis=0)],
                   {"x": x2}, {}, ["y", "z"]),
        "split": ([
            n("Split", ["x"], ["a", "b"], axis=1, split=[2, 3]),
            n("Split", ["x", "s"], ["c", "d"], axis=1),
            n("Split", ["y"], ["e", "f"], axis=0)],
            {"x": x2, "y": rng.standard_normal((4, 3)).astype(np.float32)},
            {"s": _i64(4, 1)}, ["a", "b", "c", "d", "e", "f"]),
        "tile": ([n("Tile", ["x", "r"], ["y"])],
                 {"x": rng.standard_normal((2, 1, 3)).astype(np.float32)},
                 {"r": _i64(2, 3, 1)}, ["y"]),
        "reduce_flatten": ([
            n("ReduceMean", ["x"], ["m"], axes=[1, 3]),
            n("ReduceMax", ["x"], ["mx"], axes=[2], keepdims=0),
            n("ReduceMin", ["x", "ax"], ["mn"]),
            n("ReduceProd", ["x", "ax"], ["pr"], keepdims=0),
            n("ReduceSum", ["x"], ["s"], keepdims=0),
            n("Flatten", ["x"], ["fl"], axis=2)],
            {"x": x4}, {"ax": _i64(-1)}, ["m", "mx", "mn", "pr", "s", "fl"]),
        "conv": ([
            n("Conv", ["x", "w", "b"], ["y"], strides=[2, 1],
              dilations=[1, 2], pads=[1, 2, 0, 1], group=2),
            n("ConvTranspose", ["x1", "wt", "bt"], ["z"], strides=[3],
              pads=[1, 2], output_padding=[1])],
            {"x": x4, "x1": rng.standard_normal((1, 4, 6)).astype(
                np.float32)},
            {"w": rng.standard_normal((4, 1, 3, 3)).astype(np.float32),
             "b": rng.standard_normal(4).astype(np.float32),
             "wt": rng.standard_normal((4, 2, 4)).astype(np.float32),
             "bt": rng.standard_normal(2).astype(np.float32)}, ["y", "z"]),
        "elementwise": ([
            n("Sigmoid", ["x"], ["sg"]), n("Erf", ["x"], ["er"]),
            n("Abs", ["x"], ["ab"]), n("Sqrt", ["ab"], ["sq"]),
            n("Log", ["sq"], ["lg"]), n("Pow", ["x", "two"], ["pw"]),
            n("Max", ["x", "sg", "er"], ["mx"]), n("Min", ["x", "er"],
                                                   ["mn"]),
            n("Greater", ["x", "er"], ["gt"]),
            n("Where", ["gt", "x", "sg"], ["wh"]),
            n("Cast", ["gt"], ["ci"], to=7),
            n("Tanh", ["x"], ["th"]), n("Floor", ["x"], ["fo"])],
            {"x": x2}, {"two": np.asarray(2.0, np.float32)},
            ["sg", "er", "lg", "pw", "mx", "mn", "wh", "ci", "th", "fo"]),
        "shapes": ([
            n("Shape", ["x"], ["sh"]),
            n("ConstantOfShape", ["sh"], ["zo"],
              value=np.asarray([1.5], np.float32)),
            n("Range", ["s0", "s5", "s1"], ["rg"]),
            n("Expand", ["col", "e"], ["ex"]),
            n("Gather", ["x", "gi"], ["ga"], axis=1),
            n("Unsqueeze", ["rg", "u"], ["us"]),
            n("Squeeze", ["us", "u"], ["sq"]),
            n("Reshape", ["x", "rs"], ["re"]),
            n("Transpose", ["x"], ["tr"], perm=[1, 0]),
            n("Concat", ["x", "x"], ["cc"], axis=0),
            n("Slice", ["x", "st", "en", "sa", "ss"], ["sl"]),
            n("Greater", ["x", "zero"], ["gt0"]),
            n("NonZero", ["gt0"], ["nz"]),
            n("Softmax", ["x"], ["sm"], axis=0)],
            {"x": x2}, {"s0": np.asarray(0, np.int64),
                        "s5": np.asarray(5, np.int64),
                        "s1": np.asarray(2, np.int64),
                        "col": rng.standard_normal((3, 1)).astype(
                            np.float32),
                        "e": _i64(2, 3, 4), "gi": _i64(-1, 0),
                        "u": _i64(0), "rs": _i64(0, -1, 5),
                        "st": _i64(4, 0), "en": _i64(-(1 << 63), 2),
                        "sa": _i64(1, 0), "ss": _i64(-2, 1),
                        "zero": np.asarray(0.0, np.float32)},
            ["sh", "zo", "rg", "ex", "ga", "sq", "re", "tr", "cc", "sl",
             "nz", "sm"]),
    }


OP_CASES = _op_cases()


@pytest.mark.parametrize("case", sorted(OP_CASES))
def test_executor_matches_jax_per_op_family(tmp_path, case):
    nodes, feeds, inits, outs = OP_CASES[case]
    path = onnx_model(tmp_path / f"{case}.onnx", nodes, list(feeds), outs,
                      inits)
    jg, tg = jreader.read_onnx(path), treader.read_onnx(path)
    _assert_graphs_equal(jg, tg)
    args = list(feeds.values())
    _assert_outputs_match(jreader.OnnxExecutor(jg)(*args),
                          treader.OnnxExecutor(tg, device="cpu")(*args))


def test_conv_auto_pad_follows_the_onnx_definition(tmp_path):
    """auto_pad SAME_UPPER / SAME_LOWER / VALID (which the JAX executor
    does not read), against the ONNX definition in numpy: total padding
    max((ceil(n/s) - 1) * s + k - n, 0), the odd one at the end for
    SAME_UPPER and at the start for SAME_LOWER."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((1, 2, 9)).astype(np.float32)
    w = rng.standard_normal((3, 2, 4)).astype(np.float32)

    def conv_np(x, w, s, lo, hi):
        xp = np.pad(x, ((0, 0), (0, 0), (lo, hi)))
        n_out = (xp.shape[-1] - w.shape[-1]) // s + 1
        return np.stack([np.einsum("bck,ock->bo", xp[..., j * s:
                                                     j * s + w.shape[-1]], w)
                         for j in range(n_out)], axis=-1)

    total = max((-(-9 // 2) - 1) * 2 + 4 - 9, 0)
    for auto, (lo, hi) in (("SAME_UPPER", (total // 2, total - total // 2)),
                           ("SAME_LOWER", (total - total // 2, total // 2)),
                           ("VALID", (0, 0))):
        path = onnx_model(tmp_path / f"{auto}.onnx",
                          [onnx_node("Conv", ["x", "w"], ["y"],
                                     strides=[2], auto_pad=auto)],
                          ["x"], ["y"], {"w": w})
        got = treader.OnnxExecutor(treader.read_onnx(path), "cpu")(x)
        np.testing.assert_allclose(got.numpy(), conv_np(x, w, 2, lo, hi),
                                   rtol=1e-5, atol=1e-5)


def test_integer_div_truncates_as_onnx_defines_it(tmp_path):
    """ONNX Div on integers is integer division (truncated), as exported
    shape arithmetic (T // 2) expects; the JAX executor divides them into
    floats, which give the same shapes once truncated by Reshape or
    Cast (ROADMAP, differences recorded)."""
    path = onnx_model(tmp_path / "div.onnx",
                      [onnx_node("Div", ["a", "b"], ["q"])], ["a"], ["q"],
                      {"b": _i64(2, -3, 4)})
    a = _i64(7, 7, -9)
    got = treader.OnnxExecutor(treader.read_onnx(path), "cpu")(a)
    assert got.dtype == torch.int64
    assert got.tolist() == [3, -2, -2]
    want = np.asarray(jreader.OnnxExecutor(jreader.read_onnx(path))(a))
    assert np.trunc(want).astype(np.int64).tolist() == got.tolist()


def test_an_op_outside_the_set_raises_naming_it(tmp_path):
    path = onnx_model(tmp_path / "foo.onnx",
                      [onnx_node("Relu", ["x"], ["r"]),
                       onnx_node("Foo", ["r"], ["y"], name="odd")],
                      ["x"], ["y"])
    x = np.ones((2, 2), np.float32)
    for reader, kw in ((jreader, {}), (treader, {"device": "cpu"})):
        with pytest.raises(NotImplementedError, match="Foo.*odd"):
            reader.OnnxExecutor(reader.read_onnx(path), **kw)(x)


def test_executor_runs_on_the_card_unless_asked_for_the_cpu(src_dirs):
    g = treader.read_onnx(_path(src_dirs, "punc"))
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default device works")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        treader.OnnxExecutor(g)
    ex = treader.OnnxExecutor(g, device="cpu")
    assert ex.device.type == "cpu"
    assert all(t.device.type == "cpu" for t in ex._consts.values())

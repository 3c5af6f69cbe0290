"""ONNX test helpers that need neither jax nor the JAX package, shared by
the port's tests (through tests/torch_parity.py) and chip_smoke.py:
a protobuf writer (the inverse of tools/onnx_reader's parser), the
FunASR-layout source dirs of tests/test_onnx_verify.py's fixtures, and
graphs with the DNSMOS models' input and output contract.
"""
from __future__ import annotations

import json

import numpy as np
import torch
_ONNX_TYPES = {np.dtype(np.float32): 1, np.dtype(np.uint8): 2,
               np.dtype(np.int8): 3, np.dtype(np.int32): 6,
               np.dtype(np.int64): 7, np.dtype(np.bool_): 9,
               np.dtype(np.float64): 11}


def _varint(v: int) -> bytes:
    v &= (1 << 64) - 1          # int64 fields: two's complement
    out = b""
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out += bytes([b | 0x80])
        else:
            return out + bytes([b])


def _field(fno: int, wt: int, payload: bytes) -> bytes:
    return _varint((fno << 3) | wt) + payload


def _len_field(fno: int, payload: bytes) -> bytes:
    return _field(fno, 2, _varint(len(payload)) + payload)


def onnx_tensor(name: str, arr) -> bytes:
    """A TensorProto with raw_data (float32, int32, int64, bool, ...)."""
    arr = np.asarray(arr)
    msg = b"".join(_field(1, 0, _varint(d)) for d in arr.shape)
    msg += _field(2, 0, _varint(_ONNX_TYPES[arr.dtype]))
    msg += _len_field(8, name.encode())
    return msg + _len_field(9, arr.astype(arr.dtype.newbyteorder("<"))
                            .tobytes())


def onnx_attr(name: str, value) -> bytes:
    """An AttributeProto: int, float, bytes/str, ndarray (a tensor), or a
    list of ints or floats."""
    msg = _len_field(1, name.encode())
    if isinstance(value, np.ndarray):
        return msg + _len_field(5, onnx_tensor("", value))
    if isinstance(value, (bytes, str)):
        return msg + _len_field(4, value.encode() if isinstance(value, str)
                                else value)
    if isinstance(value, float):
        return msg + _field(2, 5, np.float32(value).tobytes())
    if isinstance(value, (int, np.integer)):
        return msg + _field(3, 0, _varint(int(value)))
    if all(isinstance(v, (int, np.integer)) for v in value):
        return msg + _len_field(8, b"".join(_varint(int(v)) for v in value))
    return msg + _len_field(7, np.asarray(value, "<f4").tobytes())


def onnx_node(op: str, inputs, outputs, name: str = "", **attrs) -> bytes:
    msg = b"".join(_len_field(1, i.encode()) for i in inputs)
    msg += b"".join(_len_field(2, o.encode()) for o in outputs)
    if name:
        msg += _len_field(3, name.encode())
    msg += _len_field(4, op.encode())
    return msg + b"".join(_len_field(5, onnx_attr(k, v))
                          for k, v in attrs.items())


def _value_info(name: str, shape=None) -> bytes:
    msg = _len_field(1, name.encode())
    if shape is not None:
        dims = b"".join(_len_field(1, b"" if d is None
                                   else _field(1, 0, _varint(d)))
                        for d in shape)
        msg += _len_field(2, _len_field(1, _len_field(2, dims)))
    return msg


def onnx_model(path, nodes, inputs, outputs, initializers=None) -> str:
    """Write a ModelProto: `nodes` from onnx_node, `inputs` a list of
    names or (name, shape) pairs, `initializers` {name: array}."""
    graph = b"".join(_len_field(1, n) for n in nodes)
    graph += b"".join(_len_field(5, onnx_tensor(k, v))
                      for k, v in (initializers or {}).items())
    for i in inputs:
        name, shape = i if isinstance(i, tuple) else (i, None)
        graph += _len_field(11, _value_info(name, shape))
    graph += b"".join(_len_field(12, _value_info(o)) for o in outputs)
    with open(path, "wb") as f:
        f.write(_len_field(7, graph))
    return str(path)


FUNASR_DIMS = dict(d_in=20, d_model=32, enc_blocks=3, dec_blocks=2,
                   ffn_dim=48, vocab=50)
FUNASR_HEADS = 4
FUNASR_T = 30
FUNASR_VAD_DIMS = dict(input_dim=40, affine_dim=14, linear_dim=25,
                       proj_dim=12, layers=2, lorder=8, output_dim=10)
FUNASR_ASR_YAML = """
frontend_conf:
  fs: 16000
  n_mels: 20
  lfr_m: 1
  lfr_n: 1
encoder_conf:
  output_size: 32
  num_blocks: 3
  attention_heads: 4
  linear_units: 48
  kernel_size: 11
decoder_conf:
  num_blocks: 2
  attention_heads: 4
  linear_units: 48
  kernel_size: 11
  sanm_shfit: 0
predictor_conf:
  threshold: 1.0
  tail_threshold: 0.45
vocab_size: 50
"""
FUNASR_SVS_YAML = ("encoder_conf:\n  output_size: 32\n  num_blocks: 3\n"
                   "  attention_heads: 4\n  linear_units: 48\n"
                   "frontend_conf:\n  n_mels: 20\n  lfr_m: 1\n  lfr_n: 1\n"
                   "vocab_size: 50\n")


def funasr_source_dirs(tmp):
    """FunASR-layout source dirs of tests/test_onnx_verify.py's fixtures,
    each with model.pt, model.onnx (torch's TorchScript exporter through
    tests/torch_funasr_export.py) and its config files: `asr` (2 outputs,
    a hotword bias_encoder in model.pt), `asr_ts` (4 outputs), `vad`,
    `punc`, `punc_online` (VadRealtime), `online` (the encoder/decoder
    pair) and `sensevoice`. Returns {kind: (dir, state dict)}."""
    from funasr_numpy_ref import (make_punc_state_dict, make_state_dict,
                                  make_vad_state_dict)
    from asr2pass_tpu_torch.frontend.audio import write_kaldi_cmvn
    from torch_funasr_export import (TorchCTTransformer,
                                     TorchCTTransformerVadRealtime,
                                     TorchFsmnVad, TorchOnlineDecoder,
                                     TorchOnlineEncoder, TorchParaformer,
                                     TorchSenseVoice, export_onnx,
                                     load_numpy_state_dict)

    d, h, t = FUNASR_DIMS, FUNASR_HEADS, FUNASR_T
    torch.manual_seed(0)
    out = {}

    def new_dir(kind, sd, config, tokens=True):
        src = tmp / kind
        src.mkdir()
        torch.save({k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()},
                   src / "model.pt")
        (src / "config.yaml").write_text(config)
        if tokens:
            (src / "tokens.json").write_text(json.dumps(
                [f"t{i}" for i in range(d["vocab"])]))
        out[kind] = (src, sd)
        return src

    def module(cls, sd, **kw):
        m = load_numpy_state_dict(cls(**kw), sd)
        return m.eval()

    para = dict(d_in=d["d_in"], d_model=d["d_model"],
                enc_blocks=d["enc_blocks"], dec_blocks=d["dec_blocks"],
                heads=h, ffn=d["ffn_dim"], vocab=d["vocab"])
    feats = (torch.randn(1, t, d["d_in"]), torch.tensor([t]))
    for kind, ts in (("asr", False), ("asr_ts", True)):
        sd = make_state_dict(np.random.default_rng(7 if ts else 5),
                             timestamp=ts, hotword=not ts, **d)
        yaml_text = FUNASR_ASR_YAML if not ts else FUNASR_ASR_YAML.replace(
            "predictor_conf:\n", "predictor_conf:\n  use_timestamp: true\n")
        src = new_dir(kind, sd, yaml_text)
        write_kaldi_cmvn(str(src / "am.mvn"),
                         np.full(d["d_in"], -8.0, np.float32),
                         np.full(d["d_in"], 0.25, np.float32))
        (src / "seg_dict").write_text("hello t1 t2\n")
        export_onnx(module(TorchParaformer, sd, timestamp=ts, **para), feats,
                    str(src / "model.onnx"), ["speech", "speech_lengths"],
                    ["logits", "token_num"]
                    + (["us_alphas", "us_cif_peak"] if ts else []))

    vd = FUNASR_VAD_DIMS
    sd = make_vad_state_dict(np.random.default_rng(29), **vd)
    src = new_dir("vad", sd, "model_conf: {}\n", tokens=False)
    caches = [torch.zeros(1, vd["proj_dim"], vd["lorder"] - 1, 1)
              for _ in range(vd["layers"])]
    export_onnx(module(TorchFsmnVad, sd, **vd),
                (torch.randn(1, 25, vd["input_dim"]), *caches),
                str(src / "model.onnx"),
                ["speech"] + [f"in_cache_{i}" for i in range(vd["layers"])],
                ["probs"] + [f"out_cache_{i}" for i in range(vd["layers"])])

    punc = dict(vocab=60, d_model=32, blocks=3, heads=h, ffn=48)
    heads_yaml = "encoder_conf:\n  attention_heads: 4\n"
    sd = make_punc_state_dict(np.random.default_rng(11), vocab=60,
                              d_model=32, blocks=3, ffn_dim=48)
    src = new_dir("punc", sd, heads_yaml)
    export_onnx(module(TorchCTTransformer, sd, **punc),
                (torch.randint(0, 60, (1, 24)), torch.tensor([24])),
                str(src / "model.onnx"), ["input", "text_lengths"],
                ["logits"])
    sd = make_punc_state_dict(np.random.default_rng(13), vocab=60,
                              d_model=32, blocks=3, ffn_dim=48)
    src = new_dir("punc_online", sd, heads_yaml)
    vm = torch.ones(1, 1, 24, 24)
    export_onnx(module(TorchCTTransformerVadRealtime, sd, **punc),
                (torch.randint(0, 60, (1, 24), dtype=torch.int32),
                 torch.tensor([24], dtype=torch.int32), vm, vm.clone()),
                str(src / "model.onnx"),
                ["inputs", "text_lengths", "vad_mask", "sub_masks"],
                ["logits"])

    sd = make_state_dict(np.random.default_rng(17), **d)
    src = new_dir("online", sd, FUNASR_ASR_YAML)
    w = 20                              # the default chunk_size window
    export_onnx(module(TorchOnlineEncoder, sd, d_in=d["d_in"],
                       d_model=d["d_model"], blocks=d["enc_blocks"],
                       heads=h, ffn=d["ffn_dim"], kernel=11),
                (torch.randn(1, w, d["d_in"]),
                 torch.tensor([w], dtype=torch.int32)),
                str(src / "model.onnx"), ["speech", "speech_lengths"],
                ["enc", "enc_len", "alphas"])
    caches = [torch.zeros(1, d["d_model"], 10)
              for _ in range(d["dec_blocks"])]
    export_onnx(module(TorchOnlineDecoder, sd, d_model=d["d_model"],
                       blocks=d["dec_blocks"], heads=h, ffn=d["ffn_dim"],
                       kernel=11, vocab=d["vocab"]),
                (torch.randn(1, w, d["d_model"]),
                 torch.tensor([w], dtype=torch.int32),
                 torch.randn(1, 3, d["d_model"]),
                 torch.tensor([3], dtype=torch.int32), *caches),
                str(src / "decoder.onnx"),
                ["enc", "enc_len", "acoustic_embeds", "acoustic_embeds_len"]
                + [f"in_cache_{i}" for i in range(d["dec_blocks"])],
                ["logits", "sample_ids"]
                + [f"out_cache_{i}" for i in range(d["dec_blocks"])])

    torch.manual_seed(5)
    m = TorchSenseVoice(d_in=20, d_model=32, blocks=3, tp_blocks=2, heads=h,
                        ffn=48, vocab=50, n_embed=16).eval()
    sd = {k: v.numpy() for k, v in m.state_dict().items()}
    src = new_dir("sensevoice", sd, FUNASR_SVS_YAML)
    export_onnx(m, (torch.randn(1, t, 20), torch.tensor([t], dtype=torch.int32),
                    torch.tensor([3]), torch.tensor([14])),
                str(src / "model.onnx"),
                ["speech", "speech_lengths", "language", "textnorm"],
                ["ctc_logits"])
    return out


def dnsmos_graphs(out_dir, seed: int = 0) -> str:
    """model_v8.onnx and sig_bak_ovr.onnx in out_dir, encoded by hand with
    the published DNSMOS models' contract (P.808: [1, 900, 120] log-mel
    frames -> [1, 1]; P.835: [1, 144160] samples -> [1, 3] SIG/BAK/OVRL)
    and seeded weights: a small conv net each, scores near 1-5."""
    rng = np.random.default_rng(seed)

    def w(*shape, s=0.3):
        return (rng.standard_normal(shape) * s).astype(np.float32)

    n = onnx_node
    onnx_model(f"{out_dir}/model_v8.onnx", [
        n("Unsqueeze", ["input_1"], ["x4"], axes=[1]),
        n("Conv", ["x4", "c1", "b1"], ["h1"], pads=[1, 1, 1, 1]),
        n("Relu", ["h1"], ["r1"]),
        n("MaxPool", ["r1"], ["p1"], kernel_shape=[2, 2]),
        n("Conv", ["p1", "c2", "b2"], ["h2"], strides=[2, 2]),
        n("Relu", ["h2"], ["r2"]),
        n("GlobalAveragePool", ["r2"], ["g"]),
        n("Flatten", ["g"], ["f"]),
        n("Gemm", ["f", "d", "db"], ["s"]),
        n("Add", ["s", "three"], ["output"])],
        [("input_1", [1, 900, 120])], ["output"],
        {"c1": w(4, 1, 3, 3), "b1": w(4, s=0.1), "c2": w(8, 4, 3, 3),
         "b2": w(8, s=0.1), "d": w(8, 1), "db": w(1, s=0.1),
         "three": np.asarray(3.0, np.float32)})
    onnx_model(f"{out_dir}/sig_bak_ovr.onnx", [
        n("Reshape", ["input_1", "shape"], ["x3"]),
        n("Conv", ["x3", "c", "b"], ["h"], strides=[160]),
        n("Relu", ["h"], ["r"]),
        n("ReduceMean", ["r"], ["m"], axes=[2], keepdims=0),
        n("Gemm", ["m", "d", "db"], ["z"]),
        n("Sigmoid", ["z"], ["sg"]),
        n("Mul", ["sg", "four"], ["sc"]),
        n("Add", ["sc", "one"], ["Identity:0"])],
        [("input_1", [1, 144160])], ["Identity:0"],
        {"shape": np.asarray([1, 1, 144160], np.int64), "c": w(3, 1, 400,
                                                                s=0.05),
         "b": w(3, s=0.1), "d": w(3, 3), "db": w(3, s=0.1),
         "four": np.asarray(4.0, np.float32),
         "one": np.asarray(1.0, np.float32)})
    return str(out_dir)

"""Dependency-free ONNX model reader + a PyTorch graph executor.

Counterpart of the JAX package's tools/onnx_reader.py. The reference
ships several auxiliary ONNX models (the DNSMOS MOS scorers, and the
exported FunASR model dirs its servers download). This module reads the
ONNX protobuf container with a hand-rolled wire-format parser (no `onnx`
or `onnxruntime`) and provides:

  * read_onnx(path) -> OnnxGraph: initializers {name: np.ndarray}, nodes
    (op_type, inputs, outputs, attrs), graph inputs/outputs and the
    inputs' declared shapes. tools/convert_funasr.py reads model.onnx
    checkpoints with it (torch.onnx export keeps the module-qualified
    parameter names).
  * OnnxExecutor: runs a graph op by op with torch, on `device` (the
    card unless the caller asks for the CPU). It covers the JAX
    executor's op set (the DNSMOS family and what torch.onnx.export
    emits for FunASR-style graphs); any other op raises
    NotImplementedError naming it. It is not a general ONNX runtime.

The executor keeps values in two places. Float initializers are moved to
the device once, when the executor is built; integer initializers,
Constant nodes and Shape outputs stay on the host as CPU tensors, and a
node whose inputs are all on the host runs on the host. So the shape
arithmetic of an exported graph (Shape -> Gather -> Concat -> Reshape,
Range, ConstantOfShape, Expand) never turns a device tensor into a
Python shape, which would wait for the device at every node. A host
value that meets a device value is copied to the device (initializers
once, into a cache).

Wire format: each field = varint key (field_no << 3 | wire_type);
wire types 0=varint 1=fixed64 2=length-delimited 5=fixed32.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from asr2pass_tpu_torch.utils import resolve_device

# --------------------------------------------------------------------------
# protobuf wire-format primitives
# --------------------------------------------------------------------------


def _read_varint(buf: memoryview, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _fields(buf: memoryview):
    """Yield (field_no, wire_type, value) over a message buffer.
    value: int for varint/fixed, memoryview for length-delimited."""
    pos = 0
    n = len(buf)
    while pos < n:
        key, pos = _read_varint(buf, pos)
        fno, wt = key >> 3, key & 7
        if wt == 0:
            val, pos = _read_varint(buf, pos)
        elif wt == 1:
            val = int.from_bytes(buf[pos:pos + 8], "little")
            pos += 8
        elif wt == 2:
            ln, pos = _read_varint(buf, pos)
            val = buf[pos:pos + ln]
            pos += ln
        elif wt == 5:
            val = int.from_bytes(buf[pos:pos + 4], "little")
            pos += 4
        else:  # groups (3/4) don't occur in onnx
            raise ValueError(f"unsupported wire type {wt}")
        yield fno, wt, val


def _packed_varints(val) -> List[int]:
    out = []
    pos = 0
    while pos < len(val):
        v, pos = _read_varint(val, pos)
        out.append(v)
    return out


def _int64(v: int) -> int:
    # onnx int64 fields are plain varints (not zigzag): two's complement
    return v - (1 << 64) if v >= (1 << 63) else v


def _f32(v: int):
    return np.frombuffer(v.to_bytes(4, "little"), "<f4")[0]


# --------------------------------------------------------------------------
# ONNX messages
# --------------------------------------------------------------------------

_DTYPES = {
    1: np.float32, 2: np.uint8, 3: np.int8, 4: np.uint16, 5: np.int16,
    6: np.int32, 7: np.int64, 9: np.bool_, 10: np.float16, 11: np.float64,
    12: np.uint32, 13: np.uint64,
}
_TORCH_DTYPES = {
    1: torch.float32, 2: torch.uint8, 3: torch.int8, 5: torch.int16,
    6: torch.int32, 7: torch.int64, 9: torch.bool, 10: torch.float16,
    11: torch.float64,
    **{k: getattr(torch, n) for k, n in ((4, "uint16"), (12, "uint32"),
                                         (13, "uint64"))
       if hasattr(torch, n)},
}


def _parse_tensor(buf: memoryview) -> Tuple[str, np.ndarray]:
    dims: List[int] = []
    dtype = 1
    name = ""
    raw: Optional[bytes] = None
    float_data: List[float] = []
    int_data: List[int] = []
    for fno, wt, val in _fields(buf):
        if fno == 1:
            if wt == 0:
                dims.append(_int64(val))
            else:
                dims.extend(_int64(v) for v in _packed_varints(val))
        elif fno == 2 and wt == 0:
            dtype = val
        elif fno == 4:  # float_data (packed)
            float_data.extend(np.frombuffer(bytes(val), dtype="<f4").tolist()
                              if wt == 2 else [_f32(val)])
        elif fno in (5, 7):  # int32_data / int64_data (packed varints)
            if wt == 2:
                int_data.extend(_int64(v) for v in _packed_varints(val))
            else:
                int_data.append(_int64(val))
        elif fno == 8 and wt == 2:
            name = bytes(val).decode("utf-8")
        elif fno == 9 and wt == 2:
            raw = bytes(val)
    np_dtype = _DTYPES.get(dtype, np.float32)
    if raw is not None:
        arr = np.frombuffer(raw, dtype=np_dtype)
    elif float_data:
        arr = np.asarray(float_data, dtype=np_dtype)
    elif int_data:
        arr = np.asarray(int_data, dtype=np_dtype)
    else:
        arr = np.zeros(0, dtype=np_dtype)
    if dims:
        arr = arr.reshape(dims)
    elif arr.size == 1:
        # empty dims = rank-0 scalar in the proto; frombuffer yields (1,)
        arr = arr.reshape(())
    return name, arr


def _parse_attribute(buf: memoryview) -> Tuple[str, object]:
    name = ""
    value: object = None
    ints: List[int] = []
    floats: List[float] = []
    strings: List[bytes] = []
    for fno, wt, val in _fields(buf):
        if fno == 1 and wt == 2:
            name = bytes(val).decode("utf-8")
        elif fno == 2 and wt == 5:  # f
            value = _f32(val)
        elif fno == 3 and wt == 0:  # i
            value = _int64(val)
        elif fno == 4 and wt == 2:  # s
            value = bytes(val)
        elif fno == 5 and wt == 2:  # t (tensor)
            value = _parse_tensor(val)[1]
        elif fno == 7:  # floats
            if wt == 2:
                floats.extend(np.frombuffer(bytes(val), "<f4").tolist())
            else:
                floats.append(_f32(val))
        elif fno == 8:  # ints
            if wt == 2:
                ints.extend(_int64(v) for v in _packed_varints(val))
            else:
                ints.append(_int64(val))
        elif fno == 9 and wt == 2:  # strings
            strings.append(bytes(val))
    if ints:
        value = ints
    elif floats:
        value = floats
    elif strings and value is None:
        value = strings
    return name, value


@dataclass
class OnnxNode:
    op_type: str
    inputs: List[str]
    outputs: List[str]
    attrs: Dict[str, object]
    name: str = ""


@dataclass
class OnnxGraph:
    initializers: Dict[str, np.ndarray] = field(default_factory=dict)
    nodes: List[OnnxNode] = field(default_factory=list)
    inputs: List[str] = field(default_factory=list)
    outputs: List[str] = field(default_factory=list)
    input_shapes: Dict[str, List[Optional[int]]] = field(default_factory=dict)


def _parse_value_info(buf: memoryview):
    name = ""
    shape: List[Optional[int]] = []
    for fno, wt, val in _fields(buf):
        if fno == 1 and wt == 2:
            name = bytes(val).decode("utf-8")
        elif fno == 2 and wt == 2:  # TypeProto
            for f2, w2, v2 in _fields(val):
                if f2 == 1 and w2 == 2:  # tensor_type
                    for f3, w3, v3 in _fields(v2):
                        if f3 == 2 and w3 == 2:  # shape
                            for f4, w4, v4 in _fields(v3):
                                if f4 == 1 and w4 == 2:  # dim
                                    dv: Optional[int] = None
                                    for f5, w5, v5 in _fields(v4):
                                        if f5 == 1 and w5 == 0:
                                            dv = _int64(v5)
                                    shape.append(dv)
    return name, shape


def _parse_node(buf: memoryview) -> OnnxNode:
    node = OnnxNode(op_type="", inputs=[], outputs=[], attrs={})
    for fno, wt, val in _fields(buf):
        if fno == 1 and wt == 2:
            node.inputs.append(bytes(val).decode("utf-8"))
        elif fno == 2 and wt == 2:
            node.outputs.append(bytes(val).decode("utf-8"))
        elif fno == 3 and wt == 2:
            node.name = bytes(val).decode("utf-8")
        elif fno == 4 and wt == 2:
            node.op_type = bytes(val).decode("utf-8")
        elif fno == 5 and wt == 2:
            k, v = _parse_attribute(val)
            node.attrs[k] = v
    return node


def _parse_graph(buf: memoryview) -> OnnxGraph:
    g = OnnxGraph()
    for fno, wt, val in _fields(buf):
        if fno == 1 and wt == 2:
            g.nodes.append(_parse_node(val))
        elif fno == 5 and wt == 2:
            name, arr = _parse_tensor(val)
            g.initializers[name] = arr
        elif fno == 11 and wt == 2:
            name, shape = _parse_value_info(val)
            g.inputs.append(name)
            g.input_shapes[name] = shape
        elif fno == 12 and wt == 2:
            name, _ = _parse_value_info(val)
            g.outputs.append(name)
    # graph "inputs" include initializers in older opsets; drop them
    g.inputs = [n for n in g.inputs if n not in g.initializers]
    return g


def read_onnx(path: str) -> OnnxGraph:
    """Parse a .onnx file into an OnnxGraph (initializers as numpy)."""
    with open(path, "rb") as f:
        data = f.read()
    buf = memoryview(data)
    for fno, wt, val in _fields(buf):
        if fno == 7 and wt == 2:  # ModelProto.graph
            return _parse_graph(val)
    raise ValueError(f"{path}: no graph found (not an ONNX model?)")


# --------------------------------------------------------------------------
# the executor
# --------------------------------------------------------------------------

_UNARY = {
    "Sqrt": torch.sqrt, "Log": torch.log, "Relu": torch.relu,
    "Sigmoid": torch.sigmoid, "Sin": torch.sin, "Cos": torch.cos,
    "Tanh": torch.tanh, "Neg": torch.neg, "Exp": torch.exp,
    "Floor": torch.floor, "Ceil": torch.ceil, "Round": torch.round,
    "Reciprocal": torch.reciprocal, "Abs": torch.abs,
    "Not": torch.logical_not,
}
_COMPARE = {
    "Equal": torch.eq, "Greater": torch.gt, "GreaterOrEqual": torch.ge,
    "Less": torch.lt, "LessOrEqual": torch.le, "And": torch.logical_and,
    "Or": torch.logical_or,
}
_REDUCE = {
    "ReduceMax": torch.amax, "ReduceMin": torch.amin,
    "ReduceMean": torch.mean, "ReduceSum": torch.sum,
}
_HOST = torch.device("cpu")


def _ints(t) -> List[int]:
    """A host tensor (or attribute list) of integers as Python ints."""
    if isinstance(t, torch.Tensor):
        return [int(v) for v in t.reshape(-1).tolist()]
    return [int(v) for v in np.asarray(t).reshape(-1).tolist()]


def _scalar(t):
    return t.reshape(()).item() if isinstance(t, torch.Tensor) else t


def _host_tensor(arr) -> torch.Tensor:
    """A numpy array or scalar as a CPU tensor (copied, so that tensors
    never alias the parsed file's read-only buffers)."""
    return torch.from_numpy(np.array(arr))


class OnnxExecutor:
    """Execute an OnnxGraph with torch (nodes are in topological order per
    the ONNX spec). Covers the JAX executor's op set: the DNSMOS family
    plus what torch.onnx.export emits for FunASR-style Paraformer graphs
    (LayerNormalization, Softmax, Gather, Shape, Where, NonZero, LSTM,
    ...). tools/convert_funasr.py --verify runs a source model.onnx
    through it as the conversion oracle. Raises NotImplementedError
    naming any other op.

    device: "cuda" (default; raises without CUDA) or "cpu". Calls take
    numpy arrays or tensors, run under torch.inference_mode and return
    tensors on `device` (a tuple when the graph has several outputs)."""

    def __init__(self, graph: OnnxGraph, device="cuda"):
        self.g = graph
        self.device = resolve_device(device)
        self._consts: Dict[str, torch.Tensor] = {}
        for name, arr in graph.initializers.items():
            t = _host_tensor(arr)
            self._consts[name] = (t.to(self.device) if t.is_floating_point()
                                  else t)
        # Constant nodes are evaluated once, on the host
        self._nodes = []
        for node in graph.nodes:
            if node.op_type == "Constant":
                val = node.attrs.get("value")
                if val is None:  # value_float / value_int forms
                    val = node.attrs.get("value_float",
                                         node.attrs.get("value_int"))
                self._consts[node.outputs[0]] = _host_tensor(np.asarray(val))
            else:
                self._nodes.append(node)
        self._host_ids = {id(t) for t in self._consts.values()
                          if t.device != self.device}
        self._on_device: Dict[int, torch.Tensor] = {}

    # -- placement --------------------------------------------------------

    def _dev(self, t: torch.Tensor) -> torch.Tensor:
        """`t` on the executor's device; an initializer kept on the host
        is copied once and cached."""
        if t.device == self.device:
            return t
        key = id(t)
        if key in self._host_ids:
            cached = self._on_device.get(key)
            if cached is None:
                cached = self._on_device[key] = t.to(self.device)
            return cached
        return t.to(self.device)

    def _same(self, *xs):
        """The inputs on one device: the host if all are there, else the
        executor's device."""
        ts = [x if isinstance(x, torch.Tensor) else _host_tensor(x)
              for x in xs]
        if all(t.device == _HOST for t in ts) or self.device == _HOST:
            return ts
        return [self._dev(t) for t in ts]

    @staticmethod
    def _promote(a, b):
        dt = torch.result_type(a, b)
        return a.to(dt), b.to(dt)

    # -- the run ----------------------------------------------------------

    def __call__(self, *inputs):
        with torch.inference_mode():
            env: Dict[str, object] = dict(self._consts)
            for name, x in zip(self.g.inputs, inputs):
                t = x if isinstance(x, torch.Tensor) else torch.as_tensor(
                    np.asarray(x))
                env[name] = t.to(self.device)
            for node in self._nodes:
                out = self._run(node, env)
                if isinstance(out, tuple):
                    for name, val in zip(node.outputs, out):
                        if name:
                            env[name] = val
                else:
                    env[node.outputs[0]] = out
            outs = tuple(self._dev(env[o]) for o in self.g.outputs)
        return outs if len(outs) > 1 else outs[0]

    def _run(self, node: OnnxNode, env: dict):
        t, i, a = node.op_type, node.inputs, node.attrs

        def get(k):
            n = i[k] if k < len(i) else ""
            return env[n] if n else None

        if t in ("Identity", "Dropout"):
            return get(0)
        if t == "Cast":
            to = _TORCH_DTYPES.get(int(a.get("to", 1)), torch.float32)
            return get(0).to(to)
        if t in ("Add", "Mul", "Sub", "Div", "Pow"):
            x, y = self._same(get(0), get(1))
            if t == "Pow":
                return torch.pow(x, y)
            x, y = self._promote(x, y)
            if t == "Div":
                if x.is_floating_point():
                    return torch.div(x, y)
                return torch.div(x, y, rounding_mode="trunc")
            return {"Add": torch.add, "Mul": torch.mul,
                    "Sub": torch.sub}[t](x, y)
        if t in ("Max", "Min"):
            xs = self._same(*[env[n] for n in i])
            fn = torch.maximum if t == "Max" else torch.minimum
            out = xs[0]
            for other in xs[1:]:
                out = fn(*self._promote(out, other))
            return out
        if t in _UNARY:
            return _UNARY[t](get(0))
        if t == "Erf":
            return torch.erf(get(0).to(torch.float32))
        if t in _COMPARE:
            x, y = self._same(get(0), get(1))
            if t in ("And", "Or"):
                return _COMPARE[t](x, y)
            return _COMPARE[t](*self._promote(x, y))
        if t == "Where":
            c, x, y = self._same(get(0), get(1), get(2))
            return torch.where(c.bool(), *self._promote(x, y))
        if t == "MatMul":
            x, y = self._same(get(0), get(1))
            return torch.matmul(x, y)
        if t == "Gemm":
            x, w = self._same(get(0), get(1))
            if a.get("transA"):
                x = x.T
            if a.get("transB"):
                w = w.T
            out = torch.matmul(x, w) * float(a.get("alpha", 1.0))
            if len(i) > 2 and i[2]:
                out, c = self._same(out, get(2))
                out = out + c * float(a.get("beta", 1.0))
            return out
        if t == "Transpose":
            x = get(0)
            perm = a.get("perm") or list(range(x.dim()))[::-1]
            return x.permute(*[int(p) for p in perm])
        if t == "Unsqueeze":
            axes = a.get("axes") or _ints(get(1))
            x = get(0)
            rank = x.dim() + len(axes)
            for ax in sorted(ax % rank for ax in axes):
                x = x.unsqueeze(ax)
            return x
        if t == "Squeeze":
            axes = a.get("axes") or (_ints(get(1)) if len(i) > 1 and i[1]
                                     else None)
            x = get(0)
            if not axes:
                return x.squeeze()
            return x.squeeze(tuple(ax % x.dim() for ax in axes))
        if t == "Reshape":
            x = get(0)
            shape = _ints(get(1))
            if not a.get("allowzero"):
                # ONNX: a 0 entry copies the corresponding input dim
                shape = [x.shape[k] if d == 0 else d
                         for k, d in enumerate(shape)]
            return x.reshape(shape)
        if t == "Flatten":
            x = get(0)
            ax = int(a.get("axis", 1)) % max(x.dim(), 1)
            return x.reshape(int(np.prod(x.shape[:ax])), -1)
        if t == "Concat":
            xs = self._same(*[env[n] for n in i])
            dt = xs[0].dtype
            for x in xs[1:]:
                dt = torch.promote_types(dt, x.dtype)
            return torch.cat([x.to(dt) for x in xs],
                             dim=int(a.get("axis", 0)))
        if t == "Slice":
            return self._slice(get(0), node, env)
        if t in _REDUCE or t == "ReduceProd":
            return self._reduce(t, get(0), node, env)
        if t == "GlobalAveragePool":
            x = get(0)
            return x.mean(dim=tuple(range(2, x.dim())), keepdim=True)
        if t == "Conv":
            x, w = self._same(get(0), get(1))
            b = self._same(get(2))[0] if len(i) > 2 and i[2] else None
            return self._conv(x, w, b, a)
        if t == "ConvTranspose":
            x, w = self._same(get(0), get(1))
            b = self._same(get(2))[0] if len(i) > 2 and i[2] else None
            return self._conv_transpose(x, w, b, a)
        if t in ("MaxPool", "AveragePool"):
            return self._pool(get(0), a, reducer="max" if t == "MaxPool"
                              else "mean")
        if t == "Shape":
            return torch.tensor(list(get(0).shape), dtype=torch.int64)
        if t == "ConstantOfShape":
            shape = _ints(get(0))
            fill = a.get("value")
            if fill is None:
                return torch.zeros(shape, dtype=torch.float32)
            fill = np.asarray(fill)
            return torch.full(shape, fill.reshape(()).item(),
                              dtype=_host_tensor(fill).dtype)
        if t == "Expand":
            x = get(0)
            shape = torch.broadcast_shapes(tuple(_ints(get(1))),
                                           tuple(x.shape))
            return x.expand(shape)
        if t == "Range":
            s, e, d = (get(k) for k in range(3))
            return torch.arange(_scalar(s), _scalar(e), _scalar(d),
                                dtype=s.dtype, device=s.device)
        if t == "Tile":
            return get(0).repeat(*_ints(get(1)))
        if t == "Gather":
            x, idx = self._same(get(0), get(1))
            ax = int(a.get("axis", 0)) % x.dim()
            idx = idx.long()
            idx = torch.where(idx < 0, idx + x.shape[ax], idx)
            out = x.index_select(ax, idx.reshape(-1))
            return out.reshape(x.shape[:ax] + idx.shape + x.shape[ax + 1:])
        if t == "NonZero":
            return torch.nonzero(get(0)).T.contiguous()
        if t == "Clip":
            x = get(0)
            lo = get(1) if len(i) > 1 and i[1] else a.get("min")
            hi = get(2) if len(i) > 2 and i[2] else a.get("max")
            if lo is not None:
                x = torch.maximum(*self._promote(*self._same(x, lo)))
            if hi is not None:
                x = torch.minimum(*self._promote(*self._same(x, hi)))
            return x
        if t == "ArgMax":
            return torch.argmax(get(0), dim=int(a.get("axis", 0)),
                                keepdim=bool(a.get("keepdims", 1)))
        if t == "CumSum":
            return torch.cumsum(get(0), dim=int(_scalar(get(1))))
        if t == "Pad":
            return self._pad(get(0), node, env)
        if t == "Split":
            x = get(0)
            ax = int(a.get("axis", 0))
            sizes = a.get("split")
            if sizes is None and len(i) > 1 and i[1]:
                sizes = _ints(get(1))
            if sizes is None:
                n_out = int(a.get("num_outputs", len(node.outputs)))
                return tuple(torch.tensor_split(x, n_out, dim=ax))
            return tuple(torch.split(x, [int(s) for s in sizes], dim=ax))
        if t == "LayerNormalization":
            x, g = self._same(get(0), get(1))
            ax = int(a.get("axis", -1)) % x.dim()
            dims = tuple(range(ax, x.dim()))
            eps = float(a.get("epsilon", 1e-5))
            mu = x.mean(dim=dims, keepdim=True)
            var = ((x - mu) ** 2).mean(dim=dims, keepdim=True)
            out = (x - mu) / torch.sqrt(var + eps) * g
            if len(i) > 2 and i[2]:
                out, b = self._same(out, get(2))
                out = out + b
            return out
        if t == "Softmax":
            return torch.softmax(get(0), dim=int(a.get("axis", -1)))
        if t == "LSTM":
            # X, W, R, B, initial_h, initial_c (sequence_lens unused)
            args = [get(k) if len(i) > k and i[k] else None
                    for k in (0, 1, 2, 3, 5, 6)]
            given = iter(self._same(*[v for v in args if v is not None]))
            return self._lstm(*[None if v is None else next(given)
                                for v in args], a)
        raise NotImplementedError(f"ONNX op {t} (node {node.name!r})")

    # -- ops with more to them -------------------------------------------

    @staticmethod
    def _slice(x, node: OnnxNode, env: dict):
        i, a = node.inputs, node.attrs
        if len(i) > 1:  # opset >= 10: tensors
            starts = _ints(env[i[1]])
            ends = _ints(env[i[2]])
            axes = (_ints(env[i[3]]) if len(i) > 3 and i[3]
                    else list(range(len(starts))))
            steps = (_ints(env[i[4]]) if len(i) > 4 and i[4]
                     else [1] * len(starts))
        else:  # opset 1: attributes
            starts, ends = a["starts"], a["ends"]
            axes = a.get("axes", list(range(len(starts))))
            steps = [1] * len(starts)
        for s, e, ax, st in zip(starts, ends, axes, steps):
            ax = int(ax) % x.dim()
            n = x.shape[ax]
            e = None if e >= (1 << 62) else e
            lo, hi, step = slice(int(s), e, int(st)).indices(n)
            if step == 1:
                x = x.narrow(ax, lo, max(hi - lo, 0))
            else:
                idx = torch.arange(lo, hi, step, device=x.device)
                x = x.index_select(ax, idx)
        return x

    @staticmethod
    def _reduce(t: str, x, node: OnnxNode, env: dict):
        i, a = node.inputs, node.attrs
        axes = a.get("axes")
        if axes is None and len(i) > 1 and i[1]:
            axes = _ints(env[i[1]])     # opset >= 13 (18 for some)
        keep = bool(a.get("keepdims", 1))
        dims = (tuple(int(d) % x.dim() for d in axes) if axes
                else tuple(range(x.dim())))
        if t == "ReduceProd":
            for d in sorted(dims, reverse=True):
                x = torch.prod(x, dim=d, keepdim=keep)
            return x
        if not dims:
            return x
        return _REDUCE[t](x, dim=dims, keepdim=keep)

    @staticmethod
    def _edge_index(n: int, before: int, after: int, mode: str, device):
        """Source indices of an axis padded in 'edge' or 'reflect' mode."""
        idx = torch.arange(-before, n + after, device=device)
        if mode == "edge":
            return idx.clamp(0, n - 1)
        period = 2 * (n - 1)
        idx = idx.remainder(period) if period else idx * 0
        return torch.where(idx >= n, period - idx, idx)

    def _pad(self, x, node: OnnxNode, env: dict):
        i, a = node.inputs, node.attrs
        pads = (_ints(env[i[1]]) if len(i) > 1 and i[1]
                else [int(p) for p in a.get("pads")])
        half = len(pads) // 2
        cfg = list(zip(pads[:half], pads[half:]))
        mode = a.get("mode") or b"constant"
        mode = mode.decode() if isinstance(mode, bytes) else mode
        if mode == "constant":
            cval = 0.0
            if len(i) > 2 and i[2]:
                cval = _scalar(env[i[2]])
            flat = [p for lo, hi in reversed(cfg) for p in (lo, hi)]
            return F.pad(x, flat, value=cval)
        if mode not in ("reflect", "edge"):
            raise NotImplementedError(f"ONNX Pad mode {mode!r}")
        for ax, (lo, hi) in enumerate(cfg):
            if lo or hi:
                x = x.index_select(ax, self._edge_index(
                    x.shape[ax], lo, hi, mode, x.device))
        return x

    @staticmethod
    def _auto_pads(a: dict, in_sizes, k_eff, strides):
        """Per spatial axis (begin, end) from `pads` or `auto_pad`."""
        spatial = len(in_sizes)
        auto = a.get("auto_pad") or b"NOTSET"
        auto = auto.decode() if isinstance(auto, bytes) else auto
        if auto in ("NOTSET", ""):
            pads = [int(p) for p in a.get("pads", [0] * (2 * spatial))]
            return [(pads[d], pads[d + spatial]) for d in range(spatial)]
        if auto == "VALID":
            return [(0, 0)] * spatial
        out = []
        for n, k, s in zip(in_sizes, k_eff, strides):
            total = max((-(-n // s) - 1) * s + k - n, 0)
            small = total // 2
            out.append((small, total - small) if auto == "SAME_UPPER"
                       else (total - small, small))
        return out

    def _conv(self, x, w, b, a):
        """N-d Conv: explicit pads (asymmetric allowed, or from auto_pad),
        strides, dilations, groups; weight [out, in/groups, *k]."""
        spatial = w.dim() - 2
        strides = [int(s) for s in a.get("strides", [1] * spatial)]
        dil = [int(d) for d in a.get("dilations", [1] * spatial)]
        k_eff = [(k - 1) * d + 1 for k, d in zip(w.shape[2:], dil)]
        pads = self._auto_pads(a, x.shape[2:], k_eff, strides)
        x = F.pad(x, [p for lo, hi in reversed(pads) for p in (lo, hi)])
        conv = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}[spatial]
        return conv(x, w, b, stride=strides, dilation=dil,
                    groups=int(a.get("group", 1)))

    @staticmethod
    def _conv_transpose(x, w, b, a):
        """N-d ConvTranspose (ONNX weight [in, out/groups, *k]): the full
        transposed convolution, then `pads` cropped from each side and
        `output_padding` added at the end (zeros there, plus the bias)."""
        spatial = w.dim() - 2
        strides = [int(s) for s in a.get("strides", [1] * spatial)]
        dil = [int(d) for d in a.get("dilations", [1] * spatial)]
        opad = [int(v) for v in a.get("output_padding", [0] * spatial)]
        auto = a.get("auto_pad") or b"NOTSET"
        auto = auto.decode() if isinstance(auto, bytes) else auto
        k_eff = [(k - 1) * d + 1 for k, d in zip(w.shape[2:], dil)]
        if auto in ("NOTSET", ""):
            pads = [int(p) for p in a.get("pads", [0] * (2 * spatial))]
            pads = [(pads[d], pads[d + spatial]) for d in range(spatial)]
        elif auto == "VALID":
            pads = [(0, 0)] * spatial
        else:   # SAME_*: the output is input * stride
            pads = []
            for n, k, s, op in zip(x.shape[2:], k_eff, strides, opad):
                total = s * (n - 1) + op + k - n * s
                small = total // 2
                pads.append((small, total - small) if auto == "SAME_UPPER"
                            else (total - small, small))
        conv = {1: F.conv_transpose1d, 2: F.conv_transpose2d,
                3: F.conv_transpose3d}[spatial]
        out = conv(x, w, None, stride=strides, dilation=dil,
                   groups=int(a.get("group", 1)))
        # output_padding extends the end; then crop pads (negative F.pad)
        flat = []
        for (lo, hi), op in zip(reversed(pads), reversed(opad)):
            flat += [-lo, op - hi]
        out = F.pad(out, flat)
        if b is not None:
            out = out + b.reshape((1, -1) + (1,) * spatial)
        return out

    @staticmethod
    def _lstm(X, W, R, B, h0, c0, a):
        """ONNX LSTM (gate order i,o,f,c): X [T, N, I], W [D, 4H, I],
        R [D, 4H, H], B [D, 8H]. Returns (Y [T, D, N, H], Y_h, Y_c)."""
        hidden = int(a.get("hidden_size", R.shape[-1]))
        direction = a.get("direction") or b"forward"
        direction = (direction.decode()
                     if isinstance(direction, bytes) else direction)
        n = X.shape[1]
        outs, hs, cs = [], [], []
        for d in range(W.shape[0]):
            rev = direction == "reverse" or d == 1
            x_seq = X.flip(0) if rev else X
            bias = (B[d, :4 * hidden] + B[d, 4 * hidden:] if B is not None
                    else torch.zeros(4 * hidden, dtype=X.dtype,
                                     device=X.device))
            # the input products of every step at once; per step only
            # the recurrent one
            gx = torch.matmul(x_seq, W[d].T) + bias        # [T, N, 4H]
            r_t = R[d].T
            h = (h0[d] if h0 is not None
                 else torch.zeros(n, hidden, dtype=X.dtype, device=X.device))
            c = (c0[d] if c0 is not None
                 else torch.zeros(n, hidden, dtype=X.dtype, device=X.device))
            ys = []
            for step in range(x_seq.shape[0]):
                gi, go, gf, gc = (gx[step] + h @ r_t).split(hidden, dim=-1)
                c = torch.sigmoid(gf) * c + torch.sigmoid(gi) * torch.tanh(gc)
                h = torch.sigmoid(go) * torch.tanh(c)
                ys.append(h)
            y = torch.stack(ys)
            outs.append(y.flip(0) if rev else y)
            hs.append(h)
            cs.append(c)
        return torch.stack(outs, dim=1), torch.stack(hs), torch.stack(cs)

    @staticmethod
    def _pool(x, a, reducer="max"):
        """Max or average pooling with explicit pads; padding is -inf for
        max, and average pooling leaves it out of the divisor unless
        count_include_pad (the ONNX default)."""
        ks = [int(k) for k in a["kernel_shape"]]
        spatial = len(ks)
        strides = [int(s) for s in a.get("strides", ks)]
        pads = [int(p) for p in a.get("pads", [0] * (2 * spatial))]
        flat = []
        for d in reversed(range(spatial)):
            flat += [pads[d], pads[d + spatial]]
        if reducer == "max":
            pool = {1: F.max_pool1d, 2: F.max_pool2d, 3: F.max_pool3d}
            return pool[spatial](F.pad(x, flat, value=-float("inf")), ks,
                                 strides)
        pool = {1: F.avg_pool1d, 2: F.avg_pool2d, 3: F.avg_pool3d}[spatial]
        out = pool(F.pad(x, flat), ks, strides)
        if any(pads) and not a.get("count_include_pad", 0):
            counts = pool(F.pad(torch.ones_like(x), flat), ks, strides)
            out = out / counts
        return out

"""Minimal ONNX (protobuf) writer for U^2-Net-family checkpoints.

Counterpart of image_segmenter_tpu/models/onnx_writer.py, with its own
copy of the writer. It turns a torch state dict (rembg's names) into a
file shaped as torch.onnx.export shapes one: state-dict-named
initializers plus Conv/BatchNormalization/Relu nodes in forward-execution
order. No rembg checkpoint can be fetched where the port is tested, so
the tests and chip_smoke.py write their own from seeded weights and load
them back through models/onnx_import.py.

Only the protobuf fields the ONNX spec assigns to ModelProto(7=graph,
8=opset), GraphProto(1=node, 2=name, 5=initializer), NodeProto(1=input,
2=output, 3=name, 4=op_type), TensorProto(1=dims, 2=data_type, 8=name,
9=raw_data) are written: enough for onnxruntime to parse the weights and
the topology.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from image_segmenter_tpu_torch.models import onnx_import as OIMP

_F32, _I64 = 1, 7  # TensorProto.DataType


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b7 = n & 0x7F
        n >>= 7
        out.append(b7 | (0x80 if n else 0))
        if not n:
            return bytes(out)


def _field(num: int, wire: int, payload: bytes) -> bytes:
    return _varint((num << 3) | wire) + payload


def _len_field(num: int, payload: bytes) -> bytes:
    return _field(num, 2, _varint(len(payload)) + payload)


def _tensor_proto(name: str, arr: np.ndarray) -> bytes:
    arr = np.asarray(arr)
    dtype = _I64 if arr.dtype == np.int64 else _F32
    data = arr.astype(np.int64 if dtype == _I64 else np.float32).tobytes()
    msg = b"".join(_field(1, 0, _varint(d)) for d in arr.shape)
    msg += _field(2, 0, _varint(dtype))
    msg += _len_field(8, name.encode())
    msg += _len_field(9, data)
    return msg


def _node_proto(op: str, inputs: Sequence[str], outputs: Sequence[str],
                name: str = "") -> bytes:
    msg = b"".join(_len_field(1, s.encode()) for s in inputs)
    msg += b"".join(_len_field(2, s.encode()) for s in outputs)
    if name:
        msg += _len_field(3, name.encode())
    msg += _len_field(4, op.encode())
    return msg


def write_onnx(path: str, initializers: Dict[str, np.ndarray],
               nodes: List[Tuple[str, Sequence[str], Sequence[str]]],
               graph_name: str = "u2net") -> None:
    graph = b"".join(_len_field(1, _node_proto(op, ins, outs))
                     for op, ins, outs in nodes)
    graph += _len_field(2, graph_name.encode())
    graph += b"".join(_len_field(5, _tensor_proto(n, a))
                      for n, a in initializers.items())
    opset = _field(2, 0, _varint(11))  # OperatorSetIdProto.version
    model = _field(1, 0, _varint(7))   # ir_version
    model += _len_field(7, graph)
    model += _len_field(8, opset)
    with open(path, "wb") as f:
        f.write(model)


def graph_from_torch_state(state: Dict[str, np.ndarray],
                           positional: bool = False):
    """Build (initializers, nodes) in torch.onnx.export layout.

    With positional=True the initializer names are rewritten to the
    dot-free "onnx::Conv_<n>" style some optimizer passes produce, which
    forces the importer down its graph-order fallback. A state without a
    BatchNorm's leaves is written as a BN-folded export (Conv -> Relu).
    """
    order = OIMP.call_order(state)
    inits: Dict[str, np.ndarray] = {}
    nodes: List[Tuple[str, List[str], List[str]]] = []
    counter = [0]

    def reg(torch_name: str, op_hint: str) -> str:
        name = (f"onnx::{op_hint}_{counter[0]}" if positional else torch_name)
        counter[0] += 1
        inits[name] = state[torch_name]
        return name

    cur = "input.1"
    t = [0]

    def fresh() -> str:
        t[0] += 1
        return f"/t_{t[0]}"

    i = 0
    while i < len(order):
        kind, prefix = order[i]
        assert kind == "conv", (kind, prefix)
        conv_ins = [cur]
        for leaf in ("weight", "bias"):  # absent on truncated checkpoints
            if f"{prefix}.{leaf}" in state:
                conv_ins.append(reg(f"{prefix}.{leaf}", "Conv"))
        cur = fresh()
        nodes.append(("Conv", conv_ins, [cur]))
        follows_bn = i + 1 < len(order) and order[i + 1][0] == "bn"
        bnp = order[i + 1][1] if follows_bn else ""
        if follows_bn and bnp + ".weight" not in state:
            # BN folded into the conv at export: Conv -> Relu, no BN node.
            out = fresh()
            nodes.append(("Relu", [cur], [out]))
            cur = out
            i += 2
        elif follows_bn:
            bn_ins = [cur] + [reg(f"{bnp}.{leaf}", "BatchNormalization")
                              for leaf in OIMP._BN_LEAVES]
            cur = fresh()
            nodes.append(("BatchNormalization", bn_ins, [cur]))
            out = fresh()
            nodes.append(("Relu", [cur], [out]))
            cur = out
            i += 2
        else:
            i += 1
    out = fresh()
    nodes.append(("Sigmoid", [cur], [out]))
    return inits, nodes


def export_torch_state(path: str, state: Dict[str, np.ndarray],
                       positional: bool = False) -> None:
    """Write a torch-layout U^2-Net state dict (numpy arrays or tensors;
    `num_batches_tracked` is dropped) as a rembg-shaped .onnx."""
    arrays = {k: np.asarray(v.detach().cpu() if hasattr(v, "detach") else v,
                            np.float32)
              for k, v in state.items() if not k.endswith("num_batches_tracked")}
    inits, nodes = graph_from_torch_state(arrays, positional=positional)
    write_onnx(path, inits, nodes)

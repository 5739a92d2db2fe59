"""Dependency-free ONNX checkpoint reader and U^2-Net weight mapping.

Counterpart of image_segmenter_tpu/models/onnx_import.py, with its own
copy of the numpy protobuf reader (the port imports nothing of the JAX
package). rembg distributes its models as ONNX files
(~/.u2net/<model>.onnx); this module reads them without onnx or
onnxruntime: ONNX is protobuf, and the initializer tensors and the node
topology need only a varint-level reader for ModelProto, GraphProto,
NodeProto and TensorProto.

Torch-exported U^2-Net checkpoints keep module-path initializer names
("stage1.rebnconv1.conv_s1.weight"), which are the port's state-dict
names as they are: the port keeps PyTorch's layouts (OIHW kernels), so
nothing is transposed. A graph-order fallback pairs Conv and
BatchNormalization nodes with the modules by execution position when an
export stripped the names.
"""

from __future__ import annotations

import re
import struct
from typing import Dict, Iterable, List, Tuple

import numpy as np
import torch

# wire types
_VARINT, _I64, _LEN, _I32 = 0, 1, 2, 5

_DTYPES = {1: np.float32, 2: np.uint8, 3: np.int8, 6: np.int32, 7: np.int64,
           10: np.float16, 11: np.float64}

_CONV_LEAVES = ("weight", "bias")
_BN_LEAVES = ("weight", "bias", "running_mean", "running_var")


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


def _iter_fields(buf: memoryview):
    pos = 0
    n = len(buf)
    while pos < n:
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if wire == _VARINT:
            val, pos = _read_varint(buf, pos)
        elif wire == _I64:
            val = bytes(buf[pos:pos + 8])
            pos += 8
        elif wire == _LEN:
            ln, pos = _read_varint(buf, pos)
            val = buf[pos:pos + ln]
            pos += ln
        elif wire == _I32:
            val = bytes(buf[pos:pos + 4])
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wire}")
        yield field, wire, val


def _parse_tensor(buf: memoryview):
    dims: List[int] = []
    dtype = 1
    name = ""
    raw = None
    floats: List[float] = []
    int64s: List[int] = []
    for field, wire, val in _iter_fields(buf):
        if field == 1:  # dims (packed or repeated varint)
            if wire == _VARINT:
                dims.append(val)
            else:
                p = 0
                while p < len(val):
                    v, p = _read_varint(val, p)
                    dims.append(v)
        elif field == 2 and wire == _VARINT:
            dtype = val
        elif field == 4:  # float_data
            if wire == _I32:
                floats.append(struct.unpack("<f", val)[0])
            else:
                floats.extend(np.frombuffer(bytes(val), np.float32).tolist())
        elif field == 7:  # int64_data
            if wire == _VARINT:
                int64s.append(val)
            else:
                p = 0
                while p < len(val):
                    v, p = _read_varint(val, p)
                    int64s.append(v)
        elif field == 8:
            name = bytes(val).decode("utf-8", "replace")
        elif field == 9:
            raw = bytes(val)
    np_dtype = _DTYPES.get(dtype, np.float32)
    if raw is not None:
        arr = np.frombuffer(raw, np_dtype)
    elif floats:
        arr = np.asarray(floats, np.float32)
    elif int64s:
        arr = np.asarray(int64s, np.int64)
    else:
        arr = np.zeros(0, np_dtype)
    if dims:
        arr = arr.reshape(dims)
    return name, arr.astype(np_dtype, copy=False)


def _parse_node(buf: memoryview):
    inputs, outputs, op = [], [], ""
    for field, wire, val in _iter_fields(buf):
        if field == 1:
            inputs.append(bytes(val).decode("utf-8", "replace"))
        elif field == 2:
            outputs.append(bytes(val).decode("utf-8", "replace"))
        elif field == 4:
            op = bytes(val).decode("utf-8", "replace")
    return op, inputs, outputs


def read_onnx(path: str):
    """Parse an ONNX file -> (initializers dict name->array, nodes list)."""
    with open(path, "rb") as f:
        data = memoryview(f.read())
    graph = None
    for field, wire, val in _iter_fields(data):
        if field == 7 and wire == _LEN:  # ModelProto.graph
            graph = val
            break
    if graph is None:
        raise ValueError(f"{path}: no graph found (not an ONNX model?)")
    inits: Dict[str, np.ndarray] = {}
    nodes = []
    for field, wire, val in _iter_fields(graph):
        if field == 5 and wire == _LEN:  # initializer
            name, arr = _parse_tensor(val)
            inits[name] = arr
        elif field == 1 and wire == _LEN:  # node
            nodes.append(_parse_node(val))
    return inits, nodes


# ---------------------------------------------------------------------------
# mapping torch-named initializers onto the port's state dict
# ---------------------------------------------------------------------------

def _tree(names: Iterable[str]) -> dict:
    """Nested dict of the module paths in state-dict names."""
    tree: dict = {}
    for name in names:
        node = tree
        for part in name.split(".")[:-1]:
            node = node.setdefault(part, {})
    return tree


def _rsu_block_order(sub: dict) -> List[str]:
    """Execution order of the REBNCONV submodules of one RSU / RSU4F block:
    rebnconvin, rebnconv1..rebnconvN ascending (encoder and dilated
    bottom), then rebnconv(N-1)d..rebnconv1d descending (decoder)."""
    enc = sorted(int(m.group(1)) for k in sub
                 if (m := re.fullmatch(r"rebnconv(\d+)", k)))
    dec = sorted((int(m.group(1)) for k in sub
                  if (m := re.fullmatch(r"rebnconv(\d+)d", k))), reverse=True)
    order = []
    if "rebnconvin" in sub:
        order.append("rebnconvin")
    order += [f"rebnconv{i}" for i in enc]
    order += [f"rebnconv{i}d" for i in dec]
    return order


def call_order(names: Iterable[str]) -> List[Tuple[str, str]]:
    """Forward-execution order of the conv and BatchNorm modules of a
    U2NET/ISNet state dict, from its names.

    Returns [("conv"|"bn", module path), ...] in the order the torch
    models (and torch.onnx.export's graph) run them: conv_in (ISNet),
    encoder stages ascending, decoder stages descending, side heads,
    outconv. Pairs graph-order Conv/BatchNormalization nodes with modules
    when an export stripped the initializer names.
    """
    tree = _tree(names)
    order: List[Tuple[str, str]] = []
    if "conv_in" in tree:
        order.append(("conv", "conv_in"))
    enc = sorted(int(m.group(1)) for k in tree
                 if (m := re.fullmatch(r"stage(\d+)", k)))
    dec = sorted((int(m.group(1)) for k in tree
                  if (m := re.fullmatch(r"stage(\d+)d", k))), reverse=True)
    for st in [f"stage{i}" for i in enc] + [f"stage{i}d" for i in dec]:
        for blk in _rsu_block_order(tree[st]):
            order.append(("conv", f"{st}.{blk}.conv_s1"))
            order.append(("bn", f"{st}.{blk}.bn_s1"))
    sides = sorted((k for k in tree if re.fullmatch(r"side\d+", k)),
                   key=lambda k: int(k[4:]))
    order += [("conv", s) for s in sides]
    if "outconv" in tree:
        order.append(("conv", "outconv"))
    return order


def _is_conv(module: str) -> bool:
    last = module.split(".")[-1]
    return last in ("conv_s1", "outconv", "conv_in") or last.startswith("side")


def map_u2net_weights(inits: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """The module-named initializers of a torch-exported U2NET/ISNet, under
    their state-dict names. Raises ValueError when there are none (a
    positional export)."""
    out: Dict[str, np.ndarray] = {}
    for name, arr in inits.items():
        module, _, leaf = name.rpartition(".")
        if not module:
            continue
        if _is_conv(module) and leaf in _CONV_LEAVES:
            out[name] = arr
        elif module.split(".")[-1] == "bn_s1" and leaf in _BN_LEAVES:
            out[name] = arr
    if not out:
        raise ValueError("no module-named initializers found (positional export?)")
    return out


def map_positional(inits: Dict[str, np.ndarray], nodes,
                   names: Iterable[str]) -> Dict[str, np.ndarray]:
    """Graph-order fallback: pair Conv/BatchNormalization node weights with
    the modules of a state dict (`names`) by execution position, when the
    initializer names were stripped (e.g. "onnx::Conv_123" exports).

    torch.onnx.export emits nodes in forward execution order, which is the
    order `call_order` reproduces from the target's names.
    """
    conv_srcs: List[Tuple[np.ndarray, ...]] = []  # (weight, bias|None)
    bn_srcs: List[Tuple[np.ndarray, ...]] = []    # (scale, bias, mean, var)
    for op, ins, _outs in nodes:
        weights = [inits[n] for n in ins if n in inits]
        if op == "Conv" and weights:
            conv_srcs.append((weights[0],
                              weights[1] if len(weights) > 1 else None))
        elif op == "BatchNormalization" and len(weights) >= 4:
            bn_srcs.append(tuple(weights[:4]))

    order = call_order(names)
    conv_paths = [p for kind, p in order if kind == "conv"]
    bn_paths = [p for kind, p in order if kind == "bn"]
    if len(conv_srcs) != len(conv_paths):
        raise ValueError(
            f"positional map: graph has {len(conv_srcs)} Conv nodes with "
            f"initializer weights, model expects {len(conv_paths)}")
    if bn_srcs and len(bn_srcs) != len(bn_paths):
        raise ValueError(
            f"positional map: graph has {len(bn_srcs)} BatchNormalization "
            f"nodes, model expects {len(bn_paths)}")

    out: Dict[str, np.ndarray] = {}
    for path, (w, b) in zip(conv_paths, conv_srcs):
        out[path + ".weight"] = w
        if b is not None:
            out[path + ".bias"] = b
    for path, arrs in zip(bn_paths, bn_srcs):
        for leaf, arr in zip(_BN_LEAVES, arrs):
            out[f"{path}.{leaf}"] = arr
    return out


class LoadReport:
    """Accounting for a checkpoint import: every target leaf must be mapped
    (or provably identity, for BatchNorm leaves of a BN-folded export)."""

    def __init__(self):
        self.total = 0
        self.mapped = 0
        self.folded_bn = 0
        self.missing: List[str] = []
        self.shape_mismatch: List[str] = []
        self.mode = "named"

    @property
    def complete(self) -> bool:
        return self.mapped + self.folded_bn == self.total and self.total > 0

    def summary(self) -> str:
        s = (f"{self.mapped}/{self.total} leaves mapped ({self.mode})"
             + (f", {self.folded_bn} BN leaves identity (folded export)"
                if self.folded_bn else ""))
        if self.missing:
            s += f"; MISSING: {self.missing[:8]}{'...' if len(self.missing) > 8 else ''}"
        if self.shape_mismatch:
            s += f"; SHAPE MISMATCH: {self.shape_mismatch[:8]}"
        return s


def load_into_state_dict(module: torch.nn.Module, path: str, *,
                         strict: bool = True):
    """Load an ONNX checkpoint into a state dict for `module`.

    Tries the state-dict name mapping first, then the graph-order
    positional fallback, the better of the two winning. Returns
    (state_dict, LoadReport): the module's own tensors where nothing was
    mapped, the checkpoint's where it was, in the module's dtypes; load it
    with `module.load_state_dict`. BatchNorm leaves that a BN-folded export
    (no BatchNormalization node) lacks keep the module's values, which are
    the identity for a freshly initialised module. With strict=True
    (default) raises RuntimeError unless every leaf was mapped: a
    partially mapped checkpoint silently producing garbage masks is the
    failure this guards against.
    """
    inits, nodes = read_onnx(path)
    has_bn_nodes = any(op == "BatchNormalization" for op, _i, _o in nodes)
    target = module.state_dict()
    leaves = [k for k in target if not k.endswith("num_batches_tracked")]

    def run_merge(src: Dict[str, np.ndarray], mode: str):
        report = LoadReport()
        report.mode = mode
        out = dict(target)
        for name in leaves:
            report.total += 1
            cur = target[name]
            cand = src.get(name)
            if cand is None:
                if name.rpartition(".")[0].endswith("bn_s1") \
                        and not has_bn_nodes:
                    report.folded_bn += 1  # BN folded into convs at export
                else:
                    report.missing.append(name)
            elif tuple(np.shape(cand)) != tuple(cur.shape):
                report.shape_mismatch.append(
                    f"{name}: ckpt{tuple(np.shape(cand))} vs "
                    f"model{tuple(cur.shape)}")
            else:
                out[name] = torch.from_numpy(np.array(cand)).to(cur.dtype)
                report.mapped += 1
        return out, report

    # Named mapping first; fall back to graph-order positional pairing not
    # only when the named map fails outright but also when it maps the
    # state INCOMPLETELY: optimizer passes commonly rename just the
    # initializers they touch ('onnx::Conv_n' style), which leaves some
    # names mappable while positional pairing (which ignores names) can
    # still map everything. The better of the two reports wins.
    named_result = None
    try:
        named_result = run_merge(map_u2net_weights(inits), "named")
    except ValueError:
        pass
    if named_result is not None and named_result[1].complete:
        state, report = named_result
    else:
        try:
            pos_result = run_merge(map_positional(inits, nodes, leaves),
                                   "graph-order")
        except ValueError:
            pos_result = None
        candidates = [r for r in (named_result, pos_result) if r is not None]
        if not candidates:
            raise RuntimeError(f"ONNX import failed: no weight mapping "
                               f"strategy applied [{path}]")
        state, report = max(candidates,
                            key=lambda r: (r[1].complete, r[1].mapped))

    if strict and not report.complete:
        raise RuntimeError(f"ONNX import incomplete: {report.summary()} [{path}]")
    return state, report

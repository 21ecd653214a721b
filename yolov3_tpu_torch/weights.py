"""Darknet ``.weights`` binary serialization: bit-exact reader (+ writer for tests).

The numpy half (``read_raw``, ``fold_raw``, ``load_weights``,
``write_weights``, ``random_raw``, ``param_count``) is a copy of
``yolov3_tpu/weights.py``: that package imports JAX, the port must not, and
``tests/test_torch_frontend.py`` holds the copies equal to the originals.

On-disk contract (the reference's ``yolov3/darknet.py::Darknet.load_weights``,
SURVEY.md §2.5/§3.5):

* header: 3×int32 ``(major, minor, revision)`` then a ``seen`` image counter —
  int64 when ``major*10 + minor >= 2`` (the published yolov3 weights are
  version 0.2.0 → 20-byte header), int32 otherwise;
* a flat little-endian float32 stream consumed **in cfg order** for every
  ``[convolutional]`` block: ``bn_beta, bn_gamma, bn_running_mean,
  bn_running_var`` (each ``C_out`` floats) when ``batch_normalize=1``, else
  ``conv_bias``; then the conv weight, row-major **OIHW**.

BatchNorm is folded into the conv weights at load time (inference only):
``w' = w * γ/sqrt(σ² + ε)``, ``b' = β − μ·γ/sqrt(σ² + ε)`` with ε = 1e-5.
The folded numpy form is the JAX package's ``{idx: {"w": HWIO, "b": (C,)}}``;
:func:`params_from_jax` turns it into the port's OIHW tensors.
"""
from __future__ import annotations

import hashlib
import io
import os
from pathlib import Path
from typing import Dict, Tuple, Union

import numpy as np
import torch

from .graph import Graph, Node

BN_EPS = 1e-5

RawConv = Dict[str, np.ndarray]  # keys: weight(OIHW), bias | bn_beta/bn_gamma/bn_mean/bn_var
Params = Dict[int, Dict[str, np.ndarray]]  # folded: {layer_index: {"w": HWIO, "b": (C,)}}
TorchParams = Dict[int, Dict[str, torch.Tensor]]  # {layer_index: {"w": OIHW, "b": (C,)}}
Device = Union[str, torch.device, None]  # None: the card


def resolve_device(device: Device) -> torch.device:
    """``device`` as a torch.device with an explicit CUDA index. ``None``
    means the card: the port runs on CUDA unless the caller asks for the
    CPU, and raises when there is no card (no silent fall back)."""
    dev = torch.device(device if device is not None else "cuda")
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {dev} requested but "
                               "torch.cuda.is_available() is False")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _conv_in_channels(graph: Graph, node: Node) -> int:
    src = node.inputs[0]
    return graph.in_channels if src < 0 else graph.nodes[src].out_channels


def read_raw(path: Union[str, Path, bytes], graph: Graph) -> Tuple[Dict[int, RawConv], Dict[str, int]]:
    """Read the darknet stream into per-conv raw arrays (OIHW, unfolded BN).

    Returns (raw_params, header_dict). Raises if the stream length does not
    exactly match the graph's parameter census (the bit-exactness contract).
    """
    if isinstance(path, bytes):
        data = path
    else:
        data = Path(path).read_bytes()
    buf = io.BytesIO(data)
    major, minor, revision = np.frombuffer(buf.read(12), dtype="<i4")
    if major * 10 + minor >= 2:
        (seen,) = np.frombuffer(buf.read(8), dtype="<i8")
    else:
        (seen,) = np.frombuffer(buf.read(4), dtype="<i4")
    header = {"major": int(major), "minor": int(minor), "revision": int(revision),
              "seen": int(seen)}

    stream = np.frombuffer(buf.read(), dtype="<f4")
    ptr = 0

    def take(n: int) -> np.ndarray:
        nonlocal ptr
        if ptr + n > stream.size:
            raise ValueError(
                f"weights stream exhausted: need {n} floats at offset {ptr}, "
                f"have {stream.size - ptr}"
            )
        out = stream[ptr:ptr + n]
        ptr += n
        return out

    raw: Dict[int, RawConv] = {}
    for node in graph.conv_nodes:
        c_out = node.filters
        c_in = _conv_in_channels(graph, node)
        k = node.size
        p: RawConv = {}
        if node.batch_normalize:
            p["bn_beta"] = take(c_out).copy()
            p["bn_gamma"] = take(c_out).copy()
            p["bn_mean"] = take(c_out).copy()
            p["bn_var"] = take(c_out).copy()
        else:
            p["bias"] = take(c_out).copy()
        p["weight"] = take(c_out * c_in * k * k).reshape(c_out, c_in, k, k).copy()
        raw[node.index] = p

    if ptr != stream.size:
        raise ValueError(
            f"weights stream size mismatch: consumed {ptr} floats, file has {stream.size}"
        )
    return raw, header


def fold_raw(raw: Dict[int, RawConv]) -> Params:
    """Fold BN into conv weights and transpose OIHW→HWIO (see module docstring)."""
    params: Params = {}
    for idx, p in raw.items():
        w = p["weight"].astype(np.float32)  # OIHW
        if "bn_gamma" in p:
            scale = p["bn_gamma"] / np.sqrt(p["bn_var"] + BN_EPS)
            w = w * scale[:, None, None, None]
            b = p["bn_beta"] - p["bn_mean"] * scale
        else:
            b = p["bias"]
        params[idx] = {
            "w": np.ascontiguousarray(w.transpose(2, 3, 1, 0)),  # OIHW -> HWIO
            "b": np.ascontiguousarray(b.astype(np.float32)),
        }
    return params


def load_weights(path: Union[str, Path, bytes], graph: Graph) -> Params:
    """Read a ``.weights`` file and return the folded HWIO numpy params."""
    raw, _ = read_raw(path, graph)
    return fold_raw(raw)


def load_weights_cached(path: Union[str, Path], graph: Graph,
                        cache_dir: Union[str, Path, None] = None) -> Params:
    """:func:`load_weights` with an on-disk cache of the folded, transposed
    params: repeat loads skip the OIHW parse and the BN fold. The cache key
    fingerprints the weight file (size, ns-resolution mtime, a hash of the
    20-byte header) and the graph's architecture (param count), so a
    replaced ``.weights`` file or a cfg change under the same stem misses.
    Cache files (npz, the JAX package's layout and key) live under
    ``.param_cache/`` beside the weight file unless ``cache_dir`` says."""
    path = Path(path)
    cache_dir = Path(cache_dir) if cache_dir else path.parent / ".param_cache"
    st = path.stat()
    with open(path, "rb") as f:
        header = f.read(20)
    fp = hashlib.sha256(header).hexdigest()[:12]
    key = (f"{path.stem}-{graph.name}-{param_count(graph)}-{st.st_size}-"
           f"{st.st_mtime_ns}-{fp}")
    cache_file = cache_dir / f"{key}.npz"
    if cache_file.exists():
        with np.load(cache_file) as z:
            return {int(name[:-2]): {"w": z[name], "b": z[f"{name[:-2]}.b"]}
                    for name in z.files if name.endswith(".w")}
    params = load_weights(path, graph)
    cache_dir.mkdir(parents=True, exist_ok=True)
    flat = {}
    for idx, p in params.items():
        flat[f"{idx}.w"] = p["w"]
        flat[f"{idx}.b"] = p["b"]
    tmp = cache_file.with_suffix(f".{os.getpid()}.tmp.npz")
    np.savez(tmp, **flat)
    tmp.replace(cache_file)
    return params


def save_params(path: Union[str, Path], params: Params) -> None:
    """Persist a folded param tree as ONE ``.npz``: keys ``"{idx}.w"``
    (HWIO) and ``"{idx}.b"``, float32, the layout of
    :func:`load_weights_cached`'s files. The counterpart of the JAX
    package's ``save_params_orbax`` (``yolov3_tpu/weights.py``), which
    needs orbax and so JAX. Written to a temp file and replaced into
    place, so a reader never sees half a checkpoint. ``path`` is used as
    given (``np.savez`` would add ``.npz`` to a bare name)."""
    path = Path(path)
    flat = {}
    for idx, p in params.items():
        flat[f"{int(idx)}.w"] = np.asarray(p["w"], np.float32)
        flat[f"{int(idx)}.b"] = np.asarray(p["b"], np.float32)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    with open(tmp, "wb") as f:
        np.savez(f, **flat)
    tmp.replace(path)


def load_params(path: Union[str, Path]) -> Params:
    """Load a tree saved by :func:`save_params`: ``{idx: {"w": HWIO,
    "b": (C,)}}`` numpy float32, bit for bit what was saved (the
    counterpart of ``load_params_orbax``); :func:`params_from_jax` or
    ``Darknet.set_params`` take it as it is."""
    with np.load(Path(path)) as z:
        return {int(name[:-2]): {"w": z[name], "b": z[f"{name[:-2]}.b"]}
                for name in z.files if name.endswith(".w")}


def write_weights(path: Union[str, Path], graph: Graph, raw: Dict[int, RawConv],
                  header: Tuple[int, int, int, int] = (0, 2, 0, 0)) -> None:
    """Write a darknet-format stream from raw OIHW params (test fixture tool)."""
    major, minor, revision, seen = header
    out = io.BytesIO()
    out.write(np.array([major, minor, revision], dtype="<i4").tobytes())
    if major * 10 + minor >= 2:
        out.write(np.array([seen], dtype="<i8").tobytes())
    else:
        out.write(np.array([seen], dtype="<i4").tobytes())
    for node in graph.conv_nodes:
        p = raw[node.index]
        if node.batch_normalize:
            for key in ("bn_beta", "bn_gamma", "bn_mean", "bn_var"):
                out.write(np.asarray(p[key], dtype="<f4").tobytes())
        else:
            out.write(np.asarray(p["bias"], dtype="<f4").tobytes())
        out.write(np.asarray(p["weight"], dtype="<f4").tobytes())
    Path(path).write_bytes(out.getvalue())


def random_raw(graph: Graph, seed: int = 0, scale: float = 1.0) -> Dict[int, RawConv]:
    """Synthesize plausible random raw params for every conv (test fixtures).

    Weights are fan-in scaled (He-style) so activations through deep stacks
    stay O(1) — unscaled noise saturates sigmoids and overflows the head's
    ``exp(tw)``, which would make parity comparisons vacuous. BN running-var
    is kept positive and O(1).
    """
    rng = np.random.default_rng(seed)
    raw: Dict[int, RawConv] = {}
    for node in graph.conv_nodes:
        c_out, c_in, k = node.filters, _conv_in_channels(graph, node), node.size
        std = scale / np.sqrt(c_in * k * k)
        p: RawConv = {
            "weight": rng.normal(0.0, std, (c_out, c_in, k, k)).astype(np.float32)
        }
        if node.batch_normalize:
            p["bn_beta"] = rng.normal(0.0, 0.1, c_out).astype(np.float32)
            p["bn_gamma"] = rng.uniform(0.5, 1.5, c_out).astype(np.float32)
            p["bn_mean"] = rng.normal(0.0, 0.1, c_out).astype(np.float32)
            p["bn_var"] = rng.uniform(0.5, 1.5, c_out).astype(np.float32)
        else:
            p["bias"] = rng.normal(0.0, 0.1, c_out).astype(np.float32)
        raw[node.index] = p
    return raw


def param_count(graph: Graph) -> int:
    """Total float32 count of the weight stream (excluding header)."""
    total = 0
    for node in graph.conv_nodes:
        c_out, c_in, k = node.filters, _conv_in_channels(graph, node), node.size
        total += c_out * (4 if node.batch_normalize else 1) + c_out * c_in * k * k
    return total


def params_from_jax(params_np: Params,
                    device: Device = None) -> TorchParams:
    """Folded ``{idx: {"w": HWIO, "b": (C,)}}`` numpy params (the JAX
    package's form, and what :func:`load_weights` returns) → the port's
    ``{idx: {"w": OIHW, "b": (C,)}}`` float32 tensors on ``device``.

    The weights are stored ``channels_last`` so cuDNN picks its NHWC kernels
    for the channels_last activations of ``model.forward_features``; the
    values are the same bits either way."""
    device = resolve_device(device)
    out: TorchParams = {}
    for idx, p in params_np.items():
        w = torch.from_numpy(np.ascontiguousarray(
            np.asarray(p["w"], np.float32).transpose(3, 2, 0, 1)))  # HWIO -> OIHW
        out[int(idx)] = {
            "w": w.to(device=device, memory_format=torch.channels_last),
            "b": torch.from_numpy(np.asarray(p["b"], np.float32).copy()).to(device),
        }
    return out


def quant_state_from_jax(qparams_np, device: Device = None
                         ) -> Dict[int, Dict[str, torch.Tensor]]:
    """A quantization state's ``qparams`` as numpy arrays in the JAX
    package's form (``{idx: {"wq" int8 HWIO, "sw", "b"}}`` or ``{"w" HWIO,
    "b"}``) → the same dict of tensors on ``device``; the layout does not
    change. bfloat16 arrives either as an ``ml_dtypes`` bfloat16 array or as
    the state file's tagged raw bits (a ``"w:bf16"`` uint16 field)."""
    device = resolve_device(device)
    out: Dict[int, Dict[str, torch.Tensor]] = {}
    for idx, qp in qparams_np.items():
        fields: Dict[str, torch.Tensor] = {}
        for name, a in qp.items():
            a = np.asarray(a)
            if name.endswith(":bf16"):
                name = name[:-len(":bf16")]
                a = a.view(np.uint16)
            elif a.dtype.name == "bfloat16":
                a = a.view(np.uint16)
            else:
                fields[name] = torch.from_numpy(np.array(a)).to(device)
                continue
            bits = torch.from_numpy(np.array(a).view(np.int16))
            fields[name] = bits.view(torch.bfloat16).to(device)
        out[int(idx)] = fields
    return out

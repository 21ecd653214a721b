"""Post-training int8 quantization: the int8 tier of the port.

Port of ``yolov3_tpu/quant.py``. The scheme is the reference's:

* **weights**: per-output-channel symmetric int8 (``wq = round(w / sw[o])``)
  of the folded conv weights;
* **activations**: per-tensor int8, scales (and, for the asymmetric scheme,
  zero-points) calibrated from real batches;
* **carrier**: ``"int8"``: activations travel between ops as (int8, scale,
  zero), each eligible conv's epilogue emitting int8 in its own tensor's
  scale (:func:`forward_features_int8_carrier`); ``"bf16"``: activations
  travel in the float carrier and each eligible conv quantizes its input
  (:func:`forward_features_int8`);
* opt-in: the linear head convs (``include_heads``) and the 3-channel stem
  through the exact-u8 input representation (``include_stem``).

``qparams`` keep the reference's names and layout (``wq`` int8 HWIO, ``sw``
(C,), ``b``; or ``w`` HWIO, ``b`` for a conv that stays float), so a state
file written by either package loads in the other. The walks take NHWC
``x`` and return NHWC head maps, and work on NHWC tensors throughout: the
int8 convs are im2col + an integer matmul (``ops/int8_conv.py``), the fused
residual-block kernel K6 (``ops/cuda_block.py``) reads the int8 NHWC tensor
in place, and only the few float convs view their operand as channels_last
NCHW for ``F.conv2d``.

Rounding is the reference's: ``1.0 / scale`` and ``s_in / s_out`` are
Python doubles rounded once to float32, rounds are half-to-even, and every
site is a clipped round. One deliberate difference: the affine dequantize
folds ``zero·scale`` in float32, so ``q = zero`` gives exactly 0.0.

Usage::

    net = Darknet(cfg, precision="bf16", device="cuda").load_weights(w)
    net.quantize_int8(calibration_frames)   # (N, H, W, 3) uint8 RGB
    Detector(net, block_impl="pallas")      # the int8 routes, K6 blocks
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .graph import Graph, Node
from .model import PRECISIONS, _activate, _conv, _head_spec, _maxpool
from .ops import decode as plain_decode
from .ops import int8_conv
from .ops.cuda_decode import decode_packed, decode_packed_fused
from .precision import tf32
from .weights import TorchParams

QParams = Dict[int, Dict[str, torch.Tensor]]
# a walk's value: ("q", int8 NHWC, scale, zero) or ("f", carrier NHWC)
Value = tuple


def load_calibration_dir(path, cap: int = 32) -> List[np.ndarray]:
    """Load up to ``cap`` calibration images (RGB, native size) from a
    directory. Filter-then-cap, not cap-then-filter: a directory whose
    listing leads with non-image files must not crowd out the calibration
    images. Raises SystemExit with a one-line message when none are
    readable (a CLI treats that as user error, not a traceback)."""
    import cv2
    from pathlib import Path

    calib: List[np.ndarray] = []
    for p_img in sorted(Path(path).iterdir()):
        if not p_img.is_file():
            continue
        frame = cv2.imread(str(p_img))
        if frame is not None:
            calib.append(frame[..., ::-1])  # BGR→RGB, native size
        if len(calib) >= cap:
            break
    if not calib:
        raise SystemExit(f"no readable calibration images in {path}")
    return calib


def eligible(graph: Graph, node: Node, include_heads: bool = False,
             include_stem: bool = False) -> bool:
    """Quantize BN'd convs with ≥ 16 input channels. ``include_heads`` adds
    the no-BN linear head convs (their float32 output feeds the decode
    directly, never requantized); ``include_stem`` adds the Cin=3 stem conv,
    whose input ``u8/255`` is an exact int8 image ``q = u8 − 128`` at scale
    1/255 (zero padding ≡ q = −128), so only its weights round."""
    src = node.inputs[0]
    if src < 0:  # stem conv: reads the network input directly
        return include_stem and node.batch_normalize
    c_in = graph.nodes[src].out_channels
    if not node.batch_normalize and not include_heads:
        return False
    return c_in >= 16


def quantize_weights(graph: Graph, params: TorchParams,
                     include_heads: bool = False,
                     include_stem: bool = False) -> QParams:
    """Per-output-channel symmetric int8 quantization of the folded conv
    weights (``params``: the port's ``{idx: {"w": OIHW, "b"}}`` tensors).

    Returns qparams on the weights' device: eligible convs get {"wq" int8
    HWIO, "sw" (C,) f32, "b" f32}; the others keep {"w" HWIO, "b" f32}. The
    stem conv (``include_stem``) folds the exact-u8 zero-point term into its
    bias: with x = (q + 128)/255 and zero padding carried as q = −128,
    conv(x) = (conv_int(q) + 128·Σ_taps wq)·sw/255, and the Σ term is a
    per-output-channel constant.
    """
    q: QParams = {}
    for node in graph.conv_nodes:
        p = params[node.index]
        dev = p["w"].device
        w_hwio = p["w"].permute(2, 3, 1, 0)
        if not eligible(graph, node, include_heads, include_stem):
            q[node.index] = {"w": w_hwio.contiguous(),
                             "b": p["b"].to(torch.float32)}
            continue
        w = w_hwio.float().cpu().numpy()
        sw = np.abs(w).reshape(-1, w.shape[3]).max(axis=0) / 127.0
        sw = np.maximum(sw, 1e-12).astype(np.float32)
        wq = np.clip(np.round(w / sw), -127, 127).astype(np.int8)
        b = p["b"].float().cpu().numpy()
        if node.inputs[0] < 0:  # stem: fold the +128 zero-point term
            wsum = wq.reshape(-1, w.shape[3]).astype(np.int64).sum(axis=0)
            b = b + (128.0 / 255.0) * sw * wsum.astype(np.float32)
        q[node.index] = {"wq": torch.from_numpy(wq).to(dev),
                         "sw": torch.from_numpy(sw).to(dev),
                         "b": torch.from_numpy(b.astype(np.float32)).to(dev)}
    return q


class Operands:
    """Run-time forms of a ``qparams`` dict, built per conv at first use
    and kept: the int8 matmul / int32 conv operand of a quantized conv
    (``ops.int8_conv.weight_operand``), the OIHW channels_last weight of a
    float conv, and K6's packed block weights (``ops.cuda_block``). A
    ``Darknet`` holds one per quantization state; the public walks build a
    throw-away one when none is passed."""

    def __init__(self, qparams: QParams):
        self.qparams = qparams
        self._conv: Dict[int, Dict[str, object]] = {}
        # K6 block operands by start node, K4 head weights by ("head", conv)
        self.blocks: Dict[object, object] = {}

    def conv(self, idx: int) -> Dict[str, object]:
        op = self._conv.get(idx)
        if op is None:
            qp = self.qparams[idx]
            if "wq" in qp:
                op = int8_conv.weight_operand(qp["wq"])
                op["scales"] = {}
            else:
                op = {"w": qp["w"].permute(3, 2, 0, 1).contiguous(
                    memory_format=torch.channels_last)}
            self._conv[idx] = op
        return op

    def zero_point_terms(self, node: Node, pad: int, out_hw, in_hw,
                         sx: float, zx: int):
        """The asymmetric scheme's two epilogue constants of a quantized
        conv at one geometry, input scale and zero-point: the bias with
        ``zx·Σ_all wq`` folded in, (C,), and ``zx`` times the border deficit
        map, (1, hp, wp, C). Kept, so no weight widens per call."""
        terms = self.conv(node.index).setdefault("zp", {})
        key = (tuple(out_hw), tuple(in_hw), sx, zx)
        if key not in terms:
            qp = self.qparams[node.index]
            w32 = qp["wq"].float()
            z = float(zx)
            scale = self.dequant_scale(node.index, sx)
            terms[key] = (
                qp["b"] - scale * z * w32.sum(dim=(0, 1, 2)),
                z * _zp_border_deficit(w32, node, pad, *out_hw, *in_hw))
        return terms[key]

    def dequant_scale(self, idx: int, sx: float) -> torch.Tensor:
        """``sw · float32(sx)``, the conv epilogue's per-channel scale."""
        scales = self.conv(idx)["scales"]
        if sx not in scales:
            scales[sx] = self.qparams[idx]["sw"] * float(np.float32(sx))
        return scales[sx]


def _conv_bf16(x: torch.Tensor, node: Node, qp, operands: Operands
               ) -> torch.Tensor:
    """A conv that stays float, on the NHWC carrier ``x``: ``F.conv2d`` in
    x's type + bias + activation (``model._conv``)."""
    w = operands.conv(node.index)["w"]
    y = _conv(x.permute(0, 3, 1, 2), w, qp["b"], node)
    return y.permute(0, 2, 3, 1).contiguous()


def chain_targets(graph: Graph, qparams) -> Dict[int, int]:
    """Conv indices whose output's SOLE consumer is the next quantized conv:
    they emit int8 in the consumer's calibrated scale straight from their
    epilogue, and the float activation never exists (one float rounding
    fewer per chained activation). In yolov3 this covers every residual
    bottleneck's 1×1."""
    needed = graph.needed_outputs
    targets: Dict[int, int] = {}
    for node in graph.nodes:
        nxt = node.index + 1
        if (node.kind == "convolutional" and "wq" in qparams.get(node.index, {})
                and node.index not in needed
                and nxt < len(graph.nodes)):
            nxt_node = graph.nodes[nxt]
            if (nxt_node.kind == "convolutional"
                    and nxt_node.inputs == (node.index,)
                    and "wq" in qparams.get(nxt, {})):
                targets[node.index] = nxt
    return targets


def _conv_int8_core(x_or_q: torch.Tensor, node: Node, qp, sx: float,
                    prequantized: bool, zx: int = 0,
                    operands: Optional[Operands] = None) -> torch.Tensor:
    """int8 conv of the NHWC input → the float32 pre-activation.

    ``zx`` is the input tensor's zero-point (``act_scheme="asymmetric"``):
    the input represents ``x = sx·(q − zx)``, so with implicit zero padding

        conv(x)[p] = sx·(conv(q)[p] − zx·(Σ_all wq − deficit[p]))

    where ``deficit[p] = Σ_out-of-bounds-taps wq`` is nonzero only on the
    1-pixel pad-border ring. The global ``zx·Σwq`` term is a per-channel
    vector folded into the bias; the ring comes from
    :func:`_zp_border_deficit`. ``zx = 0`` is the symmetric scheme."""
    operands = operands or Operands({node.index: qp})
    pad = node.size // 2 if node.pad else 0
    xq = x_or_q if prequantized else _quantize_affine(x_or_q, sx, zx)
    y = int8_conv.conv_int8(xq, operands.conv(node.index), node.stride, pad)
    y32 = y.float()
    scale = operands.dequant_scale(node.index, sx)
    b = qp["b"]
    if zx:
        b, z_deficit = operands.zero_point_terms(
            node, pad, y32.shape[1:3], xq.shape[1:3], sx, zx)
        y32 = y32 + z_deficit
    return y32 * scale + b


def _zp_border_deficit(w32: torch.Tensor, node: Node, pad: int,
                       hp: int, wp: int, h_in: int, w_in: int) -> torch.Tensor:
    """The ``deficit[p]`` map of :func:`_conv_int8_core`, (1, hp, wp, C):
    outer products of 1-D edge masks with per-channel tap-row sums of the
    HWIO float weight ``w32``, corners corrected by inclusion–exclusion.

    Per output row index i, tap row ``kh`` is out of bounds iff
    ``i·s − pad + kh`` falls outside the input; for the darknet geometry
    (k ≤ 3, pad ≤ 1, stride ≤ 2) only the first and last output rows/cols
    can be deficient — checked, not assumed."""
    k, s = node.size, node.stride
    if k > 1 and (hp < 2 or wp < 2):
        # first / last row and col must be distinct cells
        raise ValueError(f"zero-point border repair needs a >= 2x2 output, "
                         f"got {hp}x{wp}")

    def miss(n_out: int, n_in: int, edge: str) -> List[int]:
        idx = 0 if edge == "lo" else n_out - 1
        return [kk for kk in range(k) if not 0 <= idx * s - pad + kk < n_in]

    m_top, m_bot = miss(hp, h_in, "lo"), miss(hp, h_in, "hi")
    m_left, m_right = miss(wp, w_in, "lo"), miss(wp, w_in, "hi")
    # interior rows/cols must be complete (ring width 1); a graph violating
    # it must extend this repair, not silently skip it
    for n_out, n_in in ((hp, h_in), (wp, w_in)):
        for idx in range(1, n_out - 1):
            if not (0 <= idx * s - pad and idx * s - pad + k - 1 < n_in):
                raise ValueError("zero-point border repair: ring wider than "
                                 "1 output px")

    def edge_mask(n: int, at_end: bool) -> torch.Tensor:
        i = torch.arange(n, device=w32.device)
        return (i == (n - 1 if at_end else 0)).float()

    corr = torch.zeros((1, 1, 1, w32.shape[3]), dtype=torch.float32,
                       device=w32.device)
    rows = [(m_top, edge_mask(hp, False)), (m_bot, edge_mask(hp, True))]
    cols = [(m_left, edge_mask(wp, False)), (m_right, edge_mask(wp, True))]
    for m_kh, rmask in rows:
        if m_kh:
            corr = corr + rmask[None, :, None, None] * w32[m_kh].sum(dim=(0, 1, 2))
    for m_kw, cmask in cols:
        if m_kw:
            corr = corr + cmask[None, None, :, None] * w32[:, m_kw].sum(dim=(0, 1, 2))
    for m_kh, rmask in rows:
        for m_kw, cmask in cols:
            if m_kh and m_kw:
                corr = corr - (rmask[None, :, None, None]
                               * cmask[None, None, :, None]
                               * w32[m_kh][:, m_kw].sum(dim=(0, 1, 2)))
    return corr


def _conv_stem_int8(x: torch.Tensor, node: Node, qp,
                    operands: Optional[Operands] = None) -> torch.Tensor:
    """int8 stem conv on the EXACT u8 input representation.

    ``x`` is the preprocessed network input in [0, 1] (``u8/255`` for
    identity-resize sources). ``q = round(255·x) − 128`` spans [−128, 127];
    zero padding is carried as q = −128 (≡ x = 0), explicitly. The +128
    zero-point term is already folded into ``qp["b"]``
    (:func:`quantize_weights`). Returns the float32 pre-activation."""
    operands = operands or Operands({node.index: qp})
    xq = (torch.round(x.float() * 255.0) - 128.0).to(torch.int8)
    pad = node.size // 2 if node.pad else 0
    y = int8_conv.conv_int8(xq, operands.conv(node.index), node.stride, pad,
                            pad_value=-128)
    return y.float() * operands.dequant_scale(node.index, 1.0 / 255.0) + qp["b"]


def consumers_of(graph: Graph) -> Dict[int, List[Node]]:
    """node index → nodes consuming its output (explicit input edges)."""
    out: Dict[int, List[Node]] = {n.index: [] for n in graph.nodes}
    for n in graph.nodes:
        for i in n.inputs:
            if i >= 0:
                out[i].append(n)
    return out


def _to_int8(f: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(f), -127, 127).to(torch.int8)


def _quantize_to(y: torch.Tensor, scale: float) -> torch.Tensor:
    return _to_int8(y.float() * (1.0 / scale))


def _quantize_affine(y: torch.Tensor, scale: float, zero: int = 0
                     ) -> torch.Tensor:
    """``q = clip(round(y/s + z), ±127)``, the affine quantize site; ``1/s``
    is a double rounded once to float32. ``z = 0`` is the symmetric site."""
    f = y.float() * (1.0 / scale)
    if zero:
        f = f + float(zero)
    return _to_int8(f)


def _dequantize_affine(q: torch.Tensor, scale: float, zero: int = 0
                       ) -> torch.Tensor:
    """``x = q·s − z·s`` with both products in float32, so ``q = z`` gives
    exactly 0.0 (the JAX package folds ``z·s`` in double, within 1 ulp of
    this)."""
    f = q.float() * scale
    if zero:
        f = f - float(np.float32(zero) * np.float32(scale))
    return f


def _requantize_affine(q: torch.Tensor, s_in: float, z_in: int,
                       s_out: float, z_out: int) -> torch.Tensor:
    """Fused dequant→quant: ``clip(round(q·r + c))`` with ``r = s_in/s_out``
    rounded once to float32 and ``c = z_out − z_in·r`` folded in float32
    (see :func:`_dequantize_affine`)."""
    r = np.float32(s_in / s_out)
    c = float(np.float32(z_out) - np.float32(z_in) * r)
    f = q.float() * float(r)
    if c:
        f = f + c
    return _to_int8(f)


def _maxpool_int8(x: torch.Tensor, node: Node) -> torch.Tensor:
    """int8 NHWC maxpool: max is monotone, so pooling quantized values in
    the producer's scale is exact. Eager PyTorch has no int8 pool on CUDA:
    the values pool as float16 there (float32 on the CPU), exact for int8,
    and the −128 padding stands for −inf (quantized values stay ≥ −127)."""
    lo = node.padding // 2
    hi = node.padding - lo
    work = torch.float16 if x.device.type == "cuda" else torch.float32
    y = F.pad(x.permute(0, 3, 1, 2).to(work), (lo, hi, lo, hi), value=-128.0)
    y = F.max_pool2d(y, node.size, node.stride)
    return y.to(torch.int8).permute(0, 2, 3, 1).contiguous()


def _upsample_nearest(x: torch.Tensor, s: int) -> torch.Tensor:
    """Nearest ×s upsample of an NHWC tensor of any type (one copy)."""
    b, h, w, c = x.shape
    return x[:, :, None, :, None, :].expand(b, h, s, w, s, c).reshape(
        b, h * s, w * s, c)


def _maxpool_f(x: torch.Tensor, node: Node) -> torch.Tensor:
    return _maxpool(x.permute(0, 3, 1, 2), node).permute(0, 2, 3, 1).contiguous()


def _carrier_dtype(precision: Optional[str]) -> torch.dtype:
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, got {precision!r}")
    return torch.bfloat16 if precision == "bf16" else torch.float32


def forward_features_int8_carrier(
        graph: Graph, qparams: QParams, tensor_scales: Dict[int, float],
        x: torch.Tensor, precision: Optional[str] = "bf16",
        upto: Optional[int] = None, stop_before_heads: bool = False,
        block_impl: str = "xla",
        tensor_zeros: Optional[Dict[int, int]] = None,
        operands: Optional[Operands] = None) -> List[torch.Tensor]:
    """int8 graph walk with an **int8 activation carrier**: each eligible
    conv's epilogue emits int8 in the tensor's own calibrated scale and
    activations travel as (int8, scale, zero):

    * conv (eligible): consumes int8 directly (producer scale), exact
      int8×int8→int32, dequant/bias/activation epilogue in float32,
      requantized to its own output scale;
    * shortcut: widen both operands with their scales, add + activation in
      float32, requantize;
    * route: single-input passes through (scale rides along); multi-input
      dequantize → concat → requantize;
    * maxpool/upsample: exact on int8 (monotone / copy), scale preserved;
    * float consumers (no-BN head convs, yolo heads): operand dequantized
      to the carrier type at the use site.

    ``tensor_scales``: node index → calibrated scale of that node's OUTPUT
    (:func:`calibrate_tensors`). ``upto``: truncate the walk after
    ``graph.nodes[:upto]`` and append the last live activation (dequantized
    to the carrier type) to the returned list; quantization decisions still
    come from the FULL graph. ``stop_before_heads``: return the PRE-head
    activations instead and skip the 1×1 head convs (K4 runs them,
    :func:`forward_packed_fused_int8`). ``block_impl="pallas"``: eligible
    residual blocks (``ops.cuda_block.fused_block_plan``) run through the
    fused kernel K6, one launch per block on the plain NHWC int8 tensor;
    blocks the plan refuses, or whose input is not int8, run node by node.
    ``tensor_zeros``: node index → zero-point for the asymmetric scheme
    (:func:`calibrate_tensors_affine`); K6 implements the symmetric sites
    only, so nonzero zero-points force ``block_impl="xla"``.
    """
    carrier_dtype = _carrier_dtype(precision)
    operands = operands or Operands(qparams)
    zof = ((lambda i: tensor_zeros.get(i, 0)) if tensor_zeros
           else (lambda i: 0))
    if tensor_zeros and any(tensor_zeros.values()):
        block_impl = "xla"  # K6 mimics the SYMMETRIC quantize sites
    needed = graph.needed_outputs
    cons = consumers_of(graph)

    # q_friendly[i]: node i genuinely absorbs an int8 operand. Quantized
    # convs and scale-resolving joins (shortcut, multi-input route) consume
    # int8 natively. PASS-THROUGH ops (maxpool/upsample/single-input route)
    # forward the carrier unchanged, so they are friendly only if ALL of
    # their own consumers are — computed transitively in reverse topological
    # order (graph.nodes is topo-ordered; skip edges only point backward).
    q_friendly: Dict[int, bool] = {}
    for n in reversed(graph.nodes):
        if n.kind == "convolutional":
            ok = "wq" in qparams.get(n.index, {})
        elif n.kind == "shortcut" or (n.kind == "route" and len(n.inputs) > 1):
            ok = True
        elif n.kind in ("maxpool", "upsample", "route"):
            ncs = cons[n.index]
            ok = bool(ncs) and all(q_friendly[c.index] for c in ncs)
        else:  # yolo heads read the carrier type
            ok = False
        q_friendly[n.index] = ok

    def want_q(node: Node) -> bool:
        """Emit int8 for this node's output? Only when ALL consumers read
        int8: a mixed edge would add a quantize→dequantize round trip on
        the float consumer's operand."""
        if node.index not in tensor_scales:
            return False
        cs = cons[node.index]
        return bool(cs) and all(q_friendly[c.index] for c in cs)

    head_convs = ({yn.inputs[0] for yn in graph.yolo_nodes}
                  if stop_before_heads else frozenset())
    cache: Dict[int, Value] = {}
    heads: List[torch.Tensor] = []
    prev: Value = ("f", x.to(carrier_dtype))

    def as_f(v: Value) -> torch.Tensor:
        if v[0] == "f":
            return v[1]
        return _dequantize_affine(v[1], v[2], v[3]).to(carrier_dtype)

    def emit(y: torch.Tensor, node: Node) -> Value:
        if want_q(node):
            s, z = tensor_scales[node.index], zof(node.index)
            return ("q", _quantize_affine(y, s, z), s, z)
        return ("f", y.to(carrier_dtype))

    bplan: Dict[int, Dict] = {}
    if block_impl == "pallas":
        from .ops import cuda_block

        bplan = cuda_block.fused_block_plan(graph, qparams, tensor_scales)
    elif block_impl != "xla":
        raise ValueError(f"unknown block_impl {block_impl!r} "
                         "(expected 'xla' or 'pallas')")

    def run_block(a: int, prev_q: Value) -> Value:
        """Nodes a, a+1, a+2 (1×1 → 3×3 → shortcut) as one K6 launch."""
        eq = want_q(graph.nodes[a + 2])
        s_out = tensor_scales[a + 2] if eq else None
        bp = cuda_block.prepare_block_params(
            qparams[a], qparams[a + 1], prev_q[2], tensor_scales[a],
            cache=operands.blocks, key=a)
        out = cuda_block.residual_block_int8(
            prev_q[1], bp, s_in=prev_q[2], s_mid=tensor_scales[a],
            s_mid2=tensor_scales[a + 1], s_out=s_out, emit_q=eq,
            carrier_dtype=carrier_dtype)
        return ("q", out, s_out, 0) if eq else ("f", out)

    skip_upto = -1
    with tf32(precision is None):
        for node in (graph.nodes if upto is None else graph.nodes[:upto]):
            if node.index <= skip_upto:
                continue  # node ran inside a fused block
            if (node.index in bplan and prev[0] == "q"
                    and (upto is None or node.index + 2 < upto)):
                prev = run_block(node.index, prev)
                skip_upto = node.index + 2
                if skip_upto in needed:
                    cache[skip_upto] = prev
                continue
            if node.index in head_convs:
                # head branch ends here: the skipped conv's only consumer
                # is its yolo node (fused_heads_eligible gate)
                heads.append(as_f(prev))
                out = prev
            elif node.kind == "convolutional":
                qp = qparams[node.index]
                if "wq" in qp:
                    if node.inputs[0] < 0:
                        # stem: exact-u8 int8 input from the RAW network
                        # input (the carrier cast would break exactness)
                        y = _conv_stem_int8(x, node, qp, operands)
                    elif prev[0] == "q":
                        y = _conv_int8_core(prev[1], node, qp, prev[2],
                                            prequantized=True, zx=prev[3],
                                            operands=operands)
                    else:
                        y = _conv_int8_core(as_f(prev), node, qp,
                                            tensor_scales[node.inputs[0]],
                                            prequantized=False,
                                            zx=zof(node.inputs[0]),
                                            operands=operands)
                    out = emit(_activate(y, node.activation), node)
                else:
                    y = _conv_bf16(as_f(prev), node, qp, operands)
                    # a float conv whose consumers all read int8 (conv0)
                    # quantizes in its epilogue
                    out = emit(y, node) if want_q(node) else ("f", y)
            elif node.kind == "maxpool":
                if prev[0] == "q":
                    out = ("q", _maxpool_int8(prev[1], node), prev[2], prev[3])
                else:
                    out = ("f", _maxpool_f(prev[1], node))
            elif node.kind == "upsample":
                out = (prev[0], _upsample_nearest(prev[1], node.stride),
                       *prev[2:])
            elif node.kind == "shortcut":
                # both operands' zero-point constants fold into ONE subtract
                zc = 0.0
                terms = []
                for v in (prev, cache[node.inputs[1]]):
                    if v[0] == "q":
                        terms.append(v[1].float() * v[2])
                        zc += float(v[3]) * v[2]
                    else:
                        terms.append(v[1].float())
                y = terms[0] + terms[1]
                if zc:
                    y = y - zc
                out = emit(_activate(y, node.activation), node)
            elif node.kind == "route":
                srcs = [prev if i == node.index - 1 else cache[i]
                        for i in node.inputs]
                if len(srcs) == 1:
                    out = srcs[0]  # scale/zero ride along, no requantize
                elif want_q(node) and all(v[0] == "q" for v in srcs):
                    s, z = tensor_scales[node.index], zof(node.index)
                    if tensor_zeros:
                        parts = [_requantize_affine(v[1], v[2], v[3], s, z)
                                 for v in srcs]
                    else:
                        parts = [_quantize_affine(
                            _dequantize_affine(v[1], v[2], v[3]), s, z)
                            for v in srcs]
                    out = ("q", torch.cat(parts, dim=-1), s, z)
                else:
                    out = ("f", torch.cat([as_f(v) for v in srcs], dim=-1))
            elif node.kind == "yolo":
                if not stop_before_heads:
                    heads.append(as_f(prev))
                out = prev
            else:  # pragma: no cover - lower() already validates kinds
                raise ValueError(node.kind)
            if node.index in needed:
                cache[node.index] = out
            prev = out
    if upto is not None:
        return heads + [as_f(prev)]
    return heads


def forward_features_int8(graph: Graph, qparams: QParams,
                          scales: Dict[int, float], x: torch.Tensor,
                          precision: Optional[str] = "bf16",
                          chain: bool = True,
                          operands: Optional[Operands] = None
                          ) -> List[torch.Tensor]:
    """int8 graph walk on the float carrier; mirrors
    ``model.forward_features``. ``scales`` maps conv index → calibrated
    input scale (:func:`calibrate`). ``chain=True`` lets solely-chained
    convs emit int8 directly (:func:`chain_targets`)."""
    carrier_dtype = _carrier_dtype(precision)
    operands = operands or Operands(qparams)
    needed = graph.needed_outputs
    chains = chain_targets(graph, qparams) if chain else {}
    cache: Dict[int, torch.Tensor] = {}
    heads: List[torch.Tensor] = []
    prev = x.to(carrier_dtype)
    prev_q = None  # int8 tensor already in THIS node's input scale
    with tf32(precision is None):
        for node in graph.nodes:
            out_q = None
            if node.kind == "convolutional":
                qp = qparams[node.index]
                if "wq" in qp:
                    if node.inputs[0] < 0:
                        y = _conv_stem_int8(x, node, qp, operands)
                    else:
                        y = _conv_int8_core(
                            prev_q if prev_q is not None else prev, node, qp,
                            scales[node.index],
                            prequantized=prev_q is not None, operands=operands)
                    y = _activate(y, node.activation)
                    if node.index in chains:
                        # int8 in the consumer's scale; the float tensor of
                        # this layer never exists
                        out_q = _quantize_to(y, scales[chains[node.index]])
                        out = out_q  # placeholder; the consumer reads out_q
                    else:
                        out = y.to(carrier_dtype)
                else:
                    out = _conv_bf16(prev, node, qp, operands)
            elif node.kind == "maxpool":
                out = _maxpool_f(prev, node)
            elif node.kind == "upsample":
                out = _upsample_nearest(prev, node.stride)
            elif node.kind == "shortcut":
                out = _activate(prev + cache[node.inputs[1]], node.activation)
            elif node.kind == "route":
                srcs = [prev if i == node.index - 1 else cache[i]
                        for i in node.inputs]
                out = srcs[0] if len(srcs) == 1 else torch.cat(srcs, dim=-1)
            elif node.kind == "yolo":
                heads.append(prev)
                out = prev
            else:  # pragma: no cover - lower() already validates kinds
                raise ValueError(node.kind)
            if node.index in needed:
                cache[node.index] = out
            prev = out
            prev_q = out_q
    return heads


def _int8_heads(graph, qparams, scales, x, precision, carrier, block_impl,
                zeros, operands) -> List[torch.Tensor]:
    if carrier == "int8":
        return forward_features_int8_carrier(
            graph, qparams, scales, x, precision, block_impl=block_impl,
            tensor_zeros=zeros, operands=operands)
    return forward_features_int8(graph, qparams, scales, x, precision,
                                 operands=operands)


def forward_compact_int8(graph: Graph, qparams: QParams, scales, x,
                         precision: Optional[str] = "bf16",
                         decode_impl: str = "xla", carrier: str = "bf16",
                         block_impl: str = "xla",
                         zeros: Optional[Dict[int, int]] = None,
                         operands: Optional[Operands] = None):
    """int8 serving forward → (boxes, scores, classes), compact decode
    (``decode_impl`` ``"xla"``: plain tensors; ``"pallas"``: K1c).

    ``carrier="int8"`` runs the int8-carrier walk (``scales`` are per-TENSOR
    scales from :func:`calibrate_tensors`); ``carrier="bf16"`` the
    per-conv-input-quantize walk (``scales`` from :func:`calibrate`).
    ``zeros``: per-tensor zero-points of the asymmetric scheme (int8
    carrier only)."""
    from .ops.cuda_decode import decode_compact

    if decode_impl not in ("xla", "pallas"):
        raise ValueError(f"decode_impl must be 'xla' or 'pallas', got "
                         f"{decode_impl!r}")
    heads = _int8_heads(graph, qparams, scales, x, precision, carrier,
                        block_impl, zeros, operands)
    fn = decode_compact if decode_impl == "pallas" else plain_decode.decode_compact
    return fn(heads, *_head_spec(graph), scales=graph.head_scales())


def forward_packed_int8(graph: Graph, qparams: QParams, scales, x,
                        prob_thresh: float, precision: Optional[str] = "bf16",
                        carrier: str = "bf16", block_impl: str = "xla",
                        zeros: Optional[Dict[int, int]] = None,
                        operands: Optional[Operands] = None):
    """int8 serving forward → (payload (B, N, 8), scores (B, N)) for
    ``ops.nms.batched_nms_packed``: the walk, then K1."""
    heads = _int8_heads(graph, qparams, scales, x, precision, carrier,
                        block_impl, zeros, operands)
    anchors, strides, classes = _head_spec(graph)
    return decode_packed(heads, anchors, strides, classes,
                         prob_thresh=prob_thresh, scales=graph.head_scales())


def forward_packed_fused_int8(graph: Graph, qparams: QParams, scales, x,
                              prob_thresh: float,
                              precision: Optional[str] = "bf16",
                              carrier: str = "int8", block_impl: str = "xla",
                              zeros: Optional[Dict[int, int]] = None,
                              operands: Optional[Operands] = None):
    """:func:`forward_packed_int8` with the 1×1 head convs inside the decode
    kernel (K4): the int8-carrier walk stops at each pre-head activation
    (dequantized to the carrier type) and the head maps never reach device
    memory. Quantized head weights (``include_heads``) are dequantized
    (``wq·sw``); the projection accumulates in float32. Callers gate on
    ``model.fused_heads_eligible``; int8 carrier only (``carrier="bf16"``
    runs :func:`forward_packed_int8`). A head with a ``scale_x_y`` raises:
    K4 takes none."""
    if carrier != "int8":
        return forward_packed_int8(graph, qparams, scales, x, prob_thresh,
                                   precision=precision, carrier=carrier,
                                   block_impl=block_impl, operands=operands)
    if any(v != 1.0 for v in graph.head_scales()):
        raise ValueError("K4 takes no scale_x_y: a graph whose heads scale "
                         "their centres runs forward_packed_int8")
    operands = operands or Operands(qparams)
    pre = forward_features_int8_carrier(
        graph, qparams, scales, x, precision, stop_before_heads=True,
        block_impl=block_impl, tensor_zeros=zeros, operands=operands)
    ws, bs = [], []
    for yn in graph.yolo_nodes:
        hc = yn.inputs[0]
        p = qparams[hc]
        key = ("head", hc)
        if key not in operands.blocks:  # dequantized / transposed once
            w = p["wq"].float() * p["sw"] if "wq" in p else p["w"]
            operands.blocks[key] = w.reshape(w.shape[2], w.shape[3]).t().contiguous()
        ws.append(operands.blocks[key])
        bs.append(p["b"])
    anchors, strides, classes = _head_spec(graph)
    return decode_packed_fused(pre, ws, bs, anchors, strides, classes,
                               prob_thresh=prob_thresh)


# ------------------------------------------------------------ calibration


def _percentile(t: torch.Tensor, q: float) -> torch.Tensor:
    """``jnp.percentile(t, q)`` (linear interpolation) of all elements, as
    a 0-d float32 tensor. ``torch.quantile`` refuses inputs over 2^24
    elements (one yolov3@416 batch-8 activation has 22M), so the two
    neighbouring order statistics come from ``kthvalue``. The fractional
    index is formed in float32 as the JAX package's compiled calibration
    pass forms it (XLA folds the division by 100 into the count:
    ``q · ((n − 1) / 100)``), so both pick the same neighbours and weights."""
    flat = t.reshape(-1).float()
    n = flat.numel()
    pos = np.float32(q) * ((np.float32(n) - np.float32(1)) / np.float32(100))
    low, high = np.floor(pos), np.ceil(pos)
    high_w = np.float32(pos - low)
    low_w = np.float32(1) - high_w
    lo_i = int(min(max(low, 0), n - 1))
    hi_i = int(min(max(high, 0), n - 1))
    lo_v = torch.kthvalue(flat, lo_i + 1).values
    hi_v = lo_v if hi_i == lo_i else torch.kthvalue(flat, hi_i + 1).values
    return lo_v * float(low_w) + hi_v * float(high_w)


def _check_percentile(percentile: float) -> None:
    if not 0.0 < percentile <= 100.0:
        raise ValueError(f"percentile must be in (0, 100], got {percentile}")


def _make_stat_fn(method: str, percentile: float
                  ) -> Callable[[torch.Tensor], torch.Tensor]:
    """Per-tensor calibration statistic.

    ``absmax``: the tensor's abs-max; never clips, but one outlier stretches
    the scale. ``percentile``: the q-th percentile of |t|, the standard PTQ
    outlier guard; values above the scale SATURATE (every quantize site is a
    clipped round). Aggregation across calibration batches is
    max-of-per-batch-percentiles."""
    if method == "absmax":
        return lambda t: t.abs().max()
    if method == "percentile":
        _check_percentile(percentile)
        return lambda t: _percentile(t.abs(), percentile)
    raise ValueError(f"unknown calibration method {method!r} "
                     "(expected 'absmax' or 'percentile')")


@torch.inference_mode()
def _calibration_walk(graph: Graph, params: TorchParams, x: torch.Tensor,
                      precision: Optional[str], visit) -> None:
    """The ONE float reference walk behind every calibration-side pass.

    Runs the float graph on NHWC ``x`` and calls ``visit(node, inp, out)``
    for every node: ``inp`` is the node's primary input (the previous node's
    output, which IS the conv input for conv nodes), ``out`` its own output,
    both as NCHW views (channels on dim 1) of channels_last tensors."""
    _carrier_dtype(precision)
    needed = graph.needed_outputs
    cache: Dict[int, torch.Tensor] = {}
    prev = x.permute(0, 3, 1, 2)
    if precision == "bf16":
        prev = prev.to(torch.bfloat16)
    with tf32(precision is None):
        for node in graph.nodes:
            if node.kind == "convolutional":
                p = params[node.index]
                out = _conv(prev, p["w"], p["b"], node)
            elif node.kind == "maxpool":
                out = _maxpool(prev, node)
            elif node.kind == "upsample":
                out = F.interpolate(prev, scale_factor=node.stride,
                                    mode="nearest")
            elif node.kind == "shortcut":
                out = _activate(prev + cache[node.inputs[1]], node.activation)
            elif node.kind == "route":
                srcs = [prev if i == node.index - 1 else cache[i]
                        for i in node.inputs]
                out = srcs[0] if len(srcs) == 1 else torch.cat(srcs, dim=1)
            else:
                out = prev
            visit(node, prev, out)
            if node.index in needed:
                cache[node.index] = out
            prev = out


def _as_batch(x, params: TorchParams) -> torch.Tensor:
    dev = next(iter(params.values()))["w"].device
    return torch.as_tensor(x).to(dev)


def _run_stats(graph, params, batches, precision, pick
               ) -> List[Dict[int, np.ndarray]]:
    """One calibration walk per batch; ``pick(node, inp, out)`` returns
    None or a tuple of 0-d tensors, fetched with one copy per batch →
    per batch {node index: float64 values}."""
    out = []
    for x in batches:
        acc: Dict[int, torch.Tensor] = {}

        def visit(node, inp, o):
            got = pick(node, inp, o)
            if got is not None:
                acc[node.index] = torch.stack([g.float() for g in got])

        _calibration_walk(graph, params, _as_batch(x, params), precision, visit)
        keys = list(acc)
        vals = torch.stack([acc[k] for k in keys]).cpu().numpy().astype(np.float64)
        out.append(dict(zip(keys, vals)))
    return out


def calibrate(graph: Graph, params: TorchParams, batches,
              precision: Optional[str] = "bf16", include_heads: bool = False,
              method: str = "absmax", percentile: float = 99.9
              ) -> Dict[int, float]:
    """Run calibration batches through the float graph recording the
    abs-max (or q-th percentile, :func:`_make_stat_fn`) INPUT of every
    eligible conv; returns {conv index: scale}. ``batches``: iterable of
    (B, H, W, C) float arrays in [0, 1], preprocessed as the serving path
    preprocesses."""
    stat = _make_stat_fn(method, percentile)
    indices = [n.index for n in graph.conv_nodes
               if eligible(graph, n, include_heads)]
    wanted = frozenset(indices)

    def pick(node, inp, out):
        if node.kind == "convolutional" and node.index in wanted:
            return (stat(inp.float()),)

    agg: Dict[int, float] = {i: 0.0 for i in indices}
    for maxima in _run_stats(graph, params, batches, precision, pick):
        for i in indices:
            agg[i] = max(agg[i], float(maxima[i][0]))
    return {i: max(agg[i], 1e-6) / 127.0 for i in indices}


def calibrate_tensors(graph: Graph, params: TorchParams, batches,
                      precision: Optional[str] = "bf16",
                      method: str = "absmax", percentile: float = 99.9
                      ) -> Dict[int, float]:
    """Per-TENSOR calibration for the int8 carrier: the abs-max (or q-th
    percentile) of EVERY node's output; returns {node index: scale}. A
    conv's input scale is its input tensor's scale."""
    stat = _make_stat_fn(method, percentile)
    agg: Dict[int, float] = {}
    for maxima in _run_stats(graph, params, batches, precision,
                             lambda node, inp, out: (stat(out.float()),)):
        for i, m in maxima.items():
            agg[i] = max(agg.get(i, 0.0), float(m[0]))
    return {i: max(m, 1e-6) / 127.0 for i, m in agg.items()}


def calibrate_tensors_affine(graph: Graph, params: TorchParams, batches,
                             precision: Optional[str] = "bf16",
                             method: str = "minmax",
                             percentile: float = 99.9
                             ) -> Tuple[Dict[int, float], Dict[int, int]]:
    """Per-tensor AFFINE calibration for ``act_scheme="asymmetric"``: every
    node output's (min, max) range maps onto the int8 carrier as
    ``x = s·(q − z)`` with ``s = (hi − lo)/254`` and the zero-point placed
    so lo ↦ −127, hi ↦ +127 and **x = 0 stays exactly representable** (the
    range always includes 0). Returns ``(scales, zeros)``.
    ``method="percentile"`` clips the range to the two-sided (100−q, q)
    percentiles, max-aggregated across batches; ``"minmax"`` is the absmax
    analogue."""
    if method == "minmax":
        lo_stat, hi_stat = torch.min, torch.max
    elif method == "percentile":
        _check_percentile(percentile)
        lo_stat = lambda t: _percentile(t, 100.0 - percentile)  # noqa: E731
        hi_stat = lambda t: _percentile(t, percentile)          # noqa: E731
    else:
        raise ValueError(f"unknown affine calibration method {method!r} "
                         "(expected 'minmax' or 'percentile')")

    def pick(node, inp, out):
        f = out.float()
        return lo_stat(f), hi_stat(f)

    agg: Dict[int, tuple] = {}
    for ranges in _run_stats(graph, params, batches, precision, pick):
        for i, (lo, hi) in ranges.items():
            plo, phi = agg.get(i, (np.inf, -np.inf))
            agg[i] = (min(plo, float(lo)), max(phi, float(hi)))
    scales: Dict[int, float] = {}
    zeros: Dict[int, int] = {}
    for i, (lo, hi) in agg.items():
        lo, hi = min(lo, 0.0), max(hi, 0.0)
        s = max(hi - lo, 1e-6) / 254.0
        scales[i] = s
        zeros[i] = int(np.clip(round(-127.0 - lo / s), -127, 127))
    return scales, zeros


def _input_scale(graph: Graph, node: Node, scales: Dict[int, float],
                 carrier: str) -> float:
    """The activation scale a quantized conv's input is rounded with:
    the PRODUCER tensor's scale on the int8 carrier, the conv's own
    per-conv scale on the float carrier."""
    return (scales[node.inputs[0]] if carrier == "int8"
            else scales[node.index])


def collect_input_stats(graph: Graph, params: TorchParams,
                        scales: Dict[int, float], conv_indices, batches,
                        carrier: str = "int8",
                        precision: Optional[str] = "bf16",
                        zeros: Optional[Dict[int, int]] = None
                        ) -> Dict[int, tuple]:
    """Per-channel input statistics for :func:`bias_correct`: for each conv
    in ``conv_indices``, ``(mu, eps)``, both (C_in,) float64: the mean of
    the conv's float input per channel over the calibration set, and the
    mean quantization residual ``x − dequant(quant(x))`` under the scale
    (and zero-point) the int8 pipeline rounds that input with. The stem's
    exact-u8 representation has scale 1/255 and no clipping."""
    wanted = frozenset(conv_indices)
    zof = ((lambda i: zeros.get(i, 0)) if zeros else (lambda i: 0))
    sums: Dict[int, list] = {}
    for x in batches:
        acc = {}

        def visit(node, inp, out):
            if node.kind != "convolutional" or node.index not in wanted:
                return
            f = inp.float()
            if node.inputs[0] < 0:  # stem: exact-u8 scheme
                deq = torch.round(f * 255.0) * (1.0 / 255.0)
            else:
                s = float(np.float32(_input_scale(graph, node, scales, carrier)))
                z = zof(node.inputs[0]) if carrier == "int8" else 0
                deq = _dequantize_affine(_quantize_affine(f, s, z), s, z)
            acc[node.index] = (f.sum(dim=(0, 2, 3)), (f - deq).sum(dim=(0, 2, 3)),
                               f.shape[0] * f.shape[2] * f.shape[3])

        _calibration_walk(graph, params, _as_batch(x, params), precision, visit)
        for i, (s_in, s_res, n) in acc.items():
            mu_s, eps_s, cnt = sums.get(i, (0.0, 0.0, 0.0))
            sums[i] = [mu_s + s_in.cpu().numpy().astype(np.float64),
                       eps_s + s_res.cpu().numpy().astype(np.float64),
                       cnt + float(n)]
    return {i: (mu_s / cnt, eps_s / cnt) for i, (mu_s, eps_s, cnt)
            in sums.items()}


def bias_correct(graph: Graph, params: TorchParams, qparams: QParams,
                 scales: Dict[int, float], batches, carrier: str = "int8",
                 precision: Optional[str] = "bf16",
                 zeros: Optional[Dict[int, int]] = None) -> QParams:
    """DFQ-style post-training bias correction (Nagel et al., arXiv
    1906.04721 §4). Weight rounding replaces ``W`` with ``W̃ = sw·wq`` and
    input rounding replaces ``x`` with ``x̃ = x − ε``; per output channel

        E[Wx] − E[W̃x̃] ≈ Σ_taps (W − W̃)·μ  +  Σ_taps W̃·ε

    with ``μ, ε`` measured on the calibration set
    (:func:`collect_input_stats`). Folding that into the conv bias makes the
    int8 pre-activation mean match the float one: a host-side qparams
    rewrite in float64, no run-time cost. Returns a NEW qparams dict; only
    the ``"b"`` entries of quantized convs change."""
    idx = [n.index for n in graph.conv_nodes
           if "wq" in qparams.get(n.index, {})]
    stats = collect_input_stats(graph, params, scales, idx, batches,
                                carrier=carrier, precision=precision,
                                zeros=zeros)
    out = dict(qparams)
    for i in idx:
        qp = qparams[i]
        w = params[i]["w"].float().permute(2, 3, 1, 0).cpu().numpy().astype(np.float64)
        w_dq = (qp["wq"].cpu().numpy().astype(np.float64)
                * qp["sw"].cpu().numpy().astype(np.float64))  # over O
        mu, eps = stats[i]
        delta = (np.einsum("hwic,i->c", w - w_dq, mu)
                 + np.einsum("hwic,i->c", w_dq, eps))
        b = qp["b"].cpu().numpy().astype(np.float64) + delta
        out[i] = {**qp, "b": torch.from_numpy(b.astype(np.float32)).to(
            qp["b"].device)}
    return out

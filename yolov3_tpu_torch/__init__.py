"""yolov3_tpu_torch: the PyTorch + CUDA port of ``yolov3_tpu`` for NVIDIA Hopper.

Same Darknet ``.cfg`` → graph → folded ``.weights`` frontend as the JAX
package, the float32 / TF32 / bf16 forward pass on cuDNN convs, and the
hand-written CUDA kernels of the serving routes: packed and compact head
decode, K1 and K1c (``ops/cuda_decode.py``, ``csrc/decode_packed.cu``), the
head-conv-fused decode K4 (``csrc/decode_fused.cu``), the fused 3×3 conv K5
(``ops/cuda_conv.py``, ``csrc/conv3x3.cu``) and greedy class-aware
suppression K2 (``ops/cuda_nms.py``, ``csrc/nms_suppress.cu``), the full
decode K3 (``csrc/decode_full.cu``), and the int8 tier (``quant.py``:
``Darknet.quantize_int8``, the int8-carrier and bf16-carrier walks, exact
int8 convs in ``ops/int8_conv.py``) with the fused int8 residual block K6
(``ops/cuda_block.py``, ``csrc/block_int8.cu``). The entry points
(``detect_mixed``, ``PipelinedDetector``, image / directory / video / cam)
are in ``inference``, the CLI is ``python -m yolov3_tpu_torch``, the HTTP
server ``python -m yolov3_tpu_torch.serve``, the diagnostic tools and their
kernels ``tools/`` and ``ops/cuda_probe.py`` (``csrc/probe.cu``). Imports
``torch``, never ``jax``; the kernels build with ``nvcc`` at first use
(``ops/_build.py``), the C++ host loader with ``g++`` (``native.py``).
"""
from .config import parse_config, parse_config_text
from .graph import Graph, Node, load_graph, lower
from .inference import Detection, Detector, inference
from .model import (Darknet, forward, forward_compact, forward_features,
                    forward_packed, forward_packed_fused,
                    fused_heads_eligible)
from .weights import load_weights, params_from_jax, quant_state_from_jax

__version__ = "0.1.0"

__all__ = [
    "parse_config", "parse_config_text", "Graph", "Node", "load_graph",
    "lower", "Darknet", "forward", "forward_compact", "forward_features",
    "forward_packed", "forward_packed_fused", "fused_heads_eligible",
    "Detection",
    "Detector", "inference", "load_weights", "params_from_jax",
    "quant_state_from_jax", "__version__",
]

"""yolov3_tpu_torch: the PyTorch + CUDA port of ``yolov3_tpu`` for NVIDIA Hopper.

Same Darknet ``.cfg`` → graph → folded ``.weights`` frontend as the JAX
package, a float forward pass on cuDNN convs, and the serving path's two
hand-written CUDA kernels: the packed head decode (``ops/cuda_decode.py``,
``csrc/decode_packed.cu``) and greedy class-aware suppression
(``ops/cuda_nms.py``, ``csrc/nms_suppress.cu``). Imports ``torch``, never
``jax``; the kernels build with ``nvcc`` at first use (``ops/_build.py``).
"""
from .config import parse_config, parse_config_text
from .graph import Graph, Node, load_graph, lower
from .inference import Detection, Detector, inference
from .model import Darknet, forward_features, forward_packed
from .weights import load_weights, params_from_jax

__version__ = "0.1.0"

__all__ = [
    "parse_config", "parse_config_text", "Graph", "Node", "load_graph",
    "lower", "Darknet", "forward_features", "forward_packed", "Detection",
    "Detector", "inference", "load_weights", "params_from_jax",
    "__version__",
]

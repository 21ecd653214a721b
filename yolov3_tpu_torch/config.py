"""Darknet ``.cfg`` parser.

Parses the INI-like Darknet config format into an ordered list of block dicts —
the same surface as the reference's ``yolov3/darknet.py::parse_config``
(SURVEY.md §2.1): ``[net]``, ``[convolutional]``, ``[shortcut]``, ``[route]``,
``[upsample]``, ``[maxpool]``, ``[yolo]`` sections; comma-separated lists
(``layers``, ``anchors``, ``mask``, ``steps``, ``scales``) split and coerced;
scalar values coerced to int/float where possible.

Host-side, stdlib-only; runs once at model-build time.

This module is a copy of ``yolov3_tpu/config.py``: importing that package
pulls in JAX (``yolov3_tpu/__init__.py`` imports the model), and the port
must not. ``tests/test_torch_frontend.py`` holds the copy equal to the
original.
"""
from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, List, Union

# Keys whose values are comma-separated lists in standard Darknet cfgs.
_LIST_KEYS = {"layers", "anchors", "mask", "steps", "scales"}

Block = Dict[str, Any]


def _coerce_scalar(value: str) -> Union[int, float, str]:
    try:
        return int(value)
    except ValueError:
        pass
    try:
        return float(value)
    except ValueError:
        pass
    return value


def _coerce(key: str, value: str) -> Any:
    if key in _LIST_KEYS:
        items = [v.strip() for v in value.split(",") if v.strip() != ""]
        return [_coerce_scalar(v) for v in items]
    return _coerce_scalar(value)


def parse_config_text(text: str) -> List[Block]:
    """Parse cfg text into an ordered list of block dicts.

    Each block has a ``"type"`` key (section name) plus its key/value options.
    The first block is normally ``[net]``.
    """
    blocks: List[Block] = []
    current: Block | None = None
    text = text.lstrip("\ufeff")  # Windows-edited cfgs ship a BOM
    for raw_line in text.splitlines():
        line = raw_line.strip()
        if not line or line.startswith(("#", ";")):
            continue
        if line.startswith("["):
            if not line.endswith("]"):
                raise ValueError(f"malformed section header: {raw_line!r}")
            current = {"type": line[1:-1].strip().lower()}
            blocks.append(current)
            continue
        if current is None:
            raise ValueError(f"option outside any section: {raw_line!r}")
        if "=" not in line:
            raise ValueError(f"malformed option line: {raw_line!r}")
        key, _, value = line.partition("=")
        key = key.strip().replace(" ", "")
        # strip trailing inline comments
        value = value.split("#", 1)[0].strip()
        current[key] = _coerce(key, value)
    if not blocks:
        raise ValueError("empty config")
    return blocks


def parse_config(path: Union[str, Path]) -> List[Block]:
    """Parse a Darknet ``.cfg`` file into a list of block dicts."""
    return parse_config_text(Path(path).read_text())


def net_options(blocks: List[Block]) -> Block:
    """Return the ``[net]`` block (input width/height/channels live here)."""
    if blocks and blocks[0]["type"] in ("net", "network"):
        return blocks[0]
    raise ValueError("config does not start with a [net] section")


def layer_blocks(blocks: List[Block]) -> List[Block]:
    """Return the layer blocks (everything after ``[net]``), index 0-based
    exactly as Darknet numbers layers."""
    return [b for b in blocks if b["type"] not in ("net", "network")]

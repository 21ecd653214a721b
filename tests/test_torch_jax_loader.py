"""The JAX package's C++ host loader (``yolov3_tpu.native``) built into a
private path for the port's tests that hold the port's loader to it.

The JAX loader builds, at first use, into ONE file next to its source and
remembers a failed load for the life of the process. Test processes that
start at once race into that file, and one that opens it half written
fails every later test of its module. :func:`private_jax_loader` points the
loader at a library of the caller's own directory for the span of a block
and restores the loader's path and cached state after it; nothing of the
JAX package changes."""
import contextlib
from pathlib import Path

import numpy as np
import pytest

from yolov3_tpu import native as jnative


@contextlib.contextmanager
def private_jax_loader(directory: Path):
    """Inside the block ``yolov3_tpu.native`` builds (g++) and loads its
    library at ``directory / "libpreproc.so"``; its ``_SO``, ``_lib`` and
    ``_tried`` are restored when the block ends."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jnative, "_SO", Path(directory) / "libpreproc.so")
        mp.setattr(jnative, "_lib", None)
        mp.setattr(jnative, "_tried", False)
        yield jnative


def test_private_build_lands_in_its_directory_and_runs(tmp_path):
    with private_jax_loader(tmp_path) as loader:
        assert loader.available()
        assert (tmp_path / "libpreproc.so").is_file()
        frame = np.random.default_rng(0).integers(0, 256, (1, 30, 40, 3),
                                                  dtype=np.uint8)
        out = loader.letterbox_batch_native(frame, (32, 32))
        assert out.shape == (1, 32, 32, 3) and out.dtype == np.uint8


def test_loader_state_restored_after_the_block(tmp_path):
    before = (jnative._SO, jnative._lib, jnative._tried)
    with private_jax_loader(tmp_path):
        assert jnative._SO == tmp_path / "libpreproc.so"
        assert jnative._lib is None and jnative._tried is False
        jnative.available()
    assert (jnative._SO, jnative._lib, jnative._tried) == before

"""Diagnostic tools of the port, each runnable on the card as
``python -m yolov3_tpu_torch.tools.<name>``: ``probe_block`` (the fused
residual block's ingredients against exact host values), ``bench_int8_dot``
(int8 tensor-core and ``__dp4a`` dots at the block's shapes) and
``bench_dot`` (what off-size M and K cost a bf16 dot)."""

"""Tools of the port, each runnable as ``python -m
yolov3_tpu_torch.tools.<name>``.

On the card, or on the CPU with ``--device cpu`` (there the checks run and
the timings are "not measured"): ``eval_coco`` (COCO mAP of a Detector run,
or offline of a results file), ``gen_eval_golden`` (the accuracy fixture
regenerated through the port), ``gen_golden`` (the three golden fixtures
regenerated into ``--out`` and held to the frozen ones), ``probe_quant_error``
(the int8 error budget: one factor fake-quantized at a time, scored on
``eval_golden.json``), ``bench_serve`` (the HTTP server under load: latency
percentiles, req/s, batch fill, device-busy share), ``bench_scan``
(``Detector(scan=k)`` throughput, scanned held to unscanned bit for bit),
``bench_tiny_k`` (the NMS working-set sweep and its truncation audit),
``bench_stem`` (the stem naive against its space-to-depth forms),
``traffic_model`` (per-stage byte and MAC floors at the card's peaks, the
one home of those peaks, beside the profilers' measured marks), the
selection-stage microbenches ``bench_topk`` (the reference's three
``bench_topk*`` tools as one), ``bench_select_group`` and ``bench_gather``;
``gen_cfgs`` (the ``models/*.cfg`` generator) and ``torch_ref`` (the
module-list PyTorch oracle) run anywhere. On the card only:
``profile_layers`` (device time of each prefix of the float walk, cuDNN or
K5 convs), ``profile_int8`` (the int8 serving path stage by stage),
``probe_block`` (the fused residual block's ingredients against exact host
values), ``bench_int8_dot`` (int8 tensor-core and ``__dp4a`` dots at the
block's shapes), ``bench_dot`` (what off-size M and K cost a bf16 dot),
``ablate_block`` and ``ablate_phases`` (kernels rebuilt with a part taken
out)."""

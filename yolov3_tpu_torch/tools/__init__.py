"""Tools of the port, each runnable as ``python -m
yolov3_tpu_torch.tools.<name>``: ``eval_coco`` (COCO mAP of a Detector run,
or offline of a results file) and ``gen_eval_golden`` (the accuracy
fixture regenerated through the port), both on the card or with
``--device cpu``; on the card only, ``profile_layers`` (device time of each
prefix of the float walk, cuDNN or K5 convs), ``profile_int8`` (the int8
serving path stage by stage), ``probe_block`` (the fused residual block's
ingredients against exact host values), ``bench_int8_dot`` (int8
tensor-core and ``__dp4a`` dots at the block's shapes), ``bench_dot`` (what
off-size M and K cost a bf16 dot), ``ablate_block`` and ``ablate_phases``
(kernels rebuilt with a part taken out)."""

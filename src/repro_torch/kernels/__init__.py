"""Hand-written Hopper kernels of the port, their plain PyTorch
versions (``ref``), the ctypes build (``build``) and the wrappers (``ops``).

  l2_rows          fused id->row gather + squared L2 (temp lanes, rerank,
                   insert search)
  adc_rows         fused id->code gather + PQ ADC (LTI lane navigation)
  frontier_select  one beam-search round step (every IO round)
  robust_prune_fp  Algorithm 3's R rounds, full precision (build, insert,
                   back-edge Delta)
  robust_prune_sdc the same rounds with SDC cover from PQ codes (merge
                   insert and Patch phases, ``use_sdc``)
  delete_repair_fp Algorithm 4 per node, gathers fused: candidate
                   assembly, the prune rounds, the changed-row select
                   (merge Delete phase, ``consolidate``)
  delete_repair_sdc the same with SDC distances and a capped expansion
  gather_rows      the row gather table[ids], INVALID rows for ids < 0
                   (``storage.HBMSource``, the device-resident graph source)
  block_topk       the stable smallest-k of each row with its ids (the
                   cross-shard merge of ``launch.ann_steps``)
"""

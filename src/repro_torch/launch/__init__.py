"""repro_torch.launch — launchers (counterpart of `repro.launch`):

  serve_graphs   synthetic traffic over the paper-suite generators through
                 `serve_mis.MISService`
  serve          LM serving: prefill a batch of prompts, then decode with a
                 KV cache, on `small_variant` of an arch's config
  train          LM training: `main` steps an arch (`small_variant` or its
                 full config) through the TrainLoop
  dryrun         every (arch × shape × mesh) cell of `configs.REGISTRY`
                 built on fake tensors as rank 0 of a fake 256- or 512-rank
                 group and run once under `perf.counting.CountingMode`:
                 memory per device, FLOPs, bytes, collectives, roofline

`mesh` has no counterpart: a `torch.distributed` group is its caller's,
given its address, world size and rank (the dry run's production meshes
live in `dryrun`).
"""

"""repro_torch.launch — launchers (counterpart of `repro.launch`):

  serve_graphs   synthetic traffic over the paper-suite generators through
                 `serve_mis.MISService`
  serve          LM serving: prefill a batch of prompts, then decode with a
                 KV cache, on `small_variant` of an arch's config
  train          `small_variant` only; the LM training launcher's `main`
                 waits for the LM's training slice (ROADMAP.md, Queue 1
                 item 19)

`dryrun` lowers cells through XLA and waits with the cost model's XLA
terms (item 17).  `mesh` has no counterpart: a `torch.distributed` group
is its caller's, given its address, world size and rank.
"""

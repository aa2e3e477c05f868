"""repro_torch.launch — launchers (counterpart of `repro.launch`):

  serve_graphs   synthetic traffic over the paper-suite generators through
                 `serve_mis.MISService`

The reference's LM `serve`, `train`, `dryrun` and `mesh` launchers are not
ported yet (ROADMAP.md, Queue 1 items 16 and 19).
"""

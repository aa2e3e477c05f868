"""Models of the port (counterpart of `repro.models`): DeepFM, the GNN
family (`gnn`) and the LM family (`lm_config`, `attention`, `moe`,
`transformer`)."""

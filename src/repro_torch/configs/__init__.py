"""Model configurations and their serve steps (counterpart of
`repro.configs`, without the mesh and `Cell` machinery)."""

"""Models of the port (counterpart of `repro.models`): DeepFM for now."""

"""Synthetic data streams (counterpart of `repro.data`)."""

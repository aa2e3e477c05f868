"""Shared GNN substrate (counterpart of `repro.models.gnn`): the MLP for now."""

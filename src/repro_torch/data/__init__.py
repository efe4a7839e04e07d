"""Synthetic federated datasets (numpy, shared with the reference)."""

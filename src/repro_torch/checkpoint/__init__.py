"""Checkpointing of trees of tensors and the resumable round loop."""

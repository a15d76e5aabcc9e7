"""End-to-end pipeline, batched serving and command line."""

from .batch import BatchItem, run_batch

__all__ = ["BatchItem", "run_batch"]

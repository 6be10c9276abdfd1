"""Synthetic token data of the port (counterpart of ``repro.data``)."""
from .pipeline import SyntheticCorpus

__all__ = ["SyntheticCorpus"]

"""Synthetic token data of the port (counterpart of ``repro.data``)."""
from .pipeline import DataLoader, SyntheticCorpus, make_passkey_sample

__all__ = ["DataLoader", "SyntheticCorpus", "make_passkey_sample"]

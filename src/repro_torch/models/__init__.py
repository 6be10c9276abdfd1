"""Dense decoder, attention and decode backends of the port (counterpart of
``repro.models``)."""

"""Cache, quantization and segment math of the port (counterpart of
``repro.core``)."""

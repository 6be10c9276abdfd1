"""The benchmark's own machinery: finding a cell's files by name, making
its inputs from the seed, tracing, and printing the result line.

Nothing here imports the JAX package.  Only :mod:`harness.program`
imports the port (``repro_torch``), the system under test."""

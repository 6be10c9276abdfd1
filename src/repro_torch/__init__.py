"""PyTorch + CUDA port of the SKVQ reproduction, for NVIDIA Hopper (H100).

The JAX package ``repro`` is the reference; this package mirrors its tree
(``core/``, ``models/``, ``kernels/``, ``serving/``, ``launch/``,
``configs/``) so each module has a findable counterpart.  It imports
``torch`` and numpy only — never ``jax`` and nothing from ``repro``.

Every entry point takes an explicit ``device``; the default is CUDA and an
entry point raises when no card is present unless the caller passes
``device="cpu"`` (see :mod:`repro_torch.device`).  On CUDA tensors the two
hand-written kernels (``csrc/kv_quant.cu``, ``csrc/decode_attn.cu``) run;
on CPU tensors their plain PyTorch versions do.
"""

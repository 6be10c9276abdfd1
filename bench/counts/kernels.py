"""Which device operation belongs to which layer, by kernel name.

* ``decode_attn``: the port's split kernel and its merge
  (``csrc/decode_attn.cu``);
* ``kv_append``: the fused decode append (``csrc/kv_quant.cu``);
* ``gemm``: cuBLAS / cuBLASLt / CUTLASS matrix products and their
  split-K reductions;
* ``glue``: every other kernel, copy and fill."""

DECODE_ATTN = ("decode_attn_split", "merge_splits")
KV_APPEND = ("kv_append_kernel",)
GEMM = ("gemm", "gemv", "nvjet", "cutlass", "xmma", "splitkreduce",
        "cublas")


def is_decode_attn(name: str) -> bool:
    return any(k in name for k in DECODE_ATTN)


def is_kv_append(name: str) -> bool:
    return any(k in name for k in KV_APPEND)


def is_gemm(name: str) -> bool:
    low = name.lower()
    return any(k in low for k in GEMM)


def is_glue(name: str) -> bool:
    return not (is_decode_attn(name) or is_kv_append(name) or is_gemm(name))

"""Fixed counts of the algorithm's work, from a configuration file's
numbers and each slot's live length: never from what the program runs,
so a program that drops work moves the time and leaves the count.

* :func:`token_flops`: one token's model FLOPs at a context length.
  Matrix products count 2 FLOPs a multiply-add over the ACTIVE
  parameters (an MoE layer: the router, ``top_k`` routed experts and the
  shared ones; never a dispatch's padded capacity), the output head
  included, the embedding lookup not; attention counts ``4 * Hq * D``
  a key (scores and the weighted sum) over every key the token attends.
* :func:`decode_attn_bytes` / :func:`decode_attn_flops`: what the decode
  kernel must read and compute for one layer and slot: every live packed
  token's K and V codes and metadata, the query in (bf16) and the
  partial out (f32 numerator, max and sum), written once; ``4 * Hq * D``
  a live packed token.  The SKVQ plane layout is written out here
  (:func:`planes`), not imported."""
from __future__ import annotations

from typing import List, Sequence, Tuple


def planes(d: int, bits: float, group: int) -> List[Tuple[int, int, int]]:
    """(width, bits, group) of each packed plane of one head: a fractional
    width is two planes, 1.5 -> half the channels at 2 bits and half at 1
    (the upper part's width rounded down to a multiple of 8), 3 -> 4 and
    2; a group never exceeds its plane."""
    split = {1.5: (2, 1), 3.0: (4, 2)}
    if bits in split:
        hi = max(int(d * 0.5) - int(d * 0.5) % 8, 8)
        (b_hi, b_lo) = split[bits]
        return [(hi, b_hi, min(group, hi)), (d - hi, b_lo, min(group, d - hi))]
    return [(d, int(bits), min(group, d))]


def packed_bytes_per_token_head(d: int, policy: dict) -> int:
    """Bytes of one token and kv head of the packed K and V: codes plus a
    scale and a zero a group (1 byte each in fp8, 2 in fp16)."""
    meta = 1 if policy.get("fp8_meta", True) else 2
    total = 0
    for bits in (policy["bits_k"], policy["bits_v"]):
        for width, b, g in planes(d, bits, policy["group_size"]):
            total += width * b // 8 + 2 * (width // g) * meta
    return total


def packed_live(length: int, policy: dict) -> int:
    """Tokens of a slot of ``length`` that sit in the packed region (past
    the sinks, before the fp window)."""
    return max(0, length - policy["n_sink"] - policy["window"])


def active_params(cfg: dict) -> int:
    """Matrix-product parameters one token passes through."""
    d, hq, hkv, hd = (cfg["hidden_size"], cfg["num_attention_heads"],
                      cfg["num_key_value_heads"], cfg["head_dim"])
    attn = d * hq * hd * 2 + d * hkv * hd * 2
    n = cfg["num_hidden_layers"]
    dense_mlp = 3 * d * cfg["intermediate_size"]
    if cfg.get("n_routed_experts"):
        nf = cfg["first_k_dense_replace"]
        fe = cfg["moe_intermediate_size"]
        moe = (d * cfg["n_routed_experts"] +
               3 * d * fe * (cfg["num_experts_per_tok"] +
                             cfg["n_shared_experts"]))
        ffn = nf * dense_mlp + (n - nf) * moe
    else:
        ffn = n * dense_mlp
    return n * attn + ffn + d * cfg["vocab_size"]


def token_flops(cfg: dict, length: int) -> float:
    """Model FLOPs of one token that attends ``length`` keys a layer."""
    attn = 4 * cfg["num_attention_heads"] * cfg["head_dim"] * length
    return 2.0 * active_params(cfg) + cfg["num_hidden_layers"] * attn


def step_flops(cfg: dict, lengths: Sequence[int]) -> float:
    """A decode step's model FLOPs over its slots' lengths (keys attended,
    the step's own token included)."""
    return sum(token_flops(cfg, n) for n in lengths)


def decode_attn_bytes(cfg: dict, length: int) -> int:
    """Bytes the decode kernel needs for one layer and slot at ``length``."""
    pol, hq, d = cfg["policy"], cfg["num_attention_heads"], cfg["head_dim"]
    live = packed_live(length, pol)
    planes_b = live * cfg["num_key_value_heads"] * \
        packed_bytes_per_token_head(d, pol)
    return planes_b + hq * d * 2 + hq * d * 4 + 2 * hq * 4


def decode_attn_flops(cfg: dict, length: int) -> int:
    return 4 * cfg["num_attention_heads"] * cfg["head_dim"] * \
        packed_live(length, cfg["policy"])

"""Distribution substrate of the port (counterpart of
``repro.distributed``) on ``torch.distributed``: sharding rules and plans,
gradient compression with its int8 wire, the GPipe pipeline."""
from .sharding import (logical, use_sharding, current_rules, ShardingCtx,
                       TRAIN_RULES, SERVE_RULES, param_partition_specs)

__all__ = ["logical", "use_sharding", "current_rules", "ShardingCtx",
           "TRAIN_RULES", "SERVE_RULES", "param_partition_specs"]

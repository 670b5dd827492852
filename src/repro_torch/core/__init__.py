from repro_torch.core import (
    agg_engine,
    aggregation,
    cost_model,
    fedavg,
    sharded_tree,
    sharding,
    topology,
    wire_codec,
)

__all__ = ["agg_engine", "aggregation", "cost_model", "fedavg",
           "sharded_tree", "sharding", "topology", "wire_codec"]

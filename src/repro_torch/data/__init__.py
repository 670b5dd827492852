from repro_torch.data.partition import (
    client_label_histogram,
    dirichlet_partition,
    iid_partition,
)
from repro_torch.data.synthetic import (
    SyntheticLM,
    SyntheticVision,
    lm_batch_specs,
)

__all__ = ["SyntheticLM", "SyntheticVision", "client_label_histogram",
           "dirichlet_partition", "iid_partition", "lm_batch_specs"]

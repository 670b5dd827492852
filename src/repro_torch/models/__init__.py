"""The port's model zoo: the dense decoder LM (``transformer``), its
layers and the uniform ``registry`` API."""
from repro_torch.models import registry

param_count = registry.param_count
init_params = registry.init_params
loss_fn = registry.loss_fn
forward = registry.forward

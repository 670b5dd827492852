"""The port's model zoo: the decoder LM families (``transformer``, with
``moe`` and ``ssm``), the encoder-decoder backbone (``encdec``), the
federated CNN (``cnn``), their layers and the uniform ``registry`` API."""
from repro_torch.models import registry

param_count = registry.param_count
active_param_count = registry.active_param_count
param_specs = registry.param_specs
init_params = registry.init_params
loss_fn = registry.loss_fn
forward = registry.forward
decode_step = registry.decode_step
cache_specs = registry.cache_specs
init_cache = registry.init_cache
input_specs = registry.input_specs
model_flops = registry.model_flops

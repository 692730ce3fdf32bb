"""The model stack of the port: the decoder LM (``model.py``), its layers
(``layers.py``), the MoE MLP (``moe.py``) and the Mamba mixer
(``ssm.py``)."""
from repro_torch.models.layers import CallConfig  # noqa: F401
from repro_torch.models.model import (  # noqa: F401
    forward_decode, forward_train, init_cache, init_params, loss_fn,
    param_count_actual,
)

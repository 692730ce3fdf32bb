"""The training path on the card: the hand-written kernels' routes refuse
autograd there too (the CUDA kernels return tensors autograd does not
track, so a backward through them would drop gradients without a word),
and a few steps of ``make_train_step`` on the card agree with the same
steps on the CPU. Skips without a CUDA device; run it on the card with

    PYTHONPATH=src python -m pytest -q --noconftest <this file>

(``--noconftest``: tests/conftest.py imports the JAX package.)
"""
import copy

import pytest
import torch

pytestmark = pytest.mark.cuda


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")


@pytest.mark.parametrize("route", ["attention", "norm", "scan"])
def test_kernel_routes_refuse_autograd_on_card(route):
    _need_card()
    from repro_torch.configs import get_config
    from repro_torch.models import CallConfig, init_params, loss_fn, ssm
    arch = "jamba-1.5-large-398b" if route == "scan" else "smollm-135m"
    cfg = get_config(arch).reduced()
    params = init_params(cfg, 0, device="cuda")
    tokens = torch.zeros((1, 16), dtype=torch.long, device="cuda")
    with pytest.raises(NotImplementedError, match="no backward"):
        if route == "scan":
            x = torch.randn((1, 16, cfg.d_model), device="cuda")
            ssm.mamba_forward(params.layers[0].mixer, x, cfg=cfg,
                              use_kernel=True)
        else:
            kw = ({"attention_impl": "pallas"} if route == "attention"
                  else {"use_pallas_norm": True})
            loss_fn(params, cfg, CallConfig(compute_dtype=torch.float32,
                                            remat=False, **kw),
                    {"tokens": tokens, "labels": tokens})


def test_train_steps_card_matches_cpu():
    _need_card()
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import DataConfig, global_batch
    from repro_torch.distributed.steps import make_train_step
    from repro_torch.models import CallConfig, init_params
    from repro_torch.optim.adamw import AdamWConfig, init_opt_state
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("smollm-135m").reduced()
    opt = AdamWConfig(lr=1e-3, warmup_steps=20)
    step = make_train_step(cfg, CallConfig(compute_dtype=torch.float32,
                                           attention_impl="dense",
                                           remat=False), opt)
    cpu = init_params(cfg, 0, device="cpu")
    card = copy.deepcopy(cpu).cuda()
    st_cpu, st_card = init_opt_state(opt, cpu), init_opt_state(opt, card)
    shape = ShapeConfig("t", "train", 32, 4)
    for i in range(3):
        b = global_batch(cfg, shape, DataConfig(), i, device="cpu")
        cpu, st_cpu, m_cpu = step(cpu, st_cpu, b)
        card, st_card, m_card = step(card, st_card,
                                     {k: v.cuda() for k, v in b.items()})
        assert abs(m_card["loss"].item() - m_cpu["loss"].item()) \
            <= 1e-5 * abs(m_cpu["loss"].item())

"""The training path on the card: the hand-written kernels' routes refuse
autograd there too (the CUDA kernels return tensors autograd does not
track, so a backward through them would drop gradients without a word),
and a few steps of ``make_train_step`` on the card agree with the same
steps on the CPU (reduced smollm-135m, xlstm-1.3b and
llama-3.2-vision-11b, whose batches carry the stub memory). Skips
without a CUDA device; run it on the card with

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


@pytest.mark.parametrize("arch", ["smollm-135m", "xlstm-1.3b",
                                  "llama-3.2-vision-11b"])
def test_train_steps_card_matches_cpu(arch):
    _need_card()
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import DataConfig, global_batch
    from repro_torch.distributed.steps import make_train_step
    from repro_torch.models import CallConfig, init_params
    from repro_torch.optim.adamw import AdamWConfig, init_opt_state
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(arch).reduced()
    opt = AdamWConfig(lr=1e-3, warmup_steps=20)
    step = make_train_step(cfg, CallConfig(compute_dtype=torch.float32,
                                           attention_impl="dense",
                                           remat=False), opt)
    cpu = init_params(cfg, 0, device="cpu")
    card = copy.deepcopy(cpu).cuda()
    # the same steps on the CPU with every embedding entry one ulp off:
    # xLSTM's losses move by rounding alone (chip_smoke.py phases 17, 19),
    # so its limit is 4x that move where that is above 1e-5
    nud = copy.deepcopy(cpu)
    e = nud.embed.data
    up = torch.rand(e.shape, generator=torch.Generator().manual_seed(7)) < 0.5
    nud.embed.data = torch.nextafter(
        e, torch.where(up, float("inf"), float("-inf")).to(e.dtype))
    st_cpu, st_card, st_nud = (init_opt_state(opt, m)
                               for m in (cpu, card, nud))
    shape = ShapeConfig("t", "train", 32, 4)
    rels, nud_rels = [], []
    for i in range(3):
        b = global_batch(cfg, shape, DataConfig(), i, device="cpu")
        cpu, st_cpu, m_cpu = step(cpu, st_cpu, b)
        nud, st_nud, m_nud = step(nud, st_nud, b)
        card, st_card, m_card = step(card, st_card,
                                     {k: v.cuda() for k, v in b.items()})
        lc = m_cpu["loss"].item()
        rels.append(abs(m_card["loss"].item() - lc) / abs(lc))
        nud_rels.append(abs(m_nud["loss"].item() - lc) / abs(lc))
    limit = 1e-5
    if arch == "xlstm-1.3b":
        limit = max(limit, 4 * max(nud_rels))
    assert max(rels) <= limit, (rels, nud_rels)

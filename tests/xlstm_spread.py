"""How far float32 rounding alone moves xlstm-1.3b's logits, in the JAX
reference and in the port, on the CPU: both packages run the reference's
weights on the same tokens, once as drawn and once with every embedding
entry moved one ulp up or down at random. Prints, per seed, the largest
logit, each package's one-ulp spread (max and mean abs change of the
logits) and the port against the reference (max and mean abs).

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/xlstm_spread.py \\
        [--full-width] [--depth 8] [--batch 2] [--seq 32] [--seeds 0 1 2]

The default is the reduced config the parity tests use
(tests/test_torch_xlstm.py). ``--full-width`` keeps the published widths
(d 2048, 4 heads, dh 1024, chunk 128) and cuts the vocabulary to 2 048 so
that both packages' weights fit a few GB; depth must be a multiple of
the super-block (8).
"""
import argparse
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as jax_get_config
from repro.models import CallConfig as JaxCall
from repro.models import forward_train as jax_forward
from repro.models import init_params as jax_init_params
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.models import CallConfig, forward_train

ARCH = "xlstm-1.3b"


def _nudged(e: np.ndarray, seed: int) -> np.ndarray:
    up = np.random.RandomState(seed).random_sample(e.shape) < 0.5
    return np.nextafter(e, np.where(up, np.inf, -np.inf).astype(e.dtype))


def _stats(a, b) -> dict:
    d = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
    return {"max": float(d.max()), "mean": float(d.mean())}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--full-width", action="store_true")
    ap.add_argument("--depth", type=int, default=8)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=32)
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    args = ap.parse_args()
    jcfg, cfg = jax_get_config(ARCH), get_config(ARCH)
    if args.full_width:
        cut = dict(n_layers=args.depth, vocab=2048)
    else:
        jcfg, cfg = jcfg.reduced(), cfg.reduced()
        cut = dict(n_layers=args.depth)
    jcfg, cfg = (dataclasses.replace(jcfg, **cut),
                 dataclasses.replace(cfg, **cut))
    jcall = JaxCall(compute_dtype=jnp.float32, attention_impl="dense",
                    remat=False)
    call = CallConfig(compute_dtype=torch.float32, attention_impl="dense",
                      remat=False)
    for seed in args.seeds:
        jparams = jax.tree.map(np.asarray,
                               jax_init_params(jcfg, jax.random.PRNGKey(seed)))
        tokens = np.random.RandomState(seed).randint(
            0, cfg.vocab, (args.batch, args.seq))
        nudged = dict(jparams, embed=_nudged(jparams["embed"], 100 + seed))
        ref, ref_n = (np.asarray(jax_forward(p, jcfg, jcall, {
            "tokens": jnp.asarray(tokens)})[0]) for p in (jparams, nudged))
        port, port_n = [], []
        for p, out in ((jparams, port), (nudged, port_n)):
            params = convert.model_params_from_reference(p, cfg, device="cpu")
            with torch.no_grad():
                out.append(forward_train(params, cfg, call, {
                    "tokens": torch.from_numpy(tokens)})[0].numpy())
            del params
        print(json.dumps({
            "config": cfg.name, "d_model": cfg.d_model, "depth": cfg.n_layers,
            "tokens": [args.batch, args.seq], "seed": seed,
            "max_logit": float(np.abs(ref).max()),
            "reference_one_ulp_spread": _stats(ref_n, ref),
            "port_one_ulp_spread": _stats(port_n[0], port[0]),
            "port_vs_reference": _stats(port[0], ref)}), flush=True)


if __name__ == "__main__":
    main()

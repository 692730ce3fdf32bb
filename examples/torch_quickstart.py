"""Quickstart through the PyTorch port: train a reduced SmolLM, checkpoint,
resume, decode.

The counterpart of examples/quickstart.py, on the CUDA card by default
(``--device cpu`` runs the plain PyTorch path on the CPU):

  PYTHONPATH=src python examples/torch_quickstart.py
  PYTHONPATH=src python examples/torch_quickstart.py --device cpu
"""
import argparse
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.launch.serve import serve
from repro_torch.launch.train import train


def quickstart(steps: int = 60, resume_steps: int = 80, batch: int = 8,
               seq: int = 32, gen: int = 16, device=None) -> dict:
    """Train ``steps`` steps with a checkpoint every ``steps // 2``, train
    again from the newest committed checkpoint up to ``resume_steps``,
    then serve. Returns {"first": the first run's train() result,
    "resumed": the second's, "serve": serve()'s}."""
    with tempfile.TemporaryDirectory() as d:
        print("== train (reduced smollm-135m) ==")
        out = train("smollm-135m", steps=steps, batch=batch, seq=seq,
                    ckpt_dir=d, ckpt_every=steps // 2, lr=2e-3,
                    log_every=max(steps // 4, 1), device=device)
        print(f"loss: {out['losses'][0]:.3f} -> {out['losses'][-1]:.3f}")
        assert out["losses"][-1] < out["losses"][0]
        print("== resume from checkpoint ==")
        again = train("smollm-135m", steps=resume_steps, batch=batch,
                      seq=seq, ckpt_dir=d, ckpt_every=resume_steps // 2,
                      lr=2e-3, log_every=max(steps // 6, 1), device=device)
    print("== decode ==")
    served = serve("smollm-135m", batch=2, prompt_len=8, gen=gen,
                   device=device)
    return {"first": out, "resumed": again, "serve": served}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device to run on (default: the CUDA card; "
                         "'cpu' runs the plain PyTorch path)")
    args = ap.parse_args(argv)
    return quickstart(device=args.device)


if __name__ == "__main__":
    main()

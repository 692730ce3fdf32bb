"""Batched serving across modalities through the PyTorch port: a decoder
LM (qwen3-14b), an audio decoder over frame embeddings (musicgen-medium,
stub frontend) and a VLM with cross-attention memory
(llama-3.2-vision-11b), each at its reduced configuration.

The counterpart of examples/serve_batch.py, on the CUDA card by default
(``--device cpu`` runs the plain PyTorch path on the CPU):

  PYTHONPATH=src python examples/torch_serve_batch.py
  PYTHONPATH=src python examples/torch_serve_batch.py --device cpu
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.launch.serve import serve

ARCHS = ("qwen3-14b", "musicgen-medium", "llama-3.2-vision-11b")


def serve_batch(batch: int = 2, prompt_len: int = 8, gen: int = 12,
                device=None) -> dict:
    """serve() each of ARCHS. Returns {arch: serve()'s result}."""
    return {arch: serve(arch, batch=batch, prompt_len=prompt_len, gen=gen,
                        device=device)
            for arch in ARCHS}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device to run on (default: the CUDA card; "
                         "'cpu' runs the plain PyTorch path)")
    args = ap.parse_args(argv)
    return serve_batch(device=args.device)


if __name__ == "__main__":
    main()

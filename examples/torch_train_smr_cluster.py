"""Fault-tolerant multi-pod training through the PyTorch port — the
paper's technique as the training control plane: Mandator vector-clock
rounds + Sporades dual-mode commit + elastic rescale after a pod crash.

The counterpart of examples/train_smr_cluster.py, on the CUDA card by
default (``--device cpu`` runs the plain PyTorch path on the CPU; the
control plane runs on the host either way):

  PYTHONPATH=src python examples/torch_train_smr_cluster.py
  PYTHONPATH=src python examples/torch_train_smr_cluster.py --device cpu
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import numpy as np

from repro_torch.launch.train import train
from repro_torch.runtime.elastic import StragglerPolicy
from repro_torch.runtime.sporades_rt import SporadesRuntime


def train_smr_cluster(steps: int = 30, crash_at: int = 10, batch: int = 6,
                      seq: int = 32, commit_steps: int = 5,
                      device=None) -> dict:
    """Three pods, pod 2 crashing at step ``crash_at``; Sporades under a
    straggling leader for ``commit_steps`` steps; the straggler deadline
    policy. Returns {"train": train()'s result, "records": each step's
    commit record (None: not committed), "views": the view after each
    step, "quorum": (on-time pods, fallback)}."""
    print(f"== 3-pod training; pod 2 crashes at step {crash_at} "
          "(elastic replan) ==")
    out = train("smollm-135m", steps=steps, batch=batch, seq=seq, n_pods=3,
                crash_pod_at=crash_at, lr=2e-3, log_every=5, device=device)
    print(f"committed steps per controller: {out['commits']}")
    assert np.isfinite(out["losses"]).all()

    print("\n== Sporades commit under a straggling leader ==")
    s = SporadesRuntime(4, seed=1)
    s.set_straggler(s.leader(0))           # leader misses the deadline
    records, views = [], []
    for step in range(commit_steps):
        cuts = {i: np.full(4, step) for i in range(4)}
        rec = s.commit_step(cuts)
        records.append(rec)
        views.append(s.view)
        print(f" step {step}: commit={'-' if rec is None else rec.mode} "
              f"view={s.view}")

    print("\n== straggler deadline policy ==")
    pol = StragglerPolicy(deadline_ms=100)
    pods, fb = pol.decide({0: 20, 1: 35, 2: 48, 3: 900}, 4)
    print(f" on-time quorum {pods}, fallback={fb} "
          f"(pod 3 gradient dropped, update rescaled 4/3)")
    return {"train": out, "records": records, "views": views,
            "quorum": (pods, fb)}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device to run on (default: the CUDA card; "
                         "'cpu' runs the plain PyTorch path)")
    args = ap.parse_args(argv)
    return train_smr_cluster(device=args.device)


if __name__ == "__main__":
    main()

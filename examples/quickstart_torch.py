"""Quickstart: train a tiny llama-family model on synthetic data, checkpoint
it, and greedy-decode from the trained weights.  The PyTorch counterpart
of ``examples/quickstart.py``: its config, constants and lines, through
``repro_torch`` only.

  PYTHONPATH=src python examples/quickstart_torch.py
  PYTHONPATH=src python examples/quickstart_torch.py --device cpu

Runs on the card unless ``--device cpu``; without CUDA it raises
RuntimeError.
"""

import argparse
import tempfile
import time

import numpy as np

from repro_torch import serve
from repro_torch.configs import get_smoke_config
from repro_torch.models.model import resolve_device
from repro_torch.train.loop import TrainConfig, Trainer


def run(cfg, device, n_steps=60, checkpoint_every=20,
        max_new_tokens=8) -> dict:
    """Train ``cfg`` for ``n_steps`` (checkpoints every
    ``checkpoint_every`` into a temporary directory), print the loss
    curve, then serve the trained weights and print the ramp's
    continuation.  -> {"losses": the logged losses, "tokens": the
    continuation, "train_seconds": the wall seconds of ``Trainer.train``,
    checkpoints included}."""
    with tempfile.TemporaryDirectory() as ckpt_dir:
        tc = TrainConfig(seq_len=64, global_batch=8, n_steps=n_steps,
                         peak_lr=2e-3, warmup_steps=10,
                         checkpoint_dir=ckpt_dir,
                         checkpoint_every=checkpoint_every, log_every=10,
                         device=str(device))
        trainer = Trainer(cfg, tc)
        t0 = time.perf_counter()
        logs = trainer.train()
        train_seconds = time.perf_counter() - t0
        print("loss curve:", [round(m["loss"], 3) for m in logs])

        # one facade for all serving (DESIGN.md §11): connect with a
        # plan preset and generate from the trained weights, the
        # Trainer's fp32 tree in the layout Model.prepare_params takes
        client = serve.connect(cfg, "mpi_everywhere",
                               params=trainer.params, n_slots=2,
                               max_len=96, device=device)
        # the synthetic data follows tok_{t+1} = a*tok_t + ... — a trained
        # model should continue a ramp
        prompt = (np.arange(1, 17) * 3 % cfg.vocab).astype(np.int32)
        [tokens] = client.generate([prompt], max_new_tokens=max_new_tokens)
        print("prompt tail:", prompt[-4:].tolist(), "->", tokens)
    return {"losses": [m["loss"] for m in logs], "tokens": tokens,
            "train_seconds": train_seconds}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    return run(get_smoke_config("smollm-360m"), device)


if __name__ == "__main__":
    main()

"""End-to-end run of the PyTorch port: train a (reduced) qwen3-family
LM on a 2-pod cluster whose control plane is HT-Paxos, surviving a pod
crash (restores from a quorum-committed checkpoint) and a leader
failover. The twin of ``examples/train_smr_service.py``, with the same
flags and schedule; it runs on the CUDA card unless ``--device cpu`` is
given.

    PYTHONPATH=src python examples/torch_train_smr_service.py [--steps 200]
        [--device cpu]
"""
import argparse
import shutil
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.configs import registry  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.runtime.coordinator import (ServiceConfig,  # noqa: E402
                                             TrainingService)
from repro_torch.runtime.statemachine import Command  # noqa: E402
from repro_torch.train.optimizer import OptConfig  # noqa: E402
from repro_torch.train.trainer import (make_state,  # noqa: E402
                                       make_train_step, set_cublas_workspace)


def main(argv=None) -> TrainingService:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-14b")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--ckpt", default=str(Path(tempfile.gettempdir())
                                          / "repro_smr_ckpt"))
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card (raises without one)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    if dev.type == "cuda":    # before the first cuBLAS call of the process
        set_cublas_workspace()
    cfg = registry.get_smoke(args.arch)
    opt = OptConfig(kind="adamw", lr=1e-3)
    step = make_train_step(cfg, opt, microbatches=1, global_batch=8)

    def init_state():
        return make_state(cfg, opt, torch.Generator(dev).manual_seed(0), dev)

    shutil.rmtree(args.ckpt, ignore_errors=True)
    svc = TrainingService(ServiceConfig(n_pods=2, ckpt_dir=args.ckpt),
                          step, init_state)
    rng = np.random.default_rng(1)
    horizon = 0.0
    for i in range(args.steps):
        batch = {"tokens": torch.from_numpy(
            rng.integers(0, cfg.vocab, (8, 64)))}
        svc.submit_command(svc.submit_batch(batch))
        if (i + 1) % 50 == 0:
            svc.submit_command(Command("CKPT", i + 1))
        if i == args.steps // 3:
            print("!! crashing pod1")
            svc.run(until=(horizon := horizon + 400))
            svc.crash_pod("pod1")
        if i == args.steps // 2:
            print("!! crashing ordering leader", svc.leader_id())
            svc.run(until=(horizon := horizon + 400))
            svc.crash_leader()
        if i == 2 * args.steps // 3:
            svc.run(until=(horizon := horizon + 800))
            print("!! restarting pod1 from committed checkpoint")
            svc.restart_pod("pod1", template_state=init_state())
    svc.run(until=horizon + 60_000)

    for p, sm in svc.pods.items():
        losses = [m["loss"] for m in sm.metrics_log]
        print(f"{p}: step={sm.step} loss {losses[0]:.3f} -> "
              f"{losses[-1]:.3f} digest={sm.digest()}")
    print("pods bitwise consistent:", svc.consistent())
    print("ordering leader now:", svc.leader_id())
    return svc


if __name__ == "__main__":
    main()

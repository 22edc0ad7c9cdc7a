"""Training launcher: the fault-tolerant training loop on one card.

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3_8b --reduced --steps 20
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu --arch llama3_8b --reduced \\
        --steps 3 --optimizer ebv

The reference's flags, with ``--device`` in place of a device mesh:
``--devices`` and ``--mesh`` error (a mesh is ROADMAP A7).  Runs on the
card unless ``--device cpu`` is given; the weights are drawn on the device
from the seed 0.  With ``--ckpt-dir`` it saves every ``--ckpt-every``
steps and at the end, and resumes from the newest checkpoint there.
"""
import argparse


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3_8b")
    ap.add_argument("--reduced", action="store_true", help="CPU-scale config")
    ap.add_argument("--device", default=None, help="'cpu' to run on the CPU (default: the card)")
    ap.add_argument("--devices", type=int, default=0, help="a device mesh: not ported yet (ROADMAP A7)")
    ap.add_argument("--mesh", default="", help="a device mesh: not ported yet (ROADMAP A7)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--optimizer", choices=["adamw", "ebv"], default="adamw")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    args = ap.parse_args(argv)
    if args.devices or args.mesh:
        ap.error("--devices and --mesh (a device mesh) are not ported to repro_torch yet (ROADMAP A7)")

    from repro_torch import device as _device
    from repro_torch.configs.base import get_config
    from repro_torch.train.loop import TrainConfig, train

    dev = _device.resolve(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.replace(**{k: v for k, v in vars(cfg.reduced()).items() if k != "name"})
    tc = TrainConfig(
        steps=args.steps, seq_len=args.seq_len, global_batch=args.batch,
        microbatches=args.microbatches, learning_rate=args.lr,
        warmup_steps=max(args.steps // 10, 2), optimizer=args.optimizer,
        ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
    )
    train(cfg, tc, device=dev)


if __name__ == "__main__":
    main()

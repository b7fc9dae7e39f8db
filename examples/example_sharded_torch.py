"""Data-parallel GSM fit on the PyTorch port, one rank per device.

The port's counterpart of ``examples/example_sharded.py``: the Monte-Carlo
batch splits over a 1-D ``data`` mesh of ranks; every rank scores its own
rows, the rows are gathered, and the update runs on each rank (on the
card, the update kernel).

    python examples/example_sharded_torch.py              # every card here
    python examples/example_sharded_torch.py --cpu 4      # 4 gloo ranks
    torchrun --nproc_per_node=4 examples/example_sharded_torch.py
"""

import argparse
import os
import tempfile

import torch
import torch.distributed as dist

from gsmvi_tpu_torch import GSM
from gsmvi_tpu_torch.models import ill_conditioned_gaussian
from gsmvi_tpu_torch.parallel import initialize_distributed, make_mesh
from gsmvi_tpu_torch.parallel.distributed import launch


def fit(rank: int, world: int, store, device_type: str, niter: int) -> None:
    """One rank: start the group (torchrun's environment when ``store`` is
    None), fit, print on rank 0."""
    if store is None:
        initialize_distributed(auto=True)
    else:
        initialize_distributed(store, world, rank,
                               backend="nccl" if device_type == "cuda"
                               else "gloo")
    try:
        device = "cpu"
        if device_type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank)))
            device = f"cuda:{torch.cuda.current_device()}"
        world = dist.get_world_size()
        mesh = make_mesh(world, devices=device_type)
        d = 256
        target = ill_conditioned_gaussian(4, d, condition=1e4, device=device)
        gsm = GSM(d, target.lp, target.lp_g, device=device, mesh=mesh)
        mean, cov = gsm.fit(99, niter=niter, batch_size=16 * world,
                            nprint=5, verbose=dist.get_rank() == 0)
        if dist.get_rank() == 0:
            err_mean = float((mean - target.mean).abs().max())
            rel_cov = float((cov - target.cov).abs().max()
                            / target.cov.abs().max())
            print(f"ranks: {world} x {device_type}")
            print(f"max |mean error|     : {err_mean:.4f}")
            print(f"rel max |cov error|  : {rel_cov:.4f}")
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", type=int, default=0,
                    help="run this many gloo ranks on the CPU")
    ap.add_argument("--niter", type=int, default=2000)
    args = ap.parse_args()
    device_type = "cpu" if args.cpu else "cuda"
    if "RANK" in os.environ:
        fit(int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"]), None,
            device_type, args.niter)
    else:
        n = args.cpu or torch.cuda.device_count()
        with tempfile.TemporaryDirectory() as tmp:
            launch(fit, n, n, f"file://{tmp}/store", device_type, args.niter)

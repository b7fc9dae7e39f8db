"""Large-D GSM fit on the PyTorch port: a 2-D (data x model) mesh of ranks
with a column-sharded covariance.

The port's counterpart of ``examples/example_large_d.py``:

- the Monte-Carlo batch splits over the ``data`` axis (each rank scores
  its own rows);
- the (D, D) covariance and its Cholesky factor are split by columns over
  the ``model`` axis (``parallel.cov_sharding``), each rank holding a
  D x D/m panel;
- the validity and sampling factor is the blocked right-looking Cholesky
  (``chol_block=``) on those panels: the O(D^3) trailing updates stay on
  each rank's columns, and only b-wide block columns cross ranks.

    python examples/example_large_d_torch.py              # every card here
    python examples/example_large_d_torch.py --cpu 4      # 4 gloo ranks
    torchrun --nproc_per_node=4 examples/example_large_d_torch.py
"""

import argparse
import os
import tempfile

import torch
import torch.distributed as dist

from gsmvi_tpu_torch import GSM
from gsmvi_tpu_torch.models import dense_gaussian
from gsmvi_tpu_torch.parallel import (cov_sharding, initialize_distributed,
                                      make_mesh_2d)
from gsmvi_tpu_torch.parallel.distributed import launch

D, B, NITER, CHOL_BLOCK = 512, 32, 4000, 128


def mesh_shape(n: int) -> tuple:
    """(data, model): four ranks on the model axis when there are eight or
    more, as the JAX example splits its devices."""
    n_model = 4 if n >= 8 else max(1, n // 2)
    return max(1, n // n_model), n_model


def fit(rank: int, world: int, store, device_type: str, niter: int) -> None:
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
        n_data, n_model = mesh_shape(dist.get_world_size())
        mesh = make_mesh_2d(n_data, n_model, devices=device_type)
        target = dense_gaussian(4, D, device=device)
        gsm = GSM(D, target.lp, target.lp_g, device=device, mesh=mesh,
                  cov_sharding=cov_sharding(mesh), chol_block=CHOL_BLOCK)
        mean, cov = gsm.fit(0, niter=niter, batch_size=B, nprint=4,
                            verbose=dist.get_rank() == 0)
        cov = cov.full_tensor()
        if dist.get_rank() == 0:
            mean_err = float((mean - target.mean).abs().max())
            cov_err = float((cov - target.cov).abs().max()
                            / target.cov.abs().max())
            print(f"mesh (data={n_data}, model={n_model}) x {device_type}")
            print(f"max |mean error|    : {mean_err:.4f}")
            print(f"rel max |cov error| : {cov_err:.4f}")
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", type=int, default=0,
                    help="run this many gloo ranks on the CPU")
    ap.add_argument("--niter", type=int, default=NITER)
    args = ap.parse_args()
    device_type = "cpu" if args.cpu else "cuda"
    if "RANK" in os.environ:
        fit(int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"]), None,
            device_type, args.niter)
    else:
        n = args.cpu or torch.cuda.device_count()
        with tempfile.TemporaryDirectory() as tmp:
            launch(fit, n, n, f"file://{tmp}/store", device_type, args.niter)

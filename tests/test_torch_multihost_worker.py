"""Worker of tests/test_torch_multihost.py (run as a subprocess): the port's
counterpart of tests/multihost_worker.py. It imports only numpy, torch and
mmlspark_tpu_torch.

`initialize_runtime` joins the processes through the TCP coordinator that
COORDINATOR_ADDRESS names (WORLD_SIZE and RANK give the rest, as torchrun
sets them), a psum crosses the process boundary, and a GBDT fit over the
2-process mesh must equal the same fit in one process.
"""

import hashlib
import sys

import numpy as np
import torch


def main() -> None:
    torch.set_num_threads(1)
    from mmlspark_tpu_torch.core import Table
    from mmlspark_tpu_torch.gbdt import GBDTClassifier
    from mmlspark_tpu_torch.parallel import collectives, get_mesh, initialize_runtime, use_mesh

    # the one-process fit first, before the process group exists
    rng = np.random.default_rng(0)           # identical data on every rank
    x = rng.normal(size=(256, 6))
    yl = x[:, 0] - 0.5 * x[:, 1] + 0.2 * rng.normal(size=256) > 0
    tbl = Table({"features": x, "label": yl.astype(np.float64)})
    single = GBDTClassifier(num_iterations=2, num_leaves=7, device="cpu").fit(tbl)

    initialize_runtime(backend="gloo", timeout_s=60)
    import torch.distributed as dist

    mesh = get_mesh()
    rank = dist.get_rank()
    total = collectives.psum(torch.tensor([float(rank + 1)]), mesh)
    with use_mesh(mesh):
        dist_model = GBDTClassifier(num_iterations=2, num_leaves=7, use_mesh=True,
                                    device="cpu").fit(tbl)
    text = dist_model.booster.to_text()
    print(f"RESULT rank={rank} world={dist.get_world_size()} shards={mesh.size} "
          f"shard={mesh.shard_index} psum={float(total[0])} "
          f"equal_local={int(text == single.booster.to_text())} "
          f"model_hash={hashlib.sha256(text.encode()).hexdigest()[:16]}", flush=True)
    dist.destroy_process_group()


if __name__ == "__main__":
    sys.exit(main())

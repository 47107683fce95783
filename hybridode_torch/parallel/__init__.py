"""Data and evaluation parallelism over torch.distributed (counterpart of hybridode/parallel/).

One process per rank (`launch`), gloo on the CPU and NCCL on CUDA; 1-D batch
data parallelism (`make_mesh`, `make_dp_train_step`), the 2-D (patients x MC)
evaluation (`make_mesh_2d`, `evaluate_sharded`), and the dryrun of N ranks
(`python -m hybridode_torch.parallel.dryrun N --device c` on gloo CPU ranks,
without `--device c` on N GPUs).
"""

from .eval import evaluate_sharded, make_sharded_eval_chunk
from .launch import close_world, init_world, is_writer, launch
from .mesh import (
    FlatMean,
    make_dp_eval_loss,
    make_dp_train_step,
    make_mesh,
    make_mesh_2d,
    replicate,
    shard_batch,
)

__all__ = [
    "launch",
    "init_world",
    "close_world",
    "is_writer",
    "make_mesh",
    "make_mesh_2d",
    "shard_batch",
    "replicate",
    "FlatMean",
    "make_dp_train_step",
    "make_dp_eval_loss",
    "make_sharded_eval_chunk",
    "evaluate_sharded",
]

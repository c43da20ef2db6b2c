"""The parallel modes over ``torch.distributed`` (the JAX package's
``parallel/``): the mesh, the partition-rule engine, the context, the step
seam, ``ParallelWrapper``, the parameter-averaging ``TrainingMaster`` and
ring/Ulysses attention. The parameter server, elastic training, pipelines
and expert parallelism are ROADMAP.md A7.3-A7.6."""
from .mesh import build_mesh, data_parallel_mesh
from .wrapper import ParallelWrapper

__all__ = ["ParallelWrapper", "build_mesh", "data_parallel_mesh"]

"""The parallel modes over ``torch.distributed`` (the JAX package's
``parallel/``): the mesh, the partition-rule engine, the context, the step
seam, ``ParallelWrapper``, the parameter-averaging ``TrainingMaster``,
ring/Ulysses attention, the asynchronous parameter server
(``param_server``, ``ps_transport``, ``ps_worker``) and elastic training
(``elastic``). Pipelines and expert parallelism are ROADMAP.md A7.5-A7.6."""
from .mesh import build_mesh, data_parallel_mesh
from .wrapper import ParallelWrapper

__all__ = ["ParallelWrapper", "build_mesh", "data_parallel_mesh"]

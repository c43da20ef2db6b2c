"""The parallel modes over ``torch.distributed`` (the JAX package's
``parallel/``): the mesh, the partition-rule engine, the context, the step
seam, ``ParallelWrapper`` (data parallelism, ZeRO, sequence and expert
parallelism, and the ``dp_tp`` placement of ``tensor_parallel``), the
GPipe pipeline (``pipeline``, ``pipeline_trainer``), expert parallelism
(``moe``), the parameter-averaging ``TrainingMaster``, ring/Ulysses
attention, the asynchronous parameter server (``param_server``,
``ps_transport``, ``ps_worker``) and elastic training (``elastic``)."""
from .elastic import ElasticTrainer
from .mesh import build_mesh, data_parallel_mesh
from .wrapper import ParallelWrapper

__all__ = ["ElasticTrainer", "ParallelWrapper", "build_mesh",
           "data_parallel_mesh"]

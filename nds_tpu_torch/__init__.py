"""nds_tpu_torch: the NDS SQL engine's in-core path on PyTorch and CUDA.

A port of ``nds_tpu`` (JAX on a TPU) that runs on an NVIDIA H100 with
hand-written CUDA kernels for sort, group-by and gather. It imports
neither ``jax`` nor ``nds_tpu``: the host front end (SQL parser, planner,
numpy oracle executor) is a copy kept in this package.
"""
from .config import EngineConfig  # noqa: F401
from .engine.session import Session  # noqa: F401

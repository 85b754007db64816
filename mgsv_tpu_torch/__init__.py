"""PyTorch/CUDA port of mgsv_tpu: the serving path (music index, retrieval,
localization) on one NVIDIA Hopper GPU.

The JAX package `mgsv_tpu` stays the reference.  This package imports
`torch` and never `jax`; it shares the framework-free modules of the JAX
package (the typed `Config`, the reference state-dict exporter, the packed
feature store, the HTTP server) by import.
"""

from mgsv_tpu.config import Config, DataConfig, LossConfig, ModelConfig, TrainConfig

__all__ = ["Config", "DataConfig", "LossConfig", "ModelConfig", "TrainConfig"]

"""PyTorch/CUDA port of mgsv_tpu on one NVIDIA Hopper GPU: the serving path
(music index, retrieval, localization) and the training step.

The JAX package `mgsv_tpu` stays the reference.  This package imports
`torch` and nothing of JAX or of the JAX package: it keeps its own copies of
the framework-free pieces it needs (the typed `Config`, the state-dict key
map, the packed feature store, the HTTP server).
"""

from mgsv_tpu_torch.config import Config, DataConfig, LossConfig, ModelConfig, TrainConfig

__all__ = ["Config", "DataConfig", "LossConfig", "ModelConfig", "TrainConfig"]

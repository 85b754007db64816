"""PyTorch/CUDA port of mgsv_tpu on one NVIDIA Hopper GPU: the serving path
(music index, retrieval, localization) and the training step.

The JAX package `mgsv_tpu` stays the reference.  This package imports
`torch` and nothing of JAX or of the JAX package: it keeps its own copies of
the framework-free pieces it needs (the typed `Config`, the state-dict key
map, the packed feature store, the HTTP server).
"""

from mgsv_tpu_torch.config import Config, DataConfig, LossConfig, ModelConfig, TrainConfig

__all__ = ["Config", "DataConfig", "LossConfig", "ModelConfig", "TrainConfig",
           "MaDe", "Trainer", "evaluate"]


def __getattr__(name):
    # lazy, as the JAX package's: `import mgsv_tpu_torch` loads no model or
    # trainer (nor torch) until one is asked for
    if name == "MaDe":
        from mgsv_tpu_torch.models.made import MaDe
        return MaDe
    if name == "Trainer":
        from mgsv_tpu_torch.train.loop import Trainer
        return Trainer
    if name == "evaluate":
        from mgsv_tpu_torch.eval.evaluator import evaluate
        return evaluate
    raise AttributeError(name)

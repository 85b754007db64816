"""Typed configuration of the port: the same five dataclasses, fields,
defaults and checks as the JAX package's `mgsv_tpu/config.py`, kept here so
that the port imports nothing of that package.  A test holds the two equal
under `dataclasses.asdict` and `from_overrides`.

Canonical defaults are the paper configuration (scripts/train_kuai_all_feature.sh
of the reference): stride 2.5, filter 10, max_v_frames 50, max_m_duration 240,
dim 256, temporal depth 1, vmr_fusion XA-music, vmr_loss
dual_single_loss_fuse, mml_fusion concat, DETR 2 enc / 6 dec, moment query
"video", 1 moment query, contrastive-align on, temperature 3e-2, lr 3e-4 for
both groups, batch 512, 100 epochs, warmup 0.02.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Optional


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """Dataset / input geometry."""

    train_csv: str = "dataset/MGSV-EC/train_data.csv"
    val_csv: str = "dataset/MGSV-EC/val_data.csv"
    test_csv: str = "dataset/MGSV-EC/test_data.csv"
    feature_root: str = "features/Kuai_feature"

    image_resolution: int = 224
    max_v_frames: int = 50           # frames at 1 fps
    max_m_duration: float = 240.0    # seconds
    stride: float = 2.5              # snippet hop (s)
    filter_sec: float = 10.0         # snippet window (s)
    padding_sec: float = 0.0
    mel_bins: int = 128
    target_length: int = 1024        # AST spectrogram frames per snippet
    sample_rate: int = 16000

    vit_dim: int = 512               # CLIP ViT-B/32 embed dim
    ast_dim: int = 768               # AST embed dim

    @property
    def max_snippet_num(self) -> int:
        return int(self.max_m_duration / self.stride)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """MaDe architecture."""

    dim_input: int = 256
    temporal_depth: int = 1
    video_temporal_depth: int = 0    # 0 = temporal_depth
    audio_temporal_depth: int = 0    # 0 = temporal_depth
    temporal_heads: int = 8
    temporal_mlp_dim: int = 1024
    temporal_dropout: float = 0.8
    fused_temporal: bool = False
    video_pe_len: int = 250
    audio_pe_len: int = 300
    with_cls_token: bool = False
    with_act_after_proj: bool = False
    transformer_is_share: bool = False
    agg_module: str = "transf"       # "transf" | "mlp"

    vmr_fusion: str = "XA-music"     # "NO" | "XA-music" | "XA-video" | "XA-music-video"
    fusion_mask: bool = True
    xpool_dropout: float = 0.3
    remat_xpool: bool = True
    remat_detr: bool = False
    # DETR encoder layers on the fused kernel (post-norm only)
    fused_detr_encoder: bool = True
    # training pooled similarity straight to [V, M] on the fused X-Pool kernel
    fused_xpool_sim: bool = True
    temperature_init_value: float = 3e-2

    mml_fusion: str = "concat"       # "concat" | "CA"
    mml_localization: str = "detr"   # "detr" | "regression"
    detr_enc_layers: int = 2
    detr_dec_layers: int = 6
    detr_heads: int = 8
    detr_ffn_dim: int = 1024
    detr_dropout: float = 0.1
    detr_pre_norm: bool = False
    # pad the fused detection sequence with mask-zero tokens to a multiple
    # of this (L=146 -> 152); 1 disables
    detr_seq_pad_multiple: int = 8
    # the reference's decoder_SA=0 flag is inert upstream, so decoder
    # self-attention runs there; True reproduces that
    decoder_self_attn: bool = True
    num_moment_queries: int = 1
    moment_query_type: str = "video" # "video" | "music" | "xpool" | "zero"
    predict_center: bool = False
    span_loss_type: str = "l1"       # only "l1" exists end to end

    contrastive_dim: int = 256
    audio_short_cut: bool = False
    moment_loss: bool = False

    ca_heads: int = 8
    ca_dim_head: int = 128
    ca_mlp_dim: int = 1024
    ca_dropout: float = 0.8

    # matmul/activation dtype of the towers and the DETR; parameters,
    # LayerNorms, softmax and losses stay float32
    compute_dtype: str = "bfloat16"  # "float32" | "bfloat16"

    def __post_init__(self) -> None:
        if self.span_loss_type != "l1":
            raise ValueError(
                f"span_loss_type={self.span_loss_type!r}: only 'l1' is "
                "implemented — the reference's 'ce' branch is dead upstream "
                "(span_embed never emits snippet logits; matcher.py:79-85 "
                "would crash). See MIGRATION.md.")
        if self.ca_heads == 1 and self.ca_dim_head == self.dim_input:
            raise ValueError(
                "ca_heads=1 with ca_dim_head == dim_input selects the "
                "project_out=False CrossAttention shape (no to_out layer), "
                "which the torch interop maps do not support; use >1 heads "
                "or a different ca_dim_head.")


@dataclasses.dataclass(frozen=True)
class LossConfig:
    """Loss weights and settings."""

    vmr_loss: str = "dual_single_loss_fuse"
    dual_single_loss_weight: float = 1.0
    ignore_same_music: int = 1       # 1 => plain InfoNCE

    l1_loss: bool = True
    aux_loss: bool = True
    contrastive_align_loss: bool = True

    weight_span: float = 4.0
    weight_giou: float = 1.0
    weight_label: float = 0.8
    weight_contrastive_align: float = 0.2

    cost_span: float = 10.0
    cost_giou: float = 1.0
    cost_class: float = 4.0

    fb_label: str = "01"             # foreground=0, background=1
    eos_coef: float = 0.1
    align_temperature: float = 0.07

    ret_loss_weight: float = 1.0
    loc_loss_weight: float = 1.0

    gt_moment_num: int = 1
    toph_moment: int = 1

    @property
    def foreground_label(self) -> int:
        return 0 if self.fb_label == "01" else 1

    @property
    def background_label(self) -> int:
        return 1 if self.fb_label == "01" else 0


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Optimization and loop settings."""

    seed: int = 42
    epochs: int = 100
    batch_size_train: int = 512
    batch_size_val: int = 40
    matching_lr: float = 3e-4
    detection_lr: float = 3e-4
    scheduler: str = "warmupcosine"  # warmupcosine|warmuplinear|warmupconstant|constant|exponential
    warmup_rate: float = 0.02
    decay_rate: float = 0.9          # exponential scheduler: gamma
    lr_update_rate: int = 50         # exponential scheduler: steps per decay
    max_grad_norm: float = 1.0
    adam_b1: float = 0.9
    adam_b2: float = 0.999
    adam_eps: float = 1e-8
    early_stop_min_epochs: int = 60
    early_stop_patience: int = 20
    gradient_accumulation_steps: int = 1
    save_every_epoch: bool = False
    device_data: str = "auto"        # "auto" | "on" | "off"
    output_dir: str = "runs"
    name: str = "made"
    log_every: int = 10
    save_checkpoints: bool = True
    mesh_shape: tuple = (1, 1)       # (dp, mp)
    donate_state: bool = True
    dropout_rng: str = "rbg"
    # the reference never optimizes decoder_query_embed; True trains it
    train_query_embed: bool = False
    profile: bool = False
    resume: str = ""
    checkpoint_every_steps: int = 0
    abort_at_step: int = 0


@dataclasses.dataclass(frozen=True)
class Config:
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    loss: LossConfig = dataclasses.field(default_factory=LossConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)

    def replace(self, **sections: Any) -> "Config":
        return dataclasses.replace(self, **sections)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, default=str)

    @staticmethod
    def from_overrides(overrides: Optional[dict] = None) -> "Config":
        """Build a Config from a flat dict of `section.key` overrides."""
        cfg = Config()
        if not overrides:
            return cfg
        sections = {"data": {}, "model": {}, "loss": {}, "train": {}}
        for key, value in overrides.items():
            section, _, field = key.partition(".")
            if section not in sections or not field:
                raise KeyError(f"Unknown config override: {key}")
            sections[section][field] = value
        return Config(
            data=dataclasses.replace(cfg.data, **sections["data"]),
            model=dataclasses.replace(cfg.model, **sections["model"]),
            loss=dataclasses.replace(cfg.loss, **sections["loss"]),
            train=dataclasses.replace(cfg.train, **sections["train"]),
        )

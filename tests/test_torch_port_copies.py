"""The port's own copies of the JAX package's framework-free pieces agree
with the originals: the typed Config, the `--section.key` override parser,
the reference state-dict key map and the example batch."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import __graft_entry__
from mgsv_tpu.cli.train import parse_kv_overrides as jax_parse
from mgsv_tpu.config import Config as JaxConfig
from mgsv_tpu.interop.torch_export import export_uni_state_dict
from mgsv_tpu.models.made import MaDe as JaxMaDe
from mgsv_tpu_torch.cli.overrides import parse_kv_overrides
from mgsv_tpu_torch.config import Config
from mgsv_tpu_torch.data.example_batch import example_batch
from mgsv_tpu_torch.interop.state_dict import jax_tree_to_state_dict

OVERRIDES = [
    {},
    {"model.dim_input": 32, "model.detr_enc_layers": 1, "loss.eos_coef": 0.2,
     "train.scheduler": "constant", "data.stride": 20.0},
    {"model.compute_dtype": "float32", "model.decoder_self_attn": False,
     "model.video_temporal_depth": 2, "train.mesh_shape": [2, 1]},
]


@pytest.mark.parametrize("overrides", OVERRIDES)
def test_config_equals_jax_config(overrides):
    ours, ref = Config.from_overrides(overrides), JaxConfig.from_overrides(overrides)
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    assert ours.data.max_snippet_num == ref.data.max_snippet_num
    assert (ours.loss.foreground_label, ours.loss.background_label) == (
        ref.loss.foreground_label, ref.loss.background_label)
    assert ours.to_json() == ref.to_json()


@pytest.mark.parametrize("bad", [{"model.nope": 1}, {"nosection": 1},
                                 {"model.span_loss_type": "ce"}])
def test_config_rejects_what_jax_rejects(bad):
    errors = []
    for cls in (Config, JaxConfig):
        with pytest.raises((KeyError, TypeError, ValueError)) as info:
            cls.from_overrides(bad)
        errors.append(type(info.value))
    assert errors[0] == errors[1]


def test_override_parser_equals_jax_parser():
    argv = ["--model.dim_input", "64", "--train.scheduler=constant", "--data.ast_dim",
            "96", "--train.name", "run-1", "--model.fusion_mask", "false"]
    assert parse_kv_overrides(argv) == jax_parse(argv)


@pytest.mark.parametrize("overrides", [
    {"model.dim_input": 16, "model.temporal_mlp_dim": 32, "model.detr_ffn_dim": 32,
     "model.detr_enc_layers": 1, "model.detr_dec_layers": 2, "model.contrastive_dim": 16,
     "model.video_pe_len": 16, "model.audio_pe_len": 16, "data.vit_dim": 32,
     "data.ast_dim": 48, "data.max_v_frames": 8, "data.stride": 30.0,
     "data.filter_sec": 30.0},
    {"model.dim_input": 16, "model.temporal_mlp_dim": 32, "model.detr_ffn_dim": 32,
     "model.detr_enc_layers": 2, "model.detr_dec_layers": 1, "model.decoder_self_attn": False,
     "model.video_pe_len": 16, "model.audio_pe_len": 16, "data.vit_dim": 32,
     "data.ast_dim": 48, "data.max_v_frames": 8, "data.stride": 30.0,
     "data.filter_sec": 30.0, "loss.contrastive_align_loss": False},
])
def test_key_map_equals_export_uni_state_dict(overrides):
    jcfg, cfg = JaxConfig.from_overrides(overrides), Config.from_overrides(overrides)
    f, s = jcfg.data.max_v_frames, jcfg.data.max_snippet_num
    params = jax.jit(lambda key: JaxMaDe(jcfg).init(
        key, jnp.zeros((1, f, jcfg.data.vit_dim)), jnp.ones((1, f)),
        jnp.zeros((1, s, jcfg.data.ast_dim)), jnp.ones((1, s))))(jax.random.PRNGKey(0))
    ours, ref = jax_tree_to_state_dict(params, cfg), export_uni_state_dict(params, jcfg)
    assert ours.keys() == ref.keys()
    for k in ref:
        np.testing.assert_array_equal(ours[k], np.asarray(ref[k]), err_msg=k)


def test_example_batch_equals_graft_entry_generator():
    cfg = Config.from_overrides({"data.max_v_frames": 6, "data.stride": 40.0,
                                 "data.filter_sec": 40.0, "data.vit_dim": 8,
                                 "data.ast_dim": 12})
    ours = example_batch(np.random.RandomState(3), cfg, 5)
    ref = __graft_entry__._example_batch(np.random.RandomState(3), cfg, 5)
    assert ours.keys() == ref.keys()
    for k in ref:
        np.testing.assert_array_equal(ours[k], ref[k], err_msg=k)
        assert ours[k].dtype == ref[k].dtype

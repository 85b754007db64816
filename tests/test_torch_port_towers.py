"""The port's frozen towers (CLIP ViT and AST) against their JAX twins at
tiny geometry, with the weights carried over two ways: a minted
reference-format state dict through both packages' importers, and JAX
parameters through `interop/from_jax.py::load_jax_*_params`.  Also the
AST importer's pieces (pos-embed surgery, RGB patch sum, DDP prefixes) and
the extraction CLI's geometry check, against the JAX package's.

Inputs and weights are made with numpy from a seed.  Tolerance 1e-5 abs in
float32 (both sides compute in float32, JAX at "highest" matmul precision;
the outputs follow LayerNorms, of order 1); 5e-2 with a bfloat16 compute
dtype (two bf16 roundings per product on each side, in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mgsv_tpu.cli import extract_features as jax_cli
from mgsv_tpu.config import Config as JaxConfig
from mgsv_tpu.models import ast as jax_ast
from mgsv_tpu.models.clip_vit import ClipVisionTower as JaxClip
from mgsv_tpu.models.clip_vit import import_clip_visual_state_dict as jax_import_clip
from mgsv_tpu_torch.cli import extract_features as port_cli
from mgsv_tpu_torch.config import Config
from mgsv_tpu_torch.interop.from_jax import load_jax_ast_params, load_jax_clip_params
from mgsv_tpu_torch.models import ast
from mgsv_tpu_torch.models.clip_vit import ClipVisionTower, import_clip_visual_state_dict

ATOL = {torch.float32: 1e-5, torch.bfloat16: 5e-2}
JAX_DTYPE = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
CLIP = dict(width=64, depth=2, heads=4, patch=8, out_dim=32, image_size=16)
AST = dict(embed_dim=64, depth=2, heads=4, label_dim=10, input_fdim=32, input_tdim=48)


def _r(rng, *shape, scale=0.05):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _ln(rng, s, prefix, d):
    s[f"{prefix}.weight"] = 1.0 + _r(rng, d)
    s[f"{prefix}.bias"] = _r(rng, d)


def mint_clip_state(rng, width, depth, patch, out_dim, image_size, **_):
    """A CLIP ViT state dict in the ViT-B-32.pt layout (`visual.*` keys)."""
    grid = (image_size // patch) ** 2
    s = {"conv1.weight": _r(rng, width, 3, patch, patch),
         "class_embedding": _r(rng, width), "positional_embedding": _r(rng, grid + 1, width),
         "proj": _r(rng, width, out_dim)}
    _ln(rng, s, "ln_pre", width)
    _ln(rng, s, "ln_post", width)
    for i in range(depth):
        b = f"transformer.resblocks.{i}"
        _ln(rng, s, f"{b}.ln_1", width)
        _ln(rng, s, f"{b}.ln_2", width)
        s[f"{b}.attn.in_proj_weight"] = _r(rng, 3 * width, width, scale=0.2)
        s[f"{b}.attn.in_proj_bias"] = _r(rng, 3 * width)
        s[f"{b}.attn.out_proj.weight"] = _r(rng, width, width, scale=0.2)
        s[f"{b}.attn.out_proj.bias"] = _r(rng, width)
        s[f"{b}.mlp.c_fc.weight"] = _r(rng, 4 * width, width, scale=0.2)
        s[f"{b}.mlp.c_fc.bias"] = _r(rng, 4 * width)
        s[f"{b}.mlp.c_proj.weight"] = _r(rng, width, 4 * width, scale=0.2)
        s[f"{b}.mlp.c_proj.bias"] = _r(rng, width)
    return {f"visual.{k}": v for k, v in s.items()}


def mint_ast_state(rng, embed_dim, depth, label_dim, input_fdim, input_tdim, channels=1,
                   pos_tokens=None, **_):
    """An AST state dict in the audioset checkpoint's layout (`module.`
    prefixes, `v.*` and `mlp_head.*` keys)."""
    d = embed_dim
    f_dim, t_dim = ast.patch_grid(10, 10, input_fdim, input_tdim)
    s = {"v.patch_embed.proj.weight": _r(rng, d, channels, 16, 16, scale=0.2),
         "v.patch_embed.proj.bias": _r(rng, d), "v.cls_token": _r(rng, 1, 1, d),
         "v.dist_token": _r(rng, 1, 1, d),
         "v.pos_embed": _r(rng, 1, pos_tokens or f_dim * t_dim + 2, d),
         "mlp_head.1.weight": _r(rng, label_dim, d), "mlp_head.1.bias": _r(rng, label_dim)}
    _ln(rng, s, "v.norm", d)
    _ln(rng, s, "mlp_head.0", d)
    for i in range(depth):
        b = f"v.blocks.{i}"
        _ln(rng, s, f"{b}.norm1", d)
        _ln(rng, s, f"{b}.norm2", d)
        s[f"{b}.attn.qkv.weight"] = _r(rng, 3 * d, d, scale=0.2)
        s[f"{b}.attn.qkv.bias"] = _r(rng, 3 * d)
        s[f"{b}.attn.proj.weight"] = _r(rng, d, d, scale=0.2)
        s[f"{b}.attn.proj.bias"] = _r(rng, d)
        s[f"{b}.mlp.fc1.weight"] = _r(rng, 4 * d, d, scale=0.2)
        s[f"{b}.mlp.fc1.bias"] = _r(rng, 4 * d)
        s[f"{b}.mlp.fc2.weight"] = _r(rng, d, 4 * d, scale=0.2)
        s[f"{b}.mlp.fc2.bias"] = _r(rng, d)
    return {f"module.{k}": v for k, v in s.items()}


@pytest.mark.parametrize("route,dtype", [("state_dict", torch.float32),
                                         ("jax_params", torch.float32),
                                         ("state_dict", torch.bfloat16)])
def test_clip_tower_matches_jax(route, dtype):
    rng = np.random.default_rng(0)
    images = rng.standard_normal((3, 3, 16, 16)).astype(np.float32)
    jax_tower = JaxClip(**CLIP, dtype=JAX_DTYPE[dtype])
    tower = ClipVisionTower(**CLIP, dtype=dtype)
    if route == "state_dict":
        state = mint_clip_state(rng, **CLIP)
        params = jax_import_clip(state, depth=CLIP["depth"])
        tower.load_state_dict(import_clip_visual_state_dict(state), strict=True)
    else:
        params = jax_tower.init(jax.random.PRNGKey(1), jnp.asarray(images))
        params = jax.tree_util.tree_map(lambda x: x + 0.05 * jnp.sin(jnp.arange(x.size).reshape(
            x.shape)), params)                                       # off the flax init
        load_jax_clip_params(tower, jax.tree_util.tree_map(np.asarray, params))
    want = np.asarray(jax_tower.apply(params, jnp.asarray(images)), np.float32)
    with torch.no_grad():
        got = tower(torch.from_numpy(images))
    assert got.dtype == torch.float32 and got.shape == (3, CLIP["out_dim"])
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL[dtype], rtol=0)


@pytest.mark.parametrize("route,dtype", [("state_dict", torch.float32),
                                         ("jax_params", torch.float32),
                                         ("state_dict", torch.bfloat16)])
def test_ast_encoder_matches_jax(route, dtype):
    rng = np.random.default_rng(1)
    spec = (rng.standard_normal((2, AST["input_tdim"], AST["input_fdim"])) * 2).astype(
        np.float32)
    jax_enc = jax_ast.ASTEncoder(**AST, dtype=JAX_DTYPE[dtype])
    enc = ast.ASTEncoder(**AST, dtype=dtype)
    if route == "state_dict":
        state = mint_ast_state(rng, **AST)
        params = jax_ast.import_ast_state_dict(state, depth=AST["depth"])
        enc.load_state_dict(ast.import_ast_state_dict(state), strict=True)
    else:
        params = jax_enc.init(jax.random.PRNGKey(2), jnp.asarray(spec))
        params = jax.tree_util.tree_map(lambda x: x + 0.05 * jnp.cos(jnp.arange(x.size).reshape(
            x.shape)), params)
        load_jax_ast_params(enc, jax.tree_util.tree_map(np.asarray, params))
    want = [np.asarray(x, np.float32) for x in jax_enc.apply(params, jnp.asarray(spec))]
    with torch.no_grad():
        got = enc(torch.from_numpy(spec))
    f_dim, t_dim = ast.patch_grid(10, 10, AST["input_fdim"], AST["input_tdim"])
    assert got[2].shape == (2, f_dim * t_dim + 2, AST["embed_dim"])
    for name, g, w in zip(("logits", "cls_dist", "tokens"), got, want):
        np.testing.assert_allclose(g.numpy(), w, atol=ATOL[dtype], rtol=0, err_msg=name)


@pytest.mark.parametrize("f_dim,t_dim", [(12, 20), (12, 101), (30, 30)])
def test_surgery_pos_embed_matches_jax(f_dim, t_dim):
    """Center cut (<= 24) and bilinear interpolation (> 24) on each axis."""
    pos = _r(np.random.default_rng(2), 1, 24 * 24 + 2, 8)
    np.testing.assert_array_equal(ast.surgery_pos_embed(pos, f_dim, t_dim),
                                  jax_ast.surgery_pos_embed(pos, f_dim, t_dim))


def test_imagenet_deit_import_sums_rgb_and_cuts_pos_like_jax():
    """sum_rgb_patch=True: the 3-channel patch conv summed to 1 channel and
    the square ImageNet pos_embed cut and resized to the 12 x 101 grid;
    `module.` prefixes stripped (twice over) and timm's unused heads dropped."""
    rng = np.random.default_rng(3)
    state = mint_ast_state(rng, 8, 1, 5, 128, 1024, channels=3, pos_tokens=24 * 24 + 2)
    state = {f"module.{k}": v for k, v in state.items()}
    state["module.module.v.head.weight"] = _r(rng, 1000, 8)
    state["module.module.v.head_dist.bias"] = _r(rng, 1000)
    ours = ast.import_ast_state_dict(state, sum_rgb_patch=True)
    theirs = jax_ast.import_ast_state_dict(state, depth=1, sum_rgb_patch=True)["params"]
    np.testing.assert_array_equal(ours["v.patch_embed.proj.weight"].numpy(),
                                  theirs["patch_proj"]["kernel"].transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(ours["v.pos_embed"].numpy(),
                                  theirs["pos_embed"].astype(np.float32))
    assert ours["v.pos_embed"].shape == (1, 12 * 101 + 2, 8)
    enc = ast.ASTEncoder(embed_dim=8, depth=1, heads=2, label_dim=5)
    enc.load_state_dict(ours, strict=True)


def test_strip_prefixes_matches_jax():
    state = {"module.v.cls_token": 1, "module.module.v.norm.weight": 2, "mlp_head.0.bias": 3}
    assert ast._strip_prefixes(state) == jax_ast._strip_prefixes(state)


def test_cli_loaders_match_jax_and_refuse_a_geometry_mismatch(tmp_path):
    """The extraction CLI's checkpoint loaders infer the same geometry as
    JAX's, and refuse an AST checkpoint whose pos_embed does not fit the
    --data geometry with the same message."""
    rng = np.random.default_rng(4)
    clip_path, ast_path = str(tmp_path / "clip.pt"), str(tmp_path / "ast.pth")
    torch.save({k: torch.from_numpy(v) for k, v in mint_clip_state(rng, **CLIP).items()},
               clip_path)
    torch.save({"model_state_dict": {k: torch.from_numpy(v) for k, v in
                                     mint_ast_state(rng, **AST).items()}}, ast_path)
    jax_tower, _ = jax_cli._load_clip_params(clip_path)
    tower = port_cli._load_clip_tower(clip_path)
    assert (tower.conv1.weight.shape[0], len(tower.transformer.resblocks), tower.patch,
            tower.proj.shape[1], tower.positional_embedding.shape[0] - 1) == (
        jax_tower.width, jax_tower.depth, jax_tower.patch, jax_tower.out_dim,
        (jax_tower.image_size // jax_tower.patch) ** 2)
    geometry = {"data.mel_bins": AST["input_fdim"], "data.target_length": AST["input_tdim"]}
    jax_enc, _ = jax_cli._load_ast_params(ast_path, JaxConfig.from_overrides(geometry).data)
    enc = port_cli._load_ast_encoder(ast_path, Config.from_overrides(geometry).data)
    assert (enc.v.pos_embed.shape[2], len(enc.v.blocks), enc.mlp_head[1].out_features) == (
        jax_enc.embed_dim, jax_enc.depth, jax_enc.label_dim)

    wrong = {"data.mel_bins": 64, "data.target_length": 48}
    with pytest.raises(ValueError) as ours:
        port_cli._load_ast_encoder(ast_path, Config.from_overrides(wrong).data)
    with pytest.raises(ValueError) as theirs:
        jax_cli._load_ast_params(ast_path, JaxConfig.from_overrides(wrong).data)
    assert str(ours.value) == str(theirs.value)
    assert "geometry mismatch" in str(ours.value)

"""Carry weights and training state into the port: JAX variable trees,
JAX's optimizer state and reference `.bin` checkpoints.

MaDe's go through the reference Uni_model's state-dict names, which the
port's MaDe uses as its own; the frozen towers' flax trees map onto the
port's tower names (flax Dense kernels [in, out] transposed to torch's
[out, in], flax convolution kernels [kh, kw, in, out] to [out, in, kh, kw],
LayerNorm scale to weight).  Every load is `strict=True`, so every port
parameter is covered and no stray entry passes unnoticed.

The cls tokens and the EmbeddingNets (agg_module="mlp") have no reference
names known: the JAX package's torch export and import refuse them.  Their
names below are the port's own (`video_cls_token`,
`audio_embedding_net.net.4.running_var`, ...), and a reference `.bin`
neither carries nor takes them (`check_reference_format`).

JAX's optimizer state (optax's, mgsv_tpu/train/optimizer.py) comes across
through `jax_opt_state_to_port` as plain numpy trees, which the JAX side
makes from optax's objects (scripts/convert_jax_run.py); every tensor goes
through the same key map as the weights, which is checked to move elements
without changing them.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from mgsv_tpu_torch.config import Config
from mgsv_tpu_torch.interop.state_dict import jax_tree_to_state_dict
from mgsv_tpu_torch.models.ast import ASTEncoder
from mgsv_tpu_torch.models.clip_vit import ClipVisionTower
from mgsv_tpu_torch.models.made import MaDe
from mgsv_tpu_torch.train.optimizer import DETECTION, FROZEN, MATCHING, TEMPORAL, group_of

# Frozen CLIP / AST encoder weights a checkpoint written by the reference
# itself carries besides the trainable head; the port serves precomputed
# features and holds no frozen towers.
FROZEN_PREFIXES = ("clip_model.", "ast_model.")
# JAX tower subtree -> the port's prefix of its cls token and EmbeddingNet
_TOWERS = {"video_tower": "video", "audio_tower": "audio"}
# JAX EmbeddingNet names -> the reference Sequential's indices (Linear,
# BatchNorm, ReLU, Linear, BatchNorm, ReLU, Linear)
_EMBEDDING_DENSE = {"fc1": "net.0", "fc2": "net.3", "fc3": "net.6"}
_EMBEDDING_NORM = {"bn1": "net.1", "bn2": "net.4"}


def check_reference_format(cfg: Config) -> None:
    """Raise NotImplementedError for a configuration that a reference-format
    checkpoint cannot hold, where the JAX package's torch export and import
    raise (interop/torch_export.py, torch_import.py): the EmbeddingNet
    aggregator and the cls token."""
    m = cfg.model
    if m.agg_module not in ("transf", "None") or m.with_cls_token:
        raise NotImplementedError(
            f"no reference-format checkpoint for agg_module={m.agg_module!r} / "
            f"with_cls_token={m.with_cls_token}: the reference's names of the EmbeddingNets "
            "and cls tokens are not known (the JAX package's export and import refuse them "
            "too); use the port's own checkpoint, a tag under --run-dir")


def _tower_keys(cfg: Config) -> set:
    """The subtrees a JAX tower of cfg holds."""
    m = cfg.model
    depth = {"video_tower": m.video_temporal_depth, "audio_tower": m.audio_temporal_depth}
    keys = {"proj"}
    if m.with_cls_token:
        keys.add("cls_token")
    if m.agg_module == "mlp":
        keys.add("embedding_net")
    return {name: keys | ({"temporal"} if m.agg_module == "transf" and not
                          m.transformer_is_share and (depth[name] or m.temporal_depth) > 0
                          else set()) for name in _TOWERS}


def jax_variables_to_state_dict(tree: Mapping, cfg: Config) -> Dict[str, np.ndarray]:
    """A JAX MaDe variable tree ({"params": ...[, "batch_stats": ...]} or
    bare params; a gradient tree alike) -> {port state-dict name: array}:
    interop/state_dict.py's reference key map, and the port's own names for
    the cls tokens, the EmbeddingNets and their running buffers (JAX's
    "batch_stats", whose [L, 1] BatchNorm leaves become [L]).  Raises
    KeyError where a tower holds a subtree the configuration does not
    build, or batch_stats come without the EmbeddingNet."""
    params = tree["params"] if "params" in tree else tree
    m = cfg.model
    ref_cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        m, agg_module="None" if m.agg_module == "mlp" else m.agg_module, with_cls_token=False))
    out = jax_tree_to_state_dict(params, ref_cfg)
    for name, keys in _tower_keys(cfg).items():
        if set(params[name]) != keys:
            raise KeyError(f"JAX {name} holds {sorted(params[name])}, the configuration "
                           f"builds {sorted(keys)}")
    stats = tree.get("batch_stats") if "params" in tree else None
    if stats is not None and m.agg_module != "mlp":
        raise KeyError(f"batch_stats given, but agg_module={m.agg_module!r} keeps none")
    for name, port in _TOWERS.items():
        sub = params[name]
        if m.with_cls_token:
            out[f"{port}_cls_token"] = _np(sub["cls_token"])
        if m.agg_module == "mlp":
            out.update(embedding_net_state(
                sub["embedding_net"],
                stats[name]["embedding_net"] if stats is not None else None,
                f"{port}_embedding_net."))
    return out


def embedding_net_state(params: Mapping, stats: Optional[Mapping] = None,
                        prefix: str = "") -> dict:
    """A JAX EmbeddingNet's params (and its batch_stats) -> the port's
    EmbeddingNet names under `prefix`: fc1/fc2/fc3 -> net.0/net.3/net.6,
    bn1/bn2 -> net.1/net.4 (scale -> weight, mean and var -> running_mean
    and running_var, [L, 1] -> [L])."""
    out = {}
    for jname, idx in _EMBEDDING_DENSE.items():
        out.update(_dense(f"{prefix}{idx}", params[jname]))
    for jname, idx in _EMBEDDING_NORM.items():
        out[f"{prefix}{idx}.weight"] = _np(params[f"{jname}_scale"])[:, 0]
        out[f"{prefix}{idx}.bias"] = _np(params[f"{jname}_bias"])[:, 0]
        if stats is not None:
            out[f"{prefix}{idx}.running_mean"] = _np(stats[f"{jname}_mean"])[:, 0]
            out[f"{prefix}{idx}.running_var"] = _np(stats[f"{jname}_var"])[:, 0]
    return out


def load_jax_params(model: MaDe, params: Mapping, cfg: Config) -> MaDe:
    """Load a JAX MaDe variable tree ({"params": ...} with "batch_stats"
    for agg_module="mlp", or bare params; leaves any array numpy reads)
    into `model`, strictly."""
    state = {k: torch.from_numpy(np.array(v, dtype=np.float32))
             for k, v in jax_variables_to_state_dict(params, cfg).items()}
    model.load_state_dict(state, strict=True)
    return model


# JAX's optimizer groups that hold Adam moments (its FROZEN group has none)
ADAM_GROUPS = (TEMPORAL, MATCHING, DETECTION)
Path = Tuple[str, ...]


def _leaves(tree, prefix: Path = ()):
    """(path, leaf) over a nested mapping, in sorted key order; a None (a
    leaf or a subtree the tree's group does not own) is yielded too."""
    if isinstance(tree, Mapping):
        for key in sorted(tree):
            yield from _leaves(tree[key], prefix + (key,))
    else:
        yield prefix, tree


def _nest(flat: Mapping[Path, Any]) -> dict:
    out: dict = {}
    for path, value in flat.items():
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = value
    return out


def _split(tree: Mapping) -> Tuple[Mapping, Optional[Mapping]]:
    """A variables tree -> (its params, its batch_stats or None)."""
    if "params" in tree:
        return tree["params"], tree.get("batch_stats")
    return tree, None


def _relayout(shapes: Mapping[Path, tuple], cfg: Config) -> Dict[str, np.ndarray]:
    """The key map of `jax_variables_to_state_dict` over params of these
    leaf shapes, as {port name: index into the leaves' elements laid end to
    end}.  Found by mapping two probes, each leaf filled with its number and
    each element with its index in its leaf; raises ValueError naming an
    entry whose values are not elements of JAX's leaves moved unchanged, an
    element two entries take, or an element no entry takes."""
    paths = list(shapes)
    sizes = np.array([int(np.prod(shapes[p], dtype=np.int64)) for p in paths], np.int64)
    if sizes.max(initial=0) >= 1 << 24:                 # the probes hold exact float32 integers
        raise ValueError(f"a leaf of {sizes.max()} elements is too large to probe")
    offsets = np.concatenate([[0], np.cumsum(sizes)])
    leaf_no = _nest({p: np.full(shapes[p], i, np.float32) for i, p in enumerate(paths)})
    element = _nest({p: np.arange(n, dtype=np.float32).reshape(shapes[p])
                     for p, n in zip(paths, sizes)})
    by_leaf = jax_variables_to_state_dict(leaf_no, cfg)
    by_element = jax_variables_to_state_dict(element, cfg)
    taken = np.zeros(offsets[-1], np.int64)
    index = {}
    for name, leaf in by_leaf.items():
        elem = by_element[name]
        valid = (np.shape(leaf) == np.shape(elem)
                 and np.array_equal(leaf, np.round(leaf)) and np.array_equal(elem, np.round(elem))
                 and ((leaf >= 0) & (leaf < len(paths))).all())
        leaf_i = leaf.astype(np.int64) if valid else None
        if valid:
            valid = bool(((elem >= 0) & (elem < sizes[leaf_i])).all())
        if not valid:
            raise ValueError(f"the key map's entry {name} is not a re-layout of JAX's leaves "
                             "(its values are not their elements moved unchanged); an "
                             "optimizer moment cannot be carried through it")
        index[name] = offsets[leaf_i] + elem.astype(np.int64)
        np.add.at(taken, index[name].ravel(), 1)
    if (taken != 1).any():
        bad = paths[int(np.searchsorted(offsets, int(np.argmax(taken != 1)), "right")) - 1]
        raise ValueError(f"the key map takes an element of JAX's {'/'.join(bad)} "
                         f"{int(taken[taken != 1][0])} times, not once")
    return index


def _gather(flat: Mapping[Path, Any], paths, shapes, index: Mapping[str, np.ndarray],
            names) -> Dict[str, torch.Tensor]:
    """{port name: tensor} of `names`, gathered from the leaves `flat` (a
    None leaf reads as zeros) laid end to end in `paths` order."""
    whole = np.concatenate([
        np.zeros(int(np.prod(shapes[p], dtype=np.int64)), np.float32) if flat.get(p) is None
        else np.asarray(flat[p], np.float32).ravel() for p in paths])
    return {name: torch.from_numpy(np.array(whole[index[name]])) for name in names}


def jax_opt_state_to_port(state: Mapping, cfg: Config) -> Dict[str, Any]:
    """JAX's optimizer state, as plain numpy trees, -> the dict
    `GroupedAdam.load_state_dict` takes (count, mu, nu, mini_step,
    gradient_step, acc_grads by port parameter name).

    state: {"count": {group: n}, "mu": {group: tree}, "nu": {group: tree}}
    over the groups temporal, matching and detection (optax's
    ScaleByAdamState of each), each tree shaped as the model's variables
    ({"params": ...[, "batch_stats": ...]} or bare params) with None where
    its group does not own the leaf (optax's MaskedNode); with
    train.gradient_accumulation_steps > 1 also optax.MultiStepsState's
    "mini_step", "gradient_step" and "acc_grads" (a whole tree).  The
    groups' moments merge leaf by leaf, each from the group that owns it,
    and go through `jax_variables_to_state_dict`'s key map, which must move
    every element unchanged (`_relayout`): the moments are elementwise, so
    a transpose, a reshape or a concatenation carries them, and any other
    entry raises.  The accumulated mean of the frozen leaves is dropped:
    the port keeps none.

    Raises ValueError where the groups' counts differ (or gradient_step
    differs from them), the accumulation does not match the
    configuration's, a leaf is owned twice, a parameter the port trains is
    owned by no group or by another group than the port's, a leaf the port
    keeps frozen (batch_stats, query_embed unless train_query_embed) has
    moments, or an entry of the key map is not a pure re-layout."""
    k = max(1, cfg.train.gradient_accumulation_steps)
    if set(state["count"]) != set(ADAM_GROUPS):
        raise ValueError(f"optimizer groups {sorted(state['count'])}, not {sorted(ADAM_GROUPS)}")
    counts = {g: int(n) for g, n in state["count"].items()}
    if len(set(counts.values())) != 1:
        raise ValueError(f"the groups' update counts differ: {counts}")
    count = counts[TEMPORAL]
    acc = state.get("acc_grads")
    if (acc is not None) != (k > 1):
        raise ValueError(f"gradient_accumulation_steps {k} with "
                         f"{'an' if acc is not None else 'no'} accumulated gradient in the state")
    gradient_step = int(state.get("gradient_step", count))
    if gradient_step != count:
        raise ValueError(f"gradient_step {gradient_step} differs from the update count {count}")
    # optax masks whole subtrees: a group's tree holds None where a module,
    # or a leaf, is another group's
    moments: Dict[str, Dict[str, dict]] = {}
    for key in ("mu", "nu"):
        moments[key] = {}
        for g in ADAM_GROUPS:
            params, stats = _split(state[key][g])
            if any(v is not None for _, v in _leaves(stats or {})):
                raise ValueError(f"{key} of group {g} holds batch_stats moments; the running "
                                 "buffers are never optimized")
            moments[key][g] = {p: v for p, v in _leaves(params) if v is not None}
    acc_flat = dict(_leaves(_split(acc)[0])) if acc is not None else {}
    if acc is not None:
        paths = sorted(acc_flat)
    else:
        owned = {p for trees in moments.values() for tree in trees.values() for p in tree}
        masked = {p for g in ADAM_GROUPS for p, v in _leaves(_split(state["mu"][g])[0])
                  if v is None}
        paths = sorted(owned | {m for m in masked
                                if not any(p[:len(m)] == m for p in owned)})
    owner: Dict[Path, Optional[str]] = {}
    for path in paths:
        owners = [g for g in ADAM_GROUPS if path in moments["mu"][g]]
        if owners != [g for g in ADAM_GROUPS if path in moments["nu"][g]]:
            raise ValueError(f"{'/'.join(path)}: mu and nu are owned by other groups")
        if len(owners) > 1:
            raise ValueError(f"{'/'.join(path)} is owned twice, by {' and '.join(owners)}")
        owner[path] = owners[0] if owners else None
    stray = [p for trees in moments.values() for tree in trees.values() for p in tree
             if p not in owner]
    if stray:
        raise ValueError(f"moments of {'/'.join(stray[0])}, which acc_grads does not hold")
    # a leaf no group owns has its shape in acc_grads, or none anywhere: it
    # then feeds only frozen entries, checked below
    shapes = {p: np.shape(moments["mu"][owner[p]][p]) if owner[p] is not None
              else np.shape(acc_flat[p]) if p in acc_flat else (1, 1) for p in paths}
    try:
        index = _relayout(shapes, cfg)
    except (ValueError, IndexError, KeyError, TypeError) as err:
        unowned = ["/".join(p) for p in paths if owner[p] is None]
        raise ValueError(f"{err} (leaves no group owns: {unowned})") from err
    ends = np.cumsum([int(np.prod(shapes[p], dtype=np.int64)) for p in paths])
    held = []
    for name, idx in index.items():
        group = group_of(name, cfg.train.train_query_embed)
        leaf_of = np.searchsorted(ends, idx.ravel(), "right")
        owners = {owner[paths[i]] for i in np.unique(leaf_of)}
        if group == FROZEN:
            if owners != {None}:
                raise ValueError(f"{name} is frozen in the port but owned by "
                                 f"{sorted(owners - {None})}")
        elif owners != {group}:
            if None in owners:
                raise ValueError(f"{name} is owned by no group (the port trains it in {group})")
            raise ValueError(f"{name} is owned by {sorted(owners)}; the port trains it in {group}")
        else:
            held.append(name)
    out = {"count": count, "gradient_step": count,
           "mini_step": int(state.get("mini_step", 0)),
           "acc_grads": _gather(acc_flat, paths, shapes, index, held) if acc is not None else {}}
    for key in ("mu", "nu"):
        merged = {p: moments[key][owner[p]][p] if owner[p] is not None else None for p in paths}
        out[key] = _gather(merged, paths, shapes, index, held)
    return out


def load_reference_bin(path: str, cfg: Config) -> MaDe:
    """A MaDe (on the CPU) with the weights of a reference-format checkpoint:
    `{"model_state_dict": ...}` as `mgsv_tpu.cli.evaluate --export-torch` and
    the reference write it, or a bare state dict.  Raises where
    `check_reference_format` does."""
    check_reference_format(cfg)
    blob = torch.load(path, map_location="cpu", weights_only=True)
    state = blob.get("model_state_dict", blob)
    state = {k: v for k, v in state.items() if not k.startswith(FROZEN_PREFIXES)}
    model = MaDe(cfg)
    model.load_state_dict(state, strict=True)
    return model


def save_reference_bin(model: MaDe, cfg: Config, path: str) -> None:
    """Write `model` as a reference-format checkpoint at `path`, as the
    reference and `mgsv_tpu.cli.evaluate --export-torch` write one.  Raises
    where `check_reference_format` does."""
    check_reference_format(cfg)
    state = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    torch.save({"epoch": 0, "loss": 0.0, "model_state_dict": state}, path)


def _np(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float32)


def _dense(prefix: str, p: Mapping) -> dict:
    return {f"{prefix}.weight": _np(p["kernel"]).T, f"{prefix}.bias": _np(p["bias"])}


def _norm(prefix: str, p: Mapping) -> dict:
    return {f"{prefix}.weight": _np(p["scale"]), f"{prefix}.bias": _np(p["bias"])}


def _conv(kernel) -> np.ndarray:
    return _np(kernel).transpose(3, 2, 0, 1)           # [kh, kw, I, O] -> [O, I, kh, kw]


def _vit_blocks(tree: Mapping, prefix: str) -> dict:
    """JAX ViTBlock subtrees block_0, block_1, ... -> `{prefix}.{i}.*`."""
    out, i = {}, 0
    while f"block_{i}" in tree:
        p, b = tree[f"block_{i}"], f"{prefix}.{i}"
        out.update({**_norm(f"{b}.norm1", p["norm1"]),
                    **_dense(f"{b}.attn.qkv", p["attn"]["qkv"]),
                    **_dense(f"{b}.attn.proj", p["attn"]["proj"]),
                    **_norm(f"{b}.norm2", p["norm2"]), **_dense(f"{b}.mlp.fc1", p["fc1"]),
                    **_dense(f"{b}.mlp.fc2", p["fc2"])})
        i += 1
    return out


def _load(module: torch.nn.Module, state: dict) -> torch.nn.Module:
    module.load_state_dict({k: torch.from_numpy(np.array(v, np.float32))
                            for k, v in state.items()}, strict=True)
    return module


def load_jax_clip_params(tower: ClipVisionTower, params: Mapping) -> ClipVisionTower:
    """Load a JAX ClipVisionTower parameter tree ({"params": ...} or bare)
    into `tower`."""
    p = params.get("params", params)
    state = {"conv1.weight": _conv(p["conv1"]["kernel"]),
             "class_embedding": _np(p["class_embedding"]),
             "positional_embedding": _np(p["positional_embedding"]),
             "proj": _np(p["proj"]), **_norm("ln_pre", p["ln_pre"]),
             **_norm("ln_post", p["ln_post"]), **_vit_blocks(p, "transformer.resblocks")}
    return _load(tower, state)


def load_jax_ast_params(encoder: ASTEncoder, params: Mapping) -> ASTEncoder:
    """Load a JAX ASTEncoder parameter tree ({"params": ...} or bare) into
    `encoder`."""
    p = params.get("params", params)
    state = {"v.patch_embed.proj.weight": _conv(p["patch_proj"]["kernel"]),
             "v.patch_embed.proj.bias": _np(p["patch_proj"]["bias"]),
             "v.cls_token": _np(p["cls_token"]), "v.dist_token": _np(p["dist_token"]),
             "v.pos_embed": _np(p["pos_embed"]), **_norm("v.norm", p["norm"]),
             **_norm("mlp_head.0", p["head_norm"]), **_dense("mlp_head.1", p["head"]),
             **_vit_blocks(p, "v.blocks")}
    return _load(encoder, state)

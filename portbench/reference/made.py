"""Plain PyTorch reference of MaDe's training step, its evaluation and its
serving query.

Written from the published equations (the ICCV 2025 MGSV paper, its
reference code xxayt/MGSV, and Moment-DETR), in float32, with no kernel,
cache or batching of the program.  It imports nothing of the program: the
benchmark hands it the same weights and raw inputs as the program, and it
works everything else out again.  Matmuls are plain `torch` operations, so
`reference/precision.py` can round their operands to a lower precision for
the control.

Dropout is reproduced draw for draw.  A training step's dropout comes from
one `torch.Generator` keyed on (seed, step): plain dropout sites draw
`torch.rand` of the site's shape from it; each hand-written kernel call
draws one Philox seed from it (`draw_seed`) and makes its masks from that
seed with the Philox arithmetic of `reference/philox.py`.  The reference
makes the same draws in the same order, so it applies the same masks.

Configuration: a flat dict of `section.key` numbers and switches (the
benchmark's configuration file).  Covered: concat fusion, the video-guided
music X-Pool, the video moment query, post-norm DETR with decoder
self-attention, the DETR heads with contrastive alignment, the
dual_single_loss_fuse retrieval loss and its evaluation's corpus
similarity, one ground-truth moment, and the temporal towers plain (under
dropout from the generator) or on the fused temporal kernel (Philox
masks).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference import philox

BIG_NEG = -1e9
Params = Dict[str, torch.Tensor]

TEMPORAL, MATCHING, DETECTION, FROZEN = "temporal", "matching", "detection", "frozen"
_GROUP = {"vit_proj": TEMPORAL, "ast_proj": TEMPORAL, "video_transformer": TEMPORAL,
          "audio_transformer": TEMPORAL,
          "video_guided_to_music_pooling_cross_transformer": MATCHING,
          "logit_scale": MATCHING, "detr_transformer": DETECTION, "span_embed": DETECTION,
          "class_embed": DETECTION, "contrastive_align_projection_query": DETECTION,
          "contrastive_align_projection_vid": DETECTION, "decoder_query_embed": FROZEN}


# --------------------------------------------------------------------- shapes
def dims(cfg: dict) -> dict:
    s = int(cfg["data.max_m_duration"] / cfg["data.stride"])
    return {"d": cfg["model.dim_input"], "f": cfg["data.max_v_frames"], "s": s,
            "vit": cfg["data.vit_dim"], "ast": cfg["data.ast_dim"],
            "mlp": cfg["model.temporal_mlp_dim"], "th": cfg["model.temporal_heads"],
            "ffn": cfg["model.detr_ffn_dim"], "dh": cfg["model.detr_heads"],
            "enc": cfg["model.detr_enc_layers"], "dec": cfg["model.detr_dec_layers"],
            "q": cfg["model.num_moment_queries"], "dc": cfg["model.contrastive_dim"]}


def param_shapes(cfg: dict) -> Dict[str, Tuple[int, ...]]:
    """Every trained parameter under the reference's state-dict names."""
    k = dims(cfg)
    d, mlp = k["d"], k["mlp"]
    out: Dict[str, Tuple[int, ...]] = {"logit_scale": ()}
    lin = lambda name, i, o: out.update({f"{name}.weight": (o, i), f"{name}.bias": (o,)})
    ln = lambda name: out.update({f"{name}.weight": (d,), f"{name}.bias": (d,)})

    def mha(name):
        out.update({f"{name}.in_proj_weight": (3 * d, d), f"{name}.in_proj_bias": (3 * d,)})
        lin(f"{name}.out_proj", d, d)

    lin("vit_proj", k["vit"], d)
    lin("ast_proj", k["ast"], d)
    for tower in ("video_transformer", "audio_transformer"):
        p = f"{tower}.layers.0"
        ln(f"{p}.0")
        mha(f"{p}.1")
        ln(f"{p}.2")
        lin(f"{p}.3.0", d, mlp)
        lin(f"{p}.3.3", mlp, d)
        lin(f"{tower}.final_linear", d, d)
    x = "video_guided_to_music_pooling_cross_transformer"
    ln(f"{x}.layer_norm1")
    for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
        lin(f"{x}.cross_attn.{proj}", d, d)
    ln(f"{x}.layer_norm2")
    lin(f"{x}.linear_proj", d, d)
    ln(f"{x}.layer_norm3")
    for i in range(k["enc"]):
        p = f"detr_transformer.encoder.layers.{i}"
        mha(f"{p}.self_attn")
        lin(f"{p}.linear1", d, k["ffn"])
        lin(f"{p}.linear2", k["ffn"], d)
        ln(f"{p}.norm1")
        ln(f"{p}.norm2")
    for i in range(k["dec"]):
        p = f"detr_transformer.decoder.layers.{i}"
        mha(f"{p}.self_attn")
        ln(f"{p}.norm1")
        mha(f"{p}.multihead_attn")
        lin(f"{p}.linear1", d, k["ffn"])
        lin(f"{p}.linear2", k["ffn"], d)
        ln(f"{p}.norm2")
        ln(f"{p}.norm3")
    ln("detr_transformer.decoder.norm")
    out["decoder_query_embed.weight"] = (k["q"], d)
    for i in range(3):
        lin(f"span_embed.layers.{i}", d, 2 if i == 2 else d)
    lin("class_embed", d, 2)
    lin("contrastive_align_projection_query", d, k["dc"])
    lin("contrastive_align_projection_vid", d, k["dc"])
    return out


def group_of(name: str) -> str:
    return _GROUP[name.split(".")[0]]


# ------------------------------------------------------------ random draws
def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The step's dropout generator: keyed on (seed, step) through numpy's
    SeedSequence, as the training step keys it."""
    key = int(np.random.SeedSequence([seed, step]).generate_state(1, np.uint64)[0])
    return torch.Generator(device=device).manual_seed(key)


def draw_seed(gen: torch.Generator) -> int:
    """One kernel call's Philox seed from the step's generator: drawn on a
    CPU generator; on a CUDA one derived from its seed and offset on the
    host, the offset stepped on by 4 as a draw would."""
    if gen.device.type == "cpu":
        return int(torch.randint(0, 2 ** 31 - 1, (), generator=gen))
    offset = gen.get_offset()
    gen.set_offset(offset + 4)
    key = np.random.SeedSequence([gen.initial_seed(), offset])
    return int(key.generate_state(1)[0] & 0x7FFFFFFF)


def dropout(x: torch.Tensor, rate: float, gen: Optional[torch.Generator]) -> torch.Tensor:
    if gen is None or rate == 0.0:
        return x
    keep = torch.rand(x.shape, generator=gen, device=x.device) >= rate
    return x * keep.to(x.dtype) / (1.0 - rate)


# ---------------------------------------------------------------- building blocks
def linear(P: Params, name: str, x: torch.Tensor) -> torch.Tensor:
    return F.linear(x, P[f"{name}.weight"], P[f"{name}.bias"])


def layer_norm(P: Params, name: str, x: torch.Tensor) -> torch.Tensor:
    return F.layer_norm(x, (x.shape[-1],), P[f"{name}.weight"], P[f"{name}.bias"], 1e-5)


def l2n(x: torch.Tensor) -> torch.Tensor:
    return x / torch.sqrt(torch.clamp((x * x).sum(-1, keepdim=True), min=1e-24))


def masked_mean(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return (x * mask[..., None]).sum(1) / mask.sum(1, keepdim=True)


def sinusoid(n: int, d: int) -> torch.Tensor:
    pos = np.arange(n, dtype=np.float32)[:, None]
    div = np.exp(np.arange(0, d, 2, dtype=np.float32) * -(math.log(10000.0) / d))
    pe = np.zeros((n, d), np.float32)
    pe[:, 0::2], pe[:, 1::2] = np.sin(pos * div), np.cos(pos * div)
    return torch.from_numpy(pe)


def sine_pos(mask: torch.Tensor, d: int) -> torch.Tensor:
    """DETR's sine embedding over the rank of the valid tokens."""
    x = torch.cumsum(mask.float(), dim=1)
    x = x / (x[:, -1:] + 1e-6) * (2 * math.pi)
    t = torch.arange(d, dtype=torch.float32, device=mask.device)
    t = 10000.0 ** (2 * torch.floor(t / 2) / d)
    p = x[:, :, None] / t
    return torch.stack([p[:, :, 0::2].sin(), p[:, :, 1::2].cos()], dim=3).reshape(
        *mask.shape, d)


def attention(P: Params, name: str, heads: int, q_in, k_in, v_in, key_mask=None,
              rate: float = 0.0, gen=None, weight_mask=None) -> torch.Tensor:
    """Multi-head attention, masked keys at BIG_NEG; dropout on the weights
    from `gen`, or the multiplicative `weight_mask`."""
    w, b = P[f"{name}.in_proj_weight"], P[f"{name}.in_proj_bias"]
    (wq, wk, wv), (bq, bk, bv) = w.chunk(3), b.chunk(3)
    n, lq, d = q_in.shape
    split = lambda t: t.reshape(n, t.shape[1], heads, d // heads).transpose(1, 2)
    q, k, v = split(F.linear(q_in, wq, bq)), split(F.linear(k_in, wk, bk)), split(
        F.linear(v_in, wv, bv))
    s = (q @ k.transpose(-1, -2)) / math.sqrt(d // heads)
    if key_mask is not None:
        s = torch.where(key_mask[:, None, None, :] != 0, s, torch.full_like(s, BIG_NEG))
    a = torch.softmax(s, dim=-1)
    a = a * weight_mask if weight_mask is not None else dropout(a, rate, gen)
    return linear(P, f"{name}.out_proj", (a @ v).transpose(1, 2).reshape(n, lq, d))


# ---------------------------------------------------------------- towers
def temporal_layer(P, p, x, mask, heads, rate, gen, masks=None):
    """LN1, attention with its residual on LN1's output, LN2, GELU FFN with
    its residual on LN2's output (the reference's Transformer_enhancement)."""
    masks = masks or {}
    site = lambda t, key: t * masks[key] if key in masks else dropout(t, rate, gen)
    y = layer_norm(P, f"{p}.0", x)
    u = attention(P, f"{p}.1", heads, y, y, y, mask, rate, gen, masks.get("attn")) + y
    z = layer_norm(P, f"{p}.2", u)
    h = site(F.gelu(linear(P, f"{p}.3.0", z)), "ffn1")
    return site(linear(P, f"{p}.3.3", h), "ffn2") + z


def tower(P, cfg, which, feats, mask, gen=None, fused=False):
    """-> (tokens [B, L, D], L2-normalized masked mean [B, D]).  `fused`:
    the temporal layer's masks from one Philox seed drawn from `gen`."""
    k = dims(cfg)
    name, proj, pe_len = (("video_transformer", "vit_proj", cfg["model.video_pe_len"])
                          if which == "video" else
                          ("audio_transformer", "ast_proj", cfg["model.audio_pe_len"]))
    rate = cfg["model.temporal_dropout"] if gen is not None else 0.0
    x = linear(P, proj, feats * mask[..., None])
    x = x + sinusoid(pe_len, k["d"]).to(x.device)[None, : x.shape[1]]
    masks = None
    if fused and rate > 0.0:
        b, n, d = x.shape
        masks = philox.temporal_masks(draw_seed(gen), b, n, d, k["mlp"], k["th"], rate,
                                      device=x.device)
    x = temporal_layer(P, f"{name}.layers.0", x, mask, k["th"], rate,
                       None if fused else gen, masks)
    x = linear(P, f"{name}.final_linear", x) * mask[..., None]
    return x, l2n(masked_mean(x, mask))


# ---------------------------------------------------------------- X-Pool
XP = "video_guided_to_music_pooling_cross_transformer"


def xpool_pooled(P, video, segs, seg_mask, rate=0.0, seed=0):
    """video [V, D], segs [M, S, D], seg_mask [M, S] -> pooled [M, V, D]:
    single-head attention of each video over each track's snippets, no
    residual around it, LN2, the linear branch with its dropout (Philox
    stream (m, v) of `seed`) and LN3."""
    d = video.shape[-1]
    q = linear(P, f"{XP}.cross_attn.q_proj", layer_norm(P, f"{XP}.layer_norm1", video))
    s1 = layer_norm(P, f"{XP}.layer_norm1", segs)
    kk, vv = linear(P, f"{XP}.cross_attn.k_proj", s1), linear(P, f"{XP}.cross_attn.v_proj", s1)
    sc = torch.einsum("vd,msd->mvs", q, kk) / math.sqrt(d)
    sc = torch.where(seg_mask[:, None, :] != 0, sc, torch.full_like(sc, BIG_NEG))
    ctx = torch.einsum("mvs,msd->mvd", torch.softmax(sc, dim=-1), vv)
    h = layer_norm(P, f"{XP}.layer_norm2", linear(P, f"{XP}.cross_attn.out_proj", ctx))
    lin = linear(P, f"{XP}.linear_proj", h)
    if rate > 0.0:
        lin = lin * philox.xpool_mask(seed, segs.shape[0], video.shape[0], d, rate,
                                      device=video.device)
    return layer_norm(P, f"{XP}.layer_norm3", h + lin)


def xpool_sim(P, video, segs, seg_mask, rate=0.0, seed=0, block=None):
    """[V, M] cosine of each video with its pooled track; `block` tracks at
    a time (no dropout) where given."""
    vhat = l2n(video)
    if block is None:
        return torch.einsum("vd,mvd->vm", vhat, l2n(xpool_pooled(P, video, segs, seg_mask,
                                                                 rate, seed)))
    return torch.cat([torch.einsum("vd,mvd->vm", vhat, l2n(xpool_pooled(
        P, video, segs[i:i + block], seg_mask[i:i + block]))) for i in
        range(0, segs.shape[0], block)], dim=1)


# ---------------------------------------------------------------- DETR
def encoder_layer(P, p, x, mask, pos, heads, rate=0.0, seed=0, ffn=1024):
    """Post-norm encoder layer; its four dropout sites from the Philox
    stream `seed` (the encoder kernel's)."""
    m = {}
    if rate > 0.0:
        b, n, d = x.shape
        m = philox.encoder_masks(seed, b, n, d, ffn, heads, rate, device=x.device)
    qk = x + pos
    o = attention(P, f"{p}.self_attn", heads, qk, qk, x, mask, weight_mask=m.get("attn"))
    if m:
        o = o * m["attn_out"]
    y = layer_norm(P, f"{p}.norm1", x + o)
    h = F.relu(linear(P, f"{p}.linear1", y))
    h = h * m["ffn1"] if m else h
    h2 = linear(P, f"{p}.linear2", h)
    h2 = h2 * m["ffn2"] if m else h2
    return layer_norm(P, f"{p}.norm2", y + h2)


def decoder_layer(P, p, tgt, memory, mem_mask, pos, qpos, heads, rate, gen):
    """Post-norm decoder layer with self-attention; dropout from `gen` in
    the order the sites run."""
    drop = lambda t: dropout(t, rate, gen)
    qk = tgt + qpos
    tgt = layer_norm(P, f"{p}.norm1", tgt + drop(attention(
        P, f"{p}.self_attn", heads, qk, qk, tgt, None, rate, gen)))
    tgt = layer_norm(P, f"{p}.norm2", tgt + drop(attention(
        P, f"{p}.multihead_attn", heads, tgt + qpos, memory + pos, memory, mem_mask, rate,
        gen)))
    h = linear(P, f"{p}.linear2", drop(F.relu(linear(P, f"{p}.linear1", tgt))))
    return layer_norm(P, f"{p}.norm3", tgt + drop(h))


def detr(P, cfg, tokens, mask, target, gen=None):
    """Concatenated tokens [B, L, D] -> (hidden [layers, B, Q, D], memory)."""
    k = dims(cfg)
    rate = cfg["model.detr_dropout"] if gen is not None else 0.0
    extra = (-tokens.shape[1]) % cfg["model.detr_seq_pad_multiple"]
    if extra:
        tokens, mask = F.pad(tokens, (0, 0, 0, extra)), F.pad(mask, (0, extra))
    pos = sine_pos(mask, k["d"])
    x = tokens
    for i in range(k["enc"]):
        seed = draw_seed(gen) if rate > 0.0 else 0
        x = encoder_layer(P, f"detr_transformer.encoder.layers.{i}", x, mask, pos, k["dh"],
                          rate, seed, k["ffn"])
    memory = x
    qpos = P["decoder_query_embed.weight"][None].expand(x.shape[0], -1, -1)
    tgt, hidden = target, []
    for i in range(k["dec"]):
        tgt = decoder_layer(P, f"detr_transformer.decoder.layers.{i}", tgt, memory, mask, pos,
                            qpos, k["dh"], rate, gen)
        hidden.append(layer_norm(P, "detr_transformer.decoder.norm", tgt))
    return torch.stack(hidden), memory


def heads(P, hidden):
    logits = linear(P, "class_embed", hidden)
    h = hidden
    for i in range(3):
        h = linear(P, f"span_embed.layers.{i}", h)
        h = F.relu(h) if i < 2 else h
    return logits, torch.sigmoid(h)


# ---------------------------------------------------------------- training
def forward(P, cfg, batch, gen=None):
    """The training forward: towers, X-Pool similarity, DETR and heads, with
    dropout from `gen` (None: none)."""
    fused_t = cfg["model.fused_temporal"]
    ft, vemb = tower(P, cfg, "video", batch["frame_feats"], batch["frame_mask"], gen, fused_t)
    st, memb = tower(P, cfg, "music", batch["segment_feats"], batch["segment_mask"], gen,
                     fused_t)
    rate = cfg["model.xpool_dropout"] if gen is not None else 0.0
    seed = draw_seed(gen) if rate > 0.0 else 0
    single = xpool_sim(P, vemb, st, batch["segment_mask"], rate, seed)
    q = cfg["model.num_moment_queries"]
    hidden, _ = detr(P, cfg, torch.cat([ft, st], 1),
                     torch.cat([batch["frame_mask"], batch["segment_mask"]], 1),
                     vemb[:, None, :].expand(-1, q, -1), gen)
    logits, spans = heads(P, hidden)
    return {"video_emb": vemb, "music_emb": memb, "music_tokens": st, "single_sim": single,
            "logits": logits, "spans": spans,
            "proj_q": l2n(linear(P, "contrastive_align_projection_query", hidden)),
            "proj_v": l2n(linear(P, "contrastive_align_projection_vid", ft))}


def cw_to_se(cw):
    return torch.stack([cw[..., 0] - 0.5 * cw[..., 1], cw[..., 0] + 0.5 * cw[..., 1]], -1)


def giou(a, b):
    """Generalized IoU of matched (start, end) spans."""
    inter = torch.clamp(torch.minimum(a[..., 1], b[..., 1]) - torch.maximum(a[..., 0], b[..., 0]),
                        min=0)
    union = (a[..., 1] - a[..., 0]) + (b[..., 1] - b[..., 0]) - inter
    enc = torch.clamp(torch.maximum(a[..., 1], b[..., 1]) - torch.minimum(a[..., 0], b[..., 0]),
                      min=0)
    safe = lambda n, dn: torch.where(dn > 0, n / torch.where(dn > 0, dn, torch.ones_like(dn)),
                                     torch.zeros_like(n))
    return safe(inter, union) - safe(enc - union, enc)


def match(cfg, logits, spans, tgt):
    """The query matched to the one target of each row: the least cost
    10 |L1| - gIoU - 4 P(fg) (Moment-DETR's weights), first on ties."""
    if logits.shape[1] == 1:
        return torch.zeros(logits.shape[0], dtype=torch.int64, device=logits.device)
    fg = torch.softmax(logits, -1)[..., 0]
    l1 = (spans - tgt[:, None, :]).abs().sum(-1)
    g = giou(cw_to_se(spans), cw_to_se(tgt)[:, None, :].expand_as(spans))
    cost = cfg["loss.cost_span"] * l1 - cfg["loss.cost_giou"] * g - cfg["loss.cost_class"] * fg
    return cost.argmin(dim=1)


def clip_ce(sims, scale):
    logits = sims * torch.exp(scale)
    return -(torch.diagonal(F.log_softmax(logits, 1)).mean()
             + torch.diagonal(F.log_softmax(logits, 0)).mean()) / 2.0


def loss_terms(cfg, out, P, spans_target) -> Dict[str, torch.Tensor]:
    """The retrieval loss (InfoNCE of the dual cosine + CLIP loss of the
    pooled similarity) and the DETR set loss over every decoder layer."""
    scale = P["logit_scale"]
    dual = clip_ce(l2n(out["video_emb"]) @ l2n(out["music_emb"]).T, scale)
    single = clip_ce(out["single_sim"], scale)
    tgt = spans_target[:, 0]
    with torch.no_grad():
        idx = [match(cfg, out["logits"][i], out["spans"][i], tgt)
               for i in range(out["logits"].shape[0])]
    loc = 0.0
    rows = torch.arange(tgt.shape[0], device=tgt.device)
    for i, j in enumerate(idx):
        logits, spans, pq = out["logits"][i], out["spans"][i], out["proj_q"][i]
        fgq = torch.zeros(logits.shape[:2], dtype=torch.bool, device=logits.device)
        fgq[rows, j] = True
        m = spans[rows, j]
        l_span = (m - tgt).abs().sum() / (tgt.shape[0] * 2.0)
        l_giou = (1.0 - giou(cw_to_se(m), cw_to_se(tgt))).sum() / tgt.shape[0]
        logp = F.log_softmax(logits, -1)
        nll = torch.where(fgq, -logp[..., 0], -logp[..., 1])
        l_label = (nll * torch.where(fgq, 1.0, cfg["loss.eos_coef"])).mean()
        al = torch.einsum("bqd,bfd->bq", pq, out["proj_v"]) / cfg["loss.align_temperature"]
        l_align = (-(al * fgq).sum(1) + torch.logsumexp(al, 1)).mean()
        loc = loc + (cfg["loss.weight_span"] * l_span + cfg["loss.weight_giou"] * l_giou
                     + cfg["loss.weight_label"] * l_label
                     + cfg["loss.weight_contrastive_align"] * l_align)
    ret = dual + single
    return {"loss": ret + loc, "retrieval_loss": ret, "localization_loss": loc}


def lr_at(cfg, count: int, total_steps: int) -> float:
    """Warmup-cosine learning rate of update `count` (0 first), in float32."""
    f32 = np.float32
    base = f32(cfg["train.matching_lr"])
    warm = int(total_steps * cfg["train.warmup_rate"])
    c = f32(count)
    if c < warm:
        return float(base * (c / f32(max(1.0, warm))))
    prog = (c - f32(warm)) / f32(max(1.0, total_steps - warm))
    return float(base * np.maximum(f32(0.0), f32(0.5) * (f32(1.0) + np.cos(f32(math.pi) * prog,
                                                                           dtype=f32))))


class Adam:
    """Adam over the three groups, each clipped by its own gradient norm
    (scaled to 1 where it reaches 1), decoder_query_embed frozen."""

    def __init__(self, P: Params, cfg: dict, total_steps: int):
        self.P, self.cfg, self.total = P, cfg, total_steps
        self.mu = {n: torch.zeros_like(p) for n, p in P.items() if group_of(n) != FROZEN}
        self.nu = {n: torch.zeros_like(p) for n in self.mu for p in [P[n]]}
        self.count = 0

    @torch.no_grad()
    def step(self, grads: Params) -> Params:
        """Apply one update; returns each parameter's gradient as clipped."""
        c = self.cfg
        b1, b2, eps = c["train.adam_b1"], c["train.adam_b2"], c["train.adam_eps"]
        k = self.count + 1
        lr = lr_at(c, self.count, self.total)
        clipped = {}
        for g in (TEMPORAL, MATCHING, DETECTION):
            names = [n for n in self.mu if group_of(n) == g]
            norm = torch.sqrt(sum((grads[n].double() ** 2).sum() for n in names)).float()
            scale = c["train.max_grad_norm"] / norm if norm >= c["train.max_grad_norm"] else 1.0
            for n in names:
                gr = grads[n] * scale
                clipped[n] = gr
                self.mu[n] = b1 * self.mu[n] + (1 - b1) * gr
                self.nu[n] = b2 * self.nu[n] + (1 - b2) * gr * gr
                upd = (self.mu[n] / (1 - b1 ** k)) / (torch.sqrt(self.nu[n] / (1 - b2 ** k)) + eps)
                self.P[n] = self.P[n] - lr * upd
        self.count += 1
        return clipped


def train_steps(P0: Params, cfg: dict, batches: List[dict], seed: int, total_steps: int,
                first_step: int = 0) -> dict:
    """Run len(batches) training steps from the weights P0 (not changed),
    the dropout of step i keyed on (seed, first_step + i).  Returns each
    step's loss, the first step's clipped gradient by leaf, and the
    weights after the last step."""
    P = {n: p.detach().clone() for n, p in P0.items()}
    opt = Adam(P, cfg, total_steps)
    losses, first_grad = [], None
    for i, batch in enumerate(batches):
        leaves = {n: p.requires_grad_(True) for n, p in opt.P.items()}
        gen = step_generator(seed, first_step + i, batch["frame_feats"].device)
        out = forward(leaves, cfg, batch, gen)
        terms = loss_terms(cfg, out, leaves, batch["spans_target"])
        names = [n for n in leaves if group_of(n) != FROZEN]
        grads = torch.autograd.grad(terms["loss"], [leaves[n] for n in names])
        opt.P = {n: p.detach() for n, p in leaves.items()}
        clipped = opt.step(dict(zip(names, grads)))
        losses.append(float(terms["loss"].detach()))
        if first_grad is None:
            first_grad = clipped
        del out, terms, grads
    return {"losses": losses, "first_grad": first_grad, "params": opt.P}


def gather(tree: Dict[str, torch.Tensor], idx: torch.Tensor) -> dict:
    """A batch from the raw tables: rows, widened to float32, masked."""
    vr, mr = tree["video_rows"][idx], tree["music_rows"][idx]
    fm, sm = tree["vm"][vr].float(), tree["mm"][mr].float()
    return {"frame_feats": tree["vf"][vr].float() * fm[..., None], "frame_mask": fm,
            "segment_feats": tree["mf"][mr].float() * sm[..., None], "segment_mask": sm,
            "spans_target": tree["spans"][idx].float()}


# ---------------------------------------------------------------- evaluation
def top_span(cfg, logits, spans):
    """Of one decoder layer's heads [N, Q, 2], each row's top-1 span in
    seconds [N, 2] and its score [N]: the query of the highest foreground
    probability."""
    score = torch.softmax(logits, -1)[..., 0]
    best = score.argmax(-1)
    rows = torch.arange(best.shape[0], device=best.device)
    return cw_to_se(spans)[rows, best] * cfg["data.max_m_duration"], score[rows, best]


@torch.no_grad()
def evaluation(P, cfg, tree, batch_size: int, block: int = 64) -> dict:
    """An evaluation of the rows of `tree` in order: the forward without
    dropout a batch of `batch_size` rows (the last padded by repeating the
    last row), each batch's loss weighted by its valid rows, each row's top-1
    span in seconds, and the corpus similarity of dual_single_loss_fuse, the
    dual cosine plus the pooled X-Pool cosine, `block` tracks at a time.
    Returns {"sim" [N, N], "spans" [N, 2], "loss", "retrieval_losses" (a
    batch's each)}."""
    if cfg["loss.vmr_loss"] != "dual_single_loss_fuse":
        raise ValueError(f"the reference evaluates dual_single_loss_fuse, "
                         f"not {cfg['loss.vmr_loss']!r}")
    n = tree["video_rows"].shape[0]
    pad = (-n) % batch_size
    order = torch.cat([torch.arange(n), torch.full((pad,), n - 1)]).to(tree["vf"].device)
    parts = {"video_emb": [], "music_emb": [], "music_tokens": [], "segment_mask": [],
             "spans": []}
    losses, retrieval, weights = [], [], []
    for i in range(0, n + pad, batch_size):
        batch = gather(tree, order[i:i + batch_size])
        out = forward(P, cfg, batch)
        terms = loss_terms(cfg, out, P, batch["spans_target"])
        losses.append(float(terms["loss"]))
        retrieval.append(float(terms["retrieval_loss"]))
        weights.append(min(batch_size, n - i))
        out["segment_mask"] = batch["segment_mask"]
        out["spans"] = top_span(cfg, out["logits"][-1], out["spans"][-1])[0]
        for k, v in parts.items():
            v.append(out[k])
    cat = {k: torch.cat(v)[:n] for k, v in parts.items()}
    vemb, memb = cat["video_emb"], cat["music_emb"]
    sim = l2n(vemb) @ l2n(memb).T + xpool_sim(P, vemb, cat["music_tokens"],
                                               cat["segment_mask"], block=block)
    return {"sim": sim, "spans": cat["spans"], "loss": float(np.average(losses, weights=weights)),
            "retrieval_losses": np.array(retrieval)}


# ---------------------------------------------------------------- serving
@torch.no_grad()
def music_index(P, cfg, feats, masks, block: int = 512):
    """The music tower over a catalog: (tokens [M, S, D], embeddings [M, D])."""
    toks, embs = [], []
    for i in range(0, feats.shape[0], block):
        t, e = tower(P, cfg, "music", feats[i:i + block].float(), masks[i:i + block].float())
        toks.append(t)
        embs.append(e)
    return torch.cat(toks), torch.cat(embs)


@torch.no_grad()
def rank(P, cfg, frames, fmask, tokens, embs, smask, block: int = 1024):
    """Retrieval scores [V, M] (the dual cosine plus the pooled X-Pool
    cosine) and the video tower's (tokens, embeddings)."""
    ft, vemb = tower(P, cfg, "video", frames.float(), fmask.float())
    sims = l2n(vemb) @ l2n(embs).T + xpool_sim(P, vemb, tokens, smask, block=block)
    return sims, ft, vemb


@torch.no_grad()
def localize(P, cfg, ft, fmask, vemb, tokens, smask):
    """Each (video, track) pair's moment in seconds [N, 2] and its score
    [N]: the DETR over the concatenated tokens, the query of the highest
    foreground probability."""
    q = cfg["model.num_moment_queries"]
    hidden, _ = detr(P, cfg, torch.cat([ft, tokens], 1), torch.cat([fmask.float(), smask], 1),
                     vemb[:, None, :].expand(-1, q, -1))
    return top_span(cfg, *heads(P, hidden[-1]))

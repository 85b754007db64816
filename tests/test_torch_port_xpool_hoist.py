"""The X-Pool training forward and backward with Wout hoisted out of the
pairs, as csrc/xpool_sim_train.cu computes them, against the JAX package.

Wout acts linearly on a softmax-weighted sum before bout and LN2, so

    Wout (sum_s p_s v_ms) + bout = sum_s p_s u_ms + bout,   u_m = v_m Wout^T,

and both passes need Wout once per track.  `hoisted_forward` writes the
forward chain out by hand in float64 torch, step for step as the CUDA
forward runs it: u^T = Wout v_m^T once per track, the scores in chunks of
128 snippets (snippets past S at -inf, masked ones at -1e9), the softmax,
pre = p u_m + bout, LN2, the dropped linear branch, LN3, the cosine.  It is
held against JAX's `_xpool_core` forward (the Pallas kernel in interpret
mode) at rate 0, against `_core_jax` fed the port's Philox mask at rate
0.3, and against the evaluation kernel `xpool_sim_fused` (interpret mode)
with the X-Pool input projections in front; every case has a track with no
valid snippet (uniform weights), at two shapes with ragged V and S.

The backward needs du_m = sum_v p_mv^T dpre_mv, dWout = sum_(m, s) du_ms^T
v_ms and dv_m = du_m Wout.  `hoisted_backward` writes that chain out the
same way (the cosine's and LN3's backward, dWlin, dh, LN2's backward, dp,
ds, du, dk, dq), and is held against JAX's `_xpool_core` VJP (forward and
backward Pallas kernels in interpret mode) at rate 0, and against the VJP of
the mask-fixed oracle `_core_jax` fed the same explicit mask at rate 0.3,
with a track that has no valid snippet (its masked scores are constants,
so q and k get nothing through them, as in `_core_jax` and the port's plain
version; JAX's Pallas backward gives such a track's uniform weights a
gradient, so the rate-0 comparison keeps every track one valid snippet).
Tolerance atol 5e-5, rtol 5e-4, as tests/test_torch_port_xpool.py holds the
float32 port (JAX runs float32).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mgsv_tpu.ops.pallas.xpool_sim import xpool_sim_fused
from mgsv_tpu.ops.pallas.xpool_sim_vjp import _core_jax, _xpool_core
from mgsv_tpu_torch.ops import philox

ATOL, RTOL = 5e-5, 5e-4
NAMES = ["q", "k", "v", "vhat", "Wout", "bout", "g2", "b2", "Wlin", "blin", "g3", "b3"]
EPS = 1e-5
CHUNK = 128                # snippets per score chunk of the CUDA forward
SHAPES = [(12, 20, 16), (7, 5, 37)]


def _inputs(vc, m, s, d, seed, dead_track=False):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((vc, d), dtype=np.float32)
    k, v = (rng.standard_normal((m, s, d), dtype=np.float32) for _ in range(2))
    mask = (rng.random((m, s)) < 0.7).astype(np.float32)
    mask[:, 0] = 1
    if dead_track:
        mask[1] = 0                # a track with no valid snippet: uniform weights
    vhat = rng.standard_normal((vc, d), dtype=np.float32)
    vhat /= np.linalg.norm(vhat, axis=-1, keepdims=True)
    eye = np.eye(d, dtype=np.float32)
    near = lambda base: (base + 0.1 * rng.standard_normal(base.shape)).astype(np.float32)
    zeros, ones = np.zeros(d, np.float32), np.ones(d, np.float32)
    jax_w = [near(eye), near(zeros), near(ones), near(zeros),
             near(eye), near(zeros), near(ones), near(zeros)]
    g = rng.standard_normal((m, vc), dtype=np.float32)
    return q, k, v, mask, vhat, jax_w, g


def _ln(x):
    mean = x.mean(-1, keepdim=True)
    xc = x - mean
    inv = torch.rsqrt((xc * xc).mean(-1, keepdim=True) + EPS)
    return xc * inv, inv


def _ln_bwd(dy, gamma, xhat, inv):
    dyg = dy * gamma
    return (dyg - dyg.mean(-1, keepdim=True)
            - xhat * (dyg * xhat).mean(-1, keepdim=True)) * inv


def hoisted_forward(q, k, v, mask, vhat, weights, dmask):
    """The forward's intermediates (sims [M, V] under "sim"), with u^T =
    Wout v_m^T once per track; float64 tensors."""
    wout, bout, g2, b2, wlin, blin, g3, b3 = weights
    m, s, d = k.shape
    ut = torch.einsum("od,msd->mos", wout, v)                    # [M, D, S], once per track
    # scores a chunk of CHUNK snippets at a time; snippets past S at -inf
    sp = -(-s // CHUNK) * CHUNK
    scores = torch.full((m, q.shape[0], sp), float("-inf"), dtype=q.dtype)
    for c in range(0, s, CHUNK):
        end = min(c + CHUNK, s)
        part = torch.einsum("vd,msd->mvs", q, k[:, c:end]) * d ** -0.5
        scores[..., c:end] = torch.where(mask[:, None, c:end] != 0, part,
                                         torch.full_like(part, -1e9))
    e = torch.exp(scores - scores.amax(-1, keepdim=True))
    p = (e / e.sum(-1, keepdim=True))[..., :s]                   # [M, V, S]
    pre = torch.einsum("mvs,mds->mvd", p, ut) + bout
    xh2, inv2 = _ln(pre)
    h = xh2 * g2 + b2
    t3 = h + (h @ wlin.T + blin) * dmask
    xh3, inv3 = _ln(t3)
    o = xh3 * g3 + b3
    inv_n = torch.rsqrt(torch.clamp((o * o).sum(-1, keepdim=True), min=1e-24))
    ohat = o * inv_n
    sim = (ohat * vhat[None]).sum(-1)
    return dict(u=ut.transpose(1, 2), p=p, xh2=xh2, inv2=inv2, h=h, xh3=xh3, inv3=inv3,
                inv_n=inv_n, ohat=ohat, sim=sim)


def hoisted_backward(q, k, v, mask, vhat, weights, g, dmask):
    """Gradients of sum(g * sims) (q, k, v, vhat and the 8 stage weights in
    torch layout), with u = v Wout^T once per track; float64 tensors."""
    wout, bout, g2, b2, wlin, blin, g3, b3 = weights
    d = q.shape[-1]
    scale = d ** -0.5
    f = hoisted_forward(q, k, v, mask, vhat, weights, dmask)
    u, p, xh2, inv2, h = f["u"], f["p"], f["xh2"], f["inv2"], f["h"]
    xh3, inv3, inv_n, ohat = f["xh3"], f["inv3"], f["inv_n"], f["ohat"]
    sim = f["sim"][..., None]
    # the cosine and LN3
    gv = g[..., None]
    dvhat = (gv * ohat).sum(0)
    do = gv * (vhat[None] - sim * ohat) * inv_n
    dg3, db3 = (do * xh3).sum((0, 1)), do.sum((0, 1))
    du3 = _ln_bwd(do, g3, xh3, inv3)
    # the dropped linear branch and LN2
    dlin = du3 * dmask
    dblin = dlin.sum((0, 1))
    dwlin = torch.einsum("mvo,mvi->oi", dlin, h)
    dh = du3 + dlin @ wlin
    dg2, db2 = (dh * xh2).sum((0, 1)), dh.sum((0, 1))
    dpre = _ln_bwd(dh, g2, xh2, inv2)
    dbout = dpre.sum((0, 1))
    # the pooling over snippets, Wout once per track
    dp = torch.einsum("mvd,msd->mvs", dpre, u)
    ds = p * (dp - (p * dp).sum(-1, keepdim=True))
    ds = torch.where(mask[:, None, :] != 0, ds, torch.zeros_like(ds))
    du = torch.einsum("mvs,mvd->msd", p, dpre)
    dk = torch.einsum("mvs,vd->msd", ds, q) * scale
    dq = torch.einsum("mvs,msd->vd", ds, k) * scale
    dwout = torch.einsum("mso,msi->oi", du, v)
    dv = du @ wout
    return [dq, dk, dv, dvhat, dwout, dbout, dg2, db2, dwlin, dblin, dg3, db3]


def _t64(a):
    return torch.from_numpy(np.asarray(a, np.float64))


def _torch64(jax_w):
    """JAX (x @ W) stage weights -> float64 torch [out, in]."""
    return [_t64(w.T) if w.ndim == 2 else _t64(w) for w in jax_w]


def _hoisted_sims(q, k, v, mask, vhat, jax_w, dmask):
    return hoisted_forward(_t64(q), _t64(k), _t64(v), _t64(mask), _t64(vhat), _torch64(jax_w),
                           _t64(dmask))["sim"].numpy()


def _hoisted(q, k, v, mask, vhat, jax_w, g, dmask):
    t = _t64
    weights = _torch64(jax_w)
    grads = hoisted_backward(t(q), t(k), t(v), t(mask), t(vhat), weights, t(g), t(dmask))
    grads = [gr.numpy() for gr in grads]
    grads[4], grads[8] = grads[4].T, grads[8].T                   # back to JAX layout
    return grads


def _assert_grads(got, want):
    for name, a, b in zip(NAMES, got, want):
        np.testing.assert_allclose(a, np.asarray(b), atol=ATOL, rtol=RTOL, err_msg=name)


@pytest.mark.kernel
@pytest.mark.parametrize("vc,m,s", [(12, 20, 16), (7, 5, 37)])
def test_hoisted_backward_matches_pallas_vjp_at_rate_0(vc, m, s):
    q, k, v, mask, vhat, jax_w, g = _inputs(vc, m, s, 32, seed=0)
    seed = jnp.zeros((1,), jnp.int32)
    _, vjp = jax.vjp(
        lambda q_, k_, v_, vh_, *w: _xpool_core(q_, k_, v_, jnp.asarray(mask), vh_, *w,
                                                seed, 0.0, 8, 4, True),
        *map(jnp.asarray, (q, k, v, vhat, *jax_w)))
    ones = np.ones((m, vc, 32), np.float32)
    _assert_grads(_hoisted(q, k, v, mask, vhat, jax_w, g, ones), vjp(jnp.asarray(g)))


@pytest.mark.kernel
def test_hoisted_backward_matches_core_jax_with_dropout():
    """Rate 0.3: the port's Philox mask [M, V, D] on both sides."""
    rate, seed = 0.3, 77
    q, k, v, mask, vhat, jax_w, g = _inputs(10, 9, 12, 32, seed=1, dead_track=True)
    dmask = philox.xpool_mask(seed, k.shape[0], q.shape[0], q.shape[1], rate).numpy()
    _, vjp = jax.vjp(
        lambda q_, k_, v_, vh_, *w: _core_jax(q_, k_, v_, jnp.asarray(mask), vh_, *w,
                                              jnp.asarray(dmask)),
        *map(jnp.asarray, (q, k, v, vhat, *jax_w)))
    _assert_grads(_hoisted(q, k, v, mask, vhat, jax_w, g, dmask), vjp(jnp.asarray(g)))


@pytest.mark.kernel
@pytest.mark.parametrize("vc,m,s", SHAPES)
def test_hoisted_forward_matches_pallas_core_at_rate_0(vc, m, s):
    q, k, v, mask, vhat, jax_w, _ = _inputs(vc, m, s, 32, seed=2, dead_track=True)
    ref = _xpool_core(*map(jnp.asarray, (q, k, v, mask, vhat, *jax_w)),
                      jnp.zeros((1,), jnp.int32), 0.0, 8, 4, True)
    got = _hoisted_sims(q, k, v, mask, vhat, jax_w, np.ones((m, vc, 32), np.float32))
    np.testing.assert_allclose(got, np.asarray(ref), atol=ATOL, rtol=RTOL)


@pytest.mark.kernel
@pytest.mark.parametrize("vc,m,s", SHAPES)
def test_hoisted_forward_matches_core_jax_with_dropout(vc, m, s):
    """Rate 0.3: the port's Philox mask [M, V, D] on both sides."""
    rate, seed = 0.3, 41
    q, k, v, mask, vhat, jax_w, _ = _inputs(vc, m, s, 32, seed=3, dead_track=True)
    dmask = philox.xpool_mask(seed, m, vc, 32, rate).numpy()
    ref = _core_jax(*map(jnp.asarray, (q, k, v, mask, vhat, *jax_w, dmask)))
    got = _hoisted_sims(q, k, v, mask, vhat, jax_w, dmask)
    np.testing.assert_allclose(got, np.asarray(ref), atol=ATOL, rtol=RTOL)


@pytest.mark.kernel
@pytest.mark.parametrize("vc,m,s", SHAPES)
def test_hoisted_forward_matches_eval_kernel(vc, m, s):
    """Against `xpool_sim_fused` ([V, M]), the evaluation's kernel, from
    video embeddings and snippet tokens: LN1 and the q, k, v projections in
    front (float64 here), vhat the normalized video embedding."""
    d = 32
    rng = np.random.default_rng(4)
    video = rng.standard_normal((vc, d), dtype=np.float32)
    segs = rng.standard_normal((m, s, d), dtype=np.float32)
    _, _, _, mask, _, jax_w, _ = _inputs(vc, m, s, d, seed=5, dead_track=True)
    near = lambda base: (base + 0.1 * rng.standard_normal(base.shape)).astype(np.float32)
    eye, zeros, ones = np.eye(d, dtype=np.float32), np.zeros(d, np.float32), np.ones(d, np.float32)
    dense = lambda w, b: {"kernel": w, "bias": b}
    proj = {name: dense(near(eye), near(zeros)) for name in ("q_proj", "k_proj", "v_proj")}
    params = {
        "layer_norm1": {"scale": near(ones), "bias": near(zeros)},
        "cross_attn": {**proj, "out_proj": dense(jax_w[0], jax_w[1])},
        "layer_norm2": {"scale": jax_w[2], "bias": jax_w[3]},
        "linear_proj": dense(jax_w[4], jax_w[5]),
        "layer_norm3": {"scale": jax_w[6], "bias": jax_w[7]},
    }
    ref = xpool_sim_fused(jnp.asarray(video), jnp.asarray(segs), jnp.asarray(mask),
                          jax.tree_util.tree_map(jnp.asarray, params), interpret=True)
    ln1 = params["layer_norm1"]

    def project(x, name):
        mean = x.mean(-1, keepdims=True)
        var = ((x - mean) ** 2).mean(-1, keepdims=True)
        xn = (x - mean) / np.sqrt(var + EPS) * ln1["scale"] + ln1["bias"]
        return xn @ proj[name]["kernel"].astype(np.float64) + proj[name]["bias"]

    video64, segs64 = video.astype(np.float64), segs.astype(np.float64)
    q, k, v = project(video64, "q_proj"), project(segs64, "k_proj"), project(segs64, "v_proj")
    vhat = video64 / np.linalg.norm(video64, axis=-1, keepdims=True)
    got = _hoisted_sims(q, k, v, mask, vhat, jax_w, np.ones((m, vc, d)))
    np.testing.assert_allclose(got.T, np.asarray(ref), atol=ATOL, rtol=RTOL)

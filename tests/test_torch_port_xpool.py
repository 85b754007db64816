"""The port's training X-Pool similarity (ops/cuda/xpool_sim.py) vs the JAX
package's custom-VJP core (mgsv_tpu/ops/pallas/xpool_sim_vjp.py).

On the CPU the wrapper runs its plain version and autograd differentiates
it; at rate 0 it is held against `_xpool_core` (forward and backward Pallas
kernels in interpret mode), at rate 0.3 against the mask-fixed oracle
`_core_jax` fed the port's Philox mask.  Tolerance atol 5e-5, rtol 5e-4, as
tests/test_xpool_sim_vjp.py holds the Pallas VJP.  The CUDA kernels are held
against the plain version on the card by tests/test_torch_port_cuda.py and
chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mgsv_tpu.models.xpool import FusedXPoolSim
from mgsv_tpu.ops.pallas.xpool_sim_vjp import _core_jax, _xpool_core
from mgsv_tpu_torch.interop.state_dict import _xpool
from mgsv_tpu_torch.models.xpool import XPoolTransformer, sim_matrix_music_pooling
from mgsv_tpu_torch.ops import philox
from mgsv_tpu_torch.ops.cuda import xpool_sim as xps

ATOL, RTOL = 5e-5, 5e-4
NAMES = ["q", "k", "v", "vhat", "Wout", "bout", "g2", "b2", "Wlin", "blin", "g3", "b3"]


def _inputs(vc=12, m=20, s=16, d=32, seed=0):
    """numpy q, k, v, mask, vhat, the JAX-layout stage weights and a cotangent."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((vc, d), dtype=np.float32)
    k, v = (rng.standard_normal((m, s, d), dtype=np.float32) for _ in range(2))
    mask = (rng.random((m, s)) < 0.7).astype(np.float32)
    mask[:, 0] = 1
    vhat = rng.standard_normal((vc, d), dtype=np.float32)
    vhat /= np.linalg.norm(vhat, axis=-1, keepdims=True)
    eye = np.eye(d, dtype=np.float32)
    near = lambda base: (base + 0.1 * rng.standard_normal(base.shape)).astype(np.float32)
    zeros, ones = np.zeros(d, np.float32), np.ones(d, np.float32)
    jax_w = [near(eye), near(zeros), near(ones), near(zeros),
             near(eye), near(zeros), near(ones), near(zeros)]
    g = rng.standard_normal((m, vc), dtype=np.float32)
    return q, k, v, mask, vhat, jax_w, g


def _torch_weights(jax_w):
    """JAX (x @ W) stage weights -> the port's torch layout ([out, in])."""
    return [w.T.copy() if w.ndim == 2 else w for w in jax_w]


def _port(q, k, v, mask, vhat, jax_w, g, rate, seed):
    ins = [torch.from_numpy(np.array(a)).requires_grad_()
           for a in (q, k, v, vhat, *_torch_weights(jax_w))]
    out = xps.xpool_sim(ins[0], ins[1], ins[2], torch.from_numpy(mask), ins[3], ins[4:],
                        rate, seed)
    grads = torch.autograd.grad(out, ins, torch.from_numpy(g))
    grads = [gr.numpy() for gr in grads]
    grads[4], grads[8] = grads[4].T, grads[8].T          # back to JAX layout
    return out.detach().numpy(), grads


def _assert_all(out, grads, ref, ref_grads):
    np.testing.assert_allclose(out, np.asarray(ref), atol=ATOL, rtol=RTOL)
    for name, got, want in zip(NAMES, grads, ref_grads):
        np.testing.assert_allclose(got, np.asarray(want), atol=ATOL, rtol=RTOL, err_msg=name)


@pytest.mark.kernel
def test_plain_version_and_grads_match_xpool_core_at_rate_0():
    q, k, v, mask, vhat, jax_w, g = _inputs()
    seed = jnp.zeros((1,), jnp.int32)
    ref, vjp = jax.vjp(
        lambda q_, k_, v_, vh_, *w: _xpool_core(q_, k_, v_, jnp.asarray(mask), vh_, *w,
                                                seed, 0.0, 8, 4, True),
        *map(jnp.asarray, (q, k, v, vhat, *jax_w)))
    out, grads = _port(q, k, v, mask, vhat, jax_w, g, 0.0, 0)
    _assert_all(out, grads, ref, vjp(jnp.asarray(g)))
    assert xps.xpool_sim_fwd.launches == xps.xpool_sim_bwd.launches == 0


@pytest.mark.kernel
def test_plain_version_and_grads_match_core_jax_with_the_same_mask():
    """Dropout 0.3 on the linear branch: the port's Philox mask [M, V, D],
    fed to the JAX oracle as numpy."""
    rate, seed = 0.3, 77
    q, k, v, mask, vhat, jax_w, g = _inputs(vc=10, m=9, s=12, d=32, seed=1)
    dmask = jnp.asarray(philox.xpool_mask(seed, k.shape[0], q.shape[0], q.shape[1],
                                          rate).numpy())
    ref, vjp = jax.vjp(
        lambda q_, k_, v_, vh_, *w: _core_jax(q_, k_, v_, jnp.asarray(mask), vh_, *w, dmask),
        *map(jnp.asarray, (q, k, v, vhat, *jax_w)))
    out, grads = _port(q, k, v, mask, vhat, jax_w, g, rate, seed)
    _assert_all(out, grads, ref, vjp(jnp.asarray(g)))
    no_drop, _ = _port(q, k, v, mask, vhat, jax_w, g, 0.0, seed)
    assert np.abs(no_drop - out).max() > 100 * ATOL          # dropout really acted


@pytest.mark.kernel
def test_pooled_similarity_matches_fused_xpool_sim_module():
    """XPoolTransformer.pooled_similarity (LN1 and q/k/v under autograd, the
    pair stage through the wrapper) vs the JAX FusedXPoolSim module and the
    port's own unfused module chain, with gradients of the inputs."""
    d, vc, m, s = 32, 10, 14, 12
    rng = np.random.default_rng(5)
    video = rng.standard_normal((vc, d), dtype=np.float32)
    segs = rng.standard_normal((m, s, d), dtype=np.float32)
    mask = (rng.random((m, s)) < 0.7).astype(np.float32)
    mask[:, 0] = 1
    g = rng.standard_normal((vc, m), dtype=np.float32)
    fused = FusedXPoolSim(d, dropout=0.3, block_v=8, block_m=4)
    params = fused.init(jax.random.PRNGKey(0), jnp.asarray(video), jnp.asarray(segs),
                        jnp.asarray(mask), True)
    params = jax.tree.map(
        lambda x: x + 0.05 * rng.standard_normal(np.shape(x)).astype(np.float32), params)
    ref, vjp = jax.vjp(lambda v_, s_: fused.apply(params, v_, s_, jnp.asarray(mask), True),
                       jnp.asarray(video), jnp.asarray(segs))
    dvideo, dsegs = vjp(jnp.asarray(g))

    state = {}
    _xpool(state, "x", params["params"])
    xpool = XPoolTransformer(d, dropout=0.3)
    xpool.load_state_dict({k[2:]: torch.from_numpy(np.array(a)) for k, a in state.items()},
                          strict=True)
    vt, st = (torch.from_numpy(a).requires_grad_() for a in (video, segs))
    sim = xpool.pooled_similarity(vt, st, torch.from_numpy(mask))
    sim.backward(torch.from_numpy(g))
    np.testing.assert_allclose(sim.detach().numpy(), np.asarray(ref), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(vt.grad.numpy(), np.asarray(dvideo), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(st.grad.numpy(), np.asarray(dsegs), atol=ATOL, rtol=RTOL)
    with torch.no_grad():
        chain = sim_matrix_music_pooling(vt, xpool(vt, st, torch.from_numpy(mask)))
    np.testing.assert_allclose(chain.numpy(), sim.detach().numpy(), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("bad", ["device", "dtype", "dim", "mask", "snippets", "weight"])
def test_kernel_wrappers_reject_what_the_kernels_do_not_take(bad):
    vc, m, s, d = 4, 3, 8, 256
    q, vhat = torch.zeros(vc, d), torch.zeros(vc, d)
    k, v, mask = torch.zeros(m, s, d), torch.zeros(m, s, d), torch.ones(m, s)
    weights = list(XPoolTransformer(d).stage_weights())
    if bad == "dtype":
        q = q.double()
    elif bad == "dim":
        q, vhat, k, v = (t[..., :128].contiguous() for t in (q, vhat, k, v))
    elif bad == "mask":
        mask = torch.ones(m, s + 1)
    elif bad == "snippets":
        k, v, mask = (torch.zeros(m, xps.MAX_S + 1, d), torch.zeros(m, xps.MAX_S + 1, d),
                      torch.ones(m, xps.MAX_S + 1))
    elif bad == "weight":
        weights[0] = torch.zeros(d, d // 2)
    if bad == "device":                            # the kernels refuse CPU tensors
        with pytest.raises(ValueError):
            xps.xpool_sim_fwd(q, k, v, mask, vhat, weights)
        with pytest.raises(ValueError):
            xps.xpool_sim_bwd(q, k, v, mask, vhat, weights, torch.zeros(m, vc))
        assert xps.xpool_sim_fwd.launches == xps.xpool_sim_bwd.launches == 0
        xps.check_supported(q, k, v, mask, vhat, weights)
        return
    with pytest.raises(ValueError):
        xps.check_supported(q, k, v, mask, vhat, weights)

"""The port's attention (kernel #7's plain version, `default_attention`,
`make_attention_fn`) against the JAX package's: `flash_attention` run as
its own tests run it on the CPU (Pallas interpret mode) and
`vit_common.default_attention`.

Inputs are made with numpy from a seed.  Tolerances: float32 1e-5 abs
(outputs are softmax-weighted means of N(0, 1) values, of order 1; both
sides compute in float32 and differ by summation order); bfloat16 2e-2
abs (the Pallas kernel rounds q and p to bf16, the plain version keeps
float32 and rounds only its output).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mgsv_tpu.models.vit_common import default_attention as jax_default_attention
from mgsv_tpu.ops.pallas.flash_attention import flash_attention as jax_flash_attention
from mgsv_tpu_torch.models.vit_common import default_attention
from mgsv_tpu_torch.ops.cuda import flash_attention as fa

F32_ATOL, BF16_ATOL = 1e-5, 2e-2


def _qkv(seed, b, h, lq, lk, d=64):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, h, lq, d), dtype=np.float32),
            rng.standard_normal((b, h, lk, d), dtype=np.float32),
            rng.standard_normal((b, h, lk, d), dtype=np.float32))


def _ragged_mask(seed, b, lk, dead_row=None):
    lens = np.random.default_rng(seed).integers(1, lk + 1, b)
    mask = (np.arange(lk)[None] < lens[:, None]).astype(np.float32)
    if dead_row is not None:
        mask[dead_row] = 0.0
    return mask


@pytest.mark.parametrize("lq,lk,masked", [(50, 50, False), (130, 200, False),
                                          (130, 200, True), (77, 61, True)])
def test_plain_version_matches_jax_kernel_float32(lq, lk, masked):
    q, k, v = _qkv(lq + lk, 2, 3, lq, lk)
    mask = _ragged_mask(lk, 2, lk, dead_row=1) if masked else None
    scale = 0.125
    want = np.asarray(jax_flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale,
        None if mask is None else jnp.asarray(mask), block_q=64, block_k=64, interpret=True))
    got = fa.flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                             scale, None if mask is None else torch.from_numpy(mask))
    assert got.dtype == torch.float32 and got.shape == (2, 3, lq, 64)
    np.testing.assert_allclose(got.numpy(), want, atol=F32_ATOL, rtol=0)
    if masked:                                    # the fully masked row gives 0
        assert not got[1].any() and not np.asarray(want[1]).any()


def test_plain_version_matches_jax_kernel_bfloat16():
    q, k, v = _qkv(7, 2, 2, 130, 200)
    mask = _ragged_mask(8, 2, 200)
    scale = 0.125
    to_jax = lambda x: jnp.asarray(x, dtype=jnp.bfloat16)            # noqa: E731
    to_torch = lambda x: torch.from_numpy(x).to(torch.bfloat16)      # noqa: E731
    want = jax_flash_attention(to_jax(q), to_jax(k), to_jax(v), scale, jnp.asarray(mask),
                               block_q=64, block_k=64, interpret=True)
    got = fa.flash_attention(to_torch(q), to_torch(k), to_torch(v), scale,
                             torch.from_numpy(mask))
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=BF16_ATOL, rtol=0)


@pytest.mark.parametrize("lq,lk", [(50, 50), (130, 200)])
def test_default_attention_matches_jax(lq, lk):
    q, k, v = _qkv(lq, 2, 3, lq, lk, d=16)
    want = np.asarray(jax_default_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                            0.25))
    got = default_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), 0.25)
    np.testing.assert_allclose(got.numpy(), want, atol=F32_ATOL, rtol=0)
    # unmasked, the plain version of the kernel is the same function
    np.testing.assert_allclose(
        fa.flash_attention_reference(*(torch.from_numpy(x) for x in (q, k, v)), 0.25).numpy(),
        want, atol=F32_ATOL, rtol=0)


@pytest.mark.parametrize("lk,takes_kernel", [(50, False), (511, False), (512, True),
                                             (600, True)])
def test_make_attention_fn_routes_by_key_length(lk, takes_kernel, monkeypatch):
    calls = []
    monkeypatch.setattr(fa, "flash_attention",
                        lambda q, k, v, scale, key_mask=None: calls.append(k.shape[2]) or
                        fa.flash_attention_reference(q, k, v, scale, key_mask))
    q, k, v = (torch.from_numpy(x) for x in _qkv(lk, 1, 2, 8, lk))
    got = fa.make_attention_fn()(q, k, v, 0.125)
    assert calls == ([lk] if takes_kernel else [])
    np.testing.assert_allclose(got.numpy(), default_attention(q, k, v, 0.125).numpy(),
                               atol=F32_ATOL, rtol=0)


def test_kernel_path_refuses_what_it_does_not_take():
    """The shape and type checks that guard a CUDA launch (no CUDA tensor
    is needed to reach them)."""
    q = torch.zeros(1, 2, 8, 32)
    with pytest.raises(ValueError, match="head dim 32"):
        fa._check(q, q, q, None)
    q = torch.zeros(1, 2, 8, 64, dtype=torch.float16)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        fa._check(q, q, q, None)
    q = torch.zeros(1, 2, 8, 64)
    with pytest.raises(ValueError, match="key_mask"):
        fa._check(q, q, q, torch.ones(1, 7))

"""The port's Philox4x32-10 dropout masks (ops/philox.py; csrc/philox.cuh
is its CUDA twin, held against it on the card by chip_smoke.py through the
kernels at rate > 0)."""

import numpy as np
import pytest
import torch

from mgsv_tpu_torch.ops import philox


def test_random123_known_answer():
    """Random123's kat_vectors: philox4x32 10 rounds, counter 0, key 0."""
    z = torch.zeros(1, dtype=torch.int64)
    words = philox.philox4x32(z, z, z, z, 0, 0)
    assert [int(w) for w in words] == [0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8]


def test_known_answer_all_ones_and_pi():
    """The other two Random123 vectors (counter/key all ones; pi digits)."""
    ones = torch.full((1,), 0xFFFFFFFF, dtype=torch.int64)
    assert [int(w) for w in philox.philox4x32(ones, ones, ones, ones, 0xFFFFFFFF,
                                              0xFFFFFFFF)] == [
        0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD]
    c = [torch.tensor([v], dtype=torch.int64)
         for v in (0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344)]
    assert [int(w) for w in philox.philox4x32(*c, 0xA4093822, 0x299F31D0)] == [
        0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1]


def test_bits_layout_is_counter_word():
    """Element e of stream (a, b) is word e & 3 of counter (e >> 2, a, b, 0)."""
    a, b = torch.tensor([5]), torch.tensor([9])
    got = philox.bits(77, a, b, 10)[0]
    for e in range(10):
        words = philox.philox4x32(torch.tensor([e >> 2]), a, b, torch.zeros(1, dtype=torch.int64),
                                  77, 0)
        assert int(got[e]) == int(words[e & 3])


@pytest.mark.parametrize("rate", [0.1, 0.3, 0.8])
def test_keep_rate_within_four_sigma(rate):
    n_rows, n = 64, 4096
    mask = philox.keep_mask(11, torch.arange(n_rows)[:, None], torch.tensor([[3]]), n, rate)
    kept = (mask > 0).float().mean().item()
    sigma = np.sqrt(rate * (1 - rate) / (n_rows * n))
    assert abs(kept - (1 - rate)) <= 4 * sigma
    assert set(torch.unique(mask).tolist()) == {0.0, philox.keep_scale(rate)}
    assert abs(philox.keep_scale(rate) - 1 / (1 - rate)) < 1e-6


def _agreement(m1, m2):
    return ((m1 > 0) == (m2 > 0)).float().mean().item()


def test_masks_independent_across_rows_sites_musics_and_seeds():
    """Two different streams (or seeds) agree on a keep decision about as
    often as independent coins do: p^2 + (1-p)^2, within 4 sigma."""
    rate, n = 0.3, 20000
    p = 1 - rate
    expect = p * p + rate * rate
    sigma = np.sqrt(expect * (1 - expect) / n)
    m = lambda seed, a, b: philox.keep_mask(seed, torch.tensor([a]), torch.tensor([b]), n, rate)[0]
    base = m(1, 0, 0)
    for other in (m(1, 1, 0),        # next batch row / music
                  m(1, 0, 1),        # next site / video
                  m(2, 0, 0),        # next seed
                  m(1, 0, 8)):       # the attention-output site after 8 heads
        assert abs(_agreement(base, other) - expect) <= 4 * sigma
    assert _agreement(base, m(1, 0, 0)) == 1.0


def test_encoder_and_xpool_masks_use_the_documented_streams():
    b, L, d, f, h, rate, seed = 2, 3, 8, 16, 2, 0.25, 42
    masks = philox.encoder_masks(seed, b, L, d, f, h, rate)
    assert masks["attn"].shape == (b, h, L, L) and masks["ffn1"].shape == (b, L, f)
    km = lambda a, s, n: philox.keep_mask(seed, torch.tensor([a]), torch.tensor([s]), n, rate)[0]
    torch.testing.assert_close(masks["attn"][1, 1].reshape(-1), km(1, 1, L * L))
    torch.testing.assert_close(masks["attn_out"][0].reshape(-1), km(0, h, L * d))
    torch.testing.assert_close(masks["ffn1"][1].reshape(-1), km(1, h + 1, L * f))
    torch.testing.assert_close(masks["ffn2"][0].reshape(-1), km(0, h + 2, L * d))
    xm = philox.xpool_mask(seed, 3, 4, d, rate)
    assert xm.shape == (3, 4, d)
    torch.testing.assert_close(xm[2, 3], km(2, 3, d))


def test_kernel_args_turn_dropout_off_at_rate_0_and_refuse_rate_1():
    # the kernels read the seed through a pointer: null at rate 0
    assert philox.device_seed(123, 0.0, torch.device("cpu")) is None
    assert philox.kernel_args(0.0, None) == (0, 0, 1.0)
    seed = philox.device_seed(-1, 0.3, torch.device("cpu"))
    assert seed.dtype == torch.int32 and seed.shape == (1,)
    assert seed.numpy().view(np.uint32)[0] == 0xFFFFFFFF       # the uint32's bits
    assert philox.device_seed(seed, 0.3, torch.device("cpu")) is seed
    ptr, thresh, scale = philox.kernel_args(0.3, seed)
    assert ptr == seed.data_ptr() and thresh == philox.threshold(0.3) > 0
    assert scale == philox.keep_scale(0.3)
    with pytest.raises(ValueError):
        philox.kernel_args(1.0, seed)


@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 - 1, 2 ** 31 + 5, 2 ** 32 - 1])
def test_masks_from_a_seed_in_device_memory_equal_the_int_seeds(seed):
    """A seed handed over as a tensor (a slot of the step's seed buffer)
    draws the bits its int draws."""
    a = torch.arange(3, dtype=torch.int64)[:, None]
    b = torch.arange(2, dtype=torch.int64)[None, :]
    held = philox.seed_tensor(seed, torch.device("cpu"))
    assert torch.equal(philox.bits(held, a, b, 37), philox.bits(seed, a, b, 37))

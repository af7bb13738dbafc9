"""CogVideoX's tiled VAE encode (``vae_encode_tiled``) in the port against
``vap_tpu/models/cogvideox/vae.py:699`` on the tiny VAE (JAX's initializer,
jittered from a numpy seed, carried over by ``convert``): a 2 x 2 grid of
the 240 x 360 sample tiles, whose latent tiles blend over 5 rows and 9
columns, and a video that fits one tile, which is the plain encode to the
bit. float32 on both sides, the tolerance of the VAE encode's parity test
(``tests/test_torch_weights.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_ckpt_util import jitter
from vap_tpu.models.cogvideox import vae as jvae
from vap_tpu_torch import convert
from vap_tpu_torch.models.cogvideox import vae as tvae

ATOL, RTOL = 5e-5, 1e-5


@pytest.fixture(scope="module")
def vaes():
    jcfg, cfg = jvae.CogVideoXVAEConfig.tiny(), tvae.CogVideoXVAEConfig.tiny()
    params = jitter(jax.jit(jvae.init_cogvideox_vae, static_argnums=1)(jax.random.PRNGKey(0),
                                                                       jcfg), 0)
    model = tvae.AutoencoderKLCogVideoX(cfg).eval()
    model.load_state_dict(convert.from_jax_vae(params, cfg))
    return jcfg, jax.tree.map(jnp.asarray, params), model


def test_tile_constants_are_jax_s():
    assert (tvae.TILE_SAMPLE_MIN_H, tvae.TILE_SAMPLE_MIN_W, tvae.TILE_OVERLAP_H,
            tvae.TILE_OVERLAP_W) == (jvae.TILE_SAMPLE_MIN_H, jvae.TILE_SAMPLE_MIN_W,
                                     jvae.TILE_OVERLAP_H, jvae.TILE_OVERLAP_W)


@pytest.mark.parametrize("height,width", [(256, 320), (264, 336)])
def test_tiled_encode_matches_jax(vaes, height, width):
    """2 x 2 tiles of 240 x 360 every 200 x 288 (the second row and column
    shorter than a tile): the moments, blended and cropped, against JAX's."""
    jcfg, params, model = vaes
    video = np.random.default_rng(height).uniform(-1, 1, (1, 5, height, width, 3)).astype(
        np.float32)
    want = jvae.vae_encode_tiled(params, jcfg, jnp.asarray(video))
    with torch.no_grad():
        got = tvae.vae_encode_tiled(model, torch.from_numpy(video))
    assert got.shape == want.shape == (1, 2, height // 8, width // 8, 2 * jcfg.latent_channels)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)


def test_one_tile_is_the_plain_encode(vaes):
    """A video inside one tile (the default 240 x 360) encodes as
    ``vae_encode`` does, to the bit."""
    _, _, model = vaes
    video = torch.from_numpy(np.random.default_rng(1).uniform(-1, 1, (1, 5, 32, 48, 3))
                             .astype(np.float32))
    with torch.no_grad():
        assert torch.equal(tvae.vae_encode_tiled(model, video), tvae.vae_encode(model, video))

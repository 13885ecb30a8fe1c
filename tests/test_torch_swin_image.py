"""The port's image-layout Swin block (K12) against the JAX package.

With inputs made by numpy from a seed, at float32: the plain twin through
`swin_block_image` against the JAX `swin_block_image` (the Pallas image
kernel in interpret mode) at the geometries of the JAX package's own test
(aligned, pad-to-multiple, shifted, unshifted, one head, the 30x40 stage-2
map of 640x480) within 2e-5; against the roll path (pad, roll, partition,
K2's plain twin with the shift mask, reverse, roll back, crop) within 2e-5;
and `pad_region_masks` equal to the JAX package's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from featurematching_tpu.ops.pallas_swin_block import pad_region_masks as jax_pad_region_masks
from featurematching_tpu.ops.pallas_swin_block import swin_block_image as jax_swin_block_image
from featurematching_tpu_torch.models.backbone_swin import (
    _shift_attn_mask,
    window_partition,
    window_reverse,
)
from featurematching_tpu_torch.ops.swin_block import swin_block_reference
from featurematching_tpu_torch.ops.swin_block_image import (
    pad_region_masks,
    swin_block_fused_image,
    swin_block_image,
)

GEOMETRIES = [  # H, W, C, heads, window, shift (tests/test_pallas_swin_block.py)
    (16, 24, 32, 4, 4, 2),
    (16, 24, 32, 4, 4, 0),
    (14, 18, 32, 2, 4, 2),  # pad-to-multiple and shift
    (12, 12, 16, 1, 4, 2),  # one head
    (30, 40, 64, 4, 8, 4),  # the stage-2 map of 640x480
]


def _params(rng, C, h, N, hid):
    def g(*shape):
        return (rng.standard_normal(shape) * 0.1).astype(np.float32)

    p = {"ln1_scale": g(C) + 1.0, "ln1_bias": g(C), "w_qkv": g(C, 3 * C), "b_qkv": g(3 * C),
         "rel_bias": g(h, N, N), "w_proj": g(C, C), "b_proj": g(C), "ln2_scale": g(C) + 1.0,
         "ln2_bias": g(C), "w_mlp1": g(C, hid), "b_mlp1": g(hid), "w_mlp2": g(hid, C),
         "b_mlp2": g(C)}
    return p


def roll_path(x, H, W, params, h, w, shift):
    """The window-space block as the backbone runs it: pad to the window,
    roll, partition, the block with the shift mask, reverse, roll back, crop."""
    B, L, C = x.shape
    xi = x.reshape(B, H, W, C)
    pad_b, pad_r = (w - H % w) % w, (w - W % w) % w
    xi = F.pad(xi, (0, 0, 0, pad_r, 0, pad_b))
    Hp, Wp = H + pad_b, W + pad_r
    mask = None
    if shift > 0:
        xi = torch.roll(xi, shifts=(-shift, -shift), dims=(1, 2))
        mask = torch.as_tensor(_shift_attn_mask(Hp, Wp, w, shift))
    oi = window_reverse(swin_block_reference(window_partition(xi, w), mask, params, h), w, Hp, Wp)
    if shift > 0:
        oi = torch.roll(oi, shifts=(shift, shift), dims=(1, 2))
    return oi[:, :H, :W].reshape(B, H * W, C)


# and tpu_optimized_config()'s head dim 64 on a ragged map
@pytest.mark.parametrize("H,W,C,h,w,shift", GEOMETRIES + [(13, 21, 64, 1, 8, 4)])
def test_twin_against_jax_image_kernel(H, W, C, h, w, shift):
    rng = np.random.default_rng(H * W + shift)
    params = _params(rng, C, h, w * w, 2 * C)
    x = rng.standard_normal((2, H * W, C)).astype(np.float32)
    ref = jax_swin_block_image(jnp.asarray(x), H, W, {k: jnp.asarray(v) for k, v in params.items()},
                               h, w, shift, interpret=True)
    got = swin_block_image(torch.tensor(x), H, W, {k: torch.tensor(v) for k, v in params.items()},
                           h, w, shift)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("H,W,C,h,w,shift", GEOMETRIES + [(13, 21, 64, 4, 8, 4),
                                                           (17, 9, 64, 4, 8, 0)])
def test_twin_against_the_roll_path(H, W, C, h, w, shift):
    """Odd maps included: content padded to a multiple of the window (pad
    tokens that take part in attention, as in the roll path) and the shift's
    pad rows and columns (isolated)."""
    rng = np.random.default_rng(H + W + C)
    params = {k: torch.tensor(v) for k, v in _params(rng, C, h, w * w, 4 * C).items()}
    x = torch.tensor(rng.standard_normal((3, H * W, C)).astype(np.float32))
    got = swin_block_image(x, H, W, params, h, w, shift)
    np.testing.assert_allclose(got.numpy(), roll_path(x, H, W, params, h, w, shift).numpy(),
                               rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("Hp2,Wp2,w,shift", [(32, 40, 8, 4), (40, 48, 8, 4), (16, 24, 4, 2),
                                              (16, 16, 8, 4)])
def test_pad_region_masks_equal_jax(Hp2, Wp2, w, shift):
    np.testing.assert_array_equal(pad_region_masks(Hp2, Wp2, w, shift),
                                  jax_pad_region_masks(Hp2, Wp2, w, shift))


def test_fused_image_on_cpu_runs_the_twin():
    """On a CPU tensor the wrapper takes its plain twin, whatever the shape
    (the kernel's limits hold on the card), and counts no launch."""
    rng = np.random.default_rng(0)
    params = {k: torch.tensor(v) for k, v in _params(rng, 32, 2, 16, 64).items()}
    xp = torch.tensor(rng.standard_normal((1, 16, 16, 32)).astype(np.float32))
    before = swin_block_fused_image.launches
    out = swin_block_fused_image(xp, params, 2, 4, 2)
    assert out.shape == xp.shape and swin_block_fused_image.launches == before

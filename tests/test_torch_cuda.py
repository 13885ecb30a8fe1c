"""The port's CUDA kernels against their plain PyTorch versions on the card.

These tests need an NVIDIA GPU (`sm_90a`) and `nvcc`; without them they skip.
They cover what the serving and training shapes of `chip_smoke.py` do not
reach: ragged edges (row counts, token counts and window counts that are no
multiple of a tile, of the grid or of a weight-gradient split), argmax ties
across tiles, other widths of the transformer kernels, weights loaded after
a first forward, bit-identical gradients across runs (the training kernels
reduce across blocks in a fixed order; K8's at C = 64, 128 and 256 and at
window counts that walk a block's window loop three times), K8's backward
with the attention branch dropped on every window (dx equal to the f32 dx1
rounded to bf16, the branch's gradients exactly 0) and with rows that keep
one key (a one-hot P, rel_bias's gradient on that row below 1e-30), the
wrappers' refusal of tensors
the kernels do not take, K6 at 1 to 64 taps, head dims 8, 16 and 64, each layer
order, one window pair and one past a full wave of its persistent grid's
pair slots, bit-identical twice, its one-layer plain mode (K10's forward) at
the training step's shapes and a weight changed in place after a forward,
K9 at a ragged token count for each width it takes
and through a whole stack, K9's backward at query lengths on its 64-row
tile's edges (1, 63, 65 and 4801 at 1 and 2 images, bit-identical twice)
and its stats_bwd at source lengths on its tiles' edges (1 to 129 and
4800, 4801 over 8 images, every width, bit-identical twice),
at the training step's cross call within chip_smoke.py's K9_TOL, with g = 0
(every output exactly 0) and with w1 = 0 (an empty ReLU mask: the stashed
dy1, dw1 and dw2 exactly 0), K10 at ragged window counts and tap counts and
through a whole stack, K10's window stage at one window and one past a
full round of its window slots at 1, 48, 49 and 64 taps and both head dims
(bit for bit twice), with g = 0 (every output exactly 0), with weights
changed in place between two calls and in a second training step after a
fused AdamW step, the serving forward at tpu_optimized_config() (head dim
64: K2 13, K5 and K6 one launch each, no eager layer) and its refusal of
widths no kernel takes, and that chip_smoke.py's training semantic check
sees faults injected into K8's, K9's, K10's and K7's outputs; K11 at ragged
window counts and each head dim, at its persistent grid's edges (one
window, fewer windows than SMs, window counts no multiple of a run or of
the mask's period, 1 to 4 head groups), at odd head counts (3, 5 and 7) at
each head dim, with a fully masked row tile and bit-identical twice at the
evaluation step's sites, K12 on odd maps against its twin and K2
through the roll path, both wrappers' refusals, and the per-op block's
evaluation forward through K11; K2 at one window and one past a full wave
of the card, with a mask whose count divides none of the window counts and
with masks whose -100 entries cover whole rows, K2 at head dim 64 at those
window counts and K12 at head dims 32 and 64 on an odd map (bit for bit
twice), and K8's forward bit-equal
to K2 with its saved probabilities against the twin's softmax; K1 and its
pass 1 on argmax ties inside one tile and at shapes that cross its row
tiles, chunks of column tiles and batch; K7 one past a tile and one past
a unit of its plan at B = 1 and 4, with a = 0 (exact zeros), with
log-sum-exps far above every sim, and bit-identical twice at the training
step's shapes; `extract_matches` on a conf matrix with exact ties at a
ragged grid and the serving grid, bit-equal to the CPU's, and the dense
evaluation Matcher taking no K1; K5's apply kernel at row counts
around its 64-row tiles and 128-row blocks at each width it takes, one
block past a full wave of the card, over an odd number of tiles and
bit-identical twice, and its wgmma, bulk-copy and mbarrier path alone
(`ring_product`); K5's stats kernel alone (kv and ks within
`stats_reference_bounds`) at source counts around its 64-row tile at each
width (head dim 64 among them), with more blocks than the card holds at
once, bit-identical twice at the serving shapes (head dims 32 and 64), and
planted faults there (a tile left out; at head dim 64 a K^T V block that
crosses its warps left out) past that bound; K3 and K4 at row and token
counts that leave each level of their blocking partly filled (a single
row, a single input token, W odd, more tiles than the grid), at the
serving sites, with a planted fault (the
last unit or tile left out) past the tolerance, and their launch counters
(4 and 3 a forward); the weight gradients (`wgrad`) at every (M, N) of the
training step at its T and at ragged T, each backward's products in one
launch as the step makes them, operands inside a stash with later blocks
behind their last row, bit-identical twice, the wrapper's refusals, and one
launch counted a backward call; the float32 forms of K1 (ragged L and S,
C = 16 and 256, planted ties across tiles, the teacher's shapes) and K5
(token counts around their 32-token tiles at head dims 16, 32 and 64, the
teacher's self call), their refusals, and the gates refusing float32
configs at construction where a selected kernel lacks it. They import neither
JAX nor the JAX package, so on a machine without JAX run them without the
repository's conftest:

    python -m pytest tests/test_torch_cuda.py -q --noconftest
"""

import importlib.util
from pathlib import Path

import pytest
import torch

from featurematching_tpu_torch.config import ModelConfig
from featurematching_tpu_torch.models.backbone_swin import _shift_attn_mask
from featurematching_tpu_torch.models.fast_inference import FastMatcher
from featurematching_tpu_torch.models.transformer import LocalFeatureTransformer
from featurematching_tpu_torch.ops import coarse_transformer_train as ctt
from featurematching_tpu_torch.ops import fine_transformer_train as ftt
from featurematching_tpu_torch.ops.coarse_transformer import (
    STATS_GROUP,
    WIDTHS,
    coarse_layer_fused,
    coarse_layer_with_stats,
    coarse_transformer_fused,
    encoder_reference,
    encoder_reference_with_stats,
    layer_values,
    launch_stats,
    pack_heads,
    ring_product,
    stats_errors,
    stats_plan,
    unpack_heads,
)
from featurematching_tpu_torch.ops.dual_softmax import (
    _lse_reference,
    _stats_reference,
    dual_softmax_confidence,
    dual_softmax_lse,
    dual_softmax_match_stats,
    plan,
)
from featurematching_tpu_torch.matching.fine import window_heatmaps
from featurematching_tpu_torch.ops.fine_stage import (
    fine_layer_forward,
    fine_layer_reference,
    fine_stage_fused,
    fine_stage_occupancy,
    fine_stage_reference,
)
from featurematching_tpu_torch.ops import layer_norm as ln_ops
from featurematching_tpu_torch.ops import patch_expand as pe_ops
from featurematching_tpu_torch.ops.layer_norm import layer_norm_chain, layer_norm_chain_plain
from featurematching_tpu_torch.ops.patch_expand import patch_expand_ln, patch_expand_ln_plain
from featurematching_tpu_torch.ops.sparse_focal_loss import (
    sparse_focal_backward,
    sparse_focal_backward_reference,
)
from featurematching_tpu_torch.ops.swin_block import swin_block_fused, swin_block_reference
from featurematching_tpu_torch.ops.swin_block_train import (
    PARAM_KEYS,
    _kernel_params,
    swin_block_train,
    swin_block_train_bwd,
    swin_block_train_fwd,
    swin_block_train_reference,
)
from featurematching_tpu_torch.ops.wgrad import wgrad, wgrad_group, wgrad_reference
from featurematching_tpu_torch.utils.kernel_bounds import wgrad_calls, wgrad_groups

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    """A seeded generator on the card; skips the test where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.Generator(device="cuda").manual_seed(0)


def _rnd(g, *shape, scale=1.0, shift=0.0, dtype=torch.float32):
    return (torch.randn(*shape, generator=g, device="cuda") * scale + shift).to(dtype)


def _assert_close(got, ref, atol, rtol):
    torch.cuda.synchronize()
    err = (got.float() - ref.float()).abs()
    bad = err > atol + rtol * ref.float().abs()
    assert not bad.any(), f"max err {float(err.max()):.3e} at {int(bad.sum())} entries"


def _ln_rows(lead, C):
    """Row counts for K3's blocking (ops/layer_norm.plan): "waves" is two
    passes of the whole grid, then 5 units and 3 rows of a sixth, so the
    grid-stride loop, the last block pass, the last unit and its last warp
    load are each partly filled."""
    if lead != "waves":
        return lead
    sms, per_sm = ln_ops._capacity(C, torch.cuda.current_device())
    unit = ln_ops.unit_rows(C)
    return (2 * sms * per_sm * ln_ops.WARPS * unit + 5 * unit + 3,)


@pytest.mark.parametrize("C", [64, 128, 256])
@pytest.mark.parametrize("two", [False, True])
@pytest.mark.parametrize("lead", [(3, 37), (1,), (8, 19200 - 3), "waves"])
def test_layer_norm_chain_ragged_rows(gen, C, two, lead):
    """111 rows (the last unit of a warp and the last block pass partly
    empty), one row, 153,597 rows and two whole grid passes plus a ragged
    third (`_ln_rows`)."""
    x = _rnd(gen, *_ln_rows(lead, C), C, scale=2.0, shift=0.5, dtype=torch.bfloat16)
    s1, b1 = _rnd(gen, C, scale=0.1, shift=1.0), _rnd(gen, C, scale=0.1)
    s2, b2 = (_rnd(gen, C, scale=0.1, shift=1.0), _rnd(gen, C, scale=0.1)) if two else (None, None)
    got = layer_norm_chain(x, s1, b1, s2, b2)
    # one bf16 rounding of an f32 result on both sides: one ulp apart at most
    _assert_close(got, layer_norm_chain_plain(x, s1, b1, s2, b2), 1.6e-2, 1.6e-2)


@pytest.mark.parametrize("shape,two", [((8, 19200, 64), False), ((8, 4800, 128), False),
                                       ((8, 1200, 256), False), ((8, 1200, 256), True)])
def test_layer_norm_chain_serving_sites(gen, shape, two):
    """The serving forward's K3 sites (patch_norm, norm_down0, norm_down1
    and 2) against the twin, and the LN chain at the widest."""
    C = shape[-1]
    x = _rnd(gen, *shape, dtype=torch.bfloat16)
    s1, b1 = _rnd(gen, C, scale=0.1, shift=1.0), _rnd(gen, C, scale=0.1)
    s2, b2 = (_rnd(gen, C, scale=0.1, shift=1.0), _rnd(gen, C, scale=0.1)) if two else (None, None)
    _assert_close(layer_norm_chain(x, s1, b1, s2, b2),
                  layer_norm_chain_plain(x, s1, b1, s2, b2), 1.6e-2, 1.6e-2)


def test_layer_norm_chain_tolerance_sees_a_unit_left_out(gen):
    """A planted fault: the kernel run over all rows but the last unit (into
    zeros) breaks the tolerance on exactly those rows."""
    C, rows = 64, 8 * 19200
    x = _rnd(gen, rows, C, dtype=torch.bfloat16)
    s, b = _rnd(gen, C, scale=0.1, shift=1.0), _rnd(gen, C, scale=0.1)
    y = torch.zeros_like(x)
    before = layer_norm_chain.launches
    ln_ops.launch_layer_norm(x, s, b, None, None, y, rows - ln_ops.unit_rows(C))
    torch.cuda.synchronize()
    err = (y.float() - layer_norm_chain_plain(x, s, b).float()).abs()
    bad = (err > 1.6e-2 + 1.6e-2 * layer_norm_chain_plain(x, s, b).float().abs()).any(1)
    assert bad[-ln_ops.unit_rows(C):].all() and not bad[:-ln_ops.unit_rows(C)].any()
    assert layer_norm_chain.launches == before  # the counter counts the wrapper's launches


def _swin_block_params(g, C, h=None):
    """K2's operands: LN scales near 1, biases near 0, bf16 weights at lecun
    scale; the relative-position bias of h heads (C // 16 when None)."""
    h, hid = h or C // 16, 4 * C
    return {
        "ln1_scale": _rnd(g, C, scale=0.1, shift=1.0), "ln1_bias": _rnd(g, C, scale=0.1),
        "w_qkv": _rnd(g, C, 3 * C, scale=C**-0.5, dtype=torch.bfloat16),
        "b_qkv": _rnd(g, 3 * C, scale=0.02), "rel_bias": _rnd(g, h, 64, 64, scale=0.02),
        "w_proj": _rnd(g, C, C, scale=C**-0.5, dtype=torch.bfloat16),
        "b_proj": _rnd(g, C, scale=0.02),
        "ln2_scale": _rnd(g, C, scale=0.1, shift=1.0), "ln2_bias": _rnd(g, C, scale=0.1),
        "w_mlp1": _rnd(g, C, hid, scale=C**-0.5, dtype=torch.bfloat16),
        "b_mlp1": _rnd(g, hid, scale=0.02),
        "w_mlp2": _rnd(g, hid, C, scale=hid**-0.5, dtype=torch.bfloat16),
        "b_mlp2": _rnd(g, C, scale=0.02),
    }


@pytest.mark.parametrize("C", [64, 128, 256])
@pytest.mark.parametrize("masked", [False, True])
def test_swin_block_small_batches(gen, C, masked):
    """Two images of a 16x24 padded map (nW = 6): window w takes mask[w % 6]."""
    h = C // 16
    x = _rnd(gen, 12, 64, C, dtype=torch.bfloat16)
    p = _swin_block_params(gen, C)
    mask = torch.as_tensor(_shift_attn_mask(16, 24, 8, 4), device="cuda") if masked else None
    got = swin_block_fused(x, mask, p, h)
    # bf16 intermediates rounded in another order (the tolerance of chip_smoke.py)
    _assert_close(got, swin_block_reference(x, mask, p, h), 5e-2, 2e-2)


@pytest.mark.parametrize("D", [16, 32, 64])
@pytest.mark.parametrize("C", [64, 128, 256])
@pytest.mark.parametrize("nwin", [1, 133, 161, 265])
@pytest.mark.parametrize("masked", [False, True])
def test_swin_block_window_counts(gen, D, C, nwin, masked):
    """One window; one past a full wave of one block an SM on 132 SMs (133,
    C = 256) and of two (265, C <= 128); one past the serving forward's 160
    windows at C = 256. The mask has nW = 6 (a 16x24 map), which divides
    none of these counts: window w takes mask[w % 6]. Head dims 16
    (default_config()), 32 and 64 (tpu_optimized_config(): 1, 2 and 4 heads,
    at C = 64 half the block's warps have no attention unit), against the
    twin with chip_smoke.py's tolerance; twice, bit for bit."""
    h = C // D
    x = _rnd(gen, nwin, 64, C, dtype=torch.bfloat16)
    p = _swin_block_params(gen, C, h)
    mask = torch.as_tensor(_shift_attn_mask(16, 24, 8, 4), device="cuda") if masked else None
    got = swin_block_fused(x, mask, p, h)
    _assert_close(got, swin_block_reference(x, mask, p, h), 5e-2, 2e-2)
    assert torch.equal(got, swin_block_fused(x, mask, p, h))


@pytest.mark.parametrize("C,h", [(64, 1), (128, 2), (128, 4), (256, 4)])
def test_swin_block_image_other_head_dims(gen, C, h):
    """K12 at head dims 64 and 32 on a ragged map (13x21, padded as the pad
    formulation pads for a shift of 4) against its twin, with K2's
    tolerance; twice, bit for bit."""
    from featurematching_tpu_torch.ops.swin_block_image import (
        pad_image,
        swin_block_fused_image,
        swin_block_image_reference,
    )

    x = _rnd(gen, 3, 13 * 21, C, dtype=torch.bfloat16)
    p = _swin_block_params(gen, C, h)
    xp, _ = pad_image(x, 13, 21, 8, 4)
    got = swin_block_fused_image(xp, p, h, 8, 4)
    _assert_close(got, swin_block_image_reference(xp, p, h, 8, 4), 5e-2, 2e-2)
    assert torch.equal(got, swin_block_fused_image(xp, p, h, 8, 4))


@pytest.mark.parametrize("C", [64, 128, 256])
def test_swin_block_masked_rows(gen, C):
    """Masks whose -100 entries cover whole rows: mask[0] lets each token
    see only itself (63 masked keys a row, each e^-100 a subnormal in the
    softmax), mask[1] masks every key of the first 16 query rows (a whole
    row tile of the attention), mask[2] lets every token see only key 0,
    mask[3] is zero. K2 against its twin with chip_smoke.py's tolerance."""
    h = C // 16
    x = _rnd(gen, 13, 64, C, dtype=torch.bfloat16)
    p = _swin_block_params(gen, C)
    mask = torch.zeros(4, 64, 64, device="cuda")
    mask[0] = -100.0 * (1.0 - torch.eye(64, device="cuda"))
    mask[1, :16] = -100.0
    mask[2, :, 1:] = -100.0
    got = swin_block_fused(x, mask, p, h)
    _assert_close(got, swin_block_reference(x, mask, p, h), 5e-2, 2e-2)


def _bf16_ulp(v):
    """One bf16 ulp at |v| (the subnormal spacing below the smallest normal)."""
    a = v.abs().clamp_min(2.0**-126)
    return torch.exp2(torch.floor(torch.log2(a)) - 7)


@pytest.mark.parametrize("C", [64, 128, 256])
def test_swin_block_train_forward_is_k2(gen, C):
    """K8's forward with both drop-path scales 1 is K2's body: on the same
    inputs its output is bit-equal to K2's. Its saved probabilities are
    within one bf16 ulp of the softmax the plain twin computes in f32, on
    inputs where the twin's q and k are the kernel's: with LN1's scale 0
    every token's LN1 output is LN1's bias, so q.k is one value for all
    pairs of a head on each side (the sum order moves it by f32 rounding,
    and a softmax ignores a constant), and the probabilities vary by the
    relative-position bias, drawn at a scale of 1, and the shift mask. On
    random inputs the twin rounds a few q and k entries to the other bf16
    neighbour of the kernel's, which moves some probabilities by more."""
    h, nwin = C // 16, 133
    x = _rnd(gen, nwin, 64, C, dtype=torch.bfloat16)
    p = _block_params(gen, C, h)
    mask = torch.as_tensor(_shift_attn_mask(16, 24, 8, 4), device="cuda")
    ones = torch.ones(nwin, device="cuda")
    out, _, _ = swin_block_train_fwd(x, mask, ones, ones, _kernel_params(p, C, h), h)
    k2 = swin_block_fused(x, mask, p, h)
    torch.cuda.synchronize()
    assert torch.equal(out, k2)
    p = p | {"ln1_scale": torch.zeros(C, device="cuda"), "rel_bias": _rnd(gen, h, 64, 64)}
    _, probs, _ = swin_block_train_fwd(x, mask, ones, ones, _kernel_params(p, C, h), h)
    hx = layer_norm_chain_plain(x, p["ln1_scale"], p["ln1_bias"])
    qkv = (hx.float() @ p["w_qkv"] + p["b_qkv"]).to(x.dtype).float()
    q, k = (qkv[..., i * C:(i + 1) * C].reshape(nwin, 64, h, 16).transpose(1, 2)
            for i in range(2))
    s = (q @ k.transpose(-1, -2)) * 0.25 + p["rel_bias"][None]
    s = s + mask[torch.arange(nwin, device="cuda") % mask.shape[0]][:, None]
    ref = torch.softmax(s, dim=-1)
    torch.cuda.synchronize()
    bad = (probs.float() - ref).abs() > _bf16_ulp(ref)
    assert not bad.any(), f"{int(bad.sum())} probabilities off by more than one bf16 ulp"


def _pe_args(g, B, H, W, C4, CH, emit_ln, bias=True):
    y = _rnd(g, B, H * W, 4 * C4, dtype=torch.bfloat16)
    s1, b1 = _rnd(g, C4, scale=0.1, shift=1.0), _rnd(g, C4, scale=0.1)
    s2, b2 = _rnd(g, C4, scale=0.1, shift=1.0), _rnd(g, C4, scale=0.1)
    wh = _rnd(g, C4, CH, scale=C4**-0.5, dtype=torch.bfloat16) if CH else None
    bh = _rnd(g, CH, scale=0.1) if CH and bias else None
    return (y, H, W, s1, b1, s2, b2, wh, bh, emit_ln)


def _pe_close(args):
    got, ref = patch_expand_ln(*args), patch_expand_ln_plain(*args)
    assert len(got) == len(ref) == int(args[-1]) + int(args[7] is not None)
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        _assert_close(g, r, 3e-2, 1.6e-2)  # one bf16 ulp of the outputs


@pytest.mark.parametrize("C4,CH,emit_ln", [(128, 256, True), (64, 0, True), (64, 64, False),
                                           (128, 0, True), (64, 256, True), (128, 64, False)])
@pytest.mark.parametrize("B,H,W", [(3, 5, 7), (1, 1, 1), (2, 9, 13), (8, 61, 83)])
def test_patch_expand_ragged_tokens(gen, C4, CH, emit_ln, B, H, W):
    """3 images of 5x7 (420 output tokens: the last tile of 128 or 64 partly
    empty, tiles crossing input rows' and images' ends, W odd), one input
    token (4 output tokens: one warp load partly filled), 2 of 9x13, and 8
    of 61x83 (162,016 tokens: more tiles than the persistent grid, a ragged
    last pass)."""
    _pe_close(_pe_args(gen, B, H, W, C4, CH, emit_ln))


@pytest.mark.parametrize("H,W,C4,CH,emit_ln", [(30, 40, 128, 256, True), (60, 80, 64, 0, True),
                                               (120, 160, 64, 64, False)])
def test_patch_expand_serving_sites(gen, H, W, C4, CH, emit_ln):
    """dec0, dec1 and dec2 of the serving forward (8 images), the heads
    without a bias as the forward calls them, against the twin."""
    _pe_close(_pe_args(gen, 8, H, W, C4, CH, emit_ln, bias=False))


def test_patch_expand_tolerance_sees_a_tile_left_out(gen):
    """A planted fault: the kernel run over all tiles but the last (into
    zeros) breaks the tolerance on exactly that tile's output tokens."""
    B, H, W, C4, CH = 8, 120, 160, 64, 64
    y, _, _, s1, b1, s2, b2, wh, _, _ = _pe_args(gen, B, H, W, C4, CH, True)
    ln_out = torch.zeros(B, 4 * H * W, C4, device="cuda", dtype=torch.bfloat16)
    head = torch.zeros(B, 4 * H * W, CH, device="cuda", dtype=torch.bfloat16)
    total, T = 4 * B * H * W, pe_ops.tile_tokens(C4)
    before = patch_expand_ln.launches
    pe_ops.launch_patch_expand(y, W, s1, b1, s2, b2, wh, None, ln_out, head, total - T)
    torch.cuda.synchronize()
    ref = patch_expand_ln_plain(y, H, W, s1, b1, s2, b2, wh, None, True)
    # each output token's input-ordered token q; the last tile's q are left out
    q = pe_ops.depth_to_space(torch.arange(total, device="cuda").reshape(B, H * W, 4), H, W)
    missing = q.reshape(-1) >= total - T
    for got, r in zip((ln_out, head), ref):
        bad = ((got.float() - r.float()).abs() > 3e-2 + 1.6e-2 * r.float().abs()).any(-1)
        assert torch.equal(bad.reshape(-1), missing)
    assert patch_expand_ln.launches == before


def test_launch_counters_of_k3_and_k4(gen):
    """Each wrapper call adds one launch; the serving forward makes K3 4 and
    K4 3 (its heads' weights kept in the kernel's layout, no bias)."""
    x = _rnd(gen, 5, 64, dtype=torch.bfloat16)
    s = _rnd(gen, 64)
    before = layer_norm_chain.launches, patch_expand_ln.launches
    layer_norm_chain(x, s, s)
    patch_expand_ln(*_pe_args(gen, 1, 2, 3, 64, 64, True))
    assert (layer_norm_chain.launches, patch_expand_ln.launches) == (before[0] + 1, before[1] + 1)
    a = torch.rand(1, 64, 64, 3, generator=gen, device="cuda")
    model = FastMatcher(ModelConfig(), device="cuda", seed=0)
    model(a, a)
    held = [model.backbone.linear_middle.weight._head_weight[1],
            model.backbone.linear_end.weight._head_weight[1]]
    layer_norm_chain.launches = patch_expand_ln.launches = 0
    model(a, a)
    assert (layer_norm_chain.launches, patch_expand_ln.launches) == (4, 3)
    assert held[0] is model.backbone.linear_middle.weight._head_weight[1]  # made once
    assert held[1] is model.backbone.linear_end.weight._head_weight[1]


@pytest.mark.parametrize("C", [64, 128, 256])
def test_dual_softmax_ragged(gen, C):
    """L = 200 rows and S = 136 columns: the last row and column tiles are partial."""
    B, L, S = 2, 200, 136
    f1 = _rnd(gen, B, S, C)
    f0 = 0.5 * _rnd(gen, B, L, C)
    f0[:, :S] += f1  # row i < S has its best column at i
    f0, f1 = f0.bfloat16(), f1.bfloat16()
    got = dual_softmax_match_stats(f0, f1, 0.1)
    ref = _stats_reference(f0, f1, 1.0 / (C * 0.1))
    # f32 sums in another order; conf is a product of exps
    _assert_close(got.row_max, ref.row_max, 0.0, 1e-3)
    _assert_close(got.col_max, ref.col_max, 0.0, 1e-3)
    assert torch.equal(got.row_argmax[:, :S].cpu(), torch.arange(S).expand(B, S).int())
    assert torch.equal(got.col_argmax.cpu(), torch.arange(S).expand(B, S).int())


def test_dual_softmax_ties_keep_the_lowest_index(gen):
    """Exact duplicates in other tiles tie: the argmax keeps the lower index,
    as jnp.argmax does. Column 5 of f1 is repeated at column 100 (another
    column tile); row 3 of f0 is repeated at row 150 (another row tile)."""
    B, L, S, C = 1, 192, 128, 64
    f1 = _rnd(gen, B, S, C)
    f1[:, 100] = f1[:, 5]
    f0 = 0.3 * _rnd(gen, B, L, C)
    f0[:, 3] = 2.0 * f1[:, 5]
    f0[:, 150] = f0[:, 3]
    f0, f1 = f0.bfloat16(), f1.bfloat16()
    got = dual_softmax_match_stats(f0, f1, 0.1)
    torch.cuda.synchronize()
    assert int(got.row_argmax[0, 3]) == 5 and int(got.row_argmax[0, 150]) == 5
    assert int(got.col_argmax[0, 5]) == 3 and int(got.col_argmax[0, 100]) == 3


@pytest.mark.parametrize("C", [64, 256])
def test_dual_softmax_ties_inside_one_tile(gen, C):
    """Exact duplicates inside one 64-column tile and one 128-row block tie:
    columns 5, 13, 43 and 45 of f1 lie in other n8 fragments and three of
    them in other lanes of a row's quad; rows 3, 19 and 35 of f0 lie on
    three warps. Every merge keeps the lower index, as jnp.argmax does; the
    log-sum-exps of the duplicates agree with the plain twin's."""
    B, L, S = 2, 200, 136
    f1 = _rnd(gen, B, S, C)
    f1[:, [13, 43, 45]] = f1[:, 5:6]
    f0 = 0.3 * _rnd(gen, B, L, C)
    f0[:, [3, 19, 35]] = 2.0 * f1[:, 5:6]
    f0, f1 = f0.bfloat16(), f1.bfloat16()
    got = dual_softmax_match_stats(f0, f1, 0.1)
    torch.cuda.synchronize()
    assert got.row_argmax[:, [3, 19, 35]].eq(5).all()
    assert got.col_argmax[:, [5, 13, 43, 45]].eq(3).all()
    inv_temp = 1.0 / (C * 0.1)
    lr, lc = dual_softmax_lse(f0, f1, inv_temp)
    rr, rc = _lse_reference(f0, f1, inv_temp)
    _assert_close(lr, rr, 1e-3, 0.0)
    _assert_close(lc, rc, 1e-3, 0.0)


def _one_past_a_chunk(B, L, C, S_max):
    """The largest S <= S_max whose last chunk of the kernels' decomposition
    (dual_softmax.plan) holds one column."""
    dev = torch.cuda.current_device()
    for S in range(S_max, 64, -1):
        p = plan(B, L, S, C, dev)
        if p.n_split > 1 and S % (64 * p.chunk) == 1:
            return S
    raise AssertionError("no S with a one-column last chunk")


@pytest.mark.parametrize("B, L, S", [
    (1, 4800, 4800), (4, 4800, 4800),  # the serving forward's shapes, and one pair
    (2, 129, 200), (4, 4737, 4800),  # L one past a 128-row tile
    (1, 4800, None),  # S one past a chunk of column tiles
])
def test_dual_softmax_across_the_decomposition(gen, B, L, S):
    """K1 and dual_softmax_lse at shapes that cross the kernels' row tiles,
    chunks and batch, against the plain twins at chip_smoke.py's
    tolerances: max values within 1e-3 relative, each argmax picking an
    entry at least (1 - 1e-3) x the plain max, log-sum-exps within 1e-3."""
    C, T, rtol = 256, 0.1, 1e-3
    S = S or _one_past_a_chunk(B, L, C, 4800)
    f0 = _rnd(gen, B, L, C)
    idx = torch.randint(0, L, (S,), generator=gen, device="cuda")
    f1 = (0.8 * f0[:, idx] + 0.6 * _rnd(gen, B, S, C)).bfloat16()
    f0 = f0.bfloat16()
    inv_temp = 1.0 / (C * T)
    got = dual_softmax_match_stats(f0, f1, T)
    ref = _stats_reference(f0, f1, inv_temp)
    _assert_close(got.row_max, ref.row_max, 0.0, rtol)
    _assert_close(got.col_max, ref.col_max, 0.0, rtol)
    conf = dual_softmax_confidence(f0, f1, inv_temp)
    row_pick = torch.gather(conf, 2, got.row_argmax.long()[..., None])[..., 0]
    col_pick = torch.gather(conf, 1, got.col_argmax.long()[:, None])[:, 0]
    assert (row_pick >= ref.row_max * (1 - rtol)).all()
    assert (col_pick >= ref.col_max * (1 - rtol)).all()
    del conf
    lr, lc = dual_softmax_lse(f0, f1, inv_temp)
    rr, rc = _lse_reference(f0, f1, inv_temp)
    _assert_close(lr, rr, 1e-3, 0.0)
    _assert_close(lc, rc, 1e-3, 0.0)


@pytest.mark.parametrize("grids", [((7, 9), (9, 7)), ((60, 80), (60, 80))], ids=["ragged", "serving"])
def test_extract_matches_on_the_card(gen, grids):
    """`extract_matches` of a conf matrix on the card equals the CPU's bit
    for bit (ids, mask, mconf), at a ragged grid and at the serving grid,
    with exact ties: a column of f1 and a row of f0 duplicated, so every row
    ties between two columns and every column between two rows."""
    from featurematching_tpu_torch.matching.coarse import (
        dual_softmax_confidence as matcher_confidence,
    )
    from featurematching_tpu_torch.matching.coarse import extract_matches

    (h0, w0), (h1, w1) = grids
    L, S, C = h0 * w0, h1 * w1, 64
    f1 = _rnd(gen, 2, S, C)
    f1[:, 7] = f1[:, 3]
    f0 = 0.5 * _rnd(gen, 2, L, C)
    f0[:, :min(L, S)] += f1[:, :min(L, S)]
    f0[:, 9] = f0[:, 2]
    conf = matcher_confidence(f0.bfloat16(), f1.bfloat16(), 0.1)
    assert torch.equal(conf[:, :, 3], conf[:, :, 7]) and torch.equal(conf[:, 2], conf[:, 9])
    for thr, border in ((1e-8, 0), (0.2, 2)):
        got = extract_matches(conf, grids[0], grids[1], thr, border, 1024)
        ref = extract_matches(conf.cpu(), grids[0], grids[1], thr, border, 1024)
        for x, y in zip(got, ref):
            assert torch.equal(x.cpu(), y)
        assert int(got[2].sum()) > 0


def test_dense_evaluation_launches_no_k1(gen):
    """The evaluation Matcher with the conf matrix wanted takes its matches
    from the matrix: no K1 launch; without it, K1 once."""
    from featurematching_tpu_torch.models.matcher import Matcher

    model = Matcher(ModelConfig(), device="cuda", seed=0)
    a = torch.rand(2, 64, 64, 3, generator=gen, device="cuda")
    before = dual_softmax_match_stats.launches
    with torch.no_grad():
        out = model(a, torch.roll(a, shifts=8, dims=2), want_conf_matrix=True)
    torch.cuda.synchronize()
    assert dual_softmax_match_stats.launches == before
    assert out.conf_matrix.dtype == torch.float32 and out.conf_matrix.shape == (2, 64, 64)
    with torch.no_grad():
        model(a, torch.roll(a, shifts=8, dims=2))
    assert dual_softmax_match_stats.launches == before + 1


def _layer_values(g, C):
    def w(i, o):
        return _rnd(g, i, o, scale=i**-0.5, dtype=torch.bfloat16)

    def ln():
        return _rnd(g, C, scale=0.1, shift=1.0), _rnd(g, C, scale=0.1)

    return layer_values(w(C, C), w(C, 2 * C), w(C, C), *ln(), w(2 * C, 2 * C), w(2 * C, C), *ln())


@pytest.mark.parametrize("C,heads", [(c, c // d) for c, d in WIDTHS])
@pytest.mark.parametrize("N", [100, 1200])
@pytest.mark.parametrize("kind", ["self", "cross"])
def test_coarse_layer_ragged_tokens(gen, C, heads, N, kind):
    """Token counts that are no multiple of the 64-row tile; a cross layer's
    source has another count than its queries."""
    G = 3
    lv = _layer_values(gen, C)
    x = _rnd(gen, G, N, C, dtype=torch.bfloat16)
    src = x if kind == "self" else _rnd(gen, G, N + 37, C, dtype=torch.bfloat16)
    got = coarse_layer_fused(x, src, lv, heads)
    # bf16 intermediates rounded in another order (the tolerance of chip_smoke.py)
    _assert_close(got, encoder_reference(x, src, lv, heads), 5e-2, 2e-2)


@pytest.mark.parametrize("K", [16, 512])
def test_ring_product(gen, K):
    """The apply kernel's wgmma, bulk-copy and mbarrier path alone: one
    m64n256k16 step, and K = 512 through the two-slot ring (32 k-steps,
    each slot filled 16 times), against the plain product of the same bf16
    operands (f32 sums in another order)."""
    a = _rnd(gen, 64, K, dtype=torch.bfloat16)
    b = _rnd(gen, K, 256, dtype=torch.bfloat16)
    _assert_close(ring_product(a, b), a.float() @ b.float(), 1e-3, 1e-5)


@pytest.mark.parametrize("C,heads", [(c, c // d) for c, d in WIDTHS])
@pytest.mark.parametrize("L", [1, 63, 64, 65, 127, 128, 129])
def test_coarse_apply_tile_edges(gen, C, heads, L):
    """Row counts around the apply kernel's 64-row tiles and 128-row blocks
    (a block's second tile in the next image, or past the last tile), at
    every width it takes; a self layer over two images."""
    G = 2
    lv = _layer_values(gen, C)
    x = _rnd(gen, G, L, C, dtype=torch.bfloat16)
    got = coarse_layer_fused(x, x, lv, heads)
    # bf16 intermediates rounded in another order (the tolerance of chip_smoke.py)
    _assert_close(got, encoder_reference(x, x, lv, heads), 5e-2, 2e-2)


@pytest.mark.parametrize("G,L,S", [(1, 265 * 64, 265 * 64), (3, 3 * 64, 1000)])
def test_coarse_apply_waves_and_odd_tiles(gen, G, L, S):
    """265 tiles of one image: 133 apply blocks, one past a full wave of the
    card's 132 SMs, the last block's second warpgroup without rows; and a
    cross layer (S != L) over an odd number of tiles in three images."""
    C, heads = 256, 8
    lv = _layer_values(gen, C)
    x = _rnd(gen, G, L, C, dtype=torch.bfloat16)
    src = x if S == L else _rnd(gen, G, S, C, dtype=torch.bfloat16)
    got = coarse_layer_fused(x, src, lv, heads)
    _assert_close(got, encoder_reference(x, src, lv, heads), 5e-2, 2e-2)


def test_coarse_apply_bit_identical(gen):
    """The apply kernel uses no atomics: two runs agree bit for bit."""
    lv = _layer_values(gen, 256)
    x = _rnd(gen, 4, 4800, 256, dtype=torch.bfloat16)
    src = _rnd(gen, 4, 4800, 256, dtype=torch.bfloat16)
    first = coarse_layer_fused(x, src, lv, 8)
    assert torch.equal(first, coarse_layer_fused(x, src, lv, 8))


def _stats_held(x, src, lv, heads):
    """`coarse_layer_with_stats` with its kv and ks held alone against the
    plain stats within `stats_reference_bounds` (one bf16 ulp of the merged
    sum, plus S 2^-23 sum |x| for the f32 summation orders and 2^-6 sqrt(sum
    x^2) for K's and V's rounding flips, x = K V or K; never looser than the
    layer's 5e-2 + 2e-2 |x|). Returns (out, kv, ks)."""
    out, kv, ks = coarse_layer_with_stats(x, src, lv, heads)
    torch.cuda.synchronize()
    for name, (err, past, _, _) in stats_errors(kv, ks, src, lv, heads).items():
        assert not past, f"{name}: max err {err:.3e} at {past} entries past the bound"
    return out, kv, ks


@pytest.mark.parametrize("C,heads", [(c, c // d) for c, d in WIDTHS])
@pytest.mark.parametrize("S", [1, 63, 64, 65, 1000, 4837])
@pytest.mark.parametrize("G", [1, 3])
def test_coarse_stats_ragged_sources(gen, C, heads, S, G):
    """The stats kernel alone at every width it takes: source counts on the
    edges of its 64-row tile, runs of one to several tiles a warpgroup,
    and one or three images."""
    lv = _layer_values(gen, C)
    src = _rnd(gen, G, S, C, dtype=torch.bfloat16)
    _stats_held(_rnd(gen, G, 5, C, dtype=torch.bfloat16), src, lv, heads)


@pytest.mark.parametrize("G,S,C,heads", [(200, 64, 256, 8), (150, 130, 128, 4)])
def test_coarse_stats_more_blocks_than_the_card_holds(gen, G, S, C, heads):
    """More work items (a run of tiles and a head group, a block each) than
    the card's SMs hold at one block an SM: the blocks run in rounds."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    per, chunks = stats_plan(G, S, C, sms)
    assert G * chunks * (C // STATS_GROUP) > sms
    lv = _layer_values(gen, C)
    src = _rnd(gen, G, S, C, dtype=torch.bfloat16)
    _stats_held(src, src, lv, heads)


@pytest.mark.parametrize("G", [8, 4])
@pytest.mark.parametrize("heads", [8, 4])
def test_coarse_stats_bit_identical(gen, G, heads):
    """The serving forward's self (G = 8) and cross (G = 4) shapes, at head
    dims 32 and 64: kv, ks and the layer's output agree bit for bit across
    two runs (the stats sum in a fixed order, without atomics)."""
    lv = _layer_values(gen, 256)
    x = _rnd(gen, G, 4800, 256, dtype=torch.bfloat16)
    src = _rnd(gen, G, 4800, 256, dtype=torch.bfloat16)
    first = _stats_held(x, src, lv, heads)
    again = coarse_layer_with_stats(x, src, lv, heads)
    for a, b in zip(first, again, strict=True):
        assert torch.equal(a, b)


@pytest.mark.parametrize("G", [8, 4])
def test_coarse_stats_bound_sees_a_tile_left_out(gen, G):
    """A planted fault at the serving shapes: runs of one tile that leave
    each image's last 64-token tile out of the sums come out past
    `stats_reference_bounds` at many entries of kv and of ks."""
    lv = _layer_values(gen, 256)
    src = _rnd(gen, G, 4800, 256, dtype=torch.bfloat16)
    kv, ks = launch_stats(src, lv, 8, 1, 4800 // 64 - 1)
    torch.cuda.synchronize()
    errs = stats_errors(kv, ks, src, lv, 8)
    assert errs["kv"][1] > errs["kv"][2] // 4 and errs["ks"][1] > errs["ks"][2] // 2, errs


@pytest.mark.parametrize("C,G", [(256, 4), (128, 3)])
def test_coarse_stats_bound_sees_a_block_left_out(gen, C, G):
    """A planted fault at head dim 64: one block of K^T V that crosses the
    stats kernel's warps (its K features 0-15 against its V features 48-63)
    left out of the launch's kv in the first head of each head group; at
    most those entries come out past `stats_reference_bounds`, and ks stays
    within it."""
    lv = _layer_values(gen, C)
    src = _rnd(gen, G, 4800, C, dtype=torch.bfloat16)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    heads = C // 64
    kv, ks = launch_stats(src, lv, heads, *stats_plan(G, 4800, C, sms))
    torch.cuda.synchronize()
    assert not any(past for _, past, _, _ in stats_errors(kv, ks, src, lv, heads).values())
    blocks = unpack_heads(kv, heads)
    blocks[:, ::STATS_GROUP // 64, :16, 48:] = 0
    errs = stats_errors(pack_heads(blocks), ks, src, lv, heads)
    assert errs["ks"][1] == 0 and 0 < errs["kv"][1] <= 256 * G * (C // STATS_GROUP), errs


def _fine_wave(names, heads):
    """One window pair past a full wave of K6's persistent grid: a pair in
    every pair slot of every block, and one more."""
    occ = fine_stage_occupancy(len(names), heads, 1 << 20)
    return occ["grid"] * occ["pairs_in_flight"] + 1


@pytest.mark.parametrize("pairs", [1, 300, "wave+1"])
@pytest.mark.parametrize("N", [1, 25, 49, 64])
@pytest.mark.parametrize("heads", [8, 4, 1])
@pytest.mark.parametrize("names", [("self", "cross"), ("cross",), ("cross", "self")])
def test_fine_stage_ragged_windows(gen, pairs, N, heads, names):
    """One window pair, 300 (fewer than a wave of the persistent grid's pair
    slots, not a multiple of its blocks) and one past a full wave; 1 to 64
    taps; head dims 8, 16 and 64; each layer order; fold and plain mode."""
    B_, C = (_fine_wave(names, heads) if pairs == "wave+1" else pairs), 64
    layers = [_layer_values(gen, C) for _ in names]
    mixes = [(_rnd(gen, N, scale=0.3), _rnd(gen, 1)) for _ in range(2)]
    w0, w1 = _rnd(gen, B_, N, C, dtype=torch.bfloat16), _rnd(gen, B_, N, C, dtype=torch.bfloat16)
    args = (w0, w1, layers, *mixes, names, heads)
    heat = fine_stage_fused(*args, fold_softargmax=True)
    got = fine_stage_fused(*args)
    own = (window_heatmaps(got[2], got[1]), window_heatmaps(got[3], got[0]))
    ref = fine_stage_reference(*args, fold_softargmax=True)
    for h, o, r in zip(heat, own, ref, strict=True):
        assert h.shape == (B_, N)
        _assert_close(h, o, 1e-5, 0.0)  # the fold's math on the kernel's own windows
        _assert_close(h, r, 5e-2, 0.0)  # chip_smoke.py's HEAT_ATOL, with its reason
        _assert_close(h.sum(-1), torch.ones(B_, device="cuda"), 1e-5, 0.0)
    for i, (a, r) in enumerate(zip(got, fine_stage_reference(*args), strict=True)):
        assert a.shape == r.shape
        _assert_close(a, r, *((5e-2, 2e-2) if i < 2 else (0.13, 0.05)))


@pytest.mark.parametrize("names", [("self", "cross"), ("cross",)])
@pytest.mark.parametrize("heads", [8, 1])
def test_fine_stage_bit_identical(gen, names, heads):
    """K6 sums in a fixed order without atomics: two runs agree bit for bit,
    in fold and plain mode, at the serving call's 4096 window pairs, at head
    dims 8 and 64."""
    layers = [_layer_values(gen, 64) for _ in names]
    mixes = [(_rnd(gen, 49, scale=0.3), _rnd(gen, 1)) for _ in range(2)]
    w0, w1 = (_rnd(gen, 4096, 49, 64, dtype=torch.bfloat16) for _ in range(2))
    args = (w0, w1, layers, *mixes, names, heads)
    for fold in (True, False):
        first = fine_stage_fused(*args, fold_softargmax=fold)
        again = fine_stage_fused(*args, fold_softargmax=fold)
        assert all(torch.equal(a, b) for a, b in zip(first, again, strict=True))


@pytest.mark.parametrize("kind", ["self", "cross"])
def test_fine_layer_forward_at_the_step_shapes(gen, kind):
    """K10's forward (K6's kernel in plain mode, one layer, one launch) at the
    training step's 4096 window pairs of 49 taps and 8 heads, against
    fine_layer_reference within chip_smoke.py's K10_TOL of each output's norm."""
    cs = _chip_smoke()
    lv = _layer_values(gen, 64)
    w0, w1 = (_rnd(gen, 4096, 49, 64, dtype=torch.bfloat16) for _ in range(2))
    before = (fine_layer_forward.launches, fine_stage_fused.launches)
    got = fine_layer_forward(w0, w1, lv, kind, 8)
    assert (fine_layer_forward.launches, fine_stage_fused.launches) == (before[0] + 1, before[1])
    ref = fine_layer_reference(w0, w1, lv, kind, 8)
    for a, r in zip(got, ref, strict=True):
        assert a.shape == r.shape and a.dtype == r.dtype
        assert cs.norm_err(a, r) <= cs.K10_TOL


def test_fine_stage_sees_weights_changed_in_place(gen):
    """K6's weight image is kept on the packed layer; a weight changed in
    place after a forward is used by the next one, through the wrapper and
    through the serving forward's packed-layer cache."""
    names = ("self", "cross")
    layers = [_layer_values(gen, 64) for _ in names]
    mixes = [(_rnd(gen, 49, scale=0.3), _rnd(gen, 1)) for _ in range(2)]
    w0, w1 = (_rnd(gen, 300, 49, 64, dtype=torch.bfloat16) for _ in range(2))
    args = (w0, w1, layers, *mixes, names, 8)
    first = fine_stage_fused(*args, fold_softargmax=True)
    layers[1].wmlp1.mul_(2)
    again = fine_stage_fused(*args, fold_softargmax=True)
    assert not torch.equal(first[0], again[0])
    for a, r in zip(again, fine_stage_reference(*args, fold_softargmax=True), strict=True):
        _assert_close(a, r, 5e-2, 0.0)
    a = torch.rand(1, 64, 64, 3, generator=gen, device="cuda")
    b = torch.roll(a, shifts=8, dims=2)
    model = FastMatcher(ModelConfig(), device="cuda", seed=0)
    model(a, b)
    with torch.no_grad():
        model.fine_transformer.layer_1.mlp1.weight.mul_(2)
    again = model(a, b)
    fresh = FastMatcher(ModelConfig(), device="cuda", seed=1)
    fresh.load_state_dict(model.state_dict())
    ref = fresh(a, b)
    assert torch.equal(again.fine.mkpts0_f, ref.fine.mkpts0_f)
    assert torch.equal(again.fine.mkpts1_f, ref.fine.mkpts1_f)


def test_forward_sees_new_weights(gen):
    """The packed transformer operands are cached between forwards; weights
    loaded in place after a first forward must be used by the next one."""
    a = torch.rand(1, 64, 64, 3, generator=gen, device="cuda")
    b = torch.roll(a, shifts=8, dims=2)
    model = FastMatcher(ModelConfig(), device="cuda", seed=0)
    first = model(a, b)
    fresh = FastMatcher(ModelConfig(), device="cuda", seed=1)
    model.load_state_dict(fresh.state_dict())
    again, ref = model(a, b), fresh(a, b)
    assert not torch.equal(first.feat_c0, again.feat_c0)
    assert torch.equal(again.feat_c0, ref.feat_c0)
    assert torch.equal(again.fine.mkpts0_f, ref.fine.mkpts0_f)


def test_wrappers_raise_rather_than_fall_back(gen):
    """A CUDA tensor the kernels do not take raises; no plain fallback runs."""
    x = _rnd(gen, 4, 64)  # float32, not bfloat16
    s, b = _rnd(gen, 64), _rnd(gen, 64)
    before = layer_norm_chain.launches
    with pytest.raises(ValueError, match="bfloat16"):
        layer_norm_chain(x, s, b)
    with pytest.raises(ValueError, match="C in"):
        layer_norm_chain(_rnd(gen, 4, 96, dtype=torch.bfloat16), _rnd(gen, 96), _rnd(gen, 96))
    f = _rnd(gen, 1, 64, 64, dtype=torch.float16)  # K1 takes bfloat16 and float32
    with pytest.raises(ValueError, match="bfloat16"):
        dual_softmax_match_stats(f, f, 0.1)
    assert layer_norm_chain.launches == before
    c_before, f_before = coarse_transformer_fused.launches, fine_stage_fused.launches
    lv = _layer_values(gen, 256)
    x = _rnd(gen, 1, 80, 256)
    with pytest.raises(ValueError, match="bfloat16"):
        coarse_transformer_fused(x, x, [lv], ("self",), 8)
    xb = x.bfloat16()
    with pytest.raises(ValueError, match="head dim"):
        coarse_transformer_fused(xb, xb, [lv], ("self",), 32)  # head dim 8
    fl = _layer_values(gen, 64)
    mix = (_rnd(gen, 49), _rnd(gen, 1))
    w = _rnd(gen, 4, 49, 64)
    with pytest.raises(ValueError, match="bfloat16"):
        fine_stage_fused(w, w, [fl], mix, mix, ("cross",), 8)
    wb = w.bfloat16()
    with pytest.raises(ValueError, match="head dim"):
        fine_stage_fused(wb, wb, [fl], mix, mix, ("cross",), 2)  # head dim 32
    with pytest.raises(ValueError, match="layers"):
        fine_stage_fused(wb, wb, [fl] * 3, mix, mix, ("self", "cross", "self"), 8)
    assert (coarse_transformer_fused.launches, fine_stage_fused.launches) == (c_before, f_before)


def _block_params(g, C, h):
    """f32 operands; the weights hold bf16 values, so the kernels and the
    plain twin see the same weights."""
    hid = 4 * C

    def w(i, o):
        return _rnd(g, i, o, scale=i**-0.5).bfloat16().float()

    return {
        "ln1_scale": _rnd(g, C, scale=0.1, shift=1.0), "ln1_bias": _rnd(g, C, scale=0.1),
        "w_qkv": w(C, 3 * C), "b_qkv": _rnd(g, 3 * C, scale=0.02),
        "rel_bias": _rnd(g, h, 64, 64, scale=0.02), "w_proj": w(C, C),
        "b_proj": _rnd(g, C, scale=0.02), "ln2_scale": _rnd(g, C, scale=0.1, shift=1.0),
        "ln2_bias": _rnd(g, C, scale=0.1), "w_mlp1": w(C, hid), "b_mlp1": _rnd(g, hid, scale=0.02),
        "w_mlp2": w(hid, C), "b_mlp2": _rnd(g, C, scale=0.02),
    }


def _rel(got, ref):
    torch.cuda.synchronize()
    got, ref = got.detach().float(), ref.detach().float()
    return float((got - ref).abs().max() / ref.abs().max())


def _block_train_grads(x, mask, s1, s2, p, h, gout, plain):
    xx = x.detach().requires_grad_(True)
    pp = {k: v.detach().requires_grad_(True) for k, v in p.items()}
    fn = swin_block_train_reference if plain else swin_block_train
    out = fn(xx, mask, s1, s2, pp, h)
    out.backward(gout)
    return [out, xx.grad] + [pp[k].grad for k in PARAM_KEYS]


@pytest.mark.parametrize("C", [64, 128, 256])
@pytest.mark.parametrize("nwin,masked", [(12, False), (12, True), (301, True), (533, True)])
def test_swin_block_train_against_autograd_of_the_plain_twin(gen, C, nwin, masked):
    """Window counts of 12 (one window a block), 301 (more than the
    backward's 264 blocks, and 19,264 tokens: a ragged last weight-gradient
    split) and 533 = 2 x 264 + 5 (five blocks walk their window loop three
    times), with the shift mask of a 16x24 map (window w takes mask[w % 6])
    and drop-path scales of 0 and 1/keep. The output, dx and all 13
    gradients within chip_smoke.py's K8 tolerance (5e-2 of max |plain|)."""
    h = C // 16
    x = _rnd(gen, nwin, 64, C, dtype=torch.bfloat16)
    gout = _rnd(gen, nwin, 64, C, dtype=torch.bfloat16)
    p = _block_params(gen, C, h)
    mask = s1 = s2 = None
    if masked:
        mask = torch.as_tensor(_shift_attn_mask(16, 24, 8, 4), device="cuda")
        s1 = torch.where(torch.arange(nwin, device="cuda") % 3 == 0, 0.0, 1 / 0.8)
        s2 = torch.where(torch.arange(nwin, device="cuda") % 5 == 1, 0.0, 1 / 0.8)
    got = _block_train_grads(x, mask, s1, s2, p, h, gout, plain=False)
    ref = _block_train_grads(x, mask, s1, s2, p, h, gout, plain=True)
    for name, a, r in zip(["out", "dx", *PARAM_KEYS], got, ref, strict=True):
        assert a.shape == r.shape and a.dtype == r.dtype, name
        assert _rel(a, r) <= 5e-2, name


@pytest.mark.parametrize("C", [64, 128, 256])
@pytest.mark.parametrize("nwin", [301, 533])
def test_swin_block_train_gradients_are_bit_identical(gen, C, nwin):
    """Two backward runs on the same inputs give equal bits: every sum across
    windows, blocks and weight-gradient splits runs in a fixed order. 533
    windows make five of the 264 blocks walk their window loop three times."""
    h = C // 16
    x = _rnd(gen, nwin, 64, C, dtype=torch.bfloat16)
    gout = _rnd(gen, nwin, 64, C, dtype=torch.bfloat16)
    p = _block_params(gen, C, h)
    mask = torch.as_tensor(_shift_attn_mask(16, 24, 8, 4), device="cuda")
    first = _block_train_grads(x, mask, None, None, p, h, gout, plain=False)
    again = _block_train_grads(x, mask, None, None, p, h, gout, plain=False)
    for name, a, b in zip(["out", "dx", *PARAM_KEYS], first, again, strict=True):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("C", [64, 128, 256])
@pytest.mark.parametrize("nwin", [1, 301, 533])
def test_swin_block_train_at_head_dim_64(gen, C, nwin):
    """tpu_optimized_config()'s head dim 64 (1, 2 and 4 heads): one window,
    301 (more than the backward's 264 blocks, a ragged last weight-gradient
    split) and 533 (blocks walking their window loop three times), under the
    shift mask of a 16x24 map and drop-path scales of 0 and 1/keep: the
    output, dx and all 13 gradients within chip_smoke.py's K8 tolerance, and
    the backward twice bit for bit."""
    h = C // 64
    x = _rnd(gen, nwin, 64, C, dtype=torch.bfloat16)
    gout = _rnd(gen, nwin, 64, C, dtype=torch.bfloat16)
    p = _block_params(gen, C, h)
    mask = torch.as_tensor(_shift_attn_mask(16, 24, 8, 4), device="cuda")
    # window 0 keeps both branches, so one window has every gradient
    s1 = torch.where(torch.arange(nwin, device="cuda") % 3 == 1, 0.0, 1 / 0.8)
    s2 = torch.where(torch.arange(nwin, device="cuda") % 5 == 1, 0.0, 1 / 0.8)
    got = _block_train_grads(x, mask, s1, s2, p, h, gout, plain=False)
    ref = _block_train_grads(x, mask, s1, s2, p, h, gout, plain=True)
    again = _block_train_grads(x, mask, s1, s2, p, h, gout, plain=False)
    for name, a, r, b in zip(["out", "dx", *PARAM_KEYS], got, ref, again, strict=True):
        assert a.shape == r.shape and a.dtype == r.dtype, name
        assert _rel(a, r) <= 5e-2, name
        assert torch.equal(a, b), name


def _bwd_keeping_dx1(x, s1, s2, probs, x1, g, kp, h, mlp_windows=None):
    """swin_block_train_bwd's launch (`bwd_launch`), returning the f32
    gradient of the residual stream after the attention branch (dx1, which
    mlp_bwd writes and attn_bwd reads) beside dx and the 13 gradients."""
    from featurematching_tpu_torch.ops import swin_block_train as sbt

    dx, grads, dx1 = sbt.bwd_launch(x, s1, s2, probs, x1, g, kp, h, mlp_windows)
    torch.cuda.synchronize()
    return dx, dict(zip(PARAM_KEYS, grads)), dx1


@pytest.mark.parametrize("C", [64, 128, 256])
def test_swin_block_train_backward_with_the_attention_branch_dropped(gen, C):
    """s1 = 0 on every window: do = 0, so da, dS and dqkv are 0, dx = dx1 +
    LN1ᵀ(0) is dx1 rounded to bf16, bit for bit, and the gradients of the
    attention branch's parameters (LN1, w_qkv, b_qkv, rel_bias, w_proj,
    b_proj) are exactly 0."""
    h, nwin = C // 16, 301
    x = _rnd(gen, nwin, 64, C, dtype=torch.bfloat16)
    gout = _rnd(gen, nwin, 64, C, dtype=torch.bfloat16)
    kp = _kernel_params(_block_params(gen, C, h), C, h)
    mask = torch.as_tensor(_shift_attn_mask(16, 24, 8, 4), device="cuda")
    s1 = torch.zeros(nwin, device="cuda")
    s2 = torch.full((nwin,), 1 / 0.8, device="cuda")
    _, probs, x1 = swin_block_train_fwd(x, mask, s1, s2, kp, h)
    dx, grads, dx1 = _bwd_keeping_dx1(x, s1, s2, probs, x1, gout, kp, h)
    assert torch.equal(dx, dx1.bfloat16())
    assert bool(dx1.abs().max() > 0)
    for k in ("ln1_scale", "ln1_bias", "w_qkv", "b_qkv", "rel_bias", "w_proj", "b_proj"):
        assert not bool(grads[k].any()), k
    assert bool(grads["w_mlp1"].abs().max() > 0)


@pytest.mark.parametrize("C", [64, 128, 256])
def test_swin_block_train_backward_with_the_mlp_branch_dropped(gen, C):
    """s2 = 0 on every window: dm = 0, so dge, dy1 and dh2 are 0, dx1 = g +
    LN2ᵀ(0) is the output gradient itself in f32, bit for bit, and the
    gradients of the MLP branch's parameters (LN2, w_mlp1, b_mlp1, w_mlp2,
    b_mlp2) are exactly 0."""
    h, nwin = C // 16, 301
    x = _rnd(gen, nwin, 64, C, dtype=torch.bfloat16)
    gout = _rnd(gen, nwin, 64, C, dtype=torch.bfloat16)
    kp = _kernel_params(_block_params(gen, C, h), C, h)
    mask = torch.as_tensor(_shift_attn_mask(16, 24, 8, 4), device="cuda")
    s1 = torch.full((nwin,), 1 / 0.8, device="cuda")
    s2 = torch.zeros(nwin, device="cuda")
    _, probs, x1 = swin_block_train_fwd(x, mask, s1, s2, kp, h)
    dx, grads, dx1 = _bwd_keeping_dx1(x, s1, s2, probs, x1, gout, kp, h)
    assert torch.equal(dx1, gout.float())
    for k in ("ln2_scale", "ln2_bias", "w_mlp1", "b_mlp1", "w_mlp2", "b_mlp2"):
        assert not bool(grads[k].any()), k
    assert bool(grads["w_qkv"].abs().max() > 0)


@pytest.mark.parametrize("C", [64, 128, 256])
def test_swin_block_train_mlp_bwd_at_its_grid_edges(gen, C):
    """mlp_bwd's persistent grid (`mlp_grid`: the blocks the card holds at
    once) at 1 window, one window a block (a full wave of the grid) and one
    more (a block walks its window loop twice), and at C = 256 the training
    step's 160 windows and 161, with the shift mask and drop-path scales of
    0 and 1/keep: the output, dx and the 13 gradients within chip_smoke.py's
    K8 tolerance (5e-2 of max |plain|) of the twin's autograd, and two
    backward runs bit-identical."""
    from featurematching_tpu_torch.ops import swin_block_train as sbt

    h = C // 16
    full = sbt.mlp_grid(10**9, sbt.bwd_occupancy(C)[3], sbt.sm_count(0))
    counts = [1, full, full + 1] + ([160, 161] if C == 256 else [])
    mask = torch.as_tensor(_shift_attn_mask(16, 24, 8, 4), device="cuda")
    for nwin in counts:
        x = _rnd(gen, nwin, 64, C, dtype=torch.bfloat16)
        gout = _rnd(gen, nwin, 64, C, dtype=torch.bfloat16)
        p = _block_params(gen, C, h)
        s1 = torch.where(torch.arange(nwin, device="cuda") % 3 == 2, 0.0, 1 / 0.8)
        s2 = torch.where(torch.arange(nwin, device="cuda") % 5 == 1, 0.0, 1 / 0.8)
        got = _block_train_grads(x, mask, s1, s2, p, h, gout, plain=False)
        ref = _block_train_grads(x, mask, s1, s2, p, h, gout, plain=True)
        for name, a, r in zip(["out", "dx", *PARAM_KEYS], got, ref, strict=True):
            assert _rel(a, r) <= 5e-2, (nwin, name)
        again = _block_train_grads(x, mask, s1, s2, p, h, gout, plain=False)
        for name, a, b in zip(["out", "dx", *PARAM_KEYS], got, again, strict=True):
            assert torch.equal(a, b), (nwin, name)


@pytest.mark.parametrize("C", [64, 128, 256])
def test_swin_block_train_rows_with_one_key(gen, C):
    """A mask that leaves one key of row 37 unmasked in every mask window
    (another key in each; the other rows keep the 16x24 map's shift mask):
    P is one-hot on that row up to the probabilities of its masked keys
    (e^-100 and below, 0 or subnormal in bf16), so dS = P (dP - rowsum(dP P))
    vanishes there. The output, dx and the 13 gradients within
    chip_smoke.py's K8 tolerance of the plain twin, and rel_bias's gradient
    on row 37 below 1e-30 in magnitude."""
    h, nwin, row = C // 16, 301, 37
    x = _rnd(gen, nwin, 64, C, dtype=torch.bfloat16)
    gout = _rnd(gen, nwin, 64, C, dtype=torch.bfloat16)
    p = _block_params(gen, C, h)
    mask = torch.as_tensor(_shift_attn_mask(16, 24, 8, 4), device="cuda").clone()
    nW = mask.shape[0]
    mask[:, row, :] = -100.0
    mask[torch.arange(nW, device="cuda"), row, torch.arange(nW, device="cuda") * 11 % 64] = 0.0
    s1 = torch.where(torch.arange(nwin, device="cuda") % 3 == 0, 0.0, 1 / 0.8)
    s2 = torch.where(torch.arange(nwin, device="cuda") % 5 == 1, 0.0, 1 / 0.8)
    got = _block_train_grads(x, mask, s1, s2, p, h, gout, plain=False)
    ref = _block_train_grads(x, mask, s1, s2, p, h, gout, plain=True)
    for name, a, r in zip(["out", "dx", *PARAM_KEYS], got, ref, strict=True):
        assert _rel(a, r) <= 5e-2, name
    rel_bias = got[2 + PARAM_KEYS.index("rel_bias")]
    assert float(rel_bias[:, row].abs().max()) < 1e-30
    assert float(rel_bias.abs().max()) > 0


@pytest.mark.parametrize("C", [64, 128, 256])
def test_sparse_focal_backward_ragged(gen, C):
    """L = 200 rows and S = 136 columns (S != L, neither a multiple of the
    64-row tile): the log-sum-exps within 1e-3 and K7's softmax terms within
    1e-2 of max |plain| (chip_smoke.py's tolerances), bit-identical twice."""
    B, L, S, inv_temp = 2, 200, 136, 1.0 / (C * 0.1)
    f1 = _rnd(gen, B, S, C)
    f0 = 0.5 * _rnd(gen, B, L, C)
    f0[:, :S] += f1
    f0, f1 = f0.bfloat16(), f1.bfloat16()
    lr, lc = dual_softmax_lse(f0, f1, inv_temp)
    rr, rc = _lse_reference(f0, f1, inv_temp)
    _assert_close(lr, rr, 1e-3, 0.0)
    _assert_close(lc, rc, 1e-3, 0.0)
    a_r = torch.rand(B, L, generator=gen, device="cuda") * (torch.rand(B, L, generator=gen, device="cuda") < 0.2)
    a_c = torch.rand(B, S, generator=gen, device="cuda") * (torch.rand(B, S, generator=gen, device="cuda") < 0.2)
    d0, d1 = sparse_focal_backward(f0, f1, a_r, lr, a_c, lc, inv_temp)
    r0, r1 = sparse_focal_backward_reference(f0, f1, a_r, lr, a_c, lc, inv_temp)
    assert d0.shape == r0.shape and d1.shape == r1.shape
    assert _rel(d0, r0) <= 1e-2 and _rel(d1, r1) <= 1e-2
    e0, e1 = sparse_focal_backward(f0, f1, a_r, lr, a_c, lc, inv_temp)
    assert torch.equal(d0, e0) and torch.equal(d1, e1)


def _sfl_inputs(g, B, L, S, C):
    """K7's inputs in chip_smoke.py's form: f1's rows near some of f0's,
    the log-sum-exps from K1's pass 1, a_r and a_c on about a fifth of the
    rows and columns."""
    inv_temp = 1.0 / (C * 0.1)
    f0 = _rnd(g, B, L, C)
    idx = torch.randint(0, L, (S,), generator=g, device="cuda")
    f1 = (0.8 * f0[:, idx] + 0.6 * _rnd(g, B, S, C)).bfloat16()
    f0 = f0.bfloat16()
    lr, lc = dual_softmax_lse(f0, f1, inv_temp)
    a_r = torch.rand(B, L, generator=g, device="cuda") * (torch.rand(B, L, generator=g, device="cuda") < 0.2)
    a_c = torch.rand(B, S, generator=g, device="cuda") * (torch.rand(B, S, generator=g, device="cuda") < 0.2)
    return [f0, f1, a_r, lr, a_c, lc, inv_temp]


def _sfl_check(args):
    """K7 within 1e-2 of max |plain| (chip_smoke.py's tolerance), finite and
    bit-identical over two calls; returns the kernel's (df0, df1)."""
    d0, d1 = sparse_focal_backward(*args)
    e0, e1 = sparse_focal_backward(*args)
    r0, r1 = sparse_focal_backward_reference(*args)
    assert d0.shape == r0.shape and d1.shape == r1.shape
    assert _rel(d0, r0) <= 1e-2 and _rel(d1, r1) <= 1e-2
    assert bool(torch.isfinite(d0).all()) and bool(torch.isfinite(d1).all())
    assert torch.equal(d0, e0) and torch.equal(d1, e1)
    return d0, d1


@pytest.mark.parametrize("C", [64, 256])
@pytest.mark.parametrize("L, S", [(65, 129), (129, 65)])
@pytest.mark.parametrize("B", [1, 4])
def test_sparse_focal_backward_tile_and_unit_edges(gen, B, L, S, C):
    """L and S one past a 64-row tile of the other side and one past a
    planned unit of 128 owned rows (the second warpgroup of the last unit
    holds one row, or none): a grid of fewer blocks than the card holds, with
    units cut between blocks."""
    _sfl_check(_sfl_inputs(gen, B, L, S, C))


def test_sparse_focal_backward_zero_weights_give_zeros(gen):
    """a_r = a_c = 0: df0 and df1 exactly 0, rows and columns past a tile
    included."""
    args = _sfl_inputs(gen, 2, 1000, 777, 256)
    args[2], args[4] = torch.zeros_like(args[2]), torch.zeros_like(args[4])
    d0, d1 = sparse_focal_backward(*args)
    torch.cuda.synchronize()
    assert not bool(d0.any()) and not bool(d1.any())


def test_sparse_focal_backward_far_lse(gen):
    """Rows and columns whose log-sum-exp sits far above every sim (their
    exponentials underflow to 0): no NaN or inf, and the result within the
    tolerance of the plain twin."""
    args = _sfl_inputs(gen, 2, 1000, 777, 256)
    args[2] = args[2] + 0.5  # every row and column carries weight
    args[4] = args[4] + 0.5
    args[3][:, ::7] = 1e4
    args[5][:, 3::5] = 1e4
    _sfl_check(args)


def test_sparse_focal_backward_step_shapes_bit_identical(gen):
    """The training step's call, [4, 4800, 256] against itself: within the
    tolerance of the plain twin and bit-identical twice (the partials of
    units cut between blocks are added in a fixed order)."""
    _sfl_check(_sfl_inputs(gen, 4, 4800, 4800, 256))


# the training step's weight-gradient products: the first T of each (M, N)
WGRAD_STEP_T = {}
for _T, _M, _N in wgrad_calls(ModelConfig()):
    WGRAD_STEP_T.setdefault((_M, _N), _T)


@pytest.mark.parametrize("M, N", sorted(WGRAD_STEP_T))
def test_wgrad_against_the_twin(gen, M, N):
    """Every (M, N) of the step at its T and at T = 1, 63, 65 (a stage and
    one past it) and 4097 (a ragged last split): within 1e-4 of max |plain|
    (f32 sums of exact bf16 products in another order), and two calls bit
    for bit (the splits' partials added in a fixed order)."""
    for T in (1, 63, 65, 4097, WGRAD_STEP_T[(M, N)]):
        a = _rnd(gen, T, M, dtype=torch.bfloat16)
        b = _rnd(gen, T, N, dtype=torch.bfloat16)
        got, again = wgrad(a, b), wgrad(a, b)
        ref = wgrad_reference(a, b)
        torch.cuda.synchronize()
        err = float((got - ref).abs().max() / ref.abs().max())
        assert err <= 1e-4, (T, err)
        assert torch.equal(got, again), T


@pytest.mark.parametrize("kind", ["K8 C=64", "K8 C=128", "K8 C=256", "K9", "K10"])
def test_wgrad_group_of_a_backward(gen, kind):
    """A backward's products in one launch, as the step makes them (an
    operand two products read is one tensor), at a ragged token count (301
    windows of 64 or 49 tokens, 4801 tokens for K9) and at the step's own:
    each within 1e-4 of max |plain|, and two launches bit for bit."""
    step = {f"K8 C={g[0][1]}": g for g in wgrad_groups(ModelConfig()) if len(g) == 4}
    step |= {"K9": wgrad_groups(ModelConfig())[13], "K10": wgrad_groups(ModelConfig())[-1]}
    group = step[kind]
    ragged = {"K9": 4801, "K10": 49 * 301}.get(kind, 64 * 301)
    for T in (ragged, group[0][0]):
        names = {}
        for _, M, N, a, b in group:
            names.setdefault(a, _rnd(gen, T, M, dtype=torch.bfloat16))
            names.setdefault(b, _rnd(gen, T, N, dtype=torch.bfloat16))
        pairs = [(names[a], names[b]) for _, _, _, a, b in group]
        got, again = wgrad_group(pairs), wgrad_group(pairs)
        torch.cuda.synchronize()
        for q, ((a, b), d, e) in enumerate(zip(pairs, got, again)):
            ref = wgrad_reference(a, b)
            assert float((d - ref).abs().max() / ref.abs().max()) <= 1e-4, (T, q)
            assert torch.equal(d, e), (T, q)


def test_wgrad_operands_inside_a_stash(gen):
    """Operands at the offsets K10's stash gives them (T C bf16 apart, T =
    49 G, so no multiple of a 64-token stage) with the stash's later blocks
    behind their last row: the rows past T read as zeros, not as the next
    block."""
    G, C = 301, 64
    T = 49 * G
    stash = _rnd(gen, 3 * T * C, dtype=torch.bfloat16)
    a, b = stash[T * C:2 * T * C].view(T, C), stash[:T * C].view(T, C)
    got, ref = wgrad(a, b), wgrad_reference(a, b)
    torch.cuda.synchronize()
    assert float((got - ref).abs().max() / ref.abs().max()) <= 1e-4


def test_wgrad_raises_rather_than_fall_back(gen):
    """float32 operands, M = 96, N = 32, no token, a strided operand: the
    wrapper raises and launches nothing."""
    before = wgrad.launches
    a, b = _rnd(gen, 70, 64, dtype=torch.bfloat16), _rnd(gen, 70, 128, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="bfloat16"):
        wgrad(a.float(), b)
    with pytest.raises(ValueError, match="multiples of 64"):
        wgrad(_rnd(gen, 70, 96, dtype=torch.bfloat16), b)
    with pytest.raises(ValueError, match="multiples of 64"):
        wgrad(a, b[:, :32].contiguous())
    with pytest.raises(ValueError, match="multiples of 64"):
        wgrad(a[:0], b[:0])
    with pytest.raises(ValueError, match="contiguous"):
        wgrad(a, b[:, ::2])
    assert wgrad.launches == before


def test_backwards_count_their_wgrad_launches(gen):
    """A K8 backward makes its four weight-gradient products, K9's and
    K10's their six, in one launch: each wrapper adds it to wgrad's
    counter."""
    before = wgrad.launches
    x = _rnd(gen, 12, 64, 64, dtype=torch.bfloat16)
    _block_train_grads(x, None, None, None, _block_params(gen, 64, 4), 4, torch.ones_like(x),
                       plain=False)
    torch.cuda.synchronize()
    assert wgrad.launches == before + 1
    lv = _layer_values(gen, 256)
    xc = _rnd(gen, 1, 100, 256, dtype=torch.bfloat16)
    _k9_call(xc, xc, lv, 8, torch.ones_like(xc), plain=False)
    assert wgrad.launches == before + 2
    lf = _layer_values(gen, 64)
    xf = _rnd(gen, 3, 49, 64, dtype=torch.bfloat16)
    _k10_call(xf, xf, lf, 8, torch.ones(3, 49, 64, device="cuda"), plain=False)
    assert wgrad.launches == before + 3


def test_training_wrappers_raise_rather_than_fall_back(gen):
    """Head dims 8 and 32, C = 96, float32 activations, one drop-path scale
    alone: the training wrappers raise and launch nothing."""
    before = (swin_block_train_fwd.launches, swin_block_train_bwd.launches,
              dual_softmax_lse.launches, sparse_focal_backward.launches)
    p = _block_params(gen, 64, 4)
    xb = _rnd(gen, 4, 64, 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head dim"):
        swin_block_train(xb, None, None, None, p, 8)
    with pytest.raises(ValueError, match="head dim"):  # 32: K8 takes 16 and 64
        swin_block_train(xb, None, None, None, _block_params(gen, 64, 2), 2)
    with pytest.raises(ValueError, match="bfloat16"):
        swin_block_train(xb.float(), None, None, None, p, 4)
    with pytest.raises(ValueError, match="both drop-path scales"):
        swin_block_train(xb, None, torch.ones(4, device="cuda"), None, p, 4)
    x96 = _rnd(gen, 4, 64, 96, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="C in"):
        swin_block_train(x96, None, None, None, _block_params(gen, 96, 6), 6)
    f = _rnd(gen, 1, 64, 96, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="C in"):
        dual_softmax_lse(f, f, 0.1)
    v = torch.zeros(1, 64, device="cuda")
    with pytest.raises(ValueError, match="C in"):
        sparse_focal_backward(f, f, v, v, v, v, 0.1)
    f32 = _rnd(gen, 1, 64, 64)
    with pytest.raises(ValueError, match="bfloat16"):
        sparse_focal_backward(f32, f32, v, v, v, v, 0.1)
    after = (swin_block_train_fwd.launches, swin_block_train_bwd.launches,
             dual_softmax_lse.launches, sparse_focal_backward.launches)
    assert after == before


def test_swin_block_train_saves_for_a_backward_only(gen, monkeypatch):
    """Under no_grad, or when nothing requires a gradient, the forward kernel
    writes neither the probabilities nor x1; its output is bit-identical to
    the saving forward's."""
    import featurematching_tpu_torch.ops.swin_block_train as sbt

    C, h, nwin = 64, 4, 12
    x = _rnd(gen, nwin, 64, C, dtype=torch.bfloat16)
    p = _block_params(gen, C, h)
    mask = torch.as_tensor(_shift_attn_mask(16, 24, 8, 4), device="cuda")
    saved = []
    fwd = sbt.swin_block_train_fwd

    def spy(*args):
        res = fwd(*args)
        saved.append(res[1] is not None and res[2] is not None)
        return res

    spy.launches = 0  # the wrapper counts its launches on the name it is called by
    monkeypatch.setattr(sbt, "swin_block_train_fwd", spy)
    training = swin_block_train(x.detach().requires_grad_(True), mask, None, None, p, h)
    with torch.no_grad():
        no_grad = swin_block_train(x.detach().requires_grad_(True), mask, None, None, p, h)
    no_leaf = swin_block_train(x, mask, None, None, p, h)
    assert saved == [True, False, False]
    assert torch.equal(training.detach(), no_grad) and torch.equal(no_grad, no_leaf)


def _k9_close(got, ref, exact, name):
    """K9 against its bf16 twin, given the twin in float32 arithmetic on the
    same inputs (`exact`), for the stats and the gradients: the kernel is as
    close to the float32 result as the twin is, |kernel - exact| <= 1.25
    |twin - exact| + 1e-5 |twin| (norms). Both sides round to bf16 at the
    same points but sum in another order, so a rounding can fall the other
    way, and where a ReLU or feature-map input is within rounding of 0 the
    two take the two branches: a few entries differ by their whole size,
    which weighs more in a small call than in the step's (where
    chip_smoke.py holds the kernel to 1e-2 of the twin's norm, its K9_TOL),
    and through a stack the two drift apart as far as each is from the
    float32 result. A kernel fault moves the kernel away from that result
    (the twin's own error is 0.2-5% of a tensor's norm in these calls). A
    forward output ends in a LayerNorm and a bf16 rounding, so a rounding
    that falls the other way upstream moves its whole row: it is held by
    K5's tolerance instead."""
    torch.cuda.synchronize()
    got, ref, exact = (t.detach().float() for t in (got, ref, exact))
    own = float((ref - exact).norm()) + 1e-5 * float(ref.norm())
    err = float((got - exact).norm())
    assert err <= 1.25 * own, f"{name}: {err:.3e} vs {own:.3e}"


def _k9_call(x, src, lv, heads, gout, plain):
    if plain:
        out, kv, ks = encoder_reference_with_stats(x, src, lv, heads)
        dx, dsrc, wg = ctt.coarse_layer_backward_reference(x, src, kv, ks, gout, lv, heads)
    else:
        out, kv, ks = ctt.coarse_layer_forward(x, src, lv, heads)
        dx, dsrc, wg = ctt.coarse_layer_backward(x, src, kv, ks, gout, lv,
                                                 ctt.train_values(lv), heads)
    return [out, kv, ks, dx, dsrc, *wg]


@pytest.mark.parametrize("C,heads", [(c, c // d) for c, d in ctt.TRAIN_WIDTHS])
@pytest.mark.parametrize("kind", ["self", "cross"])
def test_coarse_train_call_ragged_tokens(gen, C, heads, kind):
    """200 query tokens (no multiple of the 64-row tile), and 237 source
    tokens for a cross call: the forward's out (K5's tolerance), kv and ks
    and the backward's dx, dsrc and 9 gradients against the plain twin on the
    same inputs, by `_k9_close` against the twin in bf16 and in float32
    arithmetic; twice, bit for bit."""
    G, N = 3, 200
    lv = _layer_values(gen, C)
    x = _rnd(gen, G, N, C, dtype=torch.bfloat16)
    src = x if kind == "self" else _rnd(gen, G, N + 37, C, dtype=torch.bfloat16)
    gout = _rnd(gen, G, N, C, dtype=torch.bfloat16)
    got = _k9_call(x, src, lv, heads, gout, plain=False)
    ref = _k9_call(x, src, lv, heads, gout, plain=True)
    x32 = x.float()
    src32 = x32 if kind == "self" else src.float()
    exact = _k9_call(x32, src32, type(lv)(*[t.float() for t in lv]), heads, gout.float(),
                     plain=True)
    names = ["out", "kv", "ks", "dx", "dsrc", "dwq", "dwkv", "dwmerge", "dn1s", "dn1b", "dw1",
             "dw2", "dn2s", "dn2b"]
    for name, a, r, e in zip(names, got, ref, exact, strict=True):
        assert a.shape == r.shape and a.dtype == r.dtype, name
        if name == "out":  # K5's output: its own tolerance (test_coarse_layer_ragged_tokens)
            _assert_close(a, r, 5e-2, 2e-2)
        else:
            _k9_close(a, r, e, name)
    again = _k9_call(x, src, lv, heads, gout, plain=False)
    for name, a, b in zip(names, got, again, strict=True):
        assert torch.equal(a, b), name  # fixed-order sums: bit for bit


K9_NAMES = ["dx", "dsrc", "dwq", "dwkv", "dwmerge", "dn1s", "dn1b", "dw1", "dw2", "dn2s", "dn2b"]


def _k9_grads(x, src, kv, ks, gout, lv, heads, plain):
    """[dx, dsrc, the 9 gradients] of one call's backward on the forward's
    stats (kv, ks): the kernels or, plain, the twin."""
    if plain:
        dx, dsrc, wg = ctt.coarse_layer_backward_reference(x, src, kv, ks, gout, lv, heads)
    else:
        dx, dsrc, wg = ctt.coarse_layer_backward(x, src, kv, ks, gout, lv,
                                                 ctt.train_values(lv), heads)
    return [dx, dsrc, *wg]


def _k9_held(x, src, kv, ks, gout, lv, heads):
    """The kernels' backward, held against the twin by `_k9_close` (the twin
    in float32 arithmetic on the same stats as the reference); returned."""
    got = _k9_grads(x, src, kv, ks, gout, lv, heads, plain=False)
    ref = _k9_grads(x, src, kv, ks, gout, lv, heads, plain=True)
    exact = _k9_grads(x.float(), src.float(), kv.float(), ks.float(), gout.float(),
                      type(lv)(*[t.float() for t in lv]), heads, plain=True)
    for name, a, r, e in zip(K9_NAMES, got, ref, exact, strict=True):
        assert a.shape == r.shape and a.dtype == r.dtype, name
        _k9_close(a, r, e, name)
    return got


@pytest.mark.parametrize("L", [1, 63, 65, 4801])
@pytest.mark.parametrize("G", [1, 2])
@pytest.mark.parametrize("kind", ["self", "cross"])
def test_coarse_train_tile_edges(gen, L, G, kind):
    """Query lengths at apply_bwd's 64-row tile's edges (one row, one short of
    a tile, one past it, one past the step's 75 tiles), C = 256 with 8 heads,
    and 37 more source tokens than queries for a cross call: the backward
    against the plain twin on the same stats by `_k9_close` (the twin in
    float32 arithmetic as the reference), and bit-identical twice."""
    C, heads = 256, 8
    lv = _layer_values(gen, C)
    x = _rnd(gen, G, L, C, dtype=torch.bfloat16)
    src = x if kind == "self" else _rnd(gen, G, L + 37, C, dtype=torch.bfloat16)
    gout = _rnd(gen, G, L, C, dtype=torch.bfloat16)
    _, kv, ks = ctt.coarse_layer_forward(x, src, lv, heads)
    got = _k9_held(x, src, kv, ks, gout, lv, heads)
    again = _k9_grads(x, src, kv, ks, gout, lv, heads, plain=False)
    for name, a, b in zip(K9_NAMES, got, again, strict=True):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("C,heads", [(c, c // d) for c, d in ctt.TRAIN_WIDTHS])
@pytest.mark.parametrize("S", [1, 63, 64, 65, 127, 128, 129, 4800, 4801])
def test_coarse_train_stats_bwd_tile_edges(gen, C, heads, S):
    """stats_bwd at its tiles' edges, at every width it takes: cross calls
    of 8 images (70 query tokens each) over S source tokens: one row, one
    short of a 64-token tile, a tile, one past it, one short of two, two,
    one past them, the step's 75 tiles and one past (8 x 76 tiles: more
    than the persistent grid's warpgroup slots, so a block takes a run of
    tiles over two images, and an odd run leaves a warpgroup without a tile
    in its last round). The backward against the plain twin by `_k9_close`
    (`_k9_held`: dsrc, and dwkv from the stashed [dkf | dv]), and
    bit-identical twice."""
    G, L = 8, 70
    lv = _layer_values(gen, C)
    x = _rnd(gen, G, L, C, dtype=torch.bfloat16)
    src = _rnd(gen, G, S, C, dtype=torch.bfloat16)
    gout = _rnd(gen, G, L, C, dtype=torch.bfloat16)
    _, kv, ks = ctt.coarse_layer_forward(x, src, lv, heads)
    got = _k9_held(x, src, kv, ks, gout, lv, heads)
    again = _k9_grads(x, src, kv, ks, gout, lv, heads, plain=False)
    for name, a, b in zip(K9_NAMES, got, again, strict=True):
        assert torch.equal(a, b), name


def test_coarse_train_step_cross_call(gen):
    """The training step's cross call [4, 4800, 256] (8 heads): dx, dsrc and
    the 10 gradients against the plain twin within chip_smoke.py's K9_TOL of
    each tensor's norm."""
    cs = _chip_smoke()
    lv = _layer_values(gen, 256)
    x, src, gout = (_rnd(gen, 4, 4800, 256, dtype=torch.bfloat16) for _ in range(3))
    _, kv, ks = ctt.coarse_layer_forward(x, src, lv, 8)
    got = cs.k9_tensors(None, ctt.coarse_layer_backward(x, src, kv, ks, gout, lv,
                                                        ctt.train_values(lv), 8))
    torch.cuda.synchronize()
    ref = cs.k9_tensors(None, ctt.coarse_layer_backward_reference(x, src, kv, ks, gout, lv, 8))
    errs = {n: cs.norm_err(got[n], ref[n]) for n in got}
    assert all(v <= cs.K9_TOL for v in errs.values()), errs


@pytest.mark.parametrize("kind", ["self", "cross"])
def test_coarse_train_zero_gradient(gen, kind):
    """g = 0 (200 query tokens, ragged): dx, dsrc and every gradient exactly 0."""
    lv = _layer_values(gen, 256)
    x = _rnd(gen, 2, 200, 256, dtype=torch.bfloat16)
    src = x if kind == "self" else _rnd(gen, 2, 237, 256, dtype=torch.bfloat16)
    _, kv, ks = ctt.coarse_layer_forward(x, src, lv, 8)
    got = _k9_grads(x, src, kv, ks, torch.zeros_like(x), lv, 8, plain=False)
    for name, a in zip(K9_NAMES, got, strict=True):
        torch.cuda.synchronize()
        assert bool((a == 0).all()), name


def _k9_bwd_keeping_stash(x, src, kv, ks, g, lv, lt, heads):
    """coarse_layer_backward's launch with its buffers allocated as the
    wrapper does, returning the stashed dy1 [G, L, 2C] beside dw1 and dw2."""
    from featurematching_tpu_torch.ops import _build

    G, L, C = x.shape
    S, D = src.shape[1], C // heads
    f32 = dict(device=x.device, dtype=torch.float32)
    tiles = G * -(-L // 64)
    sms = ctt.sm_count(x.device.index or 0)
    outs = [torch.empty_like(x), torch.empty_like(src), torch.empty(C, C, **f32),
            torch.empty(C, 2 * C, **f32), torch.empty(C, C, **f32), torch.empty(4 * C, **f32),
            torch.empty(2 * C, 2 * C, **f32), torch.empty(2 * C, C, **f32),
            torch.empty((9 * G * L + 2 * G * S) * C, device=x.device, dtype=torch.bfloat16),
            torch.empty(tiles * 4 * C, **f32), torch.empty(tiles * C * D, **f32),
            torch.empty(tiles * C, **f32),
            torch.empty(G * C * D, device=x.device, dtype=torch.bfloat16),
            torch.empty(G * C, device=x.device, dtype=torch.bfloat16),
            torch.empty(ctt.partial_floats(ctt.wgrad_calls(G * L, G * S, C), sms), **f32)]
    _build.launch("coarse_transformer_train", "fm_coarse_train_bwd", ctt._BWD_ARGS,
                  ctt._ptrs([x, src, kv, ks, g, *lv, *lt, ctt.stats_bwd_image(lv)]),
                  ctt._ptrs(outs), G, L, S, C, D,
                  sms, _build.stream())
    torch.cuda.synchronize()
    T = G * L
    # the stash: o, msg (C), h (2C), dy2 (C), dy1 (2C), ...
    dy1 = outs[8][5 * C * T:7 * C * T].view(G, L, 2 * C)
    return dy1, outs[6], outs[7]


def test_coarse_train_empty_relu_mask(gen):
    """w1 = 0: no hidden unit is positive on any row, so the stashed dy1, dw1
    and dw2 are exactly 0; the other outputs (dx = g, dn2b = the sum of g, the
    rest 0) hold against the plain twin by `_k9_close`."""
    C, heads = 256, 8
    lv = _layer_values(gen, C)
    lv = lv._replace(wmlp1=torch.zeros_like(lv.wmlp1))
    x = _rnd(gen, 2, 200, C, dtype=torch.bfloat16)
    src = _rnd(gen, 2, 237, C, dtype=torch.bfloat16)
    gout = _rnd(gen, 2, 200, C, dtype=torch.bfloat16)
    _, kv, ks = ctt.coarse_layer_forward(x, src, lv, heads)
    dy1, dw1, dw2 = _k9_bwd_keeping_stash(x, src, kv, ks, gout, lv, ctt.train_values(lv), heads)
    assert bool((dy1 == 0).all()) and bool((dw1 == 0).all()) and bool((dw2 == 0).all())
    _k9_held(x, src, kv, ks, gout, lv, heads)


def _stack_grads(tf, f0, f1, w0, w1):
    tf.zero_grad(set_to_none=True)
    a, b = f0.detach().requires_grad_(True), f1.detach().requires_grad_(True)
    o0, o1 = tf(a, b)
    ((o0.float() * w0).sum() + (o1.float() * w1).sum()).backward()
    return [o0, o1, a.grad, b.grad] + [p.grad for p in tf.parameters()]


def test_coarse_train_stack_against_the_twin(gen, monkeypatch):
    """A self + cross stack (C = 256, 8 heads, 2 x 300 tokens of 2 images)
    through coarse_transformer_train: the outputs, both feature gradients
    and all 20 parameter gradients against the same Function run on the
    plain twins on the card (the outputs at K5's tolerance, the gradients by
    `_k9_close` against the twins in bf16 and in float32); K9 launches 3 + 3
    times."""
    torch.manual_seed(0)
    tf = LocalFeatureTransformer(256, 8, ("self", "cross"), use_fused_train=True).cuda()
    f0, f1 = (_rnd(gen, 2, 300, 256, scale=0.5, dtype=torch.bfloat16) for _ in range(2))
    w0, w1 = _rnd(gen, 2, 300, 256), _rnd(gen, 2, 300, 256)
    before = (ctt.coarse_layer_forward.launches, ctt.coarse_layer_backward.launches)
    got = _stack_grads(tf, f0, f1, w0, w1)
    after = (ctt.coarse_layer_forward.launches, ctt.coarse_layer_backward.launches)
    assert (after[0] - before[0], after[1] - before[1]) == (3, 3)
    monkeypatch.setattr(ctt, "coarse_layer_forward", encoder_reference_with_stats)
    monkeypatch.setattr(ctt, "coarse_layer_backward",
                        lambda x, s, kv, ks, g, lv, lt, h:
                        ctt.coarse_layer_backward_reference(x, s, kv, ks, g, lv, h))
    ref = _stack_grads(tf, f0, f1, w0, w1)
    exact = _stack_grads(tf, f0.float(), f1.float(), w0, w1)
    for i, (a, r, e) in enumerate(zip(got, ref, exact, strict=True)):
        assert a.shape == r.shape and a.dtype == r.dtype, i
        if i < 2:  # the stack's outputs: K5's layer tolerance
            _assert_close(a, r, 5e-2, 2e-2)
        else:
            _k9_close(a, r, e, i)


def test_coarse_train_wrapper_raises_rather_than_fall_back(gen):
    """float32 activations, head dim 128, head dim 64 at C = 128, a float32
    upstream gradient: the K9 wrapper raises and launches nothing."""
    lv = _layer_values(gen, 256)
    x = _rnd(gen, 1, 64, 256, dtype=torch.bfloat16)
    out, kv, ks = ctt.coarse_layer_forward(x, x, lv, 8)
    lt = ctt.train_values(lv)
    before = ctt.coarse_layer_backward.launches
    with pytest.raises(ValueError, match="bfloat16"):
        ctt.coarse_layer_backward(x.float(), x.float(), kv, ks, x, lv, lt, 8)
    with pytest.raises(ValueError, match="head dim"):
        ctt.coarse_layer_backward(x, x, kv, ks, x, lv, lt, 2)
    lv128 = _layer_values(gen, 128)
    x128 = _rnd(gen, 1, 64, 128, dtype=torch.bfloat16)
    _, kv128, ks128 = ctt.coarse_layer_forward(x128, x128, lv128, 2)  # K5 takes (128, 64)
    with pytest.raises(ValueError, match="head dim"):
        ctt.coarse_layer_backward(x128, x128, kv128, ks128, x128, lv128, ctt.train_values(lv128), 2)
    with pytest.raises(ValueError, match="bfloat16"):
        ctt.coarse_layer_backward(x, x, kv, ks, x.float(), lv, lt, 8)
    assert ctt.coarse_layer_backward.launches == before


def _k10_call(x, src, lv, heads, gout, plain):
    if plain:
        return list(ftt.fine_layer_backward_reference(x, src, gout, lv, heads))
    return list(ftt.fine_layer_backward(x, src, gout, lv, heads))


K10_NAMES = ["dx", "dsrc", "dwq", "dwkv", "dwmerge", "dn1s", "dn1b", "dw1", "dw2", "dn2s",
             "dn2b"]


def _flat(r):
    """A K10 call's outputs by name; a self call has no dsrc (dx holds it)."""
    return {n: t for n, t in zip(K10_NAMES, [r[0], r[1], *r[2]], strict=True) if t is not None}


@pytest.mark.parametrize("G", [1, 301])
@pytest.mark.parametrize("N", [25, 49])
@pytest.mark.parametrize("kind,heads", [("self", 8), ("cross", 8), ("cross", 4), ("self", 1),
                                        ("cross", 1)])
def test_fine_train_call_ragged_windows(gen, G, N, kind, heads):
    """One window (fewer than the grid's blocks) and 301 (more than two an
    SM, a ragged weight-gradient split), 25 and 49 taps, head dims 8, 16
    and 64: dx, dsrc and the 9 gradients against the plain twin on the same
    inputs (a self call: dx + dsrc as dx), by `_k9_close` against the twin
    in bf16 and in float32 arithmetic; twice, bit for bit."""
    C = 64
    lv = _layer_values(gen, C)
    x = _rnd(gen, G, N, C, dtype=torch.bfloat16)
    src = x if kind == "self" else _rnd(gen, G, N, C, dtype=torch.bfloat16)
    gout = _rnd(gen, G, N, C)
    got = _flat(_k10_call(x, src, lv, heads, gout, plain=False))
    ref = _flat(_k10_call(x, src, lv, heads, gout, plain=True))
    x32 = x.float()
    src32 = x32 if kind == "self" else src.float()
    exact = _flat(_k10_call(x32, src32, type(lv)(*[t.float() for t in lv]), heads, gout,
                            plain=True))
    assert list(got) == list(ref) == list(exact) == [n for n in K10_NAMES
                                                     if kind == "cross" or n != "dsrc"]
    for name, a in got.items():
        assert a.shape == ref[name].shape and a.dtype == ref[name].dtype, name
        _k9_close(a, ref[name], exact[name], name)
    again = _flat(_k10_call(x, src, lv, heads, gout, plain=False))
    for name, a in got.items():
        assert torch.equal(a, again[name]), name  # fixed-order sums: bit for bit


def _window_slots():
    """The window stage's window slots on this card: blocks x warpgroups."""
    occ = ftt.window_bwd_occupancy(8, 1 << 20)
    return occ["grid"] * occ["warpgroups"]


@pytest.mark.parametrize("windows", ["one", "ragged_round"])
@pytest.mark.parametrize("N", [1, 48, 49, 64])
@pytest.mark.parametrize("kind,heads", [("self", 8), ("cross", 8), ("self", 4), ("cross", 4),
                                        ("self", 1), ("cross", 1)])
def test_window_bwd_edges(gen, windows, N, kind, heads):
    """The window stage at its grid's edges: one window, and one past a full
    round of its window slots (the last round holds one window of a
    warpgroup); 1, 48, 49 and 64 taps (the 64-row tile with 63, 16, 15 and
    no padded rows); head dims 8, 16 and 64; self and cross calls: every output
    against the plain twin as test_fine_train_call_ragged_windows holds
    them, and twice bit for bit."""
    C = 64
    G = 1 if windows == "one" else _window_slots() + 1
    lv = _layer_values(gen, C)
    x = _rnd(gen, G, N, C, dtype=torch.bfloat16)
    src = x if kind == "self" else _rnd(gen, G, N, C, dtype=torch.bfloat16)
    gout = _rnd(gen, G, N, C)
    got = _flat(_k10_call(x, src, lv, heads, gout, plain=False))
    again = _flat(_k10_call(x, src, lv, heads, gout, plain=False))
    ref = _flat(_k10_call(x, src, lv, heads, gout, plain=True))
    x32 = x.float()
    src32 = x32 if kind == "self" else src.float()
    exact = _flat(_k10_call(x32, src32, type(lv)(*[t.float() for t in lv]), heads, gout,
                            plain=True))
    assert list(got) == list(ref)
    for name, a in got.items():
        assert a.shape == ref[name].shape and a.dtype == ref[name].dtype, name
        assert torch.isfinite(a).all(), name
        _k9_close(a, ref[name], exact[name], name)
        assert torch.equal(a, again[name]), name


@pytest.mark.parametrize("kind", ["self", "cross"])
def test_window_bwd_zero_gradient(gen, kind):
    """g = 0: dx, dsrc and every gradient exactly 0 (the padded rows and
    masked heads add nothing either)."""
    G, N, C = 300, 49, 64
    lv = _layer_values(gen, C)
    x = _rnd(gen, G, N, C, dtype=torch.bfloat16)
    src = x if kind == "self" else _rnd(gen, G, N, C, dtype=torch.bfloat16)
    got = _flat(_k10_call(x, src, lv, 8, torch.zeros(G, N, C, device="cuda"), plain=False))
    torch.cuda.synchronize()
    for name, a in got.items():
        assert (a == 0).all(), name


def test_window_bwd_sees_weights_changed_in_place(gen):
    """The kernel's weight image is kept on the packed layer while its
    tensors stay the same at the same versions: a weight changed in place
    between two calls is seen by the second (against the twin on the new
    weights)."""
    G, N, C = 300, 49, 64
    lv = _layer_values(gen, C)
    x, src = (_rnd(gen, G, N, C, dtype=torch.bfloat16) for _ in range(2))
    gout = _rnd(gen, G, N, C)
    first = _flat(_k10_call(x, src, lv, 8, gout, plain=False))
    lv.wkv.mul_(2)
    lv.wmlp1.mul_(-1)
    got = _flat(_k10_call(x, src, lv, 8, gout, plain=False))
    ref = _flat(_k10_call(x, src, lv, 8, gout, plain=True))
    exact = _flat(_k10_call(x.float(), src.float(), type(lv)(*[t.float() for t in lv]), 8, gout,
                            plain=True))
    assert not torch.equal(got["dx"], first["dx"])
    for name, a in got.items():
        _k9_close(a, ref[name], exact[name], name)


def test_fine_train_second_step_after_fused_adamw(gen, monkeypatch):
    """Two training steps of a self + cross stack through
    fine_transformer_train with a fused AdamW step between, which writes
    the weights without bumping their versions: the second step's gradients
    against the same Function on the plain twins with the weights the
    optimizer wrote (`_k9_close`)."""
    torch.manual_seed(0)
    tf = LocalFeatureTransformer(64, 8, ("self", "cross"), use_fused_train=True).cuda()
    f0, f1 = (_rnd(gen, 300, 49, 64, scale=0.5, dtype=torch.bfloat16) for _ in range(2))
    w0, w1 = _rnd(gen, 300, 49, 64), _rnd(gen, 300, 49, 64)
    first = _stack_grads(tf, f0, f1, w0, w1)
    versions = [p._version for p in tf.parameters()]
    torch.optim.AdamW(tf.parameters(), lr=0.05, fused=True).step()
    assert [p._version for p in tf.parameters()] == versions  # the writes the cache must see
    got = _stack_grads(tf, f0, f1, w0, w1)
    assert not torch.equal(got[2], first[2])
    monkeypatch.setattr(ftt, "fine_layer_forward", fine_layer_reference)
    monkeypatch.setattr(ftt, "fine_layer_backward", ftt.fine_layer_backward_reference)
    ref = _stack_grads(tf, f0, f1, w0, w1)
    exact = _stack_grads(tf, f0.float(), f1.float(), w0, w1)
    for i, (a, r, e) in enumerate(zip(got, ref, exact, strict=True)):
        if i < 2:  # the stack's outputs: K6's window tolerance
            _assert_close(a, r, 5e-2, 2e-2)
        else:
            _k9_close(a, r, e, i)


def test_fine_train_stack_against_the_twin(gen, monkeypatch):
    """A self + cross stack (C = 64, 8 heads, 2 x 300 windows of 49 taps)
    through fine_transformer_train: the outputs (K6's tolerance), both
    window gradients and all 20 parameter gradients against the same
    Function run on the plain twins on the card (`_k9_close` against the
    twins in bf16 and in float32); K10 launches 2 forwards and 3 backwards,
    K6's serving counter none."""
    torch.manual_seed(0)
    tf = LocalFeatureTransformer(64, 8, ("self", "cross"), use_fused_train=True).cuda()
    f0, f1 = (_rnd(gen, 300, 49, 64, scale=0.5, dtype=torch.bfloat16) for _ in range(2))
    w0, w1 = _rnd(gen, 300, 49, 64), _rnd(gen, 300, 49, 64)
    before = (fine_layer_forward.launches, ftt.fine_layer_backward.launches,
              fine_stage_fused.launches)
    got = _stack_grads(tf, f0, f1, w0, w1)
    after = (fine_layer_forward.launches, ftt.fine_layer_backward.launches,
             fine_stage_fused.launches)
    assert tuple(a - b for a, b in zip(after, before)) == (2, 3, 0)
    monkeypatch.setattr(ftt, "fine_layer_forward", fine_layer_reference)
    twin = ftt.fine_layer_backward_reference
    monkeypatch.setattr(ftt, "fine_layer_backward", twin)
    ref = _stack_grads(tf, f0, f1, w0, w1)
    exact = _stack_grads(tf, f0.float(), f1.float(), w0, w1)
    for i, (a, r, e) in enumerate(zip(got, ref, exact, strict=True)):
        assert a.shape == r.shape and a.dtype == r.dtype, i
        if i < 2:  # the stack's outputs: K6's window tolerance
            _assert_close(a, r, 5e-2, 2e-2)
        else:
            _k9_close(a, r, e, i)


def test_fine_train_wrapper_raises_rather_than_fall_back(gen):
    """C = 128, head dims 4 and 32, 65 taps, a bf16 upstream gradient: the
    K10 wrapper raises and launches nothing."""
    lv = _layer_values(gen, 64)
    x = _rnd(gen, 2, 49, 64, dtype=torch.bfloat16)
    g = _rnd(gen, 2, 49, 64)
    before = ftt.fine_layer_backward.launches
    lv128 = _layer_values(gen, 128)
    x128 = _rnd(gen, 2, 49, 128, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="C=64"):
        ftt.fine_layer_backward(x128, x128, _rnd(gen, 2, 49, 128), lv128, 8)
    with pytest.raises(ValueError, match="head dim"):
        ftt.fine_layer_backward(x, x, g, lv, 16)  # head dim 4
    with pytest.raises(ValueError, match="head dim"):
        ftt.fine_layer_backward(x, x, g, lv, 2)  # head dim 32
    x65 = _rnd(gen, 2, 65, 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="taps"):
        ftt.fine_layer_backward(x65, x65, _rnd(gen, 2, 65, 64), lv, 8)
    with pytest.raises(ValueError, match="float32"):
        ftt.fine_layer_backward(x, x, g.bfloat16(), lv, 8)
    assert ftt.fine_layer_backward.launches == before


def test_serving_forward_takes_the_per_op_branches(gen):
    """tpu_optimized_config()'s widths: Swin head dim 64, coarse 256 with 4
    heads of 64 and fine 64 with one head of 64 all have their kernels, so
    the serving forward launches K2 (built at head dim 64) 13 times and K5
    and K6 once each, runs no eager coarse or fine layer, and its outputs
    are finite. A width the JAX gates take and no kernel does raises at
    construction, naming the kernel: coarse 256 with 2 heads of 128 (K5),
    fine 128 or three fine layers (K6), and a Swin head dim of 8 (K2)."""
    import dataclasses

    from featurematching_tpu_torch.config import tpu_optimized_config

    cfg = tpu_optimized_config().model
    model = FastMatcher(cfg, device="cuda", seed=0)
    assert model.use_fused_coarse(64) and model.use_fused_fine()
    eager = []
    for tf in (model.coarse_transformer, model.fine_transformer):
        for layer in tf.children():
            layer.register_forward_hook(lambda *_: eager.append(1))
    a = torch.rand(2, 64, 64, 3, generator=gen, device="cuda")
    before = (swin_block_fused.launches, coarse_transformer_fused.launches,
              fine_stage_fused.launches)
    out = model(a, torch.roll(a, shifts=8, dims=2))
    torch.cuda.synchronize()
    after = (swin_block_fused.launches, coarse_transformer_fused.launches,
             fine_stage_fused.launches)
    assert tuple(n - b for n, b in zip(after, before)) == (13, 1, 1) and not eager
    assert torch.isfinite(out.feat_c0.float()).all()
    m = out.coarse.mask
    assert torch.isfinite(out.fine.mkpts0_f[m]).all()
    for bad, kernel in (
            (dataclasses.replace(cfg, coarse=dataclasses.replace(cfg.coarse, nhead=2)), "K5"),
            (dataclasses.replace(cfg, fine=dataclasses.replace(cfg.fine, d_model=128)), "K6"),
            (dataclasses.replace(cfg, fine=dataclasses.replace(
                cfg.fine, layer_names=("self", "cross", "self"))), "K6"),
            (dataclasses.replace(cfg, swin=dataclasses.replace(cfg.swin, num_heads=(8, 16, 32))),
             "K2")):
        with pytest.raises(NotImplementedError, match=kernel):
            FastMatcher(bad, device="cuda")


def test_training_at_head_dim_64_stops_at_k8(gen):
    """The training step at tpu_optimized_config() (every switch 'auto')
    no longer stops at K8's head-dim check: K8's backward takes head dim 64,
    and the training gates take that config's coarse (256, 64) and fine
    (64, 1) widths, so at 64x64, batch 1, a step launches K8 13 + 13 times,
    K9 and K10 once an encoder call, runs no eager coarse or fine layer, and
    its loss is finite."""
    import numpy as np

    from featurematching_tpu_torch.config import tpu_optimized_config
    from featurematching_tpu_torch.data.synthetic import synthetic_batch
    from featurematching_tpu_torch.ops.fine_stage import fine_train_supported
    from featurematching_tpu_torch.train.step import create_train_state, train_step

    cfg = tpu_optimized_config()
    c, f = cfg.model.coarse, cfg.model.fine
    assert ctt.coarse_train_supported(c.layer_names, c.d_model, c.nhead, 64)
    assert fine_train_supported(f.layer_names, f.d_model, f.nhead, f.window_size**2)
    state = create_train_state(cfg, device="cuda", seed=0)
    batch = synthetic_batch(np.random.default_rng(0), batch_size=1, image_size=(64, 64),
                            num_gt=cfg.model.match_coarse.max_gt_matches)
    batch = {k: torch.as_tensor(v, device="cuda") for k, v in batch.items()}
    eager = []
    for tf in (state.model.coarse_transformer, state.model.fine_transformer):
        for layer in tf.children():
            layer.register_forward_hook(lambda *_: eager.append(1))
    counted = (swin_block_train_fwd, swin_block_train_bwd, ctt.coarse_layer_backward,
               ftt.fine_layer_backward)
    before = [w.launches for w in counted]
    state, met = train_step(state, batch)
    torch.cuda.synchronize()
    made = [w.launches - b for w, b in zip(counted, before)]
    assert made == [13, 13, 12, 3] and not eager
    assert np.isfinite(float(met["loss"]))


def test_training_matcher_refuses_widths_its_kernels_lack(gen):
    """The training Matcher at tpu_optimized_config() with one width that
    the JAX gate takes and no training kernel does (coarse C 256 with 2
    heads of 128, fine C 64 with 2 heads of 32, Swin head dims 32): its
    construction on the card raises, naming the kernel, where the
    transformer would otherwise run eager layers."""
    import dataclasses

    from featurematching_tpu_torch.config import tpu_optimized_config
    from featurematching_tpu_torch.models.matcher import Matcher

    cfg = tpu_optimized_config().model
    for bad, kernel in (
            (dataclasses.replace(cfg, coarse=dataclasses.replace(cfg.coarse, nhead=2)), "K9"),
            (dataclasses.replace(cfg, fine=dataclasses.replace(cfg.fine, nhead=2)), "K10"),
            (dataclasses.replace(cfg, swin=dataclasses.replace(cfg.swin, num_heads=(2, 4, 8))),
             "K8")):
        with pytest.raises(NotImplementedError, match=kernel):
            Matcher(bad, device="cuda")


def test_evaluation_forward_at_head_dim_64_takes_k5_and_k6(gen):
    """The evaluation Matcher at tpu_optimized_config() (per-op Swin block):
    with no gradient to take, its coarse stack runs through K9's forward
    (K5's kernels, 12 calls for 8 layers) and its fine stack through K10's
    (K6's kernel, one launch a layer), with no eager coarse or fine layer.
    (In training K9's and K10's backwards take them too:
    test_training_at_head_dim_64_stops_at_k8.)"""
    import dataclasses

    from featurematching_tpu_torch.config import tpu_optimized_config
    from featurematching_tpu_torch.models.matcher import Matcher
    from featurematching_tpu_torch.ops.fine_stage import fine_layer_forward

    cfg = tpu_optimized_config().model
    cfg = dataclasses.replace(cfg, swin=dataclasses.replace(cfg.swin, fused_block="off"))
    model = Matcher(cfg, device="cuda", seed=0)
    eager = []
    for tf in (model.coarse_transformer, model.fine_transformer):
        for layer in tf.children():
            layer.register_forward_hook(lambda *_: eager.append(1))
    a = torch.rand(2, 64, 64, 3, generator=gen, device="cuda")
    before = (ctt.coarse_layer_forward.launches, fine_layer_forward.launches)
    with torch.no_grad():
        out = model(a, torch.roll(a, shifts=8, dims=2))
    torch.cuda.synchronize()
    after = (ctt.coarse_layer_forward.launches, fine_layer_forward.launches)
    assert tuple(x - y for x, y in zip(after, before)) == (12, 2) and not eager
    assert torch.isfinite(out.feat_c0.float()).all()
    assert torch.isfinite(out.fine.mkpts0_f[out.coarse.mask]).all()


def _chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_RB = PARAM_KEYS.index("rel_bias")
# faults injected into the kernels' outputs inside the training step: a share
# of every weight gradient lost (as a dropped block partial would lose it),
# the rel_bias gradient's heads in the wrong order, a share of df1 lost, and
# the last rows of df0 lost (a ragged row tile not written)
K8_FAULTS = {
    "k8_grads_5pc_short": lambda dx, gr: (dx, [g * 0.95 for g in gr]),
    "k8_rel_bias_heads_rolled": lambda dx, gr: (dx, [*gr[:_RB], gr[_RB].roll(1, 0), *gr[_RB + 1:]]),
}
K7_FAULTS = {
    "k7_df1_5pc_short": lambda d0, d1: (d0, d1 * 0.95),
    "k7_last_8_rows_lost": lambda d0, d1: (torch.cat([d0[:, :-8], 0 * d0[:, -8:]], 1), d1),
}
# K9: a share of the K | V weight gradient lost; dsrc's heads in the wrong order
K9_FAULTS = {
    "k9_dwkv_5pc_short": lambda dx, dsrc, wg: (dx, dsrc, (wg[0], wg[1] * 0.95, *wg[2:])),
    "k9_dsrc_heads_rolled": lambda dx, dsrc, wg: (
        dx, dsrc.unflatten(-1, (8, -1)).roll(1, -2).flatten(-2), wg),
}
# K10: the same two faults in the fine transformer's backward (a self call
# returns no dsrc: it is added into dx)
K10_FAULTS = {
    "k10_dwkv_5pc_short": K9_FAULTS["k9_dwkv_5pc_short"],
    "k10_dsrc_heads_rolled": lambda dx, dsrc, wg: (
        (dx, dsrc, wg) if dsrc is None else K9_FAULTS["k9_dsrc_heads_rolled"](dx, dsrc, wg)),
}


@pytest.mark.parametrize("fault", [None, *K8_FAULTS, *K9_FAULTS, *K10_FAULTS, *K7_FAULTS])
def test_training_agreement_sees_kernel_faults(gen, monkeypatch, fault):
    """chip_smoke.py's training semantic check: a sound step is within its
    LIMITS, and a step whose K8, K9, K10 or K7 output carries a fault is not. Prints
    the readings (run with -s) that PERF.md records beside the limits."""
    import featurematching_tpu_torch.ops.sparse_focal_loss as sfl
    import featurematching_tpu_torch.ops.swin_block_train as sbt

    cs = _chip_smoke()
    for mod, name, faults in ((sbt, "swin_block_train_bwd", K8_FAULTS),
                              (ctt, "coarse_layer_backward", K9_FAULTS),
                              (ftt, "fine_layer_backward", K10_FAULTS),
                              (sfl, "sparse_focal_backward", K7_FAULTS)):
        if fault in faults:
            kernel = getattr(mod, name)

            def faulty(*args, kernel=kernel, inject=faults[fault]):
                return inject(*kernel(*args))

            faulty.launches = 0  # the wrapper counts its launches on the name it is called by
            monkeypatch.setattr(mod, name, faulty)
    r = cs.training_agreement(*cs.semantic_setup())
    bad = cs.agreement_failures(r)
    keys = ("loss", "min_cos", "feat_sin", "feat_norm", "k8_sin", "k8_norm", "k9_sin", "k9_norm",
            "k10_sin", "k10_norm", "k7_sin", "k7_norm")
    print(f"\nfault {fault}: " + ", ".join(f"{k} {r[k]:.3e}" for k in keys)
          + f"; worst at {r['min_cos_at']} / {r['k8_sin_at']} / {r['k8_norm_at']} / "
          f"{r['k9_sin_at']} / {r['k9_norm_at']} / {r['k10_sin_at']} / {r['k10_norm_at']} / "
          f"{r['k7_sin_at']} / {r['k7_norm_at']}; "
          f"outside the limits: {bad}")
    assert (bad == []) if fault is None else bad


# K11 against its twin: chip_smoke.py's tolerance (K11_ATOL, K11_RTOL)
K11_TOL = (2e-2, 2**-7)


@pytest.mark.parametrize("d", [16, 32, 64])
@pytest.mark.parametrize("nwin,map_hw", [(13, None), (301, (16, 24)), (7, (8, 24))])
def test_window_attention_ragged_windows(gen, d, nwin, map_hw):
    """Window counts that are no multiple of the mask's period (nW = 6 and
    3) or of anything else, each head dim, 4 heads: window b takes mask[b % nW]."""
    from featurematching_tpu_torch.ops.window_attention import (
        window_attention,
        window_attention_reference,
    )

    h = 4
    C = h * d
    qkv = _rnd(gen, nwin, 64, 3 * C, dtype=torch.bfloat16)
    bias = _rnd(gen, h, 64, 64, scale=0.1)
    mask = (torch.as_tensor(_shift_attn_mask(*map_hw, 8, 4), device="cuda")
            if map_hw else None)
    before = window_attention.launches
    got = window_attention(qkv, bias, mask, h, d**-0.5)
    assert window_attention.launches == before + 1
    _assert_close(got, window_attention_reference(qkv, bias, mask, h, d**-0.5), *K11_TOL)


def _k11_mask(gen, nW):
    """An additive mask of nW windows: normal values, a third of the entries -100."""
    m = _rnd(gen, nW, 64, 64)
    return torch.where(torch.rand(nW, 64, 64, generator=gen, device="cuda") < 0.3, -100.0, m)


def _k11_case(gen, nwin, C, h, mask):
    """K11 on random q, k, v and bias against its twin; (out, the call's arguments)."""
    from featurematching_tpu_torch.ops.window_attention import (
        window_attention,
        window_attention_reference,
    )

    args = (_rnd(gen, nwin, 64, 3 * C, dtype=torch.bfloat16), _rnd(gen, h, 64, 64, scale=0.1),
            mask, h, (C // h) ** -0.5)
    got = window_attention(*args)
    _assert_close(got, window_attention_reference(*args), *K11_TOL)
    return got, args


@pytest.mark.parametrize("d,C", [(16, 64), (16, 256), (32, 128), (64, 64), (64, 256)])
@pytest.mark.parametrize("nwin", [1, 7, 133, 301])
@pytest.mark.parametrize("nW", [0, 3])
def test_window_attention_grid_edges(gen, d, C, nwin, nW):
    """The persistent grid's edges (ops/window_attention.plan): one window,
    fewer windows than SMs (runs of one window), and window counts that are
    no multiple of a run's length or of the mask's period nW = 3; 1 to 4 head
    groups, each head dim."""
    _k11_case(gen, nwin, C, C // d, _k11_mask(gen, nW) if nW else None)


@pytest.mark.parametrize("d,h", [(16, 3), (16, 5), (16, 7), (32, 3), (32, 5), (32, 7), (64, 3)])
@pytest.mark.parametrize("nW", [0, 3])
def test_window_attention_odd_heads(gen, d, h, nW):
    """Odd head counts: the last head group holds fewer heads than 64 / d,
    and its boxes reach into k's and v's columns or past the row's end."""
    _k11_case(gen, 133, h * d, h, _k11_mask(gen, nW) if nW else None)


@pytest.mark.parametrize("d", [16, 32, 64])
def test_window_attention_fully_masked_rows(gen, d):
    """A mask window whose second 16-row tile is -100 on every key, and one
    row of the first tile -100 on every key but one."""
    mask = _k11_mask(gen, 2)
    mask[1, 16:32] = -100.0
    mask[0, 5] = -100.0
    mask[0, 5, 17] = 0.0
    _k11_case(gen, 66, 4 * d if d < 64 else 128, 4 if d < 64 else 2, mask)


@pytest.mark.parametrize("nwin,C,map_hw", [(2400, 64, (120, 160)), (160, 256, (32, 40)),
                                           (640, 128, None)])
def test_window_attention_bit_identical(gen, nwin, C, map_hw):
    """Two calls at evaluation-step sites give the same bits."""
    from featurematching_tpu_torch.ops.window_attention import window_attention

    mask = (torch.as_tensor(_shift_attn_mask(*map_hw, 8, 4), device="cuda")
            if map_hw else None)
    got, args = _k11_case(gen, nwin, C, C // 16, mask)
    assert torch.equal(got, window_attention(*args))


@pytest.mark.parametrize("heads,masked", [(1, False), (1, True), (2, True)])
def test_window_attention_repeated_launches(gen, heads, masked):
    """300 launches at C = 64 and 2400 windows, head dims 64 and 32 (4 and 2
    windows in flight a block, so a window lane waits for a ring slot while
    another lane's copies into it may still be in flight): every launch ends
    and gives the first one's bits."""
    from featurematching_tpu_torch.ops.window_attention import window_attention

    mask = (torch.as_tensor(_shift_attn_mask(120, 160, 8, 4), device="cuda")
            if masked else None)
    ref, args = _k11_case(gen, 2400, 64, heads, mask)
    for _ in range(15):
        outs = [window_attention(*args) for _ in range(20)]
        assert all(torch.equal(o, ref) for o in outs)


@pytest.mark.parametrize("C,H,W,shift", [(64, 13, 21, 4), (64, 13, 21, 0), (128, 17, 9, 4),
                                         (128, 9, 16, 0), (256, 30, 40, 4), (256, 8, 8, 0)])
def test_swin_block_image_odd_maps(gen, C, H, W, shift):
    """Odd maps with and without the shift, 3 images: against the plain twin
    on the padded map (K2's tolerance) and against K2 through the roll path
    (chip_smoke.py's K12_K2_RTOL)."""
    from featurematching_tpu_torch.ops.swin_block_image import (
        pad_image,
        swin_block_fused_image,
        swin_block_image,
        swin_block_image_reference,
    )

    h = C // 16
    cs = _chip_smoke()
    p = _block_params(gen, C, h)
    x = _rnd(gen, 3, H * W, C, dtype=torch.bfloat16)
    before = swin_block_fused_image.launches
    got = swin_block_image(x, H, W, p, h, 8, shift)
    assert swin_block_fused_image.launches == before + 1
    xp, top = pad_image(x, H, W, 8, shift)
    ref = swin_block_image_reference(xp, p, h, 8, shift)[:, top:top + H, top:top + W]
    _assert_close(got, ref.reshape(3, H * W, C), 5e-2, 2e-2)
    k2 = cs.roll_path(x, H, W, shift, lambda xw, m: swin_block_fused(xw, m, p, h))
    _assert_close(got, k2, 0.0, cs.K12_K2_RTOL)


def test_window_attention_and_image_block_raise(gen):
    """Outside their limits the two wrappers raise on a CUDA tensor; no plain
    fallback runs and no launch is counted."""
    from featurematching_tpu_torch.ops.swin_block_image import (
        swin_block_fused_image,
        swin_block_image,
    )
    from featurematching_tpu_torch.ops.window_attention import window_attention

    before = window_attention.launches
    bias = _rnd(gen, 4, 64, 64)
    with pytest.raises(ValueError, match="bfloat16"):
        window_attention(_rnd(gen, 2, 64, 192), bias, None, 4, 0.25)
    with pytest.raises(ValueError, match="8x8 windows"):
        window_attention(_rnd(gen, 2, 16, 192, dtype=torch.bfloat16), bias[:, :16, :16], None, 4,
                         0.25)
    with pytest.raises(ValueError, match="head dim"):
        window_attention(_rnd(gen, 2, 64, 192, dtype=torch.bfloat16), _rnd(gen, 8, 64, 64),
                         None, 8, 0.25)  # head dim 8
    with pytest.raises(ValueError, match="C <= 256"):
        window_attention(_rnd(gen, 2, 64, 3 * 512, dtype=torch.bfloat16), _rnd(gen, 8, 64, 64),
                         None, 8, 0.125)
    with pytest.raises(ValueError, match="shape"):
        window_attention(_rnd(gen, 2, 64, 192, dtype=torch.bfloat16), bias[:2], None, 4, 0.25)
    assert window_attention.launches == before
    before = swin_block_fused_image.launches
    p64 = _block_params(gen, 64, 4)
    x = _rnd(gen, 1, 16 * 16, 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head dim"):
        swin_block_image(x, 16, 16, _block_params(gen, 64, 8), 8, 8, 4)  # head dim 8
    with pytest.raises(ValueError, match="window 8"):
        swin_block_image(x, 16, 16, p64, 4, 4, 2)
    with pytest.raises(ValueError, match="padded"):
        swin_block_fused_image(x.reshape(1, 16, 16, 64)[:, :12].contiguous(), p64, 4, 8, 0)
    with pytest.raises(ValueError, match="bfloat16"):
        swin_block_image(x.float(), 16, 16, p64, 4, 8, 0)
    assert swin_block_fused_image.launches == before


@pytest.mark.parametrize("heads", [(4, 8, 16), (1, 2, 4)])
def test_evaluation_forward_with_the_per_op_block(gen, heads):
    """swin.fused_block 'off': the evaluation forward runs every block's
    attention through K11 (head dim 16, and 64 as tpu_optimized_config()
    has it), no K8 and no K2; in training no K11."""
    import dataclasses

    from featurematching_tpu_torch.models.matcher import Matcher
    from featurematching_tpu_torch.ops.window_attention import window_attention

    cfg = ModelConfig()
    cfg = dataclasses.replace(cfg, swin=dataclasses.replace(cfg.swin, num_heads=heads,
                                                            fused_block="off"))
    model = Matcher(cfg, device="cuda", seed=0)
    a = torch.rand(2, 64, 64, 3, generator=gen, device="cuda")
    before = (window_attention.launches, swin_block_train_fwd.launches,
              swin_block_fused.launches)
    with torch.no_grad():
        out = model(a, torch.roll(a, shifts=8, dims=2))
    torch.cuda.synchronize()
    after = (window_attention.launches, swin_block_train_fwd.launches,
             swin_block_fused.launches)
    assert tuple(x - y for x, y in zip(after, before)) == (13, 0, 0)
    assert torch.isfinite(out.feat_c0.float()).all()
    with torch.no_grad():
        model(a, a, train=True)
    assert window_attention.launches == after[0]


@pytest.mark.parametrize("B, L, S, C", [
    (2, 200, 137, 256),  # the last row and column tiles partial
    (1, 129, 257, 256),  # one row past a 128-row tile, one column past two tiles
    (3, 4800, 4800, 256),  # the teacher's shapes (several splits)
    (1, 96, 80, 16),  # tiny_test_config()'s width
])
def test_dual_softmax_float32_ragged_with_ties(gen, B, L, S, C):
    """K1's float32 kernel against its plain twin at ragged L and S: the
    maxima within 1e-4 relative, each argmax a plain maximum within 1e-4.
    Planted exact ties: f1's column 3 repeated at S - 1 and at 130 (other
    column tiles, where they exist) and row 2 of f0 repeated at L - 1; row 2
    is made to prefer column 3, so its argmax, and the duplicate row's, must
    be the lower index, 3, and column 3's and its copies' must be row 2."""
    f1 = _rnd(gen, B, S, C)
    f0 = 0.3 * _rnd(gen, B, L, C)
    dup_cols = sorted({S - 1, min(130, S - 1)} - {3})
    f1[:, dup_cols] = f1[:, 3:4].clone()
    f0[:, 2] = 2.0 * f1[:, 3]
    f0[:, L - 1] = f0[:, 2]
    got = dual_softmax_match_stats(f0, f1, 0.1)
    ref = _stats_reference(f0, f1, 1.0 / (C * 0.1))
    _assert_close(got.row_max, ref.row_max, 0.0, 1e-4)
    _assert_close(got.col_max, ref.col_max, 0.0, 1e-4)
    conf = dual_softmax_confidence(f0, f1, 1.0 / (C * 0.1))
    row_pick = torch.gather(conf, 2, got.row_argmax.long()[..., None])[..., 0]
    col_pick = torch.gather(conf, 1, got.col_argmax.long()[:, None])[:, 0]
    assert (row_pick >= ref.row_max * (1 - 1e-4)).all()
    assert (col_pick >= ref.col_max * (1 - 1e-4)).all()
    assert got.row_argmax[:, [2, L - 1]].eq(3).all()
    assert got.col_argmax[:, [3, *dup_cols]].eq(2).all()
    again = dual_softmax_match_stats(f0, f1, 0.1)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_dual_softmax_refuses_what_it_does_not_take(gen):
    """The float32 kernel takes C a multiple of 16; half precision raises;
    nothing is converted."""
    f = _rnd(gen, 1, 64, 24)
    with pytest.raises(ValueError, match="multiple of 16"):
        dual_softmax_match_stats(f, f, 0.1)
    h = _rnd(gen, 1, 64, 64).half()
    with pytest.raises(ValueError):
        dual_softmax_match_stats(h, h, 0.1)


def _f32_layer(gen, C):
    from featurematching_tpu_torch.ops.coarse_transformer import layer_values as pack

    def w(i, o):
        return _rnd(gen, i, o, scale=i**-0.5).contiguous()

    def ln():
        return _rnd(gen, C, scale=0.1, shift=1.0), _rnd(gen, C, scale=0.1)

    return pack(w(C, C), w(C, 2 * C), w(C, C), *ln(), w(2 * C, 2 * C), w(2 * C, C), *ln())


@pytest.mark.parametrize("G, L, S", [(1, 1, 1), (2, 31, 33), (3, 100, 32), (8, 4800, 4800)])
def test_coarse_layer_float32_ragged(gen, G, L, S):
    """K5's float32 kernels (stats, merge, apply) at (256, 32) against the
    plain twin at token counts around their 32-token tiles, a self call
    (src = x) where L = S, and at the teacher's self call: out, kv (each
    head's K^T V row-major, the twin's unpacked) and ks within 2e-4 (+ 2e-4
    relative; f32 sums in another order), bit-identical twice; the launch
    counted once a call."""
    C, heads = 256, 8
    lv = _f32_layer(gen, C)
    x = _rnd(gen, G, L, C)
    src = x if L == S else _rnd(gen, G, S, C)
    before = ctt.coarse_layer_forward.launches
    got = ctt.coarse_layer_forward(x, src, lv, heads)
    assert ctt.coarse_layer_forward.launches == before + 1
    out, kv, ks = encoder_reference_with_stats(x, src, lv, heads)
    ref = out, unpack_heads(kv, heads).reshape(G, -1), ks
    for g_, r_ in zip(got, ref):
        assert g_.dtype == torch.float32 and g_.shape == r_.shape
        _assert_close(g_, r_, 2e-4, 2e-4)
    again = ctt.coarse_layer_forward(x, src, lv, heads)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_coarse_layer_float32_refuses_what_it_does_not_take(gen):
    """C = 128, head dims 16 and 64, and bf16 weights with float32
    activations raise, and so does K9's backward at float32."""
    lv128 = _f32_layer(gen, 128)
    x = _rnd(gen, 1, 64, 128)
    with pytest.raises(ValueError, match="head dim"):
        coarse_layer_with_stats(x, x, lv128, 4)
    lv = _f32_layer(gen, 256)
    x = _rnd(gen, 1, 64, 256)
    for heads in (16, 4):
        with pytest.raises(ValueError, match="head dim"):
            coarse_layer_with_stats(x, x, lv, heads)
    bf = lv._replace(wq=lv.wq.bfloat16())
    with pytest.raises(ValueError, match="wq"):
        coarse_layer_with_stats(x, x, bf, 8)
    out, kv, ks = coarse_layer_with_stats(x, x, lv, 8)
    with pytest.raises(ValueError):
        ctt.coarse_layer_backward(x, x, kv, ks, out, lv, ctt.train_values(lv), 8)


def test_float32_gates_refuse_at_construction(gen):
    """On the card a config whose selected kernels lack float32 raises
    NotImplementedError at construction, naming them: FastMatcher (K2, K3,
    K4, K6), a training Swin Matcher (K9's and K10's backwards, wgrad, K7),
    one that selects K8 or K11; the teacher's profile constructs (its K1 and
    K5 take float32)."""
    import dataclasses

    from featurematching_tpu_torch.config import loftr_tiny_config
    from featurematching_tpu_torch.models.matcher import Matcher

    f32 = dataclasses.replace(ModelConfig(), compute_dtype="float32")
    with pytest.raises(NotImplementedError, match="K2.*K6|K6.*K2"):
        FastMatcher(f32, device="cuda")
    off = dataclasses.replace(f32, swin=dataclasses.replace(
        f32.swin, fused_block="off", fused_attention="off"))
    for cfg, names in ((off, ("K9's backward", "K10", "wgrad", "K7")),
                       (dataclasses.replace(f32, swin=dataclasses.replace(
                           f32.swin, fused_attention="off")), ("K8",)),
                       (dataclasses.replace(f32, swin=dataclasses.replace(
                           f32.swin, fused_block="off")), ("K11",))):
        with pytest.raises(NotImplementedError) as info:
            Matcher(cfg, device="cuda")
        assert all(n in str(info.value) for n in names), str(info.value)
    model = Matcher(loftr_tiny_config().model, device="cuda")
    assert model.widths_lacking() == []

"""The least time an H100 could take for the work of each TPU kernel.

A kernel's bound is the larger of two times: the bytes its function must
move (each input read once, each output written once) over the card's memory
rate, and its matrix-product operations over the bf16 tensor-core peak.
Both rates are NVIDIA's published H100 SXM figures, which assume the card's
full 700 W power limit. The `*_work` functions count (bytes, operations) for
one call at given shapes; `chip_smoke.py` applies them to the inputs it runs,
and this module's command line applies them to every kernel of the JAX
package at `default_config()` and at `tpu_optimized_config()` (head dim 64
throughout), 640x480, batch 4:

    python -m featurematching_tpu_torch.utils.kernel_bounds

Training kernels are counted at the same shapes (the default training batch
is also 4 pairs at 640x480, with `max_gt_matches` = 1024 fine windows a
pair). A forward and its backward count together: the backward does twice
the forward's products, reads the forward's inputs and the output gradient,
writes the input gradient and f32 weight gradients, and what the forward
saves for it is written once and read once. K8, K7 and K9, which the port
has, are counted per launch as their kernels run: K8's forward (K2's work
plus the probabilities and the residual stream it keeps) and backward
apart, K7 as the backward's softmax terms plus the pass-1 log-sum-exps of
its forward, K9 per encoder call, its forward (K5's stats and apply work)
and backward apart, and K10 per encoder call likewise (its forward a share
of K6's one-layer launch); the command line prints the forward and backward
of K9 and K10 on rows of their own. The weight-gradient products those
backwards share (`wgrad`, 142 a step in 28 launches, one a backward call)
are counted apart, on rows of their own, by `wgrad_work` for a product
alone and by `wgrad_group_work` for a backward's launch, where an operand
two products read (K9's and K10's x and dy1) is read once; they are part
of the K8, K9 and K10 backward rows, not added to them.
"""

from __future__ import annotations

import math
from typing import Dict, List, NamedTuple, Tuple

HBM_BYTES_PER_S = 3.35e12
BF16_TENSOR_FLOPS = 989e12
WINDOW = 64  # tokens of an 8x8 Swin window
SMS = 132  # streaming multiprocessors of the H100 SXM
BF16, F32 = 2, 4

Work = Tuple[float, float]  # (bytes, operations)


def bound_ms(nbytes: float, flops: float) -> Tuple[float, str]:
    """(least time in ms, "bytes" or "operations", whichever bounds it)."""
    tb, to = nbytes / HBM_BYTES_PER_S * 1e3, flops / BF16_TENSOR_FLOPS * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def total(works) -> Work:
    works = list(works)
    return sum(w[0] for w in works), sum(w[1] for w in works)


def swin_block_work(windows: int, C: int, heads: int, mask_windows: int,
                    tokens: int = 0) -> Work:
    """K2 `swin_block_fused` on [windows, 64, C], mask [mask_windows, 64, 64]
    (0: none). `tokens`: activation tokens read and written, when they are
    fewer than the windows hold (K12 reads the unpadded image)."""
    tokens = tokens or windows * WINDOW
    weights = 12 * C * C * BF16 + 13 * C * F32 + heads * WINDOW * WINDOW * F32
    nbytes = 2 * tokens * C * BF16 + weights + mask_windows * WINDOW * WINDOW * F32
    return nbytes, windows * WINDOW * (24 * C * C + 4 * WINDOW * C)


def window_attention_work(windows: int, C: int, heads: int, mask_windows: int) -> Work:
    """K11: q, k, v in and the heads' output out (bf16); rel bias and mask (f32)."""
    nbytes = (4 * windows * WINDOW * C * BF16 + heads * WINDOW * WINDOW * F32
              + mask_windows * WINDOW * WINDOW * F32)
    return nbytes, windows * 4 * WINDOW * WINDOW * C


def layer_norm_work(rows: int, C: int, n_ln: int = 1) -> Work:
    """K3 `layer_norm_chain`: bf16 [rows, C] in and out, f32 scales/biases."""
    return 2 * rows * C * BF16 + n_ln * 2 * C * F32, 0.0


def patch_expand_work(batch: int, H: int, W: int, C4: int, head: int, emit_ln: bool) -> Work:
    """K4 `patch_expand_ln` on the expand output [batch, H*W, 4*C4]; `head`
    is the head's width (0: none)."""
    tokens = batch * 4 * H * W
    nbytes = (tokens * C4 * BF16 * (2 if emit_ln else 1) + 4 * C4 * F32
              + head * (tokens * BF16 + C4 * BF16 + F32))
    return nbytes, 2 * tokens * C4 * head


def dual_softmax_work(B: int, L: int, S: int, C: int) -> Work:
    """K1 `dual_softmax_match_stats`: bf16 features in, an f32 max and an
    int32 argmax per row and per column out. Two passes over the L x S
    products: the [L, S] matrix is never stored, so the second recomputes it."""
    return B * (L + S) * C * BF16 + B * (L + S) * 2 * F32, 2 * 2 * B * L * S * C


def encoder_work(tokens: int, C: int, heads: int, layers: int) -> Work:
    """LoFTR encoder layers (q, k, v, merge, 2C->2C and 2C->C products, linear
    attention) over `tokens` tokens in all; bf16 activations in and out."""
    flops = layers * tokens * (20 * C * C + 4 * C * (C // heads))
    return 2 * tokens * C * BF16 + layers * (10 * C * C * BF16 + 4 * C * F32), flops


def coarse_stats_work(G: int, N: int, C: int, heads: int) -> Work:
    """K5's stats launch over G images of N source tokens: bf16 tokens and
    [wk | wv] in, each head's f32 KᵀV [D, D] and K_sum out; the K, V
    projection and the heads' diagonal KᵀV blocks (C D multiply-adds a
    token: four times head dim 16's at head dim 64)."""
    D = C // heads
    nbytes = G * N * C * BF16 + 2 * C * C * BF16 + G * (C * D + C) * F32
    return nbytes, G * N * (2 * 2 * C * C + 2 * C * D)


def coarse_apply_work(G: int, N: int, C: int, heads: int) -> Work:
    """K5's apply launch over G images of N query tokens: bf16 tokens and
    the stats in, bf16 tokens out; the q, merge, 2C->2C and 2C->C products
    and Q.KV."""
    D = C // heads
    nbytes = (2 * G * N * C * BF16 + G * (C * D + C) * BF16 + 8 * C * C * BF16
              + 4 * C * F32)
    return nbytes, G * N * (2 * 8 * C * C + 2 * C * D)


def fine_stage_work(windows: int, taps: int, C: int, heads: int, layers: int) -> Work:
    """K6 `fine_stage_fused` in fold mode on `windows` pairs of [taps, C]
    windows: both windows, the layers' weights and the two mixes in, f32
    heatmaps out. Operations: every layer on both windows, the two mixes and
    the two centre-window correlations."""
    enc_bytes, enc_flops = encoder_work(2 * windows * taps, C, heads, layers)
    nbytes = enc_bytes - 2 * windows * taps * C * BF16 + 2 * (taps + 1) * F32 \
        + 2 * windows * taps * F32
    return nbytes, enc_flops + 2 * 2 * windows * taps * C * 2


def sparse_focal_backward_work(B: int, L: int, S: int, C: int) -> Work:
    """K7's backward kernel: bf16 f0s and f1, f32 a_r, lse_r, a_c, lse_c in;
    f32 df0 and df1 out; the products sim, dsim f1 and dsimᵀ f0s."""
    nbytes = B * (L + S) * C * (BF16 + F32) + 2 * B * (L + S) * F32
    return nbytes, 3 * 2 * B * L * S * C


def dual_softmax_lse_work(B: int, L: int, S: int, C: int) -> Work:
    """K1's pass 1 alone (K7's forward): bf16 features in, f32 row and
    column log-sum-exps out; one pass of the L x S products."""
    return B * (L + S) * C * BF16 + B * (L + S) * F32, 2 * B * L * S * C


def swin_block_train_fwd_work(windows: int, C: int, heads: int, mask_windows: int) -> Work:
    """K8's forward: K2's work, the two drop-path scales read, and the
    probabilities [windows, heads, 64, 64] and x1 [windows, 64, C] (bf16)
    written for the backward."""
    nbytes, flops = swin_block_work(windows, C, heads, mask_windows)
    return (nbytes + 2 * windows * F32 + windows * heads * WINDOW * WINDOW * BF16
            + windows * WINDOW * C * BF16), flops


def swin_block_train_bwd_work(windows: int, C: int, heads: int, mask_windows: int) -> Work:
    """K8's backward: x, x1, the output gradient and the probabilities (bf16),
    the scales and the weights in; dx (bf16) and the 13 parameter gradients
    (f32) out; twice the forward's products (the gradients with respect to
    the activations and to the weights)."""
    weights = 12 * C * C * BF16 + 13 * C * F32 + heads * WINDOW * WINDOW * F32
    grads = 12 * C * C * F32 + 13 * C * F32 + heads * WINDOW * WINDOW * F32
    tokens = windows * WINDOW
    nbytes = (4 * tokens * C * BF16 + windows * heads * WINDOW * WINDOW * BF16
              + 2 * windows * F32 + weights + grads)
    return nbytes, 2 * swin_block_work(windows, C, heads, mask_windows)[1]


def swin_block_train_attn_bwd_work(windows: int, C: int, heads: int,
                                   mask_windows: int) -> Work:
    """`attn_bwd`, the attention branch of K8's backward, alone. The backward
    is split where the residual stream's gradient crosses between the two
    branches (`csrc/swin_block_train.cu`): `mlp_bwd` writes dx1 in f32, and
    the weight gradients are products over all tokens in `wgrad`, which reads
    the bf16 operands attn_bwd stashes for it. Under that split attn_bwd must
    read x (bf16), dx1 (f32), the saved probabilities (bf16), the drop-path
    scale and its weights, and write dx and the stash's h1, dqkv, o and do
    (bf16). Its products are the activation gradients da = do Wprojᵀ,
    dh1 = dqkv Wqkvᵀ (4 C² multiply-adds a token) and the attention's dP,
    dq, dk and dv (4 x 64 C); the recomputed qkv and o are the kernel's
    choice, not counted. `mask_windows` is taken for the sites' signature:
    the backward reads the saved probabilities, not the mask."""
    del mask_windows
    tokens = windows * WINDOW
    weights = 4 * C * C * BF16 + (3 * C + 2 * C) * F32
    nbytes = (tokens * C * (BF16 + F32 + BF16) + tokens * 6 * C * BF16
              + windows * heads * WINDOW * WINDOW * BF16 + windows * F32 + weights)
    return nbytes, 2 * tokens * (4 * C * C + 4 * WINDOW * C)


def swin_block_train_mlp_bwd_work(windows: int, C: int, heads: int,
                                  mask_windows: int) -> Work:
    """`mlp_bwd`, the MLP branch of K8's backward, alone, under the same split
    as `swin_block_train_attn_bwd_work`: it must read x1 and the output
    gradient g (bf16), the drop-path scale and its weights W1 and W2 (bf16)
    with b1 and LN2's scale and bias (f32), and write dx1 (f32) and the
    stash's h2, dm (C each), dy1 and gelu(y1) (4 C each, bf16). Its products
    are the activation gradients dge = dm W2ᵀ and dh2 = dy1 W1ᵀ (8 C²
    multiply-adds a token); the recomputed y1 = h2 W1 is the kernel's
    choice, not counted. `heads` and `mask_windows` are taken for the
    sites' signature: the MLP branch has neither."""
    del heads, mask_windows
    tokens = windows * WINDOW
    weights = 8 * C * C * BF16 + (4 * C + 2 * C) * F32
    nbytes = (tokens * C * (BF16 + BF16 + F32) + tokens * 10 * C * BF16 + windows * F32
              + weights)
    return nbytes, 2 * tokens * 8 * C * C


def coarse_train_fwd_work(G: int, L: int, S: int, C: int, heads: int) -> Work:
    """K9's forward for one encoder call (L query tokens of G images over S
    source tokens): K5's stats and apply launches."""
    return total([coarse_stats_work(G, S, C, heads), coarse_apply_work(G, L, C, heads)])


def coarse_train_bwd_work(G: int, L: int, S: int, C: int, heads: int, self_call: bool) -> Work:
    """K9's backward for one encoder call: x and src (one tensor for a self
    call), the output gradient, the merged stats (bf16) and the weights in;
    dx and dsrc (bf16) and the layer's gradients (f32) out; twice the
    forward's products."""
    D = C // heads
    tokens = G * L + (0 if self_call else G * S)
    nbytes = ((tokens + G * L) * C * BF16 + G * (C * D + C) * BF16
              + 10 * C * C * BF16 + 4 * C * F32
              + (G * L + G * S) * C * BF16 + 10 * C * C * F32 + 4 * C * F32)
    return nbytes, 2 * coarse_train_fwd_work(G, L, S, C, heads)[1]


def coarse_train_apply_bwd_work(G: int, L: int, S: int, C: int, heads: int) -> Work:
    """`apply_bwd`, the query side of K9's backward for one encoder call,
    alone. The backward is split where the source side begins
    (`csrc/coarse_transformer_train.cu`): the weight gradients are products
    over all tokens in `wgrad`, which reads the bf16 operands apply_bwd
    stashes for it, and the source side reads only the merged dKᵀV and dK_sum
    of apply_bwd's per-tile partials. Under that split apply_bwd must read x
    and g, the merged stats kv and ks (bf16), the weights wq, wmerge, w1, w2
    (bf16, once: the transposed copies are the kernel's packing of the same
    values) and LN1's scale and bias and LN2's scale (f32); and write dx and
    the stash's o, msg, h (2C), dy2, dy1 (2C), dm1 and dqf (9C bf16 a token),
    and the f32 partials of each 64-token tile: the LN gradients (4C), each
    head's dKᵀV (C D) and dK_sum (C). Its products are the activation
    gradients dy1 = dy2 w2ᵀ, dmsg = dy1 w1[C:]ᵀ, do = dm1 wmergeᵀ and dx =
    [dy1 | dqf] [w1[:C]ᵀ ; wqᵀ] (8 C² multiply-adds a token), the dQ =
    dopre KVᵀ and dKᵀV = Qᵀ dopre of each head (2 C D); the recomputed
    forward tile (Q, o, m1, h, y2, and x wq again for the feature map's
    derivative) is the kernel's choice, not counted. S enters only as the
    scale S / (Z + eps)."""
    del S
    D = C // heads
    tiles = G * -(-L // 64)
    nbytes = (G * L * C * BF16 * 2 + G * (C * D + C) * BF16 + 8 * C * C * BF16 + 3 * C * F32
              + G * L * C * BF16 + G * L * 9 * C * BF16 + tiles * (4 * C + C * D + C) * F32)
    return nbytes, 2 * G * L * (8 * C * C + 2 * C * D)


def coarse_train_stats_bwd_work(G: int, S: int, C: int, heads: int) -> Work:
    """`stats_bwd`, the source side of K9's backward for one encoder call
    over G images of S source tokens, alone. The backward is split where the
    source side begins (`csrc/coarse_transformer_train.cu`): it reads only
    the merged dKᵀV and dK_sum of apply_bwd's partials, and the weight
    gradient dwkv is a product over the tokens in `wgrad`, which reads the
    [dkf | dv] stashed for it. Under that split stats_bwd must read src (C
    bf16 a token), the merged dKᵀV ([H, D, D] an image) and dK_sum ([C] an
    image; bf16) and wkv once (2 C² bf16: the image the kernel reads is its
    packing of the same values); and write dsrc (C bf16 a token) and the
    stash's [dkf | dv] (2 C bf16 a token). Its products are dsrc = [dkf |
    dv] wkvᵀ (2 C² multiply-adds a token) and each head's dV = K_h dKV_h
    and dK = V_h dKV_hᵀ (2 C D); K and V recomputed from src (src wkv) are
    the kernel's choice, not counted."""
    D = C // heads
    T = G * S
    nbytes = T * 4 * C * BF16 + G * (C * D + C) * BF16 + 2 * C * C * BF16
    return nbytes, 2 * T * (2 * C * C + 2 * C * D)


def train_calls(layer_names, items: int) -> List[Tuple[int, bool]]:
    """(batch G, self call) of each encoder call of a differentiable stack
    over `items` images or windows in all (both sides): a self layer is one
    call on all of them, a cross layer two calls on half of them each."""
    calls = []
    for name in layer_names:
        calls += [(items, True)] if name == "self" else [(items // 2, False)] * 2
    return calls


def fine_train_fwd_work(G: int, N: int, C: int, heads: int) -> Work:
    """K10's forward for one encoder call over G windows of N taps (a share
    of K6's one-layer launch, which holds a window pair on chip): the layer's
    weights and a window in, a window out (bf16; a cross layer's two calls
    read both windows and write both); the layer's products."""
    tokens = 2 * G * N
    return (tokens * C * BF16 + 10 * C * C * BF16 + 4 * C * F32,
            G * N * (20 * C * C + 4 * C * (C // heads)))


def fine_train_bwd_work(G: int, N: int, C: int, heads: int, self_call: bool) -> Work:
    """K10's backward for one encoder call, at the TPU function's own dtypes:
    x, src and the output gradient (bf16; src is x in a self call) and the
    weights in; dx and, where it is an output of its own (a cross call),
    dsrc (bf16) and the layer's gradients (f32) out; twice the forward's
    products. The port's kernel moves more (an f32 output gradient, f32 dx
    and dsrc); what it moves beyond this is its own cost."""
    acts = 3 if self_call else 5
    nbytes = (acts * G * N * C * BF16 + 10 * C * C * BF16 + 4 * C * F32
              + 10 * C * C * F32 + 4 * C * F32)
    return nbytes, 2 * fine_train_fwd_work(G, N, C, heads)[1]


def fine_train_window_bwd_work(G: int, N: int, C: int, heads: int, self_call: bool) -> Work:
    """`window_bwd`, the window stage of K10's backward for one encoder call
    over G windows of N taps, alone. The backward is split where the
    weight gradients begin (`csrc/fine_transformer_train.cu`): they are
    products over all tokens in `wgrad`, which reads the bf16 operands
    window_bwd stashes for it, and the LN gradients are its per-block
    partials added by one `sum_parts`. Under that split window_bwd must read
    x (and src in a cross call; bf16), the output gradient g (f32), the
    weights wq, wkv, wmerge, w1 and w2 once (bf16: the transposed products
    read the kernel's packing of the same values) and LN1's scale and bias
    and LN2's scale (f32); and write dx (and dsrc in a cross call; f32), the
    stash's o, msg, dm1, dqf, dy2 (C each), h, dy1 and [dkf | dv] (2 C each),
    11 C bf16 a token, and the f32 partial row of the LN gradients (4 C) of
    each of its blocks, one an SM at most. Its products are the activation
    gradients dy1 = dy2 w2ᵀ, dmsg = dy1 w1[C:]ᵀ, do = dm1 wmergeᵀ, dx =
    [dy1 | dqf] [w1[:C]ᵀ ; wqᵀ] and dsrc = [dkf | dv] wkvᵀ (10 C² multiply-
    adds a token) and each head's attention gradients dQ = dA KVᵀ, dKV = Qᵀ
    dA, dV = K dKV and dK = V dKVᵀ (4 C D); the recomputed forward is the
    kernel's choice, not counted."""
    D = C // heads
    tokens = G * N
    acts = 1 if self_call else 2
    nbytes = (tokens * (acts * C * BF16 + C * F32 + acts * C * F32 + 11 * C * BF16)
              + 10 * C * C * BF16 + 3 * C * F32 + min(G, SMS) * 4 * C * F32)
    return nbytes, 2 * tokens * (10 * C * C + 4 * C * D)


def wgrad_work(T: int, M: int, N: int) -> Work:
    """One weight-gradient product dW = Aᵀ B (`csrc/wgrad.cuh`, inside K8's,
    K9's and K10's backwards): A [T, M] and B [T, N] read once (bf16), dW
    [M, N] written once (f32); 2 T M N operations."""
    return T * (M + N) * BF16 + M * N * F32, 2 * T * M * N


# a weight-gradient product with the names of its two operands: (T, M, N, A, B)
WgradProduct = Tuple[int, int, int, str, str]


def wgrad_group_work(group: List[WgradProduct]) -> Work:
    """One launch of weight-gradient products (a backward's group): each
    operand the group reads (by name) read once, each dW written once (f32);
    the products' operations."""
    reads = {}
    for T, M, N, a, b in group:
        reads[a], reads[b] = T * M * BF16, T * N * BF16
    return (sum(reads.values()) + sum(M * N * F32 for _, M, N, _, _ in group),
            sum(2 * T * M * N for T, M, N, _, _ in group))


def wgrad_groups(cfg, batch: int = 4, H: int = 480, W: int = 640) -> List[List[WgradProduct]]:
    """The weight-gradient products of one training step, a group a backward
    call, in the backwards' order: K8's four a Swin block (h1ᵀ dqkv, oᵀ dout,
    h2ᵀ dy1, gelu(y1)ᵀ dm over the block's windows' tokens), K9's six an
    encoder call (xᵀ dqf, oᵀ dm1, xᵀ dy1, msgᵀ dy1, hᵀ dy2 over the query
    tokens, srcᵀ [dkf | dv] over the source tokens; src is x in a self call)
    and K10's six an encoder call over its windows' taps (xᵀ dqf, srcᵀ [dkf |
    dv], oᵀ dm1, xᵀ dy1, msgᵀ dy1, hᵀ dy2)."""
    co, fi = cfg.coarse, cfg.fine
    L = (H // cfg.resolution[0]) * (W // cfg.resolution[0])
    taps = fi.window_size**2
    groups = []
    for st in swin_sites(cfg, 2 * batch, H, W):
        T, C = st.windows * WINDOW, st.C
        groups.append([(T, C, 3 * C, "h1", "dqkv"), (T, C, C, "o", "dout"),
                       (T, C, 4 * C, "h2", "dy1"), (T, 4 * C, C, "gelu(y1)", "dm")])
    C = co.d_model
    for G, self_call in train_calls(co.layer_names, 2 * batch):
        T, src = G * L, "x" if self_call else "src"
        groups.append([(T, C, C, "x", "dqf"), (T, C, C, "o", "dm1"), (T, C, 2 * C, "x", "dy1"),
                       (T, C, 2 * C, "msg", "dy1"), (T, 2 * C, C, "h", "dy2"),
                       (T, C, 2 * C, src, "dkv")])
    C = fi.d_model
    for G, self_call in train_calls(fi.layer_names, 2 * batch * cfg.match_coarse.max_gt_matches):
        T, src = G * taps, "x" if self_call else "src"
        groups.append([(T, C, C, "x", "dqf"), (T, C, 2 * C, src, "dkv"), (T, C, C, "o", "dm1"),
                       (T, C, 2 * C, "x", "dy1"), (T, C, 2 * C, "msg", "dy1"),
                       (T, 2 * C, C, "h", "dy2")])
    return groups


def wgrad_calls(cfg, batch: int = 4, H: int = 480, W: int = 640) -> List[Tuple[int, int, int]]:
    """(T, M, N) of every weight-gradient product of one training step
    (`wgrad_groups`, flat)."""
    return [pr[:3] for grp in wgrad_groups(cfg, batch, H, W) for pr in grp]


def train_stack_work(cfg, batch: int = 4, H: int = 480,
                     W: int = 640) -> Dict[str, Tuple[Work, Work]]:
    """The forward and backward Work of K9 and K10 in one training step
    (batch pairs of H x W), each summed over its encoder calls: K9 over the
    2 batch images' coarse tokens, K10 over the GT ids' fine windows of
    both sides."""
    co, fi = cfg.coarse, cfg.fine
    L = (H // cfg.resolution[0]) * (W // cfg.resolution[0])
    taps = fi.window_size**2
    k9 = train_calls(co.layer_names, 2 * batch)
    k10 = train_calls(fi.layer_names, 2 * batch * cfg.match_coarse.max_gt_matches)
    return {
        "K9": (total(coarse_train_fwd_work(G, L, L, co.d_model, co.nhead) for G, _ in k9),
               total(coarse_train_bwd_work(G, L, L, co.d_model, co.nhead, s) for G, s in k9)),
        "K10": (total(fine_train_fwd_work(G, taps, fi.d_model, fi.nhead) for G, _ in k10),
                total(fine_train_bwd_work(G, taps, fi.d_model, fi.nhead, s) for G, s in k10)),
    }


class Site(NamedTuple):
    windows: int
    C: int
    heads: int
    mask_windows: int  # 0 without the shift mask
    tokens: int  # unpadded tokens of the map
    map_hw: Tuple[int, int]  # the unpadded map


def swin_sites(cfg, images: int, H: int, W: int) -> List[Site]:
    """Every Swin block of the serving backbone, in order, as K2 sees it."""
    s = cfg.swin
    w = s.window_size
    maps = [(H // s.patch_size, W // s.patch_size)]
    for _ in range(len(s.depths) - 1):
        maps.append(((maps[-1][0] + 1) // 2, (maps[-1][1] + 1) // 2))
    n = len(s.depths)
    stages = [(i, s.depths[i]) for i in range(n)]
    stages += [(n - 1 - j, s.depths_up[n - 1 - j]) for j in range(len(s.depths_up))]
    sites = []
    for level, depth in stages:
        h, wd = maps[level]
        nw = math.ceil(h / w) * math.ceil(wd / w)
        for b in range(depth):
            sites.append(Site(images * nw, s.embed_dim * 2**level, s.num_heads[level],
                              nw if b % 2 else 0, images * h * wd, (h, wd)))
    return sites


def all_kernels(cfg, batch: int = 4, H: int = 480, W: int = 640) -> List[Tuple[str, str, Work]]:
    """(id, entry point, Work) of the twelve kernels at the given serving
    shapes; each Work sums every call of one forward (or training step)."""
    s, co, fi = cfg.swin, cfg.coarse, cfg.fine
    images, sc, E = 2 * batch, cfg.resolution[0], s.embed_dim
    L = (H // sc) * (W // sc)
    hp, wp = H // s.patch_size, W // s.patch_size
    sites = swin_sites(cfg, images, H, W)
    nwin = batch * cfg.match_coarse.max_matches  # fine windows
    taps = fi.window_size**2
    fine_enc = encoder_work(2 * nwin * taps, fi.d_model, fi.nhead, len(fi.layer_names))
    coarse = encoder_work(images * L, co.d_model, co.nhead, len(co.layer_names))
    train = train_stack_work(cfg, batch, H, W)
    return [
        ("K1", "pallas_dual_softmax.dual_softmax_match_stats", dual_softmax_work(
            batch, L, L, co.d_model)),
        ("K2", "pallas_swin_block.swin_block_fused",
         total(swin_block_work(*st[:4]) for st in sites)),
        ("K3", "pallas_ln.layer_norm_chain", total([
            layer_norm_work(images * hp * wp, E),
            layer_norm_work(images * hp * wp // 4, 2 * E),
            layer_norm_work(images * hp * wp // 16, 4 * E),
            layer_norm_work(images * hp * wp // 16, 4 * E)])),
        ("K4", "pallas_patch_expand.patch_expand_ln", total([
            patch_expand_work(images, hp // 4, wp // 4, 2 * E, 256, True),
            patch_expand_work(images, hp // 2, wp // 2, E, 0, True),
            patch_expand_work(images, hp, wp, E, 64, False)])),
        ("K5", "pallas_coarse_transformer.coarse_transformer_fused", coarse),
        # + the 49->1 mix and both heatmaps (centre . window), f32 heatmaps out
        ("K6", "pallas_fine_stage.fine_stage_fused", total([
            fine_enc, (2 * nwin * taps * F32, 2 * 2 * nwin * taps * fi.d_model * 2)])),
        ("K7", "sparse_focal_loss._sfl_bwd_pallas", total([
            dual_softmax_lse_work(batch, L, L, co.d_model),
            sparse_focal_backward_work(batch, L, L, co.d_model)])),
        ("K8", "pallas_swin_block_grad.swin_block_train", total(
            w for st in sites for w in (swin_block_train_fwd_work(*st[:4]),
                                        swin_block_train_bwd_work(*st[:4])))),
        ("K9", "pallas_coarse_grad.coarse_transformer_train", total(train["K9"])),
        ("K10", "pallas_fine_grad.fine_transformer_train", total(train["K10"])),
        ("K11", "pallas_window_attention.window_attention_pallas",
         total(window_attention_sites(cfg, images, H, W))),
        ("K12", "pallas_swin_block.swin_block_fused_image",
         total(swin_block_work(*st[:5]) for st in sites)),
    ]


def window_attention_sites(cfg, images: int = 8, H: int = 480, W: int = 640) -> List[Work]:
    """K11's work at every Swin block of the backbone (one launch a block in
    the per-op block's evaluation forward)."""
    return [window_attention_work(*st[:4]) for st in swin_sites(cfg, images, H, W)]


def main() -> None:
    from featurematching_tpu_torch.config import default_config, tpu_optimized_config

    print(f"H100 SXM peaks: {HBM_BYTES_PER_S / 1e12} TB/s, {BF16_TENSOR_FLOPS / 1e12} "
          "TFLOP/s bf16 (700 W); default_config(), 640x480, batch 4")
    print("| Id | Kernel | MB moved | GFLOP | bound ms | bound by |")
    print("|---|---|---|---|---|---|")
    cfg = default_config().model
    split = train_stack_work(cfg)
    for kid, name, work in all_kernels(cfg):
        rows = (zip((f"{kid} fwd", f"{kid} bwd"), split[kid]) if kid in split
                else [(kid, work)])
        for rid, (nbytes, flops) in rows:
            b, by = bound_ms(nbytes, flops)
            print(f"| {rid} | {name} | {nbytes / 1e6:.1f} | {flops / 1e9:.1f} | {b:.4f} | {by} |")
    for kid, name, (nbytes, flops) in all_kernels(tpu_optimized_config().model):
        b, by = bound_ms(nbytes, flops)
        print(f"| {kid} (tpu_optimized_config, head dim 64) | {name} | {nbytes / 1e6:.1f} | "
              f"{flops / 1e9:.1f} | {b:.4f} | {by} |")
    sites = swin_sites(cfg, 8, 480, 640)  # the step's 13 blocks over both images of 4 pairs
    for name, fn in (("attn_bwd", swin_block_train_attn_bwd_work),
                     ("mlp_bwd", swin_block_train_mlp_bwd_work)):
        works = [fn(*st[:4]) for st in sites]
        nbytes, flops = total(works)
        b, by = bound_ms(nbytes, flops)
        print(f"| K8 bwd's {name} alone (13 launches a step) | csrc/swin_block_train.cu "
              f"{name}_kernel | {nbytes / 1e6:.1f} | {flops / 1e9:.1f} | {b:.4f} | {by} |")
    co = cfg.coarse
    L = (480 // cfg.resolution[0]) * (640 // cfg.resolution[0])  # coarse tokens an image
    works = [coarse_train_stats_bwd_work(G, L, co.d_model, co.nhead)
             for G, _ in train_calls(co.layer_names, 8)]
    nbytes, flops = total(works)
    b, by = bound_ms(nbytes, flops)
    print(f"| K9 bwd's stats_bwd alone ({len(works)} launches a step) | "
          f"csrc/coarse_transformer_train.cu stats_bwd_kernel | {nbytes / 1e6:.1f} | "
          f"{flops / 1e9:.1f} | {b:.4f} | {by} |")
    fi = cfg.fine
    works = [fine_train_window_bwd_work(G, fi.window_size**2, fi.d_model, fi.nhead, s)
             for G, s in train_calls(fi.layer_names, 8 * cfg.match_coarse.max_gt_matches)]
    nbytes, flops = total(works)
    b, by = bound_ms(nbytes, flops)
    print(f"| K10 bwd's window_bwd alone ({len(works)} launches a step) | "
          f"csrc/fine_transformer_train.cu window_bwd_kernel | {nbytes / 1e6:.1f} | "
          f"{flops / 1e9:.1f} | {b:.4f} | {by} |")
    groups = wgrad_groups(cfg)
    for label, works in (
            ("each product alone", [wgrad_work(*c) for c in wgrad_calls(cfg)]),
            (f"{len(groups)} launches of a backward's products", [wgrad_group_work(grp)
                                                                   for grp in groups])):
        nbytes, flops = total(works)
        bounds = [bound_ms(*w) for w in works]
        by = sum(1 for _, x in bounds if x == "bytes")
        print(f"| wgrad (142 products a step in K8, K9 and K10 bwd; {label}) | "
              f"csrc/wgrad.cuh fm::wgrad_group | {nbytes / 1e6:.1f} | {flops / 1e9:.1f} | "
              f"{sum(b for b, _ in bounds):.4f} (summed) | bytes for {by}, operations for "
              f"{len(works) - by} |")


if __name__ == "__main__":
    main()

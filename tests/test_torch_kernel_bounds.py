"""The work counts behind the kernels' bounds in chip_smoke.py and PERF.md."""

import pytest

from featurematching_tpu_torch.config import ModelConfig
from featurematching_tpu_torch.utils.kernel_bounds import (
    all_kernels,
    coarse_train_apply_bwd_work,
    bound_ms,
    coarse_apply_work,
    coarse_stats_work,
    coarse_train_bwd_work,
    coarse_train_fwd_work,
    coarse_train_stats_bwd_work,
    dual_softmax_lse_work,
    fine_stage_work,
    fine_train_bwd_work,
    fine_train_fwd_work,
    fine_train_window_bwd_work,
    main,
    sparse_focal_backward_work,
    swin_block_train_attn_bwd_work,
    swin_block_train_bwd_work,
    swin_block_train_fwd_work,
    swin_block_train_mlp_bwd_work,
    swin_block_work,
    swin_sites,
    total,
    train_calls,
    window_attention_sites,
    window_attention_work,
)


def test_swin_sites_are_the_backbones_blocks():
    """640x480, 4 pairs: 13 blocks; maps padded to the window before counting
    windows (60x80 -> 64x80, 30x40 -> 32x40); odd blocks carry the mask."""
    sites = [s[:4] for s in swin_sites(ModelConfig(), 8, 480, 640)]
    enc2 = [(160, 256, 16, 0), (160, 256, 16, 20)] * 3
    assert sites == ([(2400, 64, 4, 0), (2400, 64, 4, 300), (640, 128, 8, 0), (640, 128, 8, 80)]
                     + enc2 + [(160, 256, 16, 0), (640, 128, 8, 0), (2400, 64, 4, 0)])


def test_every_kernel_has_a_bound():
    rows = all_kernels(ModelConfig())
    assert [r[0] for r in rows] == [f"K{i}" for i in range(1, 13)]
    for _, _, (nbytes, flops) in rows:
        ms, by = bound_ms(nbytes, flops)
        assert ms > 0 and by in ("bytes", "operations")


def test_per_call_work_sums_to_the_kernel_totals():
    """K5: 4 self layers (stats + apply over both images) and 8 cross
    launches (one image each) do the operations of the whole stack; K6: one
    fold call does the operations of its row."""
    cfg = ModelConfig()
    rows = {r[0]: r[2] for r in all_kernels(cfg)}
    c, f = cfg.coarse, cfg.fine
    L = 60 * 80
    launches = [(8, 4), (4, 8)]  # (images, launches) per forward
    flops = sum(n * (coarse_stats_work(G, L, c.d_model, c.nhead)[1]
                     + coarse_apply_work(G, L, c.d_model, c.nhead)[1]) for G, n in launches)
    assert flops == rows["K5"][1]
    fine = fine_stage_work(4 * 1024, f.window_size**2, f.d_model, f.nhead, len(f.layer_names))
    assert fine[1] == rows["K6"][1]
    assert fine[0] < rows["K6"][0]  # the fold mode writes heatmaps, not windows


def test_training_kernels_count_their_launches():
    """K8: 13 forward and 13 backward launches a step, the backward twice the
    forward's products and more bytes than it; K7: the pass-1 log-sum-exps
    and the backward's three products."""
    cfg = ModelConfig()
    rows = {r[0]: r[2] for r in all_kernels(cfg)}
    sites = swin_sites(cfg, 8, 480, 640)
    fwd = [swin_block_train_fwd_work(*st[:4]) for st in sites]
    bwd = [swin_block_train_bwd_work(*st[:4]) for st in sites]
    assert len(sites) == 13
    assert sum(w[1] for w in fwd + bwd) == rows["K8"][1]
    for st, f, b in zip(sites, fwd, bwd):
        assert f[1] == swin_block_work(*st[:4])[1] and b[1] == 2 * f[1] and b[0] > f[0]
    L, C = 60 * 80, cfg.coarse.d_model
    lse, k7 = dual_softmax_lse_work(4, L, L, C), sparse_focal_backward_work(4, L, L, C)
    assert lse[1] + k7[1] == rows["K7"][1] and k7[1] == 3 * lse[1]


def test_attn_bwd_counts_its_own_split():
    """K8's attention backward alone at C = 128 on 640 windows (8 heads),
    by hand: a token's x, f32 dx1 and dx, and the four stash operands h1,
    dqkv, o and do (bf16); the probabilities, the drop-path scales and the
    weights once; products 2 T (4 C^2 + 256 C), the recomputed qkv and o
    not counted."""
    W, C, h = 640, 128, 8
    T = W * 64
    nbytes, flops = swin_block_train_attn_bwd_work(W, C, h, 80)
    token = 2 * C + 4 * C + 2 * C + 2 * (C + 3 * C + C + C)
    probs = W * h * 64 * 64 * 2
    weights = (3 * C * C + C * C) * 2 + (3 * C + C + C) * 4  # w_qkv, w_proj; b_qkv, LN1
    assert nbytes == T * token + probs + W * 4 + weights
    assert flops == 2 * T * (4 * C * C + 256 * C)
    # a part of K8's backward: fewer products than the whole
    whole = swin_block_train_bwd_work(W, C, h, 80)
    assert flops < whole[1]


def test_mlp_bwd_counts_its_own_split():
    """K8's MLP backward alone at C = 256 on 160 windows (16 heads), by hand:
    a token's x1 and g (bf16) in, f32 dx1 and the four stash operands h2,
    dm, dy1 and gelu(y1) (C, C, 4 C, 4 C, bf16) out, 28 C bytes; the
    drop-path scales, W1, W2, b1 and LN2's scale and bias once; products
    2 T (8 C^2), the recomputed y1 not counted. Its products are fewer than
    the whole backward's, and the two branches' together are too."""
    W, C, h = 160, 256, 16
    T = W * 64
    nbytes, flops = swin_block_train_mlp_bwd_work(W, C, h, 20)
    token = 2 * C + 2 * C + 4 * C + 2 * (C + C + 4 * C + 4 * C)
    assert token == 28 * C
    weights = 2 * (4 * C * C) * 2 + (4 * C + C + C) * 4  # w_mlp1, w_mlp2; b_mlp1, LN2
    assert nbytes == T * token + W * 4 + weights
    assert flops == 2 * T * 8 * C * C
    whole = swin_block_train_bwd_work(W, C, h, 20)
    attn = swin_block_train_attn_bwd_work(W, C, h, 20)
    assert flops < whole[1] and flops + attn[1] < whole[1]
    # the mask does not enter the MLP branch
    assert swin_block_train_mlp_bwd_work(W, C, h, 0) == (nbytes, flops)


@pytest.mark.parametrize("kind,G", [("self", 8192), ("cross", 4096), ("cross", 7)])
def test_window_bwd_counts_its_own_split(kind, G):
    """K10's window stage alone at the training step's self call (8192
    windows of 49 taps, 8 heads) and cross call (4096), and at a grid that
    is not full (7 windows), by hand: a token's x (and src) in bf16 and g in
    f32 in, dx (and dsrc) in f32 and the 11 C bf16 stash out: 2048 bytes a
    token in the self call, 2432 in the cross call at C = 64; the weights
    once (bf16), LN1's scale and bias and LN2's scale (f32), a 4 C f32
    partial row a block (one an SM at most); products 2 T (10 C^2 + 4 C D),
    the recomputed forward not counted."""
    N, C, h = 49, 64, 8
    D, T = C // h, G * N
    nbytes, flops = fine_train_window_bwd_work(G, N, C, h, kind == "self")
    token = {"self": 2048, "cross": 2432}[kind]
    acts = 1 if kind == "self" else 2
    assert token == acts * C * 2 + C * 4 + acts * C * 4 + 11 * C * 2
    weights = (C * C + 2 * C * C + C * C + 4 * C * C + 2 * C * C) * 2 + 3 * C * 4
    assert nbytes == T * token + weights + min(G, 132) * 4 * C * 4
    assert flops == 2 * T * (10 * C * C + 4 * C * D)
    # a part of K10's backward: fewer products than the whole
    assert flops < fine_train_bwd_work(G, N, C, h, kind == "self")[1]
    # the step's three calls are bound by their bytes, about 0.54 ms together
    if G > 7:
        assert bound_ms(nbytes, flops)[1] == "bytes"
    step = total([fine_train_window_bwd_work(8192, N, C, h, True)]
                 + [fine_train_window_bwd_work(4096, N, C, h, False)] * 2)
    assert 0.53 < bound_ms(*step)[0] < 0.545


def test_apply_bwd_counts_its_own_split():
    """K9's apply backward alone at a cross call [4, 4800, 256] (8 heads),
    by hand: a token's x and g in, dx and the seven stash operands (o, msg,
    h, dy2, dy1, dm1, dqf: 9 C) out, all bf16; the merged stats of the 4
    images, wq, wmerge, w1 and w2 and LN1's scale and bias and LN2's scale
    once; the f32 partials of the 4 x 75 tiles; products 2 T (8 C^2 + 2 C
    D), the recomputed forward tile not counted."""
    G, L, C, h = 4, 4800, 256, 8
    D, T = C // h, G * L
    nbytes, flops = coarse_train_apply_bwd_work(G, L, L, C, h)
    token = 2 * C * 2 + C * 2 + 9 * C * 2
    stats = G * (C * D + C) * 2
    weights = (C * C + C * C + 2 * C * 2 * C + 2 * C * C) * 2 + 3 * C * 4
    partials = G * 75 * (4 * C + C * D + C) * 4
    assert nbytes == T * token + stats + weights + partials
    assert flops == 2 * T * (8 * C * C + 2 * C * D)
    # a part of K9's backward: fewer products than the whole; S does not count
    assert flops < coarse_train_bwd_work(G, L, L, C, h, False)[1]
    assert (nbytes, flops) == coarse_train_apply_bwd_work(G, L, 17, C, h)


@pytest.mark.parametrize("G,S", [(8, 4800), (4, 4800), (3, 65)])
def test_stats_bwd_counts_its_own_split(G, S):
    """K9's stats backward alone at the training step's self call [8, 4800,
    256] and cross call [4, 4800, 256] (8 heads) and at a ragged call, by
    hand: a token's src in, dsrc and the stash's [dkf | dv] out (4 C bf16);
    each image's merged dKᵀV and dK_sum and wkv once (bf16); products 2 T (2
    C² + 2 C D), K and V recomputed from src not counted. The step's 12
    calls (307,200 source tokens) are bound by their bytes: 633.4 MB and
    90.6 GFLOP, 0.1891 ms."""
    C, h = 256, 8
    D, T = C // h, G * S
    nbytes, flops = coarse_train_stats_bwd_work(G, S, C, h)
    assert nbytes == T * (C + C + 2 * C) * 2 + G * (C * D + C) * 2 + 2 * C * C * 2
    assert flops == 2 * T * (2 * C * C + 2 * C * D)
    # a part of K9's backward: fewer products than the whole
    assert flops < coarse_train_bwd_work(G, S, S, C, h, False)[1]
    step = total([coarse_train_stats_bwd_work(8, 4800, C, h)] * 4
                 + [coarse_train_stats_bwd_work(4, 4800, C, h)] * 8)
    assert round(step[0] / 1e6, 1) == 633.4 and round(step[1] / 1e9, 1) == 90.6
    b, by = bound_ms(*step)
    assert by == "bytes" and round(b, 4) == 0.1891


def test_command_line_prints_the_stats_bwd_row(capsys):
    """The module's table has stats_bwd's row at the step's 12 calls."""
    main()
    rows = [r for r in capsys.readouterr().out.splitlines() if "stats_bwd" in r]
    assert rows == ["| K9 bwd's stats_bwd alone (12 launches a step) | "
                    "csrc/coarse_transformer_train.cu stats_bwd_kernel | 633.4 | 90.6 | 0.1891 | "
                    "bytes |"]


def test_k9_counts_its_encoder_calls():
    """K9: 4 self calls on both images and 2 x 4 cross calls on one image
    each a step; the forward does K5's work, the backward twice its
    products and moves more bytes; together they make the K9 row."""
    cfg = ModelConfig()
    rows = {r[0]: r[2] for r in all_kernels(cfg)}
    L, C, h = 60 * 80, cfg.coarse.d_model, cfg.coarse.nhead
    calls = train_calls(cfg.coarse.layer_names, 8)
    assert sorted(calls) == [(4, False)] * 8 + [(8, True)] * 4
    fwd = [coarse_train_fwd_work(G, L, L, C, h) for G, _ in calls]
    bwd = [coarse_train_bwd_work(G, L, L, C, h, s) for G, s in calls]
    assert sum(w[1] for w in fwd) == rows["K5"][1]
    for f, b in zip(fwd, bwd):
        assert b[1] == 2 * f[1] and b[0] > f[0]
    assert sum(w[0] for w in fwd + bwd) == rows["K9"][0]
    assert sum(w[1] for w in fwd + bwd) == rows["K9"][1]


def test_k10_counts_its_encoder_calls():
    """K10: a self call on both sides' 4096 windows and 2 cross calls on
    4096 each a step; the forward does the operations of K6's encoder
    layers, the backward twice its products and moves more bytes; together
    they make the K10 row."""
    cfg = ModelConfig()
    rows = {r[0]: r[2] for r in all_kernels(cfg)}
    f = cfg.fine
    taps, nwin = f.window_size**2, 4 * 1024
    calls = train_calls(f.layer_names, 2 * nwin)
    assert calls == [(8192, True), (4096, False), (4096, False)]
    fwd = [fine_train_fwd_work(G, taps, f.d_model, f.nhead) for G, _ in calls]
    bwd = [fine_train_bwd_work(G, taps, f.d_model, f.nhead, s) for G, s in calls]
    k6 = fine_stage_work(nwin, taps, f.d_model, f.nhead, len(f.layer_names))
    assert sum(w[1] for w in fwd) == k6[1] - 2 * 2 * nwin * taps * f.d_model * 2  # no mix, no heat
    for fw, bw in zip(fwd, bwd):
        assert bw[1] == 2 * fw[1] and bw[0] > fw[0]
    # bf16 activations: x, g and dx of a self call; x, src, g, dx and dsrc of a cross call
    acts = sum(w[0] for w in bwd) - 3 * (10 * f.d_model**2 * (2 + 4) + 8 * f.d_model * 4)
    assert acts == (3 * 8192 + 5 * 2 * 4096) * taps * f.d_model * 2
    assert bound_ms(*total(bwd)) == (bound_ms(0, total(bwd)[1])[0], "operations")
    assert sum(w[0] for w in fwd + bwd) == rows["K10"][0]
    assert sum(w[1] for w in fwd + bwd) == rows["K10"][1]


def test_window_attention_sites_at_head_dim_64():
    """K11 once a block: 13 sites; at tpu_optimized_config() every block has
    head dim 64 (heads 1, 2, 4), fewer bias bytes, the same operations."""
    from featurematching_tpu_torch.config import tpu_optimized_config

    cfg = tpu_optimized_config().model
    sites = swin_sites(cfg, 8, 480, 640)
    assert len(sites) == 13 and all(s.C // s.heads == 64 for s in sites)
    tpu, default = (total(window_attention_sites(c)) for c in (cfg, ModelConfig()))
    assert tpu[1] == default[1] and tpu[0] < default[0]
    assert window_attention_sites(cfg)[1] == window_attention_work(2400, 64, 1, 300)


def test_head_dim_64_work():
    """tpu_optimized_config()'s head dim 64: K2 does the same operations with
    fewer relative-position bias bytes (one head where head dim 16 has four);
    K5's stats and K6's encoder layers form each head's whole [D, D] KᵀV, so
    their operations grow with D (C D multiply-adds a token and layer for
    KᵀV, as many for Q KᵀV); K5's apply likewise."""
    assert swin_block_work(2400, 64, 1, 300)[1] == swin_block_work(2400, 64, 4, 300)[1]
    assert (swin_block_work(2400, 64, 4, 0)[0] - swin_block_work(2400, 64, 1, 0)[0]
            == 3 * 64 * 64 * 4)
    for fn in (coarse_stats_work, coarse_apply_work):
        assert fn(8, 4800, 256, 4)[1] - fn(8, 4800, 256, 8)[1] == 8 * 4800 * 2 * 256 * 32
    assert (fine_stage_work(4096, 49, 64, 1, 2)[1] - fine_stage_work(4096, 49, 64, 8, 2)[1]
            == 2 * (2 * 4096 * 49) * 4 * 64 * (64 - 8))


@pytest.mark.parametrize("kernel", ["attn_bwd", "apply_bwd", "stats_bwd", "window_bwd"])
def test_training_backwards_at_head_dim_64(kernel):
    """tpu_optimized_config()'s training backwards by hand against the
    default's at the step's shapes. K8's attn_bwd: dP, dq, dk and dv take 64
    C multiply-adds a token at any head dim, so the operations stay and the
    saved probabilities shrink with the heads (1 of 4 at C = 64). K9's
    apply_bwd and stats_bwd: each head's dKᵀV products grow with D (2 C D
    multiply-adds a token each), as do the merged stats read and apply_bwd's
    per-tile dKᵀV partials (C D an image or tile). K10's window_bwd: its
    attention gradients (4 C D a token) grow with D."""
    G, L, C, T = 4, 4800, 256, 4 * 4800
    if kernel == "attn_bwd":
        n16, f16 = swin_block_train_attn_bwd_work(2400, 64, 4, 300)
        n64, f64 = swin_block_train_attn_bwd_work(2400, 64, 1, 300)
        assert f64 == f16 and n16 - n64 == 2400 * 3 * 64 * 64 * 2
    elif kernel == "apply_bwd":
        (n32, f32), (n64, f64) = (coarse_train_apply_bwd_work(G, L, L, C, h) for h in (8, 4))
        assert f64 - f32 == 2 * T * 2 * C * 32
        assert n64 - n32 == G * C * 32 * 2 + G * 75 * C * 32 * 4
    elif kernel == "stats_bwd":
        (n32, f32), (n64, f64) = (coarse_train_stats_bwd_work(G, L, C, h) for h in (8, 4))
        assert f64 - f32 == 2 * T * 2 * C * 32 and n64 - n32 == G * C * 32 * 2
    else:
        (n8, f8), (n64, f64) = (fine_train_window_bwd_work(4096, 49, 64, h, False)
                                for h in (8, 1))
        assert n64 == n8 and f64 - f8 == 2 * 4096 * 49 * 4 * 64 * 56


def test_all_kernels_at_tpu_optimized_config(capsys):
    """The twelve kernels at tpu_optimized_config(): K2's and K12's operations
    as the default's, K5's and K6's larger; the command line prints each
    row after the default's table."""
    from featurematching_tpu_torch.config import tpu_optimized_config

    tpu = {r[0]: r[2] for r in all_kernels(tpu_optimized_config().model)}
    default = {r[0]: r[2] for r in all_kernels(ModelConfig())}
    assert list(tpu) == list(default)
    for kid in ("K2", "K12", "K11"):
        assert tpu[kid][1] == default[kid][1] and tpu[kid][0] < default[kid][0]
    for kid in ("K5", "K6"):
        assert tpu[kid][1] > default[kid][1]
    main()
    rows = [r for r in capsys.readouterr().out.splitlines() if "(tpu_optimized_config" in r]
    assert [r.split(" (")[0] for r in rows] == [f"| K{i}" for i in range(1, 13)]


def test_float32_forms_count_the_teachers_calls(capsys):
    """The teacher's float32 kernels at loftr_tiny_config(): K1 once and K9's
    forward in 12 encoder calls (4 self of G = 8 reading their one input
    once, 8 cross of G = 4), K9's operations the bf16 counts' (the same
    products) and its bytes more (4-byte operands), K1's one L x S product
    (half the bf16 count's two: a float32 product costs more than storing
    sim and reading it back), bounded at the float32 peak outside the
    tensor cores; the command line prints both rows."""
    from featurematching_tpu_torch.config import loftr_tiny_config
    from featurematching_tpu_torch.utils.kernel_bounds import (
        BF16_TENSOR_FLOPS,
        FP32_FLOPS,
        HBM_BYTES_PER_S,
        coarse_layer_f32_work,
        dual_softmax_f32_work,
        dual_softmax_work,
        teacher_work,
    )

    work = teacher_work(loftr_tiny_config().model)
    assert len(work["K1"]) == 1 and len(work["K9 fwd"]) == 12
    L, C = 4800, 256
    assert work["K1"][0] == dual_softmax_f32_work(4, L, L, C)
    k1_bytes, k1_ops = dual_softmax_f32_work(4, L, L, C)
    assert 2 * k1_ops == dual_softmax_work(4, L, L, C)[1] == 4 * 4 * L * L * C
    # one product outlasts the sim matrix's round trip through memory
    assert k1_ops / FP32_FLOPS > 2 * 4 * 4 * L * L / HBM_BYTES_PER_S
    assert bound_ms(k1_bytes, k1_ops, FP32_FLOPS) == (k1_ops / FP32_FLOPS * 1e3, "operations")
    self_call, cross_call = coarse_layer_f32_work(8, L, L, C, 8, True), \
        coarse_layer_f32_work(4, L, L, C, 8, False)
    assert sorted(work["K9 fwd"]) == sorted([self_call] * 4 + [cross_call] * 8)
    fwd_bf16 = total([coarse_stats_work(8, L, C, 8), coarse_apply_work(8, L, C, 8)])
    assert self_call[1] == fwd_bf16[1] and self_call[0] > fwd_bf16[0]
    # a cross call reads its sources too
    assert cross_call[0] - coarse_layer_f32_work(4, L, L, C, 8, True)[0] == 4 * L * C * 4
    nbytes, flops = total(work["K9 fwd"])
    assert bound_ms(nbytes, flops, FP32_FLOPS) == (flops / FP32_FLOPS * 1e3, "operations")
    assert bound_ms(nbytes, flops)[0] < bound_ms(nbytes, flops, FP32_FLOPS)[0]
    assert BF16_TENSOR_FLOPS / FP32_FLOPS > 14
    main()
    rows = [r for r in capsys.readouterr().out.splitlines() if "float32 (loftr_tiny_config" in r]
    assert [r.split(" float32")[0] for r in rows] == ["| K1", "| K9 fwd"]

"""The outputs of K8's, K9's and K10's backwards at the default widths, for
holding two commits to the same bits on one card.

    python3 tools/train_bwd_bits.py ROOT OUT.pt
    python3 tools/train_bwd_bits.py --compare A.pt B.pt

The first form imports `chip_smoke.py` and the port from the checkout at
ROOT (another commit unpacked with `git archive` into a directory
`.gitignore` lists, or `.`), builds that checkout's kernels and saves, from
inputs made from one seed, every output of:
  - K8 (`swin_block_train_fwd` and `swin_block_train_bwd`) at the training
    step's three widths with head dim 16, without and with the shift mask
    and drop-path scales;
  - K9 (`coarse_layer_forward` and `coarse_layer_backward`) at (256, 32)
    and (128, 16), a self call and a cross call of [2, 4800, C];
  - K10 (`fine_layer_backward`) at head dims 8 and 16, a self call and a
    cross call of [4096, 49, 64].
The second form says, for each output, whether the two files hold the same
bits, and exits 1 where any differs. Run the first form for both trees in one
call on one card, then the second.
"""

import sys

import torch


def outputs(root: str) -> dict:
    sys.path.insert(0, root)
    import chip_smoke as cs
    from featurematching_tpu_torch.models.backbone_swin import _shift_attn_mask
    from featurematching_tpu_torch.ops.coarse_transformer_train import (
        coarse_layer_backward,
        coarse_layer_forward,
        train_values,
    )
    from featurematching_tpu_torch.ops.fine_transformer_train import fine_layer_backward
    from featurematching_tpu_torch.ops.swin_block_train import (
        _kernel_params,
        swin_block_train_bwd,
        swin_block_train_fwd,
    )

    g = torch.Generator(device="cuda").manual_seed(0)
    out = {}
    for nwin, C, h, (Hp, Wp) in ((2400, 64, 4, (120, 160)), (640, 128, 8, (64, 80)),
                                 (160, 256, 16, (32, 40))):
        x = cs.rnd(g, nwin, 64, C, dtype=torch.bfloat16)
        gout = cs.rnd(g, nwin, 64, C, dtype=torch.bfloat16)
        kp = _kernel_params(cs.block_params(g, C, h), C, h)
        mask = torch.as_tensor(_shift_attn_mask(Hp, Wp, 8, 4), device="cuda")
        s1, s2 = (torch.rand(2, nwin, generator=g, device="cuda") < 0.8).float() / 0.8
        for tag, m, a, b in (("plain", None, None, None), ("mask", mask, s1, s2)):
            y, probs, x1 = swin_block_train_fwd(x, m, a, b, kp, h)
            dx, grads = swin_block_train_bwd(x, a, b, probs, x1, gout, kp, h)
            key = f"K8 C={C} {tag}"
            out |= {f"{key} out": y, f"{key} probs": probs, f"{key} dx": dx}
            out |= {f"{key} grad {i}": t for i, t in enumerate(grads)}
    for C, h in ((256, 8), (128, 8)):
        for kind in ("self", "cross"):
            lv = cs.layer_values(g, C)
            lt = train_values(lv)
            x = cs.rnd(g, 2, 4800, C, dtype=torch.bfloat16)
            src = x if kind == "self" else cs.rnd(g, 2, 4800, C, dtype=torch.bfloat16)
            gout = cs.rnd(g, 2, 4800, C, dtype=torch.bfloat16)
            y, kv, ks = coarse_layer_forward(x, src, lv, h)
            dx, dsrc, grads = coarse_layer_backward(x, src, kv, ks, gout, lv, lt, h)
            key = f"K9 C={C} D={C // h} {kind}"
            out |= {f"{key} out": y, f"{key} dx": dx, f"{key} dsrc": dsrc}
            out |= {f"{key} grad {i}": t for i, t in enumerate(grads)}
    for h in (8, 4):
        for kind in ("self", "cross"):
            lv = cs.layer_values(g, 64)
            x = cs.rnd(g, 4096, 49, 64, dtype=torch.bfloat16)
            src = x if kind == "self" else cs.rnd(g, 4096, 49, 64, dtype=torch.bfloat16)
            gout = cs.rnd(g, 4096, 49, 64)
            dx, dsrc, grads = fine_layer_backward(x, src, gout, lv, h)
            key = f"K10 D={64 // h} {kind}"
            out |= {f"{key} dx": dx} | ({} if dsrc is None else {f"{key} dsrc": dsrc})
            out |= {f"{key} grad {i}": t for i, t in enumerate(grads)}
    torch.cuda.synchronize()
    return {k: v.detach().cpu() for k, v in out.items()}


def compare(a: str, b: str) -> int:
    ta, tb = torch.load(a), torch.load(b)
    differ = [k for k in ta if k not in tb or not torch.equal(ta[k], tb[k])]
    for k in ta:
        print(f"  {k}: {'DIFFERS' if k in differ else 'same bits'}")
    print(f"{len(ta) - len(differ)} of {len(ta)} outputs bit-identical "
          f"({len(set(tb) - set(ta))} only in {b})")
    return 1 if differ or set(tb) - set(ta) else 0


if __name__ == "__main__":
    if sys.argv[1] == "--compare":
        sys.exit(compare(sys.argv[2], sys.argv[3]))
    print(f"{torch.cuda.get_device_name(0)}: saving {sys.argv[2]} from {sys.argv[1]}", flush=True)
    torch.save(outputs(sys.argv[1]), sys.argv[2])

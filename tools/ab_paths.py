"""The device time of the port's three paths in one checkout, for comparing
two commits on one card.

    python3 tools/ab_paths.py ROOT

imports `chip_smoke.py` and the port from the checkout at ROOT (another
commit unpacked with `git archive` into a directory `.gitignore` lists, or
`.`), builds that checkout's kernels and prints:
  - the serving forward (`default_config()`, 640x480, batch 4, bf16): its
    device time by the profiler over one forward after a warm-up, its
    launches, and the time of K5's kernels (stats, merge, apply) and of
    K6's (fine_stage_kernel) in it; its host clock (median, least and most
    of HOST_RUNS runs of chip_smoke's N_FORWARD forwards); and the host time
    of K5's 8-layer stack alone at the forward's shapes (three stacks issued
    with no wait for the card, median, least and most of HOST_RUNS); for
    both, the CUDA runtime calls with the most host time (the profiler);
  - the training step (`chip_smoke.training_step`: step time, device time
    of the forward, backward and optimizer, launches);
  - the evaluation step with the per-op block (`chip_smoke.eval_forward`:
    step time, device time, launches);
  - the device time of K6's kernel (K10's forward) in the profile of the
    whole training step and of the whole evaluation step, of K11's kernel
    (`window_attention_kernel`) in the evaluation step's, and of K7's
    kernels (`sfl_bwd_kernel`, `prep_kernel`) and the weight gradients'
    (`wgrad_kernel`, `sum_parts_group_kernel`; `sum_parts_kernel`, which
    also add the backwards' other partials) and K8's backward's window
    kernels (`mlp_bwd_kernel`, `attn_bwd_kernel`), K10's backward's
    (`window_bwd_kernel`) and K9's backward's (`apply_bwd_kernel`,
    `stats_bwd_kernel`) in the training step's;
  - the training step's backward on the host clock (`loss.backward()` after
    a forward, the card drained before and waited for after: median, least
    and most of HOST_RUNS).
Run it once for each tree in turns (old, new, new, old) in one call on one
card.
"""

import importlib
import re
import subprocess
import sys
import time

ROOT = sys.argv[1]
sys.path.insert(0, ROOT)
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from featurematching_tpu_torch.config import default_config  # noqa: E402
from featurematching_tpu_torch.models.fast_inference import FastMatcher  # noqa: E402
from featurematching_tpu_torch.ops import _build  # noqa: E402

# the module of `featurematching_tpu_torch.ops` that holds each wrapper
MODULES = {
    "swin_block_fused": "swin_block", "layer_norm_chain": "layer_norm",
    "patch_expand_ln": "patch_expand", "dual_softmax_match_stats": "dual_softmax",
    "dual_softmax_lse": "dual_softmax", "coarse_transformer_fused": "coarse_transformer",
    "fine_stage_fused": "fine_stage", "swin_block_train_fwd": "swin_block_train",
    "swin_block_train_bwd": "swin_block_train", "sparse_focal_backward": "sparse_focal_loss",
    "coarse_layer_forward": "coarse_transformer_train",
    "coarse_layer_backward": "coarse_transformer_train",
    "fine_layer_forward": "fine_stage", "fine_layer_backward": "fine_transformer_train",
    "window_attention": "window_attention", "swin_block_fused_image": "swin_block_image",
    "wgrad": "wgrad",
}
K5_KERNELS = ("stats_kernel", "merge_kernel", "apply_kernel")
K6_KERNEL = "fine_stage_kernel"
K7_KERNELS = ("sfl_bwd_kernel", "prep_kernel")
WGRAD_KERNELS = ("wgrad_kernel", "sum_parts_group_kernel", "sum_parts_kernel")
K8_BWD_KERNELS = ("mlp_bwd_kernel", "attn_bwd_kernel")
K10_BWD_KERNEL = "window_bwd_kernel"
K9_BWD_KERNELS = ("apply_bwd_kernel", "stats_bwd_kernel")
K11_KERNEL = "window_attention_kernel"
HOST_RUNS = 7
_profiles = []  # the rows of each chip_smoke.profile_ms call
_profile_ms = cs.profile_ms


def _recording_profile_ms(fn):
    busy, rows = _profile_ms(fn)
    _profiles.append(rows)
    return busy, rows


cs.profile_ms = _recording_profile_ms


def kernel_ms(rows, name: str) -> float:
    return sum(ms for ms, _, n in rows if re.search(rf"\b{name}\b", n))


def kernel_launches(rows, name: str) -> int:
    return sum(c for _, c, n in rows if re.search(rf"\b{name}\b", n))


def host_ms(fn, n: int, wait: bool) -> str:
    """Median, least and most host ms of one fn() call over HOST_RUNS runs of
    n calls, the card drained before each run and, where `wait`, waited for
    at its end."""
    runs = []
    for _ in range(HOST_RUNS):
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(n):
            fn()
        if wait:
            torch.cuda.synchronize()
        runs.append((time.perf_counter() - t) / n * 1e3)
    runs.sort()
    return f"{runs[len(runs) // 2]:.3f} ms (least {runs[0]:.3f}, most {runs[-1]:.3f})"


def runtime_calls(fn, top: int = 6) -> str:
    """The CUDA runtime and driver calls of one fn() call with the most host
    time, from the profiler: name, calls and host ms."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = sorted(((e.cpu_time_total / 1e3, e.count, e.key) for e in prof.key_averages()
                   if e.key.startswith("cu") and e.key != "cudaDeviceSynchronize"), reverse=True)
    return ", ".join(f"{name} x{n} {ms:.3f} ms" for ms, n, name in rows[:top])


def k5_host() -> None:
    """K5's 8-layer stack as the serving forward calls it, on the host clock
    with no wait for the card: what its wrappers cost the host."""
    from featurematching_tpu_torch.ops.coarse_transformer import coarse_transformer_fused

    g = torch.Generator(device="cuda").manual_seed(0)
    n = (cs.H // 8) * (cs.W // 8)
    layers = [cs.layer_values(g, 256) for _ in range(8)]
    f0, f1 = (cs.rnd(g, cs.B, n, 256, dtype=torch.bfloat16) for _ in range(2))
    fn = lambda: coarse_transformer_fused(f0, f1, layers, ("self", "cross") * 4, 8)  # noqa: E731
    fn()  # warm-up: images and plans
    print(f"  K5's stack on the host, issued without waiting: {host_ms(fn, 3, False)} a stack; "
          f"its runtime calls: {runtime_calls(fn)}", flush=True)


def backward_host() -> None:
    """The training step's backward on the host clock, as
    chip_smoke.training_step runs the step."""
    import numpy as np

    from featurematching_tpu_torch.data.synthetic import synthetic_batch
    from featurematching_tpu_torch.train.step import create_train_state, forward_with_loss

    cfg = cs.training_config()
    state = create_train_state(cfg, device="cuda", seed=0)
    batch = synthetic_batch(np.random.default_rng(0), batch_size=cs.B, image_size=(cs.H, cs.W),
                            num_gt=cfg.model.match_coarse.max_gt_matches)
    batch = {k: torch.as_tensor(v, device="cuda") for k, v in batch.items()}
    runs = []
    for i in range(HOST_RUNS + 1):
        state.model.zero_grad(set_to_none=True)
        losses, _ = forward_with_loss(state.model, cfg, batch, train=True)
        torch.cuda.synchronize()
        t = time.perf_counter()
        losses.loss.backward()
        torch.cuda.synchronize()
        if i:  # the first is a warm-up
            runs.append((time.perf_counter() - t) * 1e3)
    runs.sort()
    print(f"  training step's backward, host clock: {runs[len(runs) // 2]:.3f} ms (least "
          f"{runs[0]:.3f}, most {runs[-1]:.3f})", flush=True)


def serving_forward() -> None:
    model = FastMatcher(default_config().model, device="cuda", seed=0)
    gi = torch.Generator(device="cuda").manual_seed(1)
    img0 = torch.rand(cs.B, cs.H, cs.W, 3, generator=gi, device="cuda")
    img1 = torch.roll(img0, shifts=16, dims=2)
    with torch.no_grad():
        model(img0, img1)  # warm-up: builds and packs
        busy, rows = cs.profile_ms(lambda: model(img0, img1))
    k5 = {k: kernel_ms(rows, k) for k in K5_KERNELS}
    print(f"  serving forward: {busy:.3f} ms of device time, {sum(r[1] for r in rows)} "
          f"launches; K5 {sum(k5.values()):.4f} ms (" + ", ".join(
              f"{k} {v:.4f}" for k, v in k5.items()) + f"); K6 {kernel_ms(rows, K6_KERNEL):.4f} ms",
          flush=True)
    with torch.no_grad():
        host = host_ms(lambda: model(img0, img1), cs.N_FORWARD, True)
    print(f"  serving forward, host clock: {host} a forward", flush=True)
    with torch.no_grad():
        print(f"  serving forward's runtime calls: {runtime_calls(lambda: model(img0, img1))}",
              flush=True)


def main() -> None:
    t = time.time()
    _build.build()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(f"[{ROOT}] build {time.time() - t:.1f} s; card {card}", flush=True)
    wrappers = {n: getattr(importlib.import_module(f"featurematching_tpu_torch.ops.{MODULES[n]}"),
                           n) for n in cs.EXPECTED_PER_STEP}
    serving_forward()
    k5_host()
    cs.training_step(wrappers, {})
    print(f"  K6's kernel (K10's forward) in the training step: "
          f"{kernel_ms(_profiles[-1], K6_KERNEL):.4f} ms; K7's: " + ", ".join(
              f"{k} {kernel_ms(_profiles[-1], k):.4f} ms" for k in K7_KERNELS)
          + "; the weight gradients': " + ", ".join(
              f"{k} {kernel_ms(_profiles[-1], k):.4f} ms x{kernel_launches(_profiles[-1], k)}"
              for k in WGRAD_KERNELS) + "; K8's backward's window kernels: " + ", ".join(
              f"{k} {kernel_ms(_profiles[-1], k):.4f} ms x{kernel_launches(_profiles[-1], k)}"
              for k in K8_BWD_KERNELS) + f"; K10's backward's window stage: {K10_BWD_KERNEL} "
          f"{kernel_ms(_profiles[-1], K10_BWD_KERNEL):.4f} ms "
          f"x{kernel_launches(_profiles[-1], K10_BWD_KERNEL)}; K9's backward's: " + ", ".join(
              f"{k} {kernel_ms(_profiles[-1], k):.4f} ms x{kernel_launches(_profiles[-1], k)}"
              for k in K9_BWD_KERNELS), flush=True)
    backward_host()
    cs.eval_forward(wrappers, {})
    print(f"  K6's kernel (K10's forward) in the evaluation step: "
          f"{kernel_ms(_profiles[-1], K6_KERNEL):.4f} ms; K11's: {K11_KERNEL} "
          f"{kernel_ms(_profiles[-1], K11_KERNEL):.4f} ms "
          f"x{kernel_launches(_profiles[-1], K11_KERNEL)}", flush=True)


if __name__ == "__main__":
    main()

"""The work counts behind the kernels' bounds in chip_smoke.py and PERF.md."""

from featurematching_tpu_torch.config import ModelConfig
from featurematching_tpu_torch.utils.kernel_bounds import all_kernels, bound_ms, swin_sites


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

"""Model FLOPs of StyleGAN2's generator forward, with `flops.py`'s
convention: dense MACs × 2 of each layer at its output resolution, so a
fused or resampled form that runs other MACs counts alike. Per sample: the
mapping's FCs, every affine, every modulated 3×3 conv (conv0 at its
upsampled output) and every 1×1 toRGB; the modulation, demodulation, FIR
filters and epilogues are elementwise or bandwidth-bound and not counted.
Config-f at 1024²: 451 GMAC an image, 14.4 TFLOP a request of 16."""

from __future__ import annotations

from benchmark.reference import stylegan2 as ref


def forward_flops(model: dict, batch: int) -> float:
    z, w = int(model["z_dim"]), int(model["w_dim"])
    macs = z * w + (int(model["mapping_layers"]) - 1) * w * w
    prev = 0
    for res in ref.resolutions(model):
        c = ref.channels(model, res)
        convs = [c] if res == 4 else [prev, c]
        macs += sum(w * cin + res * res * 9 * cin * c for cin in convs)
        macs += w * c + res * res * c * int(model["img_channels"])
        prev = c
    return 2.0 * batch * macs

"""Model FLOPs of StyleGAN3-T's generator forward, with `flops.py`'s
convention: dense MACs × 2 of each layer at its output's size, so a fused
or resampled form that runs other MACs counts alike. Per sample: the
mapping's FCs, the input layer's affine and channel mix, every affine,
every modulated 3×3 conv at its output (the input's size + 2) and the 1×1
toRGB; the Fourier features, the modulation, demodulation, the filtered
leaky ReLUs' FIR filters and activations are elementwise or bandwidth-bound
and not counted. `stylegan3-t` at 1024²: 285.6 GMAC an image, 9.14 TFLOP a
request of 16."""

from __future__ import annotations

from benchmark.reference import stylegan3 as ref


def forward_flops(model: dict, batch: int) -> float:
    z, w = int(model["z_dim"]), int(model["w_dim"])
    macs = z * w + (int(model["mapping_layers"]) - 1) * w * w
    spec = ref.input_spec(model)
    macs += w * 4 + spec["size"] ** 2 * spec["channels"] ** 2
    for layer in ref.schedule(model):
        out = layer["in_size"] + layer["kernel"] - 1
        cin = layer["in_channels"]
        macs += w * cin + out * out * layer["kernel"] ** 2 * cin * layer["channels"]
    return 2.0 * batch * macs

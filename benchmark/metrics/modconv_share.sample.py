"""% of the device time of StyleGAN2 forwards in the kernels launched inside
the `stylegan2.modconv` ranges (modulation, convolution, demodulation and
noise; the upsample inside conv0 counts as resample), in a profiled pass of
back-to-back forwards (moves sample_img_per_s)."""


def read(ctx):
    return ctx.get("span_shares", {}).get("stylegan2.modconv")

"""% of the device time of StyleGAN2 forwards in the kernels launched inside
the `stylegan2.resample` ranges (every FIR upsample: conv0's and the RGB
skip's), in a profiled pass of back-to-back forwards (moves
sample_img_per_s)."""


def read(ctx):
    return ctx.get("span_shares", {}).get("stylegan2.resample")

"""% of the device time of StyleGAN3 forwards in the kernels launched inside
the `stylegan3.filtered_lrelu` ranges (each filtered leaky ReLU: its up
stage, activation and down stage, and the toRGB's bias and clamp), in a
profiled pass of back-to-back forwards (moves sample_img_per_s)."""


def read(ctx):
    return ctx.get("span_shares", {}).get("stylegan3.filtered_lrelu")

"""Device ms of one step with R1: its CUDA graph replayed back to back, or
CUDA events around eager steps (moves train_img_per_s)."""


def read(ctx):
    return ctx.get("device_ms", {}).get("r1")

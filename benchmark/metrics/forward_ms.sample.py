"""Device ms of one G forward: forwards enqueued back to back, CUDA events
(moves sample_img_per_s)."""


def read(ctx):
    return ctx.get("device_ms", {}).get("forward")
